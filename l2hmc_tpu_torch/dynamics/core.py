"""Network-augmented leapfrog dynamics — the L2HMC core
(counterpart of ``l2hmc_tpu/dynamics/core.py``).

Static configuration lives in a ``Dynamics`` dataclass; learnable state is an
explicit params tree ``{"alpha", "xnet", "vnet"}`` of tensors. The T leapfrog
steps run as a Python loop. The update equations are the paper's
(arXiv 1711.09268, eqs. 8-13), with the exact inverse and the log-det-Jacobian
``sum(sv1 + sv2 + mb*sx1 + m*sx2)``.

Supported: HMC mode, scalar or per-dimension (``eps_dim``) step size,
``input_scale``. Not ported yet (raise ``NotImplementedError``): ``eps_step``,
``eps_mat``, ``net_input_fn``, ``use_temperature``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from l2hmc_tpu_torch.config import resolve_device
from l2hmc_tpu_torch.nets.core import Module
from l2hmc_tpu_torch.targets.base import batched_grad

Params = Any


def make_masks(mask_seed: int, T: int, dim: int) -> np.ndarray:
    """Per-step random binary half-masks from a seed: exactly ``dim // 2``
    ones per step, drawn with numpy's ``default_rng`` so they match the JAX
    package's masks bit for bit. (T, dim) float32."""
    rng = np.random.default_rng(mask_seed)
    masks = np.zeros((T, dim), np.float32)
    for t in range(T):
        idx = rng.permutation(dim)[: dim // 2]
        masks[t, idx] = 1.0
    return masks


def time_encoding(T: int) -> np.ndarray:
    """(T, 2) [cos, sin](2*pi*t/T) features."""
    t = np.arange(T, dtype=np.float32)
    return np.stack(
        [np.cos(2.0 * np.pi * t / T), np.sin(2.0 * np.pi * t / T)], axis=1
    )


@dataclasses.dataclass(frozen=True, eq=False)
class Dynamics:
    """Static configuration of the augmented-leapfrog integrator.

    Attributes:
      dim: state dimensionality.
      energy: batched energy ``x -> (n,)``.
      T: leapfrog steps per trajectory.
      xnet / vnet: S/T/Q modules (ignored when ``hmc=True``).
      hmc: plain-HMC mode — zero networks, exact leapfrog.
      eps_trainable: whether alpha = log(eps) receives gradients.
      eps_dim: per-dimension step size (alpha has shape (dim,)).
      mask_seed: seed for the per-step binary masks.
      input_scale: per-dimension sigma whitening the net inputs
        (x-like inputs / sigma, gradient inputs * sigma).
      grad_energy: batched energy gradient; autograd of ``energy`` when None.
    """

    dim: int
    energy: Callable[[torch.Tensor], torch.Tensor]
    T: int = 25
    xnet: Optional[Module] = None
    vnet: Optional[Module] = None
    hmc: bool = False
    eps_trainable: bool = True
    eps_dim: bool = False
    eps_step: bool = False
    eps_mat: bool = False
    use_temperature: bool = False
    mask_seed: int = 0
    input_scale: Optional[tuple] = None
    net_input_fn: Optional[Callable] = None
    grad_energy: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def __post_init__(self):
        if not self.hmc and (self.xnet is None or self.vnet is None):
            raise ValueError("non-HMC dynamics requires xnet and vnet modules")
        for name in ("eps_step", "eps_mat", "use_temperature"):
            if getattr(self, name):
                raise NotImplementedError(f"Dynamics.{name} is not ported yet")
        if self.net_input_fn is not None:
            raise NotImplementedError("Dynamics.net_input_fn is not ported yet")
        if self.grad_energy is None:
            object.__setattr__(self, "grad_energy", batched_grad(self.energy))
        object.__setattr__(self, "masks", make_masks(self.mask_seed, self.T, self.dim))
        object.__setattr__(self, "times", time_encoding(self.T))
        object.__setattr__(self, "_cache", {})

    def _consts(self, like: torch.Tensor):
        """(masks (T, dim), times (T, 2), input sigma or None) on ``like``'s
        device and dtype, made once per device."""
        key = (like.device, like.dtype)
        c = self._cache.get(key)
        if c is None:
            sig = None
            if self.input_scale is not None:
                sig = torch.as_tensor(
                    np.asarray(self.input_scale, np.float32), dtype=like.dtype,
                    device=like.device,
                )
            c = (
                torch.as_tensor(self.masks, dtype=like.dtype, device=like.device),
                torch.as_tensor(self.times, dtype=like.dtype, device=like.device),
                sig,
            )
            self._cache[key] = c
        return c

    # -- params ------------------------------------------------------------

    def init_params(self, generator: torch.Generator, eps=0.1, device=None) -> Params:
        """{"alpha": log eps, "xnet": ..., "vnet": ...}. ``eps`` may be a
        (dim,) vector with ``eps_dim``. Runs on ``cuda`` unless ``device``
        says otherwise."""
        dev = resolve_device(device)
        alpha = torch.log(torch.as_tensor(eps, dtype=torch.float32)).to(dev)
        if self.eps_dim:
            alpha = torch.broadcast_to(alpha, (self.dim,)).clone()
        elif alpha.ndim != 0:
            raise ValueError("vector eps init requires eps_dim")
        if self.hmc:
            return {"alpha": alpha, "xnet": (), "vnet": ()}
        return {
            "alpha": alpha,
            "xnet": self.xnet.init(generator, dev),
            "vnet": self.vnet.init(generator, dev),
        }

    def eps(self, params: Params) -> torch.Tensor:
        alpha = params["alpha"]
        if not self.eps_trainable:
            alpha = alpha.detach()
        return torch.exp(alpha)

    # -- energies ----------------------------------------------------------

    def kinetic(self, v: torch.Tensor) -> torch.Tensor:
        return 0.5 * torch.sum(v * v, dim=1)

    def hamiltonian(self, x, v) -> torch.Tensor:
        return self.energy(x) + self.kinetic(v)

    def _apply_nets(self, params: Params, net: str, inputs, sig) -> tuple:
        """VNet/XNet apply; zeros in HMC mode. With ``input_scale`` vnet sees
        [x / sigma, grad * sigma] and xnet [v, masked x / sigma]."""
        if self.hmc:
            z = torch.zeros_like(inputs[0])
            return z, z, z
        if sig is not None:
            if net == "vnet":
                inputs = [inputs[0] / sig, inputs[1] * sig, *inputs[2:]]
            else:
                inputs = [inputs[0], inputs[1] / sig, *inputs[2:]]
        mod = self.vnet if net == "vnet" else self.xnet
        s, t, q = mod.apply(params[net], inputs)
        return s, t, q

    # -- single leapfrog substeps -----------------------------------------

    def forward_step(self, params, x, v, step_idx: int):
        """One augmented leapfrog step; returns (x_out, v_out, logdet)."""
        eps = self.eps(params)
        masks, times, sig = self._consts(x)
        t = times[step_idx].expand(x.shape[0], 2)
        m = masks[step_idx]
        mb = 1.0 - m

        grad1 = self.grad_energy(x)
        s, tt, q = self._apply_nets(params, "vnet", [x, grad1, t, None], sig)
        sv1 = 0.5 * eps * s
        fv1 = eps * q
        v_h = v * torch.exp(sv1) + 0.5 * eps * (-torch.exp(fv1) * grad1 + tt)

        s, tt, q = self._apply_nets(params, "xnet", [v_h, m * x, t, None], sig)
        sx1 = eps * s
        fx1 = eps * q
        y = m * x + mb * (x * torch.exp(sx1) + eps * (torch.exp(fx1) * v_h + tt))

        s, tt, q = self._apply_nets(params, "xnet", [v_h, mb * y, t, None], sig)
        sx2 = eps * s
        fx2 = eps * q
        x_o = mb * y + m * (y * torch.exp(sx2) + eps * (torch.exp(fx2) * v_h + tt))

        grad2 = self.grad_energy(x_o)
        s, tt, q = self._apply_nets(params, "vnet", [x_o, grad2, t, None], sig)
        sv2 = 0.5 * eps * s
        fv2 = eps * q
        v_o = v_h * torch.exp(sv2) + 0.5 * eps * (-torch.exp(fv2) * grad2 + tt)

        logdet = torch.sum(sv1 + sv2 + mb * sx1 + m * sx2, dim=1)
        return x_o, v_o, logdet

    def backward_step(self, params, x_o, v_o, step_idx: int):
        """Exact inverse of :meth:`forward_step`."""
        eps = self.eps(params)
        masks, times, sig = self._consts(x_o)
        t = times[step_idx].expand(x_o.shape[0], 2)
        m = masks[step_idx]
        mb = 1.0 - m

        grad1 = self.grad_energy(x_o)
        s, tt, q = self._apply_nets(params, "vnet", [x_o, grad1, t, None], sig)
        sv2 = -0.5 * eps * s
        fv2 = eps * q
        v_h = (v_o - 0.5 * eps * (-torch.exp(fv2) * grad1 + tt)) * torch.exp(sv2)

        s, tt, q = self._apply_nets(params, "xnet", [v_h, mb * x_o, t, None], sig)
        sx2 = -eps * s
        fx2 = eps * q
        y = mb * x_o + m * torch.exp(sx2) * (x_o - eps * (torch.exp(fx2) * v_h + tt))

        s, tt, q = self._apply_nets(params, "xnet", [v_h, m * y, t, None], sig)
        sx1 = -eps * s
        fx1 = eps * q
        x = m * y + mb * torch.exp(sx1) * (y - eps * (torch.exp(fx1) * v_h + tt))

        grad2 = self.grad_energy(x)
        s, tt, q = self._apply_nets(params, "vnet", [x, grad2, t, None], sig)
        sv1 = -0.5 * eps * s
        fv1 = eps * q
        v = torch.exp(sv1) * (v_h - 0.5 * eps * (-torch.exp(fv1) * grad2 + tt))

        logdet = torch.sum(sv1 + sv2 + mb * sx1 + m * sx2, dim=1)
        return x, v, logdet

    # -- full trajectories -------------------------------------------------

    def forward(self, params, x, v):
        """T forward steps; returns (X, V, logdet)."""
        logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for step in range(self.T):
            x, v, ld = self.forward_step(params, x, v, step)
            logdet = logdet + ld
        return x, v, logdet

    def backward(self, params, x, v):
        """T inverse steps applied in reverse order."""
        logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for step in range(self.T - 1, -1, -1):
            x, v, ld = self.backward_step(params, x, v, step)
            logdet = logdet + ld
        return x, v, logdet

    def p_accept(self, params, x0, v0, x1, v1, log_jac) -> torch.Tensor:
        """MH acceptance prob exp(min(H0 - H1 + logJ, 0)), NaN-guarded to 0."""
        e_old = self.hamiltonian(x0, v0)
        e_new = self.hamiltonian(x1, v1)
        p = torch.exp(torch.clamp(e_old - e_new + log_jac, max=0.0))
        return torch.where(torch.isfinite(p), p, torch.zeros_like(p))
