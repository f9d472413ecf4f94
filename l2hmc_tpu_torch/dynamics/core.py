"""Network-augmented leapfrog dynamics — the L2HMC core
(counterpart of ``l2hmc_tpu/dynamics/core.py``).

Static configuration lives in a ``Dynamics`` dataclass; learnable state is an
explicit params tree ``{"alpha", "xnet", "vnet"}`` of tensors. The T leapfrog
steps run as a Python loop. The update equations are the paper's
(arXiv 1711.09268, eqs. 8-13), with the exact inverse and the log-det-Jacobian
``sum(sv1 + sv2 + mb*sx1 + m*sx2)``.

Supported: HMC mode, scalar or per-dimension (``eps_dim``) step size, the
dense drift preconditioner ``eps_mat``, ``input_scale``, the state-dependent
net-input features ``net_input_fn``, the temperature (``use_temperature``:
the energy and its gradient divided by the ``temperature`` a call passes),
and the ``aux`` input: a per-batch side input (for the VAE sampler a dict of
the raw batch, its embedding and the decoder params) that is handed to
``energy``/``grad_energy`` as ``aux=`` and to the nets as their fourth Zip
input. Not ported yet (raises ``NotImplementedError``): ``eps_step``.
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
      energy: batched energy ``x -> (n,)``; called as ``energy(x, aux=aux)``
        when the caller passes ``aux``.
      T: leapfrog steps per trajectory.
      xnet / vnet: S/T/Q modules (ignored when ``hmc=True``).
      hmc: plain-HMC mode — zero networks, exact leapfrog.
      eps_trainable: whether alpha = log(eps) receives gradients.
      eps_dim: per-dimension step size (alpha has shape (dim,)).
      eps_mat: a dense trainable (dim, dim) matrix W (the params' ``"w"``
        leaf) in place of eps on the translation terms only: v-drifts
        become ``a @ W``, x-drifts ``a @ W.T``; the exp-gates keep the
        scalar eps, so the log-det and the closed-form inverse are
        unchanged. Mutually exclusive with ``eps_dim`` and ``eps_step``.
      mask_seed: seed for the per-step binary masks.
      use_temperature: divide the energy and its gradient by the
        ``temperature`` argument of the energies, substeps, trajectories
        and ``p_accept`` (1.0 by default): a scalar, or an (n,) tensor of
        one a chain (the rungs of ``mcmc.pt_sample_chain``).
      input_scale: per-dimension sigma whitening the net inputs
        (x-like inputs / sigma, gradient inputs * sigma).
      net_input_fn: a state-dependent net-input feature map
        ``(net, inputs) -> inputs`` (``net`` is "vnet" or "xnet", ``inputs``
        the list the S/T/Q module would see), applied after
        ``input_scale``; exclusive with it. A fixed function of the
        substep's own arguments, so each substep stays invertible with the
        same log-det.
      grad_energy: batched energy gradient (same ``aux`` convention);
        autograd of ``energy`` when None.
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
        if sum((self.eps_dim, self.eps_step, self.eps_mat)) > 1:
            raise ValueError("eps_dim, eps_step and eps_mat are mutually exclusive")
        if self.input_scale is not None and self.net_input_fn is not None:
            # net_input_fn would see already-rescaled inputs, and compute
            # features of the wrong coordinates
            raise ValueError(
                "input_scale and net_input_fn are mutually exclusive — "
                "fold the linear whitening into the feature map instead"
            )
        if self.eps_step:
            raise NotImplementedError("Dynamics.eps_step is not ported yet")
        if self.grad_energy is None:
            object.__setattr__(self, "grad_energy", batched_grad(self.energy))
        object.__setattr__(self, "masks", make_masks(self.mask_seed, self.T, self.dim))
        object.__setattr__(self, "times", time_encoding(self.T))
        object.__setattr__(self, "_cache", {})

    def consts(self, device, dtype=torch.float32):
        """(masks (T, dim), times (T, 2), input sigma or None) on ``device``
        in ``dtype``, made once per device, so a step copies nothing from
        the host (what a captured step needs)."""
        key = (torch.device(device), dtype)
        c = self._cache.get(key)
        if c is None:
            sig = None
            if self.input_scale is not None:
                sig = torch.as_tensor(
                    np.asarray(self.input_scale, np.float32), dtype=dtype, device=device,
                )
            c = (
                torch.as_tensor(self.masks, dtype=dtype, device=device),
                torch.as_tensor(self.times, dtype=dtype, device=device),
                sig,
            )
            self._cache[key] = c
        return c

    # -- params ------------------------------------------------------------

    def init_params(self, generator: torch.Generator, eps=0.1, device=None) -> Params:
        """{"alpha": log eps, "xnet": ..., "vnet": ...}. ``eps`` may be a
        (dim,) vector with ``eps_dim``. With ``eps_mat`` the tree gains a
        ``"w"`` leaf: a scalar eps gives W = eps I and alpha = log eps, a
        (dim, dim) eps gives W = eps and alpha = mean log|diag W| (the
        exp-gates' scale). Runs on ``cuda`` unless ``device`` says
        otherwise."""
        dev = resolve_device(device)
        eps_t = torch.as_tensor(eps, dtype=torch.float32).cpu()
        w = None
        if self.eps_mat:
            if eps_t.ndim == 0:
                w = eps_t * torch.eye(self.dim, dtype=torch.float32)
                alpha = torch.log(eps_t)
            elif tuple(eps_t.shape) == (self.dim, self.dim):
                d = torch.diagonal(eps_t).abs()
                if not bool((d > 0).all()):
                    raise ValueError(
                        "eps_mat init requires a nonzero diagonal (a Cholesky factor "
                        "has a positive diagonal); got zeros at indices "
                        f"{torch.nonzero(d == 0).flatten().tolist()}"
                    )
                w = eps_t.clone()
                alpha = torch.mean(torch.log(d))
            else:
                raise ValueError("eps_mat init requires a scalar or (dim, dim) eps")
        else:
            alpha = torch.log(eps_t)
            if self.eps_dim:
                alpha = torch.broadcast_to(alpha, (self.dim,)).clone()
            elif alpha.ndim != 0:
                raise ValueError("vector eps init requires eps_dim")
        alpha = alpha.to(dev)
        if self.hmc:
            params = {"alpha": alpha, "xnet": (), "vnet": ()}
        else:
            params = {
                "alpha": alpha,
                "xnet": self.xnet.init(generator, dev),
                "vnet": self.vnet.init(generator, dev),
            }
        if w is not None:
            params["w"] = w.to(dev)
        return params

    def eps(self, params: Params) -> torch.Tensor:
        alpha = params["alpha"]
        if not self.eps_trainable:
            alpha = alpha.detach()
        return torch.exp(alpha)

    def w(self, params: Params) -> torch.Tensor:
        """The dense drift preconditioner W (``eps_mat``), under the same
        trainability gate as alpha."""
        if "w" not in params:
            raise ValueError(
                'params missing "w": were they initialized with eps_mat=True? '
                "(checkpoints saved with eps_mat=False cannot drive an eps_mat Dynamics)"
            )
        w = params["w"]
        return w if self.eps_trainable else w.detach()

    # -- energies ----------------------------------------------------------

    def kinetic(self, v: torch.Tensor) -> torch.Tensor:
        return 0.5 * torch.sum(v * v, dim=1)

    def _energy(self, x, aux=None, temperature=1.0) -> torch.Tensor:
        e = self.energy(x, aux=aux) if aux is not None else self.energy(x)
        return e / temperature if self.use_temperature else e

    def _grad(self, x, aux=None, temperature=1.0) -> torch.Tensor:
        g = self.grad_energy(x, aux=aux) if aux is not None else self.grad_energy(x)
        if not self.use_temperature:
            return g
        if torch.is_tensor(temperature) and temperature.dim() == 1:  # one a chain
            temperature = temperature[:, None]
        return g / temperature

    def hamiltonian(self, x, v, aux=None, temperature=1.0) -> torch.Tensor:
        return self._energy(x, aux, temperature) + self.kinetic(v)

    def _apply_nets(self, params: Params, net: str, inputs, sig) -> tuple:
        """VNet/XNet apply; zeros in HMC mode. With ``input_scale`` vnet sees
        [x / sigma, grad * sigma] and xnet [v, masked x / sigma]; then
        ``net_input_fn`` maps the inputs."""
        if self.hmc:
            z = torch.zeros_like(inputs[0])
            return z, z, z
        if sig is not None:
            if net == "vnet":
                inputs = [inputs[0] / sig, inputs[1] * sig, *inputs[2:]]
            else:
                inputs = [inputs[0], inputs[1] / sig, *inputs[2:]]
        if self.net_input_fn is not None:
            inputs = self.net_input_fn(net, inputs)
        mod = self.vnet if net == "vnet" else self.xnet
        s, t, q = mod.apply(params[net], inputs)
        return s, t, q

    # -- single leapfrog substeps -----------------------------------------

    def _drifts(self, params, eps):
        """(drift_v, drift_x): how a translation term enters the update, eps
        times it, or with ``eps_mat`` W on v-drifts and W.T on x-drifts."""
        if self.eps_mat:
            w = self.w(params)
            return (lambda a: a @ w), (lambda a: a @ w.T)
        return (lambda a: eps * a), (lambda a: eps * a)

    def forward_step(self, params, x, v, step_idx: int, *, aux=None, temperature=1.0):
        """One augmented leapfrog step; returns (x_out, v_out, logdet)."""
        eps = self.eps(params)
        drift_v, drift_x = self._drifts(params, eps)
        masks, times, sig = self.consts(x.device, x.dtype)
        t = times[step_idx].expand(x.shape[0], 2)
        m = masks[step_idx]
        mb = 1.0 - m

        grad1 = self._grad(x, aux, temperature)
        s, tt, q = self._apply_nets(params, "vnet", [x, grad1, t, aux], sig)
        sv1 = 0.5 * eps * s
        fv1 = eps * q
        v_h = v * torch.exp(sv1) + 0.5 * drift_v(-torch.exp(fv1) * grad1 + tt)

        s, tt, q = self._apply_nets(params, "xnet", [v_h, m * x, t, aux], sig)
        sx1 = eps * s
        fx1 = eps * q
        y = m * x + mb * (x * torch.exp(sx1) + drift_x(torch.exp(fx1) * v_h + tt))

        s, tt, q = self._apply_nets(params, "xnet", [v_h, mb * y, t, aux], sig)
        sx2 = eps * s
        fx2 = eps * q
        x_o = mb * y + m * (y * torch.exp(sx2) + drift_x(torch.exp(fx2) * v_h + tt))

        grad2 = self._grad(x_o, aux, temperature)
        s, tt, q = self._apply_nets(params, "vnet", [x_o, grad2, t, aux], sig)
        sv2 = 0.5 * eps * s
        fv2 = eps * q
        v_o = v_h * torch.exp(sv2) + 0.5 * drift_v(-torch.exp(fv2) * grad2 + tt)

        logdet = torch.sum(sv1 + sv2 + mb * sx1 + m * sx2, dim=1)
        return x_o, v_o, logdet

    def backward_step(self, params, x_o, v_o, step_idx: int, *, aux=None, temperature=1.0):
        """Exact inverse of :meth:`forward_step`."""
        eps = self.eps(params)
        drift_v, drift_x = self._drifts(params, eps)
        masks, times, sig = self.consts(x_o.device, x_o.dtype)
        t = times[step_idx].expand(x_o.shape[0], 2)
        m = masks[step_idx]
        mb = 1.0 - m

        grad1 = self._grad(x_o, aux, temperature)
        s, tt, q = self._apply_nets(params, "vnet", [x_o, grad1, t, aux], sig)
        sv2 = -0.5 * eps * s
        fv2 = eps * q
        v_h = (v_o - 0.5 * drift_v(-torch.exp(fv2) * grad1 + tt)) * torch.exp(sv2)

        s, tt, q = self._apply_nets(params, "xnet", [v_h, mb * x_o, t, aux], sig)
        sx2 = -eps * s
        fx2 = eps * q
        y = mb * x_o + m * torch.exp(sx2) * (x_o - drift_x(torch.exp(fx2) * v_h + tt))

        s, tt, q = self._apply_nets(params, "xnet", [v_h, m * y, t, aux], sig)
        sx1 = -eps * s
        fx1 = eps * q
        x = m * y + mb * torch.exp(sx1) * (y - drift_x(torch.exp(fx1) * v_h + tt))

        grad2 = self._grad(x, aux, temperature)
        s, tt, q = self._apply_nets(params, "vnet", [x, grad2, t, aux], sig)
        sv1 = -0.5 * eps * s
        fv1 = eps * q
        v = torch.exp(sv1) * (v_h - 0.5 * drift_v(-torch.exp(fv1) * grad2 + tt))

        logdet = torch.sum(sv1 + sv2 + mb * sx1 + m * sx2, dim=1)
        return x, v, logdet

    # -- full trajectories -------------------------------------------------

    def forward(self, params, x, v, *, aux=None, temperature=1.0):
        """T forward steps; returns (X, V, logdet)."""
        logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for step in range(self.T):
            x, v, ld = self.forward_step(params, x, v, step, aux=aux, temperature=temperature)
            logdet = logdet + ld
        return x, v, logdet

    def backward(self, params, x, v, *, aux=None, temperature=1.0):
        """T inverse steps applied in reverse order."""
        logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for step in range(self.T - 1, -1, -1):
            x, v, ld = self.backward_step(params, x, v, step, aux=aux, temperature=temperature)
            logdet = logdet + ld
        return x, v, logdet

    def p_accept(self, params, x0, v0, x1, v1, log_jac, *, aux=None,
                 temperature=1.0) -> torch.Tensor:
        """MH acceptance prob exp(min(H0 - H1 + logJ, 0)), NaN-guarded to 0."""
        e_old = self.hamiltonian(x0, v0, aux, temperature)
        e_new = self.hamiltonian(x1, v1, aux, temperature)
        p = torch.exp(torch.clamp(e_old - e_new + log_jac, max=0.0))
        return torch.where(torch.isfinite(p), p, torch.zeros_like(p))
