"""Fused L2HMC trajectory and whole-chain sampler: CUDA kernels for Hopper
(counterpart of ``l2hmc_tpu/ops/fused_dynamics.py``).

Two kernels, both in ``csrc/`` (see the notes at the top of each source):
  - ``trajectory`` (``csrc/trajectory.cu``) replaces the Pallas
    ``_make_kernel`` / ``FusedDynamics``: one T-step trajectory, forward or
    reverse. Public class ``FusedDynamics``.
  - ``chain`` (``csrc/chain.cu``) replaces ``_make_chain_kernel`` /
    ``FusedChainSampler``: K whole MH steps per launch, optionally with the
    (K, N, D) trace. Public class ``FusedChainSampler``.

Beside each kernel is its plain PyTorch version (``trajectory_plain``,
``chain_plain``) on the same host-prepared arrays. A wrapper takes the plain
version only for a CPU tensor; for a CUDA tensor it launches the kernel or
raises. Each launch adds one to ``LAUNCHES[name]``.

Host prep mirrors the JAX package: ``_extract_net`` flattens a ``stq_net``
params tree into 13 arrays and folds the time embedding into an (H, T)
table, ``_net_scales`` folds ``input_scale`` into the embed weights, HMC
runs with zero nets (and the kernels skip them), ``_eps_col`` makes eps a
(D, 1) column. Kernel layout is transposed: state (D, N), chains along the
fast axis. Only the Gaussian energy spec is ported; other targets raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from l2hmc_tpu_torch.dynamics.core import Dynamics
from l2hmc_tpu_torch.ops import _cuda
from l2hmc_tpu_torch.ops.philox import chain_draws

# weight bundle order produced by _extract_net (one per net):
#   w1 (D,H) w2 (D,H) | wh (H,H2) bh (H2,1) | ws (H2,D) bs (D,1) ls (D,1)
#   wt (H2,D) bt (D,1) | wq (H2,D) bq (D,1) lq (D,1) | te (H,T)
_NET_ARRAYS = 13

# kernel launches per kernel since the last reset_launch_counts()
LAUNCHES = {"trajectory": 0, "chain": 0}

# compile-time caps of the kernels' instantiations (csrc/l2hmc_common.cuh)
_MAX_DIM, _MAX_HIDDEN = 64, 64
_MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _net_scales(dynamics: Dynamics):
    """Per-net embed-weight folds implementing ``Dynamics.input_scale``:
    ((xnet_s0, xnet_s1), (vnet_s0, vnet_s1)); None means unscaled."""
    sig = dynamics.input_scale
    if sig is None:
        return (None, None), (None, None)
    s = np.asarray(sig, np.float32)
    return (None, 1.0 / s), (1.0 / s, s)


def _hmc_zero_net(dim: int, T: int, device, h: int = 8) -> list[torch.Tensor]:
    """Zero-weight stand-in for the 13-array net list: S = T = Q = 0, so the
    augmented trajectory is exactly the plain leapfrog."""
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return [
        z(dim, h), z(dim, h),
        z(h, h), z(h, 1),
        z(h, dim), z(dim, 1), z(dim, 1),
        z(h, dim), z(dim, 1),
        z(h, dim), z(dim, 1), z(dim, 1),
        z(h, T),
    ]


def _extract_net(net_params: Any, trig: np.ndarray, scales=(None, None)) -> list[torch.Tensor]:
    """Flatten a ``stq_net`` params tree into the kernels' weight list,
    folding the time path into te = W3^T trig^T + (b1 + b2 + b3) and
    ``scales`` into the two embed weights."""
    zip_p = net_params[0]
    lin_h = net_params[3]
    (s_lin, s_st), t_lin, (q_lin, q_st) = net_params[5]
    e1, e2, e3 = zip_p[0], zip_p[1], zip_p[2]
    dev = e1["w"].device

    def col(b):
        return b.reshape(-1, 1)

    bias = e1["b"] + e2["b"] + e3["b"]
    te = e3["w"].T @ torch.as_tensor(trig.T, dtype=torch.float32, device=dev) + col(bias)
    s0, s1 = scales
    w1 = e1["w"] if s0 is None else e1["w"] * torch.as_tensor(s0, device=dev)[:, None]
    w2 = e2["w"] if s1 is None else e2["w"] * torch.as_tensor(s1, device=dev)[:, None]
    return [
        w1, w2,
        lin_h["w"], col(lin_h["b"]),
        s_lin["w"], col(s_lin["b"]), col(s_st["log_scale"]),
        t_lin["w"], col(t_lin["b"]),
        q_lin["w"], col(q_lin["b"]), col(q_st["log_scale"]),
        te,
    ]


def _kernel_nets(dyn: Dynamics, params, device):
    """(xnet_w, vnet_w): extracted from the params tree, or zero nets in HMC
    mode."""
    if dyn.hmc:
        w = _hmc_zero_net(dyn.dim, dyn.T, device)
        return w, w
    xs, vs = _net_scales(dyn)
    return (
        _extract_net(params["xnet"], dyn.times, xs),
        _extract_net(params["vnet"], dyn.times, vs),
    )


def _eps_col(eps: torch.Tensor, dim: int) -> torch.Tensor:
    """Scalar or (dim,) eps -> a (dim, 1) float32 column."""
    return torch.broadcast_to(eps.to(torch.float32), (dim,)).reshape(dim, 1)


# -- energy specs --------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QuadraticGaussianEnergy:
    """0.5 (x-mu)^T P (x-mu) — the SCG / tilted / ill-conditioned Gaussian."""

    prec: np.ndarray  # (D, D)
    mu: np.ndarray  # (D,)

    def consts(self, device) -> list[torch.Tensor]:
        d = self.mu.shape[0]
        return [
            torch.as_tensor(self.prec, dtype=torch.float32, device=device),
            torch.as_tensor(self.mu, dtype=torch.float32, device=device).reshape(d, 1),
        ]

    @staticmethod
    def build(vals):
        """(energy, grad_energy) on the transposed (D, N) layout."""
        prec, mu = vals

        def grad_energy(x):
            return prec @ (x - mu)

        def energy(x):
            d = x - mu
            return 0.5 * torch.sum(d * (prec @ d), dim=0, keepdim=True)

        return energy, grad_energy


def energy_spec_for_target(target):
    """Map a target to its in-kernel energy spec. Only the Gaussian family is
    ported; any other target raises."""
    prec = getattr(target, "_prec", None)
    mu = getattr(target, "mu", None)
    if prec is not None and mu is not None:
        return QuadraticGaussianEnergy(np.asarray(prec), np.asarray(mu))
    raise NotImplementedError(
        f"no fused energy spec for target {type(target).__name__}: not yet "
        "ported (only the Gaussian family is)"
    )


# -- host-prepared kernel inputs ------------------------------------------------


@dataclasses.dataclass
class KernelInputs:
    """Everything a kernel reads besides the chain state, on one device."""

    eps: torch.Tensor  # (D, 1)
    masks: torch.Tensor  # (D, T)
    consts: list  # energy spec arrays: prec (D, D), mu (D, 1)
    xnet_w: list  # 13 arrays
    vnet_w: list  # 13 arrays
    hmc: bool
    energy: Callable
    grad_energy: Callable

    @property
    def dims(self) -> tuple[int, int, int, int]:
        """(D, H, H2, T)."""
        w1, wh, te = self.xnet_w[0], self.xnet_w[2], self.xnet_w[12]
        return w1.shape[0], w1.shape[1], wh.shape[1], te.shape[1]

    def block(self) -> torch.Tensor:
        """The packed float32 parameter block the CUDA kernels read
        (layout in csrc/l2hmc_common.cuh)."""
        parts = [self.eps, self.masks, *self.consts, *self.xnet_w, *self.vnet_w]
        return torch.cat([p.reshape(-1) for p in parts]).contiguous()


def prepare(dyn: Dynamics, spec, params, device) -> KernelInputs:
    """Host prep shared by both kernels and their plain versions."""
    device = torch.device(device)
    xnet_w, vnet_w = _kernel_nets(dyn, params, device)
    consts = spec.consts(device)
    energy, grad_energy = spec.build(consts)
    return KernelInputs(
        eps=_eps_col(dyn.eps(params).detach(), dyn.dim).to(device),
        masks=torch.as_tensor(dyn.masks.T.copy(), dtype=torch.float32, device=device),
        consts=consts,
        xnet_w=[w.detach() for w in xnet_w],
        vnet_w=[w.detach() for w in vnet_w],
        hmc=dyn.hmc,
        energy=energy,
        grad_energy=grad_energy,
    )


def _kernel_block(inp: KernelInputs, x: torch.Tensor) -> torch.Tensor:
    """The packed parameter block for a kernel launch on ``x``'s device,
    after checking what the kernels take."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {x.device}")
    D, H, H2, T = inp.dims
    if D > _MAX_DIM or H > _MAX_HIDDEN or H2 > _MAX_HIDDEN:
        raise ValueError(
            f"kernel caps exceeded: dim {D}, hidden {H}/{H2} "
            f"(caps {_MAX_DIM}, {_MAX_HIDDEN})"
        )
    block = inp.block()
    if 4 * block.numel() > _MAX_SMEM:
        raise ValueError(f"parameter block of {4 * block.numel()} bytes exceeds shared memory")
    return block


def _check_state(inp: KernelInputs, *states: torch.Tensor) -> None:
    D = inp.dims[0]
    dev = inp.eps.device
    for s in states:
        if s.dtype != torch.float32:
            raise TypeError(f"state must be float32, got {s.dtype}")
        if s.dim() != 2 or s.shape[0] != D or s.shape[1] != states[0].shape[1]:
            raise ValueError(f"state must be (dim={D}, n), got {tuple(s.shape)}")
        if not s.is_contiguous():
            raise ValueError("state must be contiguous")
        if s.device != dev:
            raise ValueError(f"state on {s.device}, kernel inputs on {dev}")


# -- plain versions ------------------------------------------------------------


def _apply_stq(w: list, a, b, step: int, hmc: bool):
    """S/T/Q net on transposed activations: a, b are (D, N)."""
    if hmc:
        z = torch.zeros_like(a)
        return z, z, z
    w1, w2, wh, bh, ws, bs, ls, wt, bt, wq, bq, lq, te = w
    h = torch.relu(w1.T @ a + w2.T @ b + te[:, step : step + 1])
    h2 = torch.relu(wh.T @ h + bh)
    s = torch.exp(ls) * torch.tanh(ws.T @ h2 + bs)
    t = wt.T @ h2 + bt
    q = torch.exp(lq) * torch.tanh(wq.T @ h2 + bq)
    return s, t, q


def _trajectory_step(inp: KernelInputs, reverse: bool, step: int, x, v):
    """One substep on (D, N) state; returns (x, v, logdet increment (1, N))."""
    m = inp.masks[:, step : step + 1]
    mb = 1.0 - m
    eps, grad_energy, hmc = inp.eps, inp.grad_energy, inp.hmc

    def stq(w, a, b):
        return _apply_stq(w, a, b, step, hmc)

    if not reverse:
        grad1 = grad_energy(x)
        s, t, q = stq(inp.vnet_w, x, grad1)
        sv1 = 0.5 * eps * s
        v_h = v * torch.exp(sv1) + 0.5 * eps * (-torch.exp(eps * q) * grad1 + t)
        s, t, q = stq(inp.xnet_w, v_h, m * x)
        sx1 = eps * s
        y = m * x + mb * (x * torch.exp(sx1) + eps * (torch.exp(eps * q) * v_h + t))
        s, t, q = stq(inp.xnet_w, v_h, mb * y)
        sx2 = eps * s
        x = mb * y + m * (y * torch.exp(sx2) + eps * (torch.exp(eps * q) * v_h + t))
        grad2 = grad_energy(x)
        s, t, q = stq(inp.vnet_w, x, grad2)
        sv2 = 0.5 * eps * s
        v = v_h * torch.exp(sv2) + 0.5 * eps * (-torch.exp(eps * q) * grad2 + t)
    else:
        grad1 = grad_energy(x)
        s, t, q = stq(inp.vnet_w, x, grad1)
        sv2 = -0.5 * eps * s
        v_h = (v - 0.5 * eps * (-torch.exp(eps * q) * grad1 + t)) * torch.exp(sv2)
        s, t, q = stq(inp.xnet_w, v_h, mb * x)
        sx2 = -eps * s
        y = mb * x + m * torch.exp(sx2) * (x - eps * (torch.exp(eps * q) * v_h + t))
        s, t, q = stq(inp.xnet_w, v_h, m * y)
        sx1 = -eps * s
        x = m * y + mb * torch.exp(sx1) * (y - eps * (torch.exp(eps * q) * v_h + t))
        grad2 = grad_energy(x)
        s, t, q = stq(inp.vnet_w, x, grad2)
        sv1 = -0.5 * eps * s
        v = torch.exp(sv1) * (v_h - 0.5 * eps * (-torch.exp(eps * q) * grad2 + t))

    ld_inc = torch.sum(sv1 + sv2 + mb * sx1 + m * sx2, dim=0, keepdim=True)
    return x, v, ld_inc


def trajectory_plain(inp: KernelInputs, x, v, reverse: bool):
    """Plain version of the trajectory kernel: (D, N) x, v ->
    (X, V, logdet (1, N))."""
    T = inp.dims[3]
    ld = torch.zeros_like(x[:1])
    for step in (range(T - 1, -1, -1) if reverse else range(T)):
        x, v, inc = _trajectory_step(inp, reverse, step, x, v)
        ld = ld + inc
    return x, v, ld


def chain_plain(
    inp: KernelInputs, x, seed: int, n_mh_steps: int,
    collect_trace: bool = False, draws: Optional[Callable] = None,
):
    """Plain version of the chain kernel on (D, N) state. ``draws(step)``
    gives (v (D, N), direction uniforms (N,), accept uniforms (N,)); by
    default the kernel's own Philox draws. Both directions run and the
    chosen one is selected, as on the TPU; the accept is a select.
    Returns (x (D, N), acceptance (1, N), trace (K, D, N) or None)."""
    D, N = x.shape
    if draws is None:
        def draws(step):
            return chain_draws(seed, N, D, step, x.device)

    def kinetic(v):
        return 0.5 * torch.sum(v * v, dim=0, keepdim=True)

    accepted = torch.zeros_like(x[:1])
    trace = (
        torch.empty((n_mh_steps, D, N), dtype=x.dtype, device=x.device)
        if collect_trace else None
    )
    for k in range(n_mh_steps):
        v, u_dir, u_acc = draws(k)
        xf, vf, ldf = trajectory_plain(inp, x, v, reverse=False)
        xb, vb, ldb = trajectory_plain(inp, x, v, reverse=True)
        fwd = (u_dir < 0.5)[None, :]
        xp = torch.where(fwd, xf, xb)
        vp = torch.where(fwd, vf, vb)
        lj = torch.where(fwd, ldf, ldb)
        h0 = inp.energy(x) + kinetic(v)
        h1 = inp.energy(xp) + kinetic(vp)
        px = torch.exp(torch.clamp(h0 - h1 + lj, max=0.0))
        px = torch.where(torch.isfinite(px), px, torch.zeros_like(px))
        acc = px - u_acc[None, :] >= 0.0
        x = torch.where(acc, xp, x)
        accepted = accepted + acc.to(x.dtype)
        if trace is not None:
            trace[k] = x
    return x, accepted * (1.0 / n_mh_steps), trace


# -- wrappers ------------------------------------------------------------------


def trajectory(inp: KernelInputs, x, v, reverse: bool):
    """Fused T-step trajectory on (D, N) float32 state; returns
    (X, V, logdet (1, N)). CPU tensors take the plain version; CUDA tensors
    launch ``csrc/trajectory.cu``."""
    _check_state(inp, x, v)
    if x.device.type == "cpu":
        return trajectory_plain(inp, x, v, reverse)
    block = _kernel_block(inp, x)
    D, H, H2, T = inp.dims
    N = x.shape[1]
    lib = _cuda.library("trajectory")
    xo, vo = torch.empty_like(x), torch.empty_like(v)
    ld = torch.empty((1, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.l2hmc_trajectory(
            block.data_ptr(), D, H, H2, T, int(reverse), int(inp.hmc),
            x.data_ptr(), v.data_ptr(), xo.data_ptr(), vo.data_ptr(),
            ld.data_ptr(), N, torch.cuda.current_stream().cuda_stream,
        )
    _cuda.check(err, "trajectory")
    LAUNCHES["trajectory"] += 1
    return xo, vo, ld


def chain(inp: KernelInputs, x, seed: int, n_mh_steps: int, collect_trace: bool = False):
    """K MH steps on (D, N) float32 state; returns (x (D, N), acceptance
    (1, N), trace (K, D, N) or None). CPU tensors take the plain version;
    CUDA tensors launch ``csrc/chain.cu``."""
    _check_state(inp, x)
    if n_mh_steps <= 0:
        raise ValueError("n_mh_steps must be positive")
    if x.device.type == "cpu":
        return chain_plain(inp, x, seed, n_mh_steps, collect_trace)
    block = _kernel_block(inp, x)
    D, H, H2, T = inp.dims
    N = x.shape[1]
    lib = _cuda.library("chain")
    xo = torch.empty_like(x)
    acc = torch.empty((1, N), dtype=torch.float32, device=x.device)
    trace = (
        torch.empty((n_mh_steps, D, N), dtype=torch.float32, device=x.device)
        if collect_trace else None
    )
    with torch.cuda.device(x.device):
        err = lib.l2hmc_chain(
            block.data_ptr(), D, H, H2, T, int(inp.hmc), x.data_ptr(),
            xo.data_ptr(), acc.data_ptr(),
            trace.data_ptr() if trace is not None else None,
            N, n_mh_steps, int(seed) & 0xFFFFFFFFFFFFFFFF,
            torch.cuda.current_stream().cuda_stream,
        )
    _cuda.check(err, "chain")
    LAUNCHES["chain"] += 1
    return xo, acc, trace


# -- public classes ------------------------------------------------------------


def _check_supported(dynamics: Dynamics) -> None:
    if dynamics.eps_step or dynamics.eps_mat or dynamics.net_input_fn is not None:
        raise ValueError("fused kernels do not support eps_step, eps_mat or net_input_fn")


@dataclasses.dataclass(frozen=True)
class FusedDynamics:
    """Fused-trajectory path for a Dynamics on a spec'd target:
    ``forward(params, x, v)`` / ``backward(params, x, v)`` return
    (X, V, logdet) as ``Dynamics.forward/backward`` do, on (N, D) state."""

    dynamics: Dynamics
    spec: Any

    def _run(self, params, x, v, reverse: bool):
        inp = prepare(self.dynamics, self.spec, params, x.device)
        xo, vo, ld = trajectory(
            inp, x.T.contiguous(), v.T.contiguous(), reverse
        )
        return xo.T, vo.T, ld[0]

    def forward(self, params, x, v):
        return self._run(params, x, v, reverse=False)

    def backward(self, params, x, v):
        return self._run(params, x, v, reverse=True)

    def p_accept(self, params, x0, v0, x1, v1, log_jac):
        return self.dynamics.p_accept(params, x0, v0, x1, v1, log_jac)


def fused_for_target(dynamics: Dynamics, target) -> FusedDynamics:
    """The fused-trajectory path for a spec-supported target (HMC mode runs
    as exact leapfrog with the nets skipped)."""
    _check_supported(dynamics)
    return FusedDynamics(dynamics, energy_spec_for_target(target))


@dataclasses.dataclass(frozen=True)
class FusedChainSampler:
    """K MH steps per kernel launch.

    ``run(params, x, seed, n_mh_steps)`` advances every chain by
    ``n_mh_steps`` direction-randomized proposals and MH accepts; returns
    (x_final (N, D), mean acceptance per chain (N,)) and, with
    ``collect_trace``, the (n_mh_steps, N, D) post-MH history as a third
    output (a transposed view of the kernel's (K, D, N) buffer)."""

    dynamics: Dynamics
    spec: Any

    def run(self, params, x, seed: int, n_mh_steps: int, *, collect_trace: bool = False):
        inp = prepare(self.dynamics, self.spec, params, x.device)
        xo, acc, trace = chain(inp, x.T.contiguous(), seed, n_mh_steps, collect_trace)
        if collect_trace:
            return xo.T, acc[0], trace.permute(0, 2, 1)
        return xo.T, acc[0]


def fused_chain_sampler(dynamics: Dynamics, target) -> FusedChainSampler:
    """Whole-chain fused sampler for a spec-supported target (HMC mode runs
    as exact leapfrog with the nets skipped)."""
    _check_supported(dynamics)
    return FusedChainSampler(dynamics, energy_spec_for_target(target))
