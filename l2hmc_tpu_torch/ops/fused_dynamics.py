"""Fused L2HMC trajectory and whole-chain sampler: CUDA kernels for Hopper
(counterpart of ``l2hmc_tpu/ops/fused_dynamics.py``; its VAE half is in
``ops/fused_vae.py``).

Three kernels, all in ``csrc/`` (see the notes at the top of each source):
  - ``trajectory`` (``csrc/trajectory.cu``) replaces the Pallas
    ``_make_kernel`` / ``FusedDynamics``: one T-step trajectory, forward or
    reverse. Public class ``FusedDynamics``.
  - ``trajectory_bwd`` (``csrc/trajectory_bwd.cu``) replaces
    ``_make_bwd_kernel``: the trajectory's vector-Jacobian product, with the
    weight and eps cotangents summed over chains. Public class
    ``DifferentiableFusedDynamics``, the training path, whose
    ``torch.autograd.Function`` launches ``trajectory`` forward and
    ``trajectory_bwd`` backward.
  - ``chain`` (``csrc/chain.cu``) replaces ``_make_chain_kernel`` /
    ``FusedChainSampler``: K whole MH steps per launch, optionally with the
    (K, N, D) trace. Public class ``FusedChainSampler``.

Beside each kernel is its plain PyTorch version (``trajectory_plain``,
``trajectory_vjp_plain``, ``chain_plain``) on the same host-prepared arrays.
A wrapper takes the plain version only for a CPU tensor; for a CUDA tensor
it launches the kernel or raises. Each launch adds one to
``LAUNCHES[name]``.

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
LAUNCHES = {"trajectory": 0, "trajectory_bwd": 0, "chain": 0, "vae_chain": 0, "vae_ais": 0}

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

    @staticmethod
    def build_grad_vjp(vals):
        """VJP of ``grad_energy``: (x, d) -> P^T d, the cotangent of x."""
        prec, _ = vals

        def grad_vjp(x, d):
            return prec.T @ d

        return grad_vjp


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
    grad_vjp: Optional[Callable]  # (x, d) -> the cotangent of x through grad_energy
    emb: Optional[torch.Tensor] = None  # (H, N) aux embedding added to the nets' hidden layer

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


def prepare(dyn: Dynamics, spec, params, device, *, differentiable: bool = False) -> KernelInputs:
    """Host prep shared by the kernels and their plain versions. The weights
    and eps are detached unless ``differentiable``, where they keep their
    autograd history back to ``params`` (through ``_extract_net``'s folds
    and ``eps = exp(alpha)``) for the training path."""
    device = torch.device(device)
    xnet_w, vnet_w = _kernel_nets(dyn, params, device)
    eps = _eps_col(dyn.eps(params), dyn.dim).to(device)
    if not differentiable:
        eps = eps.detach()
        xnet_w = [w.detach() for w in xnet_w]
        vnet_w = [w.detach() for w in vnet_w]
    consts = spec.consts(device)
    energy, grad_energy = spec.build(consts)
    return KernelInputs(
        eps=eps,
        masks=torch.as_tensor(dyn.masks.T.copy(), dtype=torch.float32, device=device),
        consts=consts,
        xnet_w=xnet_w,
        vnet_w=vnet_w,
        hmc=dyn.hmc,
        energy=energy,
        grad_energy=grad_energy,
        grad_vjp=spec.build_grad_vjp(consts),
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


def _apply_stq(w: list, a, b, step: int, hmc: bool, emb=None):
    """S/T/Q net on transposed activations: a, b are (D, N). ``emb`` is the
    optional per-chain aux embedding (H, N), the VAE sampler's fourth Zip
    input, added to the hidden pre-activation."""
    if hmc:
        z = torch.zeros_like(a)
        return z, z, z
    w1, w2, wh, bh, ws, bs, ls, wt, bt, wq, bq, lq, te = w
    h = w1.T @ a + w2.T @ b + te[:, step : step + 1]
    if emb is not None:
        h = h + emb
    h = torch.relu(h)
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
        return _apply_stq(w, a, b, step, hmc, inp.emb)

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


def _stq_vjp(w: list, a, b, step: int, ds, dt, dq, gw: list):
    """VJP of ``_apply_stq`` at inputs (a, b) for output cotangents
    (ds, dt, dq): adds the 13 weight cotangents (summed over chains) into
    ``gw`` and returns (da, db). Recomputes the net's activations;
    relu'(0) = 0."""
    w1, w2, wh, bh, ws, bs, ls, wt, bt, wq, bq, lq, te = w
    z1 = w1.T @ a + w2.T @ b + te[:, step : step + 1]
    h = torch.relu(z1)
    z2 = wh.T @ h + bh
    h2 = torch.relu(z2)
    ts = torch.tanh(ws.T @ h2 + bs)
    tq = torch.tanh(wq.T @ h2 + bq)
    ds_ = ds * torch.exp(ls)
    dq_ = dq * torch.exp(lq)
    dus = ds_ * (1.0 - ts * ts)
    duq = dq_ * (1.0 - tq * tq)
    dz2 = (ws @ dus + wt @ dt + wq @ duq) * (z2 > 0)
    dz1 = (wh @ dz2) * (z1 > 0)
    for i, g in enumerate((
        a @ dz1.T, b @ dz1.T,
        h @ dz2.T, dz2.sum(1, keepdim=True),
        h2 @ dus.T, dus.sum(1, keepdim=True), (ds_ * ts).sum(1, keepdim=True),
        h2 @ dt.T, dt.sum(1, keepdim=True),
        h2 @ duq.T, duq.sum(1, keepdim=True), (dq_ * tq).sum(1, keepdim=True),
    )):
        gw[i] += g
    gw[12][:, step] += dz1.sum(1)
    return w1 @ dz1, w2 @ dz1


def _step_vjp(inp: KernelInputs, reverse: bool, step: int, x, v, dxo, dvo, dld, gx, gv):
    """VJP of ``_trajectory_step`` at (x, v) for the cotangents (dxo, dvo,
    dld) of (x', v', logdet increment), derived by hand: a recompute of the
    substep, then its four S/T/Q applications and two energy gradients in
    reverse order. Adds the nets' weight cotangents into ``gx`` (xnet) and
    ``gv`` (vnet); returns (dx, dv, deps (D, N) per chain)."""
    m = inp.masks[:, step : step + 1]
    mb = 1.0 - m
    e, ge, gvjp, hmc = inp.eps, inp.grad_energy, inp.grad_vjp, inp.hmc

    def stq(w, a, b):
        return _apply_stq(w, a, b, step, hmc)

    def stq_vjp(w, a, b, ds, dt, dq, gw):
        if hmc:
            return 0.0, 0.0
        return _stq_vjp(w, a, b, step, ds, dt, dq, gw)

    half = 0.5 * e
    if not reverse:
        g1 = ge(x)
        s1, t1, q1 = stq(inp.vnet_w, x, g1)
        E1, Q1 = torch.exp(half * s1), torch.exp(e * q1)
        vh = v * E1 + half * (-Q1 * g1 + t1)
        in2 = m * x
        s2, t2, q2 = stq(inp.xnet_w, vh, in2)
        E2, Q2 = torch.exp(e * s2), torch.exp(e * q2)
        y = m * x + mb * (x * E2 + e * (Q2 * vh + t2))
        in3 = mb * y
        s3, t3, q3 = stq(inp.xnet_w, vh, in3)
        E3, Q3 = torch.exp(e * s3), torch.exp(e * q3)
        xo = mb * y + m * (y * E3 + e * (Q3 * vh + t3))
        g2 = ge(xo)
        s4, t4, q4 = stq(inp.vnet_w, xo, g2)
        E4, Q4 = torch.exp(half * s4), torch.exp(e * q4)

        # v' = vh E4 + e/2 (-Q4 g2 + t4)
        dvh = dvo * E4
        dsv = dvo * vh * E4 + dld
        dQ = -dvo * half * g2
        de = 0.5 * dvo * (-Q4 * g2 + t4) + dQ * Q4 * q4 + 0.5 * dsv * s4
        da, db = stq_vjp(inp.vnet_w, xo, g2, dsv * half, dvo * half, dQ * Q4 * e, gv)
        dxo = dxo + da + gvjp(xo, -dvo * half * Q4 + db)
        # x' = mb y + m (y E3 + e (Q3 vh + t3))
        dy = dxo * (mb + m * E3)
        dsx = dxo * m * y * E3 + dld * m
        dt = dxo * m * e
        dQ = dt * vh
        dvh = dvh + dt * Q3
        de = de + dxo * m * (Q3 * vh + t3) + dQ * Q3 * q3 + dsx * s3
        da, db = stq_vjp(inp.xnet_w, vh, in3, dsx * e, dt, dQ * Q3 * e, gx)
        dvh = dvh + da
        dy = dy + db * mb
        # y = m x + mb (x E2 + e (Q2 vh + t2))
        dx = dy * (m + mb * E2)
        dsx = dy * mb * x * E2 + dld * mb
        dt = dy * mb * e
        dQ = dt * vh
        dvh = dvh + dt * Q2
        de = de + dy * mb * (Q2 * vh + t2) + dQ * Q2 * q2 + dsx * s2
        da, db = stq_vjp(inp.xnet_w, vh, in2, dsx * e, dt, dQ * Q2 * e, gx)
        dvh = dvh + da
        dx = dx + db * m
        # vh = v E1 + e/2 (-Q1 g1 + t1)
        dv = dvh * E1
        dsv = dvh * v * E1 + dld
        dQ = -dvh * half * g1
        de = de + 0.5 * dvh * (-Q1 * g1 + t1) + dQ * Q1 * q1 + 0.5 * dsv * s1
        da, db = stq_vjp(inp.vnet_w, x, g1, dsv * half, dvh * half, dQ * Q1 * e, gv)
        dx = dx + da + gvjp(x, -dvh * half * Q1 + db)
    else:
        g1 = ge(x)
        s1, t1, q1 = stq(inp.vnet_w, x, g1)
        E1, Q1 = torch.exp(-half * s1), torch.exp(e * q1)
        A1 = v - half * (-Q1 * g1 + t1)
        vh = A1 * E1
        in2 = mb * x
        s2, t2, q2 = stq(inp.xnet_w, vh, in2)
        E2, Q2 = torch.exp(-e * s2), torch.exp(e * q2)
        B2 = x - e * (Q2 * vh + t2)
        y = mb * x + m * E2 * B2
        in3 = m * y
        s3, t3, q3 = stq(inp.xnet_w, vh, in3)
        E3, Q3 = torch.exp(-e * s3), torch.exp(e * q3)
        B3 = y - e * (Q3 * vh + t3)
        xo = m * y + mb * E3 * B3
        g2 = ge(xo)
        s4, t4, q4 = stq(inp.vnet_w, xo, g2)
        E4, Q4 = torch.exp(-half * s4), torch.exp(e * q4)
        A4 = vh - half * (-Q4 * g2 + t4)

        # v' = E4 (vh - e/2 (-Q4 g2 + t4))
        dvh = dvo * E4
        dsv = dvo * A4 * E4 + dld
        dQ = dvh * half * g2
        de = 0.5 * dvh * (Q4 * g2 - t4) + dQ * Q4 * q4 - 0.5 * dsv * s4
        da, db = stq_vjp(inp.vnet_w, xo, g2, -half * dsv, -dvh * half, dQ * Q4 * e, gv)
        dxo = dxo + da + gvjp(xo, dvh * half * Q4 + db)
        # x' = m y + mb E3 (y - e (Q3 vh + t3))
        dB = dxo * mb * E3
        dy = dxo * m + dB
        dsx = dB * B3 + dld * mb
        dt = -dB * e
        dQ = dt * vh
        dvh = dvh + dt * Q3
        de = de - dB * (Q3 * vh + t3) + dQ * Q3 * q3 - dsx * s3
        da, db = stq_vjp(inp.xnet_w, vh, in3, -e * dsx, dt, dQ * Q3 * e, gx)
        dvh = dvh + da
        dy = dy + db * m
        # y = mb x + m E2 (x - e (Q2 vh + t2))
        dB = dy * m * E2
        dx = dy * mb + dB
        dsx = dB * B2 + dld * m
        dt = -dB * e
        dQ = dt * vh
        dvh = dvh + dt * Q2
        de = de - dB * (Q2 * vh + t2) + dQ * Q2 * q2 - dsx * s2
        da, db = stq_vjp(inp.xnet_w, vh, in2, -e * dsx, dt, dQ * Q2 * e, gx)
        dvh = dvh + da
        dx = dx + db * mb
        # vh = (v - e/2 (-Q1 g1 + t1)) E1
        dv = dvh * E1
        dsv = dvh * A1 * E1 + dld
        dQ = dv * half * g1
        de = de + 0.5 * dv * (Q1 * g1 - t1) + dQ * Q1 * q1 - 0.5 * dsv * s1
        da, db = stq_vjp(inp.vnet_w, x, g1, -half * dsv, -dv * half, dQ * Q1 * e, gv)
        dx = dx + da + gvjp(x, dv * half * Q1 + db)
    return dx, dv, de


def trajectory_vjp_plain(inp: KernelInputs, x, v, dX, dV, dld, reverse: bool):
    """Plain version of the backward kernel: the VJP of ``trajectory_plain``
    at (x, v) for the cotangents dX, dV (D, N) and dld (1, N). A recompute
    forward stores the per-step boundary (x, v); a reverse sweep applies
    ``_step_vjp`` step by step. Returns (xnet grads (13), vnet grads (13),
    deps (D, 1), dx (D, N), dv (D, N)), the weight and eps cotangents summed
    over chains (zeros for the nets in HMC mode)."""
    T = inp.dims[3]
    steps = list(range(T - 1, -1, -1) if reverse else range(T))
    xs, vs = [x], [v]
    for step in steps:
        x, v, _ = _trajectory_step(inp, reverse, step, x, v)
        xs.append(x)
        vs.append(v)
    gx = [torch.zeros_like(w) for w in inp.xnet_w]
    gv = [torch.zeros_like(w) for w in inp.vnet_w]
    de = torch.zeros_like(dX)
    dx, dv = dX, dV
    for i in range(T - 1, -1, -1):
        dx, dv, de_i = _step_vjp(inp, reverse, steps[i], xs[i], vs[i], dx, dv, dld, gx, gv)
        de = de + de_i
    return gx, gv, de.sum(1, keepdim=True), dx, dv


def mh_op(inp: KernelInputs, x, v, u_dir, u_acc):
    """One direction-randomised MH op on (D, N) state with the draws given:
    both directions run and the chosen one is selected, as on the TPU; the
    accept is a select. Returns (x (D, N), accepted (1, N) bool)."""
    def kinetic(v):
        return 0.5 * torch.sum(v * v, dim=0, keepdim=True)

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
    return torch.where(acc, xp, x), acc


def chain_plain(
    inp: KernelInputs, x, seed: int, n_mh_steps: int,
    collect_trace: bool = False, draws: Optional[Callable] = None,
):
    """Plain version of the chain kernel on (D, N) state. ``draws(step)``
    gives (v (D, N), direction uniforms (N,), accept uniforms (N,)); by
    default the kernel's own Philox draws.
    Returns (x (D, N), acceptance (1, N), trace (K, D, N) or None)."""
    D, N = x.shape
    if draws is None:
        def draws(step):
            return chain_draws(seed, N, D, step, x.device)

    accepted = torch.zeros_like(x[:1])
    trace = (
        torch.empty((n_mh_steps, D, N), dtype=x.dtype, device=x.device)
        if collect_trace else None
    )
    for k in range(n_mh_steps):
        x, acc = mh_op(inp, x, *draws(k))
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


def trajectory_vjp(inp: KernelInputs, x, v, dX, dV, dld, reverse: bool):
    """VJP of the fused trajectory at (D, N) float32 (x, v) for the
    cotangents dX, dV (D, N) and dld (1, N); returns what
    ``trajectory_vjp_plain`` returns. CPU tensors take the plain version;
    CUDA tensors launch ``csrc/trajectory_bwd.cu`` (a per-chain sweep into a
    (P, N) scratch, then a fixed-order sum over chains)."""
    _check_state(inp, x, v, dX, dV)
    N = x.shape[1]
    if dld.shape != (1, N) or dld.dtype != torch.float32 or not dld.is_contiguous() \
            or dld.device != x.device:
        raise ValueError(f"dld must be a contiguous float32 (1, {N}) tensor on {x.device}")
    if x.device.type == "cpu":
        return trajectory_vjp_plain(inp, x, v, dX, dV, dld, reverse)
    block = _kernel_block(inp, x)
    D, H, H2, T = inp.dims
    weights = [*inp.xnet_w, *inp.vnet_w]
    n_grads = sum(w.numel() for w in weights) + D
    grads = torch.empty(n_grads, dtype=torch.float32, device=x.device)
    scratch = torch.empty(n_grads * N + 2 * (T + 1) * D * N, dtype=torch.float32,
                          device=x.device)
    dx, dv = torch.empty_like(x), torch.empty_like(v)
    lib = _cuda.library("trajectory_bwd")
    with torch.cuda.device(x.device):
        err = lib.l2hmc_trajectory_bwd(
            block.data_ptr(), D, H, H2, T, int(reverse), int(inp.hmc),
            x.data_ptr(), v.data_ptr(), dX.data_ptr(), dV.data_ptr(), dld.data_ptr(),
            dx.data_ptr(), dv.data_ptr(), grads.data_ptr(), scratch.data_ptr(), N,
            torch.cuda.current_stream().cuda_stream,
        )
    _cuda.check(err, "trajectory_bwd")
    LAUNCHES["trajectory_bwd"] += 1
    parts = torch.split(grads, [w.numel() for w in weights] + [D])
    g = [p.view(w.shape) for p, w in zip(parts, weights)]
    return g[:_NET_ARRAYS], g[_NET_ARRAYS:], parts[-1].view(D, 1), dx, dv


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


def _no_aux(aux) -> None:
    """The spec'd targets' energies take no ``aux``; ``mcmc.propose`` passes
    its own (None for them) to whatever dynamics it is given."""
    if aux is not None:
        raise ValueError("the fused dynamics of a spec'd target take no aux")


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

    def forward(self, params, x, v, aux=None):
        _no_aux(aux)
        return self._run(params, x, v, reverse=False)

    def backward(self, params, x, v, aux=None):
        _no_aux(aux)
        return self._run(params, x, v, reverse=True)

    def p_accept(self, params, x0, v0, x1, v1, log_jac, aux=None):
        _no_aux(aux)
        return self.dynamics.p_accept(params, x0, v0, x1, v1, log_jac)


def fused_for_target(dynamics: Dynamics, target) -> FusedDynamics:
    """The fused-trajectory path for a spec-supported target (HMC mode runs
    as exact leapfrog with the nets skipped)."""
    _check_supported(dynamics)
    return FusedDynamics(dynamics, energy_spec_for_target(target))


class _Trajectory(torch.autograd.Function):
    """The fused trajectory as one autograd node whose boundary is the
    kernels': eps (D, 1), x, v (D, N) and the 13 + 13 net weights. Forward
    runs ``trajectory``, backward ``trajectory_vjp``."""

    @staticmethod
    def forward(ctx, inp: KernelInputs, reverse: bool, eps, x, v, *weights):
        ctx.inp = dataclasses.replace(inp, eps=None, xnet_w=[], vnet_w=[])
        ctx.reverse = reverse
        ctx.save_for_backward(eps, x, v, *weights)
        return trajectory(_with_tensors(inp, eps, weights), x, v, reverse)

    @staticmethod
    def backward(ctx, dX, dV, dld):
        eps, x, v, *weights = ctx.saved_tensors
        inp = _with_tensors(ctx.inp, eps, weights)
        gx, gv, deps, dx, dv = trajectory_vjp(
            inp, x, v, dX.contiguous(), dV.contiguous(), dld.contiguous(), ctx.reverse
        )
        gw = [None] * len(weights) if inp.hmc else [*gx, *gv]
        return (None, None, deps, dx, dv, *gw)


def _with_tensors(inp: KernelInputs, eps, weights) -> KernelInputs:
    return dataclasses.replace(
        inp, eps=eps, xnet_w=list(weights[:_NET_ARRAYS]), vnet_w=list(weights[_NET_ARRAYS:])
    )


@dataclasses.dataclass(frozen=True)
class DifferentiableFusedDynamics:
    """Training-path stand-in for ``Dynamics``: fused trajectories whose
    backward is the fused recompute-and-reverse kernel. It has the surface
    ``mcmc.propose`` reads (``forward``, ``backward``, ``p_accept``,
    ``eps``, ``hmc``), on (N, D) state. The autograd boundary sits at the
    kernels' inputs; gradients reach the params tree through
    ``_extract_net``'s folds and ``eps = exp(alpha)`` by ordinary autograd.
    HMC mode runs with zero nets, so only alpha, x and v get gradients."""

    fused: FusedDynamics

    def __post_init__(self):
        if self.fused.dynamics.use_temperature:
            raise ValueError("DifferentiableFusedDynamics does not support temperature")

    @property
    def dynamics(self) -> Dynamics:
        return self.fused.dynamics

    @property
    def hmc(self) -> bool:
        return self.fused.dynamics.hmc

    def eps(self, params):
        return self.dynamics.eps(params)

    def p_accept(self, params, x0, v0, x1, v1, log_jac, aux=None):
        _no_aux(aux)
        return self.dynamics.p_accept(params, x0, v0, x1, v1, log_jac)

    def forward(self, params, x, v, aux=None):
        _no_aux(aux)
        return self._run(params, x, v, reverse=False)

    def backward(self, params, x, v, aux=None):
        _no_aux(aux)
        return self._run(params, x, v, reverse=True)

    def _run(self, params, x, v, reverse: bool):
        inp = prepare(self.dynamics, self.fused.spec, params, x.device, differentiable=True)
        X, V, ld = _Trajectory.apply(
            inp, reverse, inp.eps, x.T.contiguous(), v.T.contiguous(),
            *inp.xnet_w, *inp.vnet_w,
        )
        return X.T, V.T, ld[0]


def differentiable_fused(dynamics: Dynamics, target) -> DifferentiableFusedDynamics:
    """The training-path fused dynamics for a spec-supported target."""
    return DifferentiableFusedDynamics(fused_for_target(dynamics, target))


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
