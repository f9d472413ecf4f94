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
``LAUNCHES[name]`` and to ``LAUNCHES[name:spec]`` (the energy spec's
``NAME``), a launch on the site-parallel configuration to
``LAUNCHES[name:sites]``, and a launch of a bfloat16 instantiation to
``LAUNCHES[name:bf16]``.

Operands: float32, or with ``compute_dtype="bfloat16"`` (``prepare``,
``FusedDynamics``, ``FusedChainSampler`` and their factories) bfloat16
operands with float32 sums in the S/T/Q nets' products, as the JAX
package's ``cd`` (``_dot_in``): the kernels' bfloat16 instantiations
(``csrc/trajectory_bf16.cu``, ``csrc/chain_bf16.cu``) read the products'
weights rounded once a launch (``KernelInputs.block``) and round each
activation where a product reads it; the plain versions round through
``ops.operands``. The time embedding ``te`` (folded in float32 outside the
kernel), the biases, log-scales, eps, masks and energies stay float32. The
backward kernel has no bfloat16 form, nor has the JAX package's:
``differentiable_fused(compute_dtype="bfloat16")`` runs the forward in
bfloat16 and its VJP in float32 at the unrounded weights, as JAX's custom
VJP does.

Host prep mirrors the JAX package: ``_extract_net`` flattens a ``stq_net``
params tree into 13 arrays and folds the time embedding into an (H, T)
table, ``_net_scales`` folds ``input_scale`` into the embed weights, HMC
runs with zero nets (and the kernels skip them), ``_eps_col`` makes eps a
(D, 1) column. Kernel layout is transposed: state (D, N), chains along the
fast axis.

The target's energy enters through an energy spec, as in the JAX package:
``QuadraticGaussianEnergy`` (the Gaussian family), ``RoughWellEnergy``,
``GmmEnergy`` (ring, mog2), ``FunnelEnergy`` and ``Phi4Energy`` (the
lattice), picked by ``energy_spec_for_target``. A spec is data: its
constants (arrays and scalars) go into the kernels' parameter block, and its
``KIND`` picks the kernels' instantiation (the structs of
``csrc/l2hmc_common.cuh``). Its ``build`` gives the plain versions' energy
and gradient, its ``build_grad_vjp`` the gradient's hand-derived
vector-Jacobian product.

Widths: up to 64 (states and hidden widths) the kernels run a chain on a
lane group (``csrc/l2hmc_lanes.cuh``); past 64, on the site-parallel
configuration (``csrc/l2hmc_sites.cuh``), a tile of chains a block, for
every spec (the funnel and the mixtures after a per-chain prelude of block
sums, ``site_prelude_floats``): states up to 4096 wide (the 64 x 64 phi^4
lattice) and hidden widths up to 128 (``trajectory_on_sites``,
``trajectory_site_geometry``; ``site_geometry``).
The chain kernel runs the phi^4 lattice there at every width
(``chain_on_sites``). ``kernel_refusal`` and the wrappers name the kernel and
the caps a request exceeds.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from l2hmc_tpu_torch.config import resolve_compute_dtype
from l2hmc_tpu_torch.dynamics.core import Dynamics
from l2hmc_tpu_torch.ops import _cuda
from l2hmc_tpu_torch.ops.operands import dot, dot_ct, lower
from l2hmc_tpu_torch.ops.philox import chain_draws

# weight bundle order produced by _extract_net (one per net):
#   w1 (D,H) w2 (D,H) | wh (H,H2) bh (H2,1) | ws (H2,D) bs (D,1) ls (D,1)
#   wt (H2,D) bt (D,1) | wq (H2,D) bq (D,1) lq (D,1) | te (H,T)
_NET_ARRAYS = 13
# the arrays of that list that are products' weights: w1, w2, wh, ws, wt, wq
_PRODUCT_WEIGHTS = (0, 1, 2, 4, 7, 9)

# kernel launches per kernel since the last reset_launch_counts()
LAUNCHES = {"trajectory": 0, "trajectory_bwd": 0, "chain": 0, "vae_chain": 0, "vae_ais": 0,
            "vae_traj": 0, "vae_traj_bwd": 0}

# widths the kernels take, all three alike: states and hidden widths up to
# 64 on the lane groups (WideLanes in csrc/l2hmc_lanes.cuh); past 64 on the
# site-parallel configuration (csrc/l2hmc_sites.cuh), states up to 4096 wide
# and hidden widths up to 128 (the caps kSiteMaxDim, kSiteMaxHidden in
# csrc/l2hmc_lanes.cuh)
_LANE_WIDTH = 64
# the backward kernel's (C, D) intermediates lie in shared memory up to this
# width, past it in its scratch (kSiteVjpSmemDim in csrc/l2hmc_sites.cuh)
_SITE_VJP_SMEM_DIM = 1024
_MAX_DIM, _MAX_HIDDEN = 4096, 128
_MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper
# the site-parallel configuration's tile: chains and threads a block
_SITE_CHAINS, _SITE_THREADS = 4, 256


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _net_scales(sig: Optional[torch.Tensor]):
    """Per-net embed-weight folds implementing ``Dynamics.input_scale``, from
    its sigma on the device: ((xnet_s0, xnet_s1), (vnet_s0, vnet_s1)); None
    means unscaled."""
    if sig is None:
        return (None, None), (None, None)
    return (None, 1.0 / sig), (1.0 / sig, sig)


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


def _extract_net(net_params: Any, trig, scales=(None, None)) -> list[torch.Tensor]:
    """Flatten a ``stq_net`` params tree into the kernels' weight list,
    folding the time path into te = W3^T trig^T + (b1 + b2 + b3) and
    ``scales`` (tensors on the params' device, or None) into the two embed
    weights. ``trig`` is the (T, 2) time encoding, numpy or a tensor."""
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
    w1 = e1["w"] if s0 is None else e1["w"] * s0[:, None]
    w2 = e2["w"] if s1 is None else e2["w"] * s1[:, None]
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
    _, times, sig = dyn.consts(device)
    xs, vs = _net_scales(sig)
    return (
        _extract_net(params["xnet"], times, xs),
        _extract_net(params["vnet"], times, vs),
    )


def _eps_col(eps: torch.Tensor, dim: int) -> torch.Tensor:
    """Scalar or (dim,) eps -> a (dim, 1) float32 column."""
    return torch.broadcast_to(eps.to(torch.float32), (dim,)).reshape(dim, 1)


# -- energy specs --------------------------------------------------------------


def _cached(cache: dict, device, dtype, make) -> list[torch.Tensor]:
    """A spec's constants on ``device`` in ``dtype``, made once per (device,
    dtype) by ``make(device, dtype)``: a launch copies nothing from the host."""
    key = (torch.device(device), dtype)
    c = cache.get(key)
    if c is None:
        c = cache[key] = make(torch.device(device), dtype)
    return list(c)


def _scalars(values, device, dtype) -> list[torch.Tensor]:
    """Scalars of a spec as one constant array, each rounded to ``dtype``
    once (as the JAX closures' Python floats are)."""
    return [torch.tensor(values, dtype=dtype, device=device)]


@dataclasses.dataclass(frozen=True)
class QuadraticGaussianEnergy:
    """0.5 (x-mu)^T P (x-mu) — the SCG / tilted / ill-conditioned Gaussian.
    Constants: prec (D, D), mu (D, 1)."""

    prec: np.ndarray  # (D, D)
    mu: np.ndarray  # (D,)
    _dev: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    KIND, NAME = 0, "gauss"

    def consts(self, device, dtype=torch.float32) -> list[torch.Tensor]:
        d = self.mu.shape[0]
        return _cached(self._dev, device, dtype, lambda dev, dt: [
            torch.as_tensor(self.prec, dtype=dt, device=dev),
            torch.as_tensor(self.mu, dtype=dt, device=dev).reshape(d, 1),
        ])

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


@dataclasses.dataclass(frozen=True)
class RoughWellEnergy:
    """0.5 |x|^2 + eps sum cos(x / freq) — the rough well (freq = eps in easy
    mode, eps^2 in hard). Constants: one array of eps, 1/freq, eps/freq and
    eps/freq^2, each rounded once; the closures multiply by 1/freq, as the
    JAX ones do."""

    eps: float
    freq: float
    _dev: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    KIND, NAME = 1, "rough_well"

    def consts(self, device, dtype=torch.float32) -> list[torch.Tensor]:
        e, f = float(self.eps), float(self.freq)
        return _cached(self._dev, device, dtype, lambda dev, dt: _scalars(
            [e, 1.0 / f, e / f, e / (f * f)], dev, dt))

    @staticmethod
    def build(vals):
        (c,) = vals
        eps, inv_f, a = c[0], c[1], c[2]

        def energy(x):
            e = 0.5 * torch.square(x) + eps * torch.cos(x * inv_f)
            return torch.sum(e, dim=0, keepdim=True)

        def grad_energy(x):
            return x - a * torch.sin(x * inv_f)

        return energy, grad_energy

    @staticmethod
    def build_grad_vjp(vals):
        """(x, d) -> (1 - (eps/freq^2) cos(x/freq)) d."""
        (c,) = vals
        inv_f, b = c[1], c[3]

        def grad_vjp(x, d):
            return (1.0 - b * torch.cos(x * inv_f)) * d

        return grad_vjp


@dataclasses.dataclass(frozen=True)
class GmmEnergy:
    """-logsumexp_k [log c_k - 0.5 (x-mu_k)^T P_k (x-mu_k)] — a full-covariance
    Gaussian mixture (ring, mog2). Constants: mus_t (D, K), precs (K*D, D)
    stacked per component, log_consts (1, K). The components run in order,
    the max subtracted before the exp."""

    mus_t: np.ndarray  # (D, K)
    precs: np.ndarray  # (K*D, D)
    log_consts: np.ndarray  # (1, K)
    _dev: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    KIND, NAME = 2, "gmm"

    def consts(self, device, dtype=torch.float32) -> list[torch.Tensor]:
        return _cached(self._dev, device, dtype, lambda dev, dt: [
            torch.as_tensor(a, dtype=dt, device=dev)
            for a in (self.mus_t, self.precs, self.log_consts)])

    @staticmethod
    def _terms(vals, x):
        """Per component (log-weight (1, N), dk = x - mu_k, P_k dk, P_k)."""
        mus_t, precs, log_consts = vals
        d, k = mus_t.shape
        out = []
        for i in range(k):
            dk = x - mus_t[:, i:i + 1]
            p = precs[i * d:(i + 1) * d]
            pd = p @ dk
            quad = 0.5 * torch.sum(dk * pd, dim=0, keepdim=True)
            out.append((log_consts[0, i] - quad, dk, pd, p))
        return out

    @staticmethod
    def _weights(terms):
        """exp(lw_k - max) per component, the max taken in component order."""
        m = terms[0][0]
        for lw, *_ in terms[1:]:
            m = torch.maximum(m, lw)
        return m, [torch.exp(lw - m) for lw, *_ in terms]

    @classmethod
    def build(cls, vals):
        def energy(x):
            m, ws = cls._weights(cls._terms(vals, x))
            return -(m + torch.log(sum(ws)))

        def grad_energy(x):
            terms = cls._terms(vals, x)
            _, ws = cls._weights(terms)
            g = sum(w * pd for w, (_, _, pd, _) in zip(ws, terms))
            return g / sum(ws)

        return energy, grad_energy

    @classmethod
    def build_grad_vjp(cls, vals):
        """With w~_k the softmax weights, p_k = P_k dk, q_k = 0.5 (P_k + P_k^T) dk
        and g = sum w~_k p_k: (x, d) -> sum_k w~_k [P_k^T d - (p_k.d) q_k]
        + (g.d) sum_k w~_k q_k."""
        def grad_vjp(x, d):
            terms = cls._terms(vals, x)
            _, ws = cls._weights(terms)
            s = sum(ws)
            wn = [w / s for w in ws]
            qs = [0.5 * (pd + p.T @ dk) for (_, dk, pd, p) in terms]
            g = sum(w * pd for w, (_, _, pd, _) in zip(wn, terms))
            gd = torch.sum(g * d, dim=0, keepdim=True)
            out = 0.0
            for w, q, (_, _, pd, p) in zip(wn, qs, terms):
                pdd = torch.sum(pd * d, dim=0, keepdim=True)
                out = out + w * (p.T @ d - pdd * q) + gd * w * q
            return out

        return grad_vjp


_LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class FunnelEnergy:
    """The Gaussian funnel with the reference's clipped energy: row 0 is v,
    rows 1.. the neck, w = clip(v, -clip, clip),
    E = 0.5 (v^2 / sigma^2 + S e^-w + n (log 2 pi + w)), S the neck's sum of
    squares, n = dim - 1. Constants: one array of 1/sigma^2, clip and n. The
    clip makes the v-gradient piecewise: zero d/dv through the saturated
    exp, as ``jax.grad`` of the clamped energy gives."""

    sigma: float
    clip: float
    dim: int
    _dev: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    KIND, NAME = 3, "funnel"

    def consts(self, device, dtype=torch.float32) -> list[torch.Tensor]:
        vals = [1.0 / float(self.sigma) ** 2, float(self.clip), float(self.dim - 1)]
        return _cached(self._dev, device, dtype, lambda dev, dt: _scalars(vals, dev, dt))

    @staticmethod
    def _parts(c, x):
        is2, clip, n = c[0], c[1], c[2]
        v = x[0:1]
        w = torch.clamp(v, -clip, clip)
        inv_s = torch.exp(-w)
        inside = ((v > -clip) & (v < clip)).to(x.dtype)
        sum_sq = torch.sum(torch.square(x[1:]), dim=0, keepdim=True)
        return is2, n, v, w, inv_s, inside, sum_sq

    @classmethod
    def build(cls, vals):
        (c,) = vals

        def energy(x):
            is2, n, v, w, inv_s, _, sum_sq = cls._parts(c, x)
            return 0.5 * (torch.square(v) * is2 + sum_sq * inv_s + n * (_LOG_2PI + w))

        def grad_energy(x):
            is2, n, v, _, inv_s, inside, sum_sq = cls._parts(c, x)
            g_v = v * is2 + 0.5 * inside * (n - sum_sq * inv_s)
            return torch.cat([g_v, x[1:] * inv_s], dim=0)

        return energy, grad_energy

    @classmethod
    def build_grad_vjp(cls, vals):
        """With the clip's derivative the strict inside mask ``in``:
        dx_v = d_v (1/sigma^2 + 0.5 in S e^-w) - in e^-w sum_{i>=1} x_i d_i,
        dx_i = e^-w d_i - in x_i e^-w d_v."""
        (c,) = vals

        def grad_vjp(x, d):
            is2, _, _, _, inv_s, inside, sum_sq = cls._parts(c, x)
            xd = torch.sum(x[1:] * d[1:], dim=0, keepdim=True)
            dv = d[0:1] * (is2 + 0.5 * inside * sum_sq * inv_s) - inside * inv_s * xd
            return torch.cat([dv, inv_s * d[1:] - inside * x[1:] * inv_s * d[0:1]], dim=0)

        return grad_vjp


@dataclasses.dataclass(frozen=True)
class Phi4Energy:
    """The 2-D phi^4 lattice action (``targets.Phi4Lattice``) as a 5-point
    stencil on the flattened (D, N) state, D = L*L, site r*L + c. The
    neighbours are JAX's construction (l2hmc_tpu/ops/fused_dynamics.py
    :548-597): vertical ones flat rolls by -+L (periodic in r for free),
    horizontal ones flat rolls by -+1 with the row-end sites wrapping
    within their row: right of c = L-1 is phi[i - (L-1)], left of c = 0 is
    phi[i + (L-1)]. Constants: one array of m^2, lam and L, each rounded
    once. The Hessian is symmetric, so the gradient's VJP is
    (4 + m^2 + 12 lam phi^2) d - (the sum of d over the four neighbours)."""

    L: int
    m2: float
    lam: float
    _dev: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    KIND, NAME = 4, "phi4"

    def consts(self, device, dtype=torch.float32) -> list[torch.Tensor]:
        vals = [float(self.m2), float(self.lam), float(self.L)]
        return _cached(self._dev, device, dtype, lambda dev, dt: _scalars(vals, dev, dt))

    @staticmethod
    def _neighbors(x):
        """(right, left, down, up) of every site of (D, N) x; L = sqrt(D)."""
        d = x.shape[0]
        L = math.isqrt(d)
        c = (torch.arange(d, device=x.device) % L)[:, None]
        right = torch.where(c == L - 1, torch.roll(x, L - 1, 0), torch.roll(x, -1, 0))
        left = torch.where(c == 0, torch.roll(x, -(L - 1), 0), torch.roll(x, 1, 0))
        return right, left, torch.roll(x, -L, 0), torch.roll(x, L, 0)

    @classmethod
    def build(cls, vals):
        (c,) = vals
        m2, lam = c[0], c[1]

        def grad_energy(x):
            right, left, down, up = cls._neighbors(x)
            lap = 4.0 * x - right - left - down - up
            return lap + m2 * x + (4.0 * lam) * x * x * x

        def energy(x):
            right, _, down, _ = cls._neighbors(x)
            x2 = torch.square(x)
            kin = 0.5 * (torch.square(right - x) + torch.square(down - x))
            pot = (0.5 * m2) * x2 + lam * torch.square(x2)
            return torch.sum(kin + pot, dim=0, keepdim=True)

        return energy, grad_energy

    @classmethod
    def build_grad_vjp(cls, vals):
        """(x, d) -> (4 + m^2 + 12 lam x^2) d - (right + left + down + up of d)."""
        (c,) = vals
        m2, lam = c[0], c[1]

        def grad_vjp(x, d):
            right, left, down, up = cls._neighbors(d)
            return (4.0 + m2 + (12.0 * lam) * x * x) * d - (right + left + down + up)

        return grad_vjp


_SPEC_NAMES = {c.KIND: c.NAME for c in (QuadraticGaussianEnergy, RoughWellEnergy, GmmEnergy,
                                         FunnelEnergy, Phi4Energy)}
# the specs whose backward kernel on sites csrc/trajectory_bwd_specs.cu builds
_BWD_SPECS_KINDS = (RoughWellEnergy.KIND, GmmEnergy.KIND, FunnelEnergy.KIND)
LAUNCHES.update({f"{k}:{n}": 0 for k in ("trajectory", "trajectory_bwd", "chain")
                 for n in _SPEC_NAMES.values()})
# the site-parallel launches
LAUNCHES.update({f"{k}:sites": 0 for k in ("trajectory", "trajectory_bwd", "chain")})
LAUNCHES.update({"trajectory:bf16": 0, "chain:bf16": 0})  # bfloat16 instantiations


def _count(name: str, inp, sites: bool) -> None:
    LAUNCHES[name] += 1
    LAUNCHES[f"{name}:{_SPEC_NAMES[inp.kind]}"] += 1
    if sites:
        LAUNCHES[f"{name}:sites"] += 1
    if inp.cd is not None:
        LAUNCHES[f"{name}:bf16"] += 1


def energy_spec_for_target(target):
    """Map a target to its in-kernel energy spec: the Gaussian family (mu,
    _prec), ``RoughWell``, ``GMM`` (ring, mog2), ``GaussianFunnel`` and
    ``Phi4Lattice``. Raises ValueError for any other target."""
    spec = _spec_or_none(target)
    if spec is None:
        raise ValueError(f"no fused energy spec for target {type(target).__name__}")
    return spec


def _spec_or_none(target):
    prec = getattr(target, "_prec", None)
    mu = getattr(target, "mu", None)
    if prec is not None and mu is not None:
        return QuadraticGaussianEnergy(np.asarray(prec), np.asarray(mu))
    if hasattr(target, "eps") and hasattr(target, "easy"):  # RoughWell
        freq = target.eps if target.easy else target.eps * target.eps
        return RoughWellEnergy(float(target.eps), float(freq))
    if hasattr(target, "_precs") and hasattr(target, "_log_consts"):  # GMM
        mus = np.asarray(target.mus, np.float32)  # (K, D)
        k, d = mus.shape
        precs = np.asarray(target._precs, np.float32).reshape(k * d, d)
        log_consts = np.asarray(target._log_consts, np.float32).reshape(1, k)
        return GmmEnergy(mus.T.copy(), precs, log_consts)
    if hasattr(target, "clip") and hasattr(target, "sigma"):  # GaussianFunnel
        return FunnelEnergy(float(target.sigma), float(target.clip), target.dim)
    if hasattr(target, "lam") and hasattr(target, "m2"):  # Phi4Lattice
        return Phi4Energy(int(target.L), float(target.m2), float(target.lam))
    return None


# -- host-prepared kernel inputs ------------------------------------------------


@dataclasses.dataclass
class KernelInputs:
    """Everything a kernel reads besides the chain state, on one device."""

    eps: torch.Tensor  # (D, 1)
    masks: torch.Tensor  # (D, T)
    consts: list  # the energy spec's constant arrays
    xnet_w: list  # 13 arrays
    vnet_w: list  # 13 arrays
    hmc: bool
    energy: Callable
    grad_energy: Callable
    grad_vjp: Optional[Callable]  # (x, d) -> the cotangent of x through grad_energy
    emb: Optional[torch.Tensor] = None  # (H, N) aux embedding added to the nets' hidden layer
    kind: int = QuadraticGaussianEnergy.KIND  # the energy spec's, for the kernels
    # the products' operand dtype (None: float32)
    cd: Optional[torch.dtype] = None

    @property
    def dims(self) -> tuple[int, int, int, int]:
        """(D, H, H2, T)."""
        w1, wh, te = self.xnet_w[0], self.xnet_w[2], self.xnet_w[12]
        return w1.shape[0], w1.shape[1], wh.shape[1], te.shape[1]

    @property
    def energy_args(self) -> tuple[int, int]:
        """(kind, floats of the constants): the energy spec as the kernels'
        entry points take it."""
        return self.kind, sum(c.numel() for c in self.consts)

    def block(self) -> torch.Tensor:
        """The packed float32 parameter block the CUDA kernels read
        (layout in csrc/l2hmc_common.cuh), with ``cd`` the products'
        weights rounded to it (the JAX kernel's ``_dot_in`` rounds them at
        every product, after ``_net_scales``' fold)."""
        nets = [[lower(w, self.cd) if i in _PRODUCT_WEIGHTS else w for i, w in enumerate(ws)]
                for ws in (self.xnet_w, self.vnet_w)]
        parts = [self.eps, self.masks, *self.consts, *nets[0], *nets[1]]
        return torch.cat([p.reshape(-1) for p in parts]).contiguous()


def prepare(dyn: Dynamics, spec, params, device, *, differentiable: bool = False,
            compute_dtype=None) -> KernelInputs:
    """Host prep shared by the kernels and their plain versions. The weights
    and eps are detached unless ``differentiable``, where they keep their
    autograd history back to ``params`` (through ``_extract_net``'s folds
    and ``eps = exp(alpha)``) for the training path. ``compute_dtype`` (as
    ``config.resolve_compute_dtype`` takes it) is the products' operand
    dtype; the weights stay float32 here. The constants come from
    per-device caches, so on a device that has them this copies nothing
    from the host and can be captured in a CUDA graph."""
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
        masks=dyn.consts(device)[0].T.contiguous(),
        consts=consts,
        xnet_w=xnet_w,
        vnet_w=vnet_w,
        hmc=dyn.hmc,
        energy=energy,
        grad_energy=grad_energy,
        grad_vjp=spec.build_grad_vjp(consts),
        kind=spec.KIND,
        cd=resolve_compute_dtype(compute_dtype),
    )


def _caps_refusal(kernel: str, dim: int, hidden: int) -> Optional[str]:
    """Why ``kernel`` cannot take a state ``dim`` wide with S/T/Q nets of
    ``hidden`` units, or None where it can (every energy spec alike)."""
    cap, hcap = _MAX_DIM, _MAX_HIDDEN
    if dim > cap or hidden > hcap:
        return (f"{kernel} kernel caps exceeded: dim {dim}, hidden {hidden} "
                f"(caps dim {cap}, hidden {hcap})")
    return None


def chain_on_sites(inp: KernelInputs) -> bool:
    """Whether the chain kernel runs ``inp`` on its site-parallel
    configuration (``site_chain`` in csrc/l2hmc_sites.cuh, by
    ``pick_lanes`` in csrc/l2hmc_lanes.cuh): a state or a hidden width past
    64, and the phi^4 lattice at every width."""
    return max(inp.dims[:3]) > _LANE_WIDTH or inp.kind == Phi4Energy.KIND


def site_prelude_floats(kind: int, nc: int, dim: int) -> int:
    """Floats of the prelude each chain of a site-parallel tile keeps in
    shared memory for the energy spec ``kind`` with ``nc`` floats of
    constants at ``dim`` (``site_pre_floats`` in csrc/l2hmc_sites.cuh): the
    funnel's 2 (the neck's sum of squares and a second sum or the energy), a
    K-component mixture's 2K + 2 (its weights, the VJP's K sums, their total
    and the energy or the VJP's g.dg), none for the other specs."""
    if kind == GmmEnergy.KIND:
        return 2 * (nc // (dim + dim * dim + 1)) + 2
    return 2 if kind == FunnelEnergy.KIND else 0


def site_geometry(dim: int, hidden: int, hidden2: int, kind: int = QuadraticGaussianEnergy.KIND,
                  nc: int = 0) -> tuple[int, int, int]:
    """(chains, threads, bytes of shared memory) a block of the chain
    kernel's site-parallel configuration takes at these widths on the energy
    spec ``kind`` with ``nc`` floats of constants: a host mirror of
    ``site_smem_floats`` in csrc/l2hmc_sites.cuh. Its buffers hold 64 hidden
    units, or 128 where a width passes 64; x', v and g of the tile's chains
    and the spec's prelude lie in shared memory, the accepted states in the
    wrapper's scratch. Raises past the caps."""
    reason = _caps_refusal("chain", dim, max(hidden, hidden2))
    if reason is not None:
        raise ValueError(reason)
    hm = _LANE_WIDTH if max(hidden, hidden2) <= _LANE_WIDTH else _MAX_HIDDEN
    C, W = _SITE_CHAINS, _SITE_THREADS // 32
    floats = (3 * C * dim + W * C * hm + 2 * C * hm + W * 3 * C + 3 * C
              + C * site_prelude_floats(kind, nc, dim))
    return C, _SITE_THREADS, 4 * floats


def site_tile(dim: int, hidden: int, hidden2: int, kind: int = QuadraticGaussianEnergy.KIND,
              nc: int = 0) -> tuple[int, int, int]:
    """``site_geometry`` as the built library reports it (chains, threads,
    bytes of shared memory a block; zeros past the caps)."""
    lib = _cuda.library("chain")
    return (lib.l2hmc_chain_site_chains(dim, hidden, hidden2),
            lib.l2hmc_chain_site_threads(dim, hidden, hidden2),
            lib.l2hmc_chain_site_smem_bytes(dim, hidden, hidden2, kind, nc))


def trajectory_on_sites(inp: KernelInputs) -> bool:
    """Whether the trajectory kernels run ``inp`` on the site-parallel
    configuration (``pick_lanes`` in csrc/l2hmc_lanes.cuh gives 3): a state
    or a hidden width past 64."""
    return max(inp.dims[:3]) > _LANE_WIDTH


def trajectory_site_geometry(kernel: str, dim: int, hidden: int, hidden2: int, n_chains: int,
                             kind: int = QuadraticGaussianEnergy.KIND,
                             nc: int = 0) -> tuple[int, int, int, int]:
    """(chains, threads, bytes of shared memory a block, scratch rows) of
    ``kernel`` ("trajectory" or "trajectory_bwd") on the site-parallel
    configuration at these widths, ``n_chains`` chains and the energy spec
    ``kind`` with ``nc`` floats of constants: a host mirror of
    ``site_smem_floats`` and ``site_vjp_smem_floats`` in
    csrc/l2hmc_sites.cuh. The trajectory kernel keeps x', v and g of its tile
    in shared memory, as the chain kernel does, and no scratch; the backward
    kernel keeps ten (C, D) arrays there up to dim 1024 (past it in its
    scratch) and the four net applications' hidden layers, and one row of
    weight and eps cotangents a block in the wrapper's scratch; both keep the
    spec's prelude (``site_prelude_floats``) beside them. Raises past the
    caps or where the lane groups serve the widths."""
    reason = _caps_refusal(kernel, dim, max(hidden, hidden2))
    if reason is not None:
        raise ValueError(reason)
    if max(dim, hidden, hidden2) <= _LANE_WIDTH:
        raise ValueError(f"{kernel} kernel runs dim {dim}, hidden {max(hidden, hidden2)} on "
                         f"its lane groups, not on sites")
    if kernel == "trajectory":
        return (*site_geometry(dim, hidden, hidden2, kind, nc), 0)
    hm = _LANE_WIDTH if max(hidden, hidden2) <= _LANE_WIDTH else _MAX_HIDDEN
    C, W = _SITE_CHAINS, _SITE_THREADS // 32
    arrays = 10 * C * dim if dim <= _SITE_VJP_SMEM_DIM else 0
    pre = C * site_prelude_floats(kind, nc, dim)
    return C, _SITE_THREADS, 4 * (arrays + W * C * hm + 10 * C * hm + pre), -(-n_chains // C)


def trajectory_site_tile(kernel: str, dim: int, hidden: int, hidden2: int,
                         kind: int = QuadraticGaussianEnergy.KIND,
                         nc: int = 0) -> tuple[int, int, int]:
    """``trajectory_site_geometry``'s first three as the built library reports
    them (zeros where the widths are not past 64 or past the caps)."""
    lib = _cuda.library(kernel)
    return (getattr(lib, f"l2hmc_{kernel}_site_chains")(dim, hidden, hidden2),
            getattr(lib, f"l2hmc_{kernel}_site_threads")(dim, hidden, hidden2),
            getattr(lib, f"l2hmc_{kernel}_site_smem_bytes")(dim, hidden, hidden2, kind, nc))


def bwd_scratch_floats(inp: KernelInputs, n: int) -> int:
    """Floats of scratch a backward launch on ``n`` chains takes: on the lane
    groups a row of weight and eps cotangents a chain and the (T + 1, 2, D,
    N) boundary states; on sites a row a block of ``_SITE_CHAINS`` chains,
    each block's (T, 2, C, D) boundary states and, past dim 1024, its
    (10, C, D) intermediates."""
    D, _, _, T = inp.dims
    P = sum(w.numel() for w in [*inp.xnet_w, *inp.vnet_w]) + D
    if not trajectory_on_sites(inp):
        return P * n + 2 * (T + 1) * D * n
    rows = -(-n // _SITE_CHAINS)
    arrays = 10 * _SITE_CHAINS * D if D > _SITE_VJP_SMEM_DIM else 0
    return rows * (P + 2 * T * _SITE_CHAINS * D + arrays)


def _kernel_block(inp: KernelInputs, x: torch.Tensor, kernel: str) -> torch.Tensor:
    """The packed parameter block for a launch of ``kernel`` on ``x``'s
    device, after checking what the kernel takes."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {x.device}")
    D, H, H2, T = inp.dims
    reason = _caps_refusal(kernel, D, 0 if inp.hmc else max(H, H2))
    if reason is not None:
        raise ValueError(reason)
    block = inp.block()
    # the lane groups stage the block in shared memory; the site-parallel
    # configuration reads it from the L2
    on_sites = chain_on_sites(inp) if kernel == "chain" else trajectory_on_sites(inp)
    if not on_sites and 4 * block.numel() > _MAX_SMEM:
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


def _apply_stq(w: list, a, b, step: int, hmc: bool, emb=None, seen=None, cd=None):
    """S/T/Q net on transposed activations: a, b are (D, N). ``emb`` is the
    optional per-chain aux embedding (H, N), the VAE sampler's fourth Zip
    input, added to the hidden pre-activation. ``seen``, a list, collects
    the two hidden pre-activations. ``cd`` lowers every product's operands
    (``ops.operands``)."""
    if hmc:
        z = torch.zeros_like(a)
        return z, z, z
    w1, w2, wh, bh, ws, bs, ls, wt, bt, wq, bq, lq, te = w
    h = dot(w1.T, a, cd) + dot(w2.T, b, cd) + te[:, step : step + 1]
    if emb is not None:
        h = h + emb
    pre2 = dot(wh.T, torch.relu(h), cd) + bh
    if seen is not None:
        seen += [h, pre2]
    h2 = torch.relu(pre2)
    s = torch.exp(ls) * torch.tanh(dot(ws.T, h2, cd) + bs)
    t = dot(wt.T, h2, cd) + bt
    q = torch.exp(lq) * torch.tanh(dot(wq.T, h2, cd) + bq)
    return s, t, q


def _trajectory_step(inp: KernelInputs, reverse: bool, step: int, x, v, seen=None):
    """One substep on (D, N) state; returns (x, v, logdet increment (1, N))."""
    m = inp.masks[:, step : step + 1]
    mb = 1.0 - m
    eps, grad_energy, hmc = inp.eps, inp.grad_energy, inp.hmc

    def stq(w, a, b):
        return _apply_stq(w, a, b, step, hmc, inp.emb, seen, inp.cd)

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


def relu_margins(inp: KernelInputs, x, v, reverse: bool) -> torch.Tensor:
    """Per chain (N,), how close the plain trajectory comes to a ReLU's kink:
    the smallest hidden pre-activation, in magnitude, of its 4 T net
    applications, as a share of the largest of the same layer,
    application and chain. The trajectory's VJP is discontinuous where
    a pre-activation crosses zero, so a chain whose margin lies within
    float32 rounding can gate differently in two correct implementations,
    which then differ by whole terms in that chain's cotangents. HMC mode
    runs no net: every margin is infinite."""
    T = inp.dims[3]
    margin = torch.full_like(x[0], float("inf"))
    for step in (range(T - 1, -1, -1) if reverse else range(T)):
        seen: list = []
        x, v, _ = _trajectory_step(inp, reverse, step, x, v, seen)
        for pre in seen:
            margin = torch.minimum(margin, pre.abs().amin(dim=0) / pre.abs().amax(dim=0))
    return margin


def _stq_vjp(w: list, a, b, step: int, ds, dt, dq, gw: list, emb=None, demb=None, cd=None):
    """VJP of ``_apply_stq`` at inputs (a, b) for output cotangents
    (ds, dt, dq): adds the 13 weight cotangents (summed over chains) into
    ``gw`` and returns (da, db). With ``emb`` the cotangent of the hidden
    pre-activation, which is also ``emb``'s, is added into ``demb``.
    Recomputes the net's activations; relu'(0) = 0. With ``cd`` each
    product's activation cotangent is rounded, each separately, and the
    weight cotangents take the lowered activations and stay float32
    (``ops.operands``)."""
    w1, w2, wh, bh, ws, bs, ls, wt, bt, wq, bq, lq, te = w
    z1 = dot(w1.T, a, cd) + dot(w2.T, b, cd) + te[:, step : step + 1]
    if emb is not None:
        z1 = z1 + emb
    h = torch.relu(z1)
    z2 = dot(wh.T, h, cd) + bh
    h2 = torch.relu(z2)
    ts = torch.tanh(dot(ws.T, h2, cd) + bs)
    tq = torch.tanh(dot(wq.T, h2, cd) + bq)
    ds_ = ds * torch.exp(ls)
    dq_ = dq * torch.exp(lq)
    dus = ds_ * (1.0 - ts * ts)
    duq = dq_ * (1.0 - tq * tq)
    dz2 = (dot_ct(ws, dus, cd) + dot_ct(wt, dt, cd) + dot_ct(wq, duq, cd)) * (z2 > 0)
    dz1 = dot_ct(wh, dz2, cd) * (z1 > 0)
    a, b, h, h2 = (lower(x, cd) for x in (a, b, h, h2))
    for i, g in enumerate((
        a @ dz1.T, b @ dz1.T,
        h @ dz2.T, dz2.sum(1, keepdim=True),
        h2 @ dus.T, dus.sum(1, keepdim=True), (ds_ * ts).sum(1, keepdim=True),
        h2 @ dt.T, dt.sum(1, keepdim=True),
        h2 @ duq.T, duq.sum(1, keepdim=True), (dq_ * tq).sum(1, keepdim=True),
    )):
        gw[i] += g
    gw[12][:, step] += dz1.sum(1)
    if demb is not None:
        demb += dz1
    return dot_ct(w1, dz1, cd), dot_ct(w2, dz1, cd)


def _step_vjp(inp: KernelInputs, reverse: bool, step: int, x, v, dxo, dvo, dld, gx, gv,
              demb=None):
    """VJP of ``_trajectory_step`` at (x, v) for the cotangents (dxo, dvo,
    dld) of (x', v', logdet increment), derived by hand: a recompute of the
    substep, then its four S/T/Q applications and two energy gradients in
    reverse order. Adds the nets' weight cotangents into ``gx`` (xnet) and
    ``gv`` (vnet) and, with ``inp.emb``, the embedding's into ``demb``;
    returns (dx, dv, deps (D, N) per chain)."""
    m = inp.masks[:, step : step + 1]
    mb = 1.0 - m
    e, ge, gvjp, hmc = inp.eps, inp.grad_energy, inp.grad_vjp, inp.hmc

    def stq(w, a, b):
        return _apply_stq(w, a, b, step, hmc, inp.emb, cd=inp.cd)

    def stq_vjp(w, a, b, ds, dt, dq, gw):
        if hmc:
            return 0.0, 0.0
        return _stq_vjp(w, a, b, step, ds, dt, dq, gw, inp.emb, demb, inp.cd)

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
    return _trajectory_vjp_plain(inp, x, v, dX, dV, dld, reverse)[:5]


def _trajectory_vjp_plain(inp: KernelInputs, x, v, dX, dV, dld, reverse: bool):
    """``trajectory_vjp_plain`` with the cotangent of ``inp.emb`` (H, N) as
    a sixth output (None without an embedding)."""
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
    demb = None if inp.emb is None else torch.zeros_like(inp.emb)
    dx, dv = dX, dV
    for i in range(T - 1, -1, -1):
        dx, dv, de_i = _step_vjp(inp, reverse, steps[i], xs[i], vs[i], dx, dv, dld, gx, gv,
                                 demb)
        de = de + de_i
    return gx, gv, de.sum(1, keepdim=True), dx, dv, demb


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


def _lib_name(kernel: str, inp: KernelInputs) -> str:
    """The library (and its entry point's suffix) that runs ``kernel`` on
    ``inp``: ``kernel``, or ``kernel_bf16`` at bfloat16 operands; the
    backward kernel on sites for the rough well, the mixtures and the funnel
    ``trajectory_bwd_specs`` (their site instantiations are a source of
    their own, ``csrc/trajectory_bwd_specs.cu``, for the build's clock)."""
    if kernel == "trajectory_bwd" and trajectory_on_sites(inp) and inp.kind in _BWD_SPECS_KINDS:
        return "trajectory_bwd_specs"
    return kernel if inp.cd is None else f"{kernel}_bf16"


def trajectory(inp: KernelInputs, x, v, reverse: bool):
    """Fused T-step trajectory on (D, N) float32 state; returns
    (X, V, logdet (1, N)). CPU tensors take the plain version; CUDA tensors
    launch ``csrc/trajectory.cu`` (a lane group a chain up to 64 wide, a
    tile of chains a block past it), or its bfloat16 instantiation
    (``csrc/trajectory_bf16.cu``) where ``inp.cd`` is bfloat16."""
    _check_state(inp, x, v)
    if x.device.type == "cpu":
        return trajectory_plain(inp, x, v, reverse)
    block = _kernel_block(inp, x, "trajectory")
    D, H, H2, T = inp.dims
    N = x.shape[1]
    name = _lib_name("trajectory", inp)
    entry = getattr(_cuda.library(name), f"l2hmc_{name}")
    xo, vo = torch.empty_like(x), torch.empty_like(v)
    ld = torch.empty((1, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = entry(
            block.data_ptr(), D, H, H2, T, *inp.energy_args, int(reverse), int(inp.hmc),
            x.data_ptr(), v.data_ptr(), xo.data_ptr(), vo.data_ptr(),
            ld.data_ptr(), N, torch.cuda.current_stream().cuda_stream,
        )
    _cuda.check(err, name)
    _count("trajectory", inp, trajectory_on_sites(inp))
    return xo, vo, ld


def trajectory_vjp(inp: KernelInputs, x, v, dX, dV, dld, reverse: bool):
    """VJP of the fused trajectory at (D, N) float32 (x, v) for the
    cotangents dX, dV (D, N) and dld (1, N); returns what
    ``trajectory_vjp_plain`` returns. CPU tensors take the plain version;
    CUDA tensors launch ``csrc/trajectory_bwd.cu`` (``trajectory_bwd_specs.cu``
    on sites for the rough well, the mixtures and the funnel; up to 64 wide a lane
    group per chain, each lane writing its share of the chain's cotangents
    into an (N, P) scratch once; past it a tile of chains a block, adding
    each substep's cotangents into the block's row of a (ceil(N / C), P)
    scratch), then a fixed-order sum over the rows. float32 only: the
    backward kernel has no bfloat16 form, nor has the JAX package's."""
    if inp.cd is not None:
        raise ValueError("trajectory_bwd kernel: float32 operands only (the JAX "
                         "package's backward kernel takes no compute dtype either)")
    _check_state(inp, x, v, dX, dV)
    N = x.shape[1]
    if dld.shape != (1, N) or dld.dtype != torch.float32 or not dld.is_contiguous() \
            or dld.device != x.device:
        raise ValueError(f"dld must be a contiguous float32 (1, {N}) tensor on {x.device}")
    if x.device.type == "cpu":
        return trajectory_vjp_plain(inp, x, v, dX, dV, dld, reverse)
    block = _kernel_block(inp, x, "trajectory_bwd")
    D, H, H2, T = inp.dims
    weights = [*inp.xnet_w, *inp.vnet_w]
    n_grads = sum(w.numel() for w in weights) + D
    grads = torch.empty(n_grads, dtype=torch.float32, device=x.device)
    scratch = torch.empty(bwd_scratch_floats(inp, N), dtype=torch.float32, device=x.device)
    dx, dv = torch.empty_like(x), torch.empty_like(v)
    name = _lib_name("trajectory_bwd", inp)
    entry = getattr(_cuda.library(name), f"l2hmc_{name}")
    with torch.cuda.device(x.device):
        err = entry(
            block.data_ptr(), D, H, H2, T, *inp.energy_args, int(reverse), int(inp.hmc),
            x.data_ptr(), v.data_ptr(), dX.data_ptr(), dV.data_ptr(), dld.data_ptr(),
            dx.data_ptr(), dv.data_ptr(), grads.data_ptr(), scratch.data_ptr(), N,
            torch.cuda.current_stream().cuda_stream,
        )
    _cuda.check(err, name)
    _count("trajectory_bwd", inp, trajectory_on_sites(inp))
    parts = torch.split(grads, [w.numel() for w in weights] + [D])
    g = [p.view(w.shape) for p, w in zip(parts, weights)]
    return g[:_NET_ARRAYS], g[_NET_ARRAYS:], parts[-1].view(D, 1), dx, dv


def chain(inp: KernelInputs, x, seed: int, n_mh_steps: int, collect_trace: bool = False):
    """K MH steps on (D, N) float32 state; returns (x (D, N), acceptance
    (1, N), trace (K, D, N) or None). CPU tensors take the plain version;
    CUDA tensors launch ``csrc/chain.cu``, or its bfloat16 instantiation
    (``csrc/chain_bf16.cu``) where ``inp.cd`` is bfloat16."""
    _check_state(inp, x)
    if n_mh_steps <= 0:
        raise ValueError("n_mh_steps must be positive")
    if x.device.type == "cpu":
        return chain_plain(inp, x, seed, n_mh_steps, collect_trace)
    block = _kernel_block(inp, x, "chain")
    D, H, H2, T = inp.dims
    N = x.shape[1]
    lib = _cuda.library("chain")
    name = _lib_name("chain", inp)
    entry = getattr(_cuda.library(name), f"l2hmc_{name}")
    xo = torch.empty_like(x)
    acc = torch.empty((1, N), dtype=torch.float32, device=x.device)
    trace = (
        torch.empty((n_mh_steps, D, N), dtype=torch.float32, device=x.device)
        if collect_trace else None
    )
    scratch = None
    if chain_on_sites(inp):
        # the site-parallel tiles' accepted states, a tile's chains past N
        # included
        c = lib.l2hmc_chain_site_chains(D, H, H2)
        scratch = torch.empty(-(-N // c) * c * D, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = entry(
            block.data_ptr(), D, H, H2, T, *inp.energy_args, int(inp.hmc), x.data_ptr(),
            xo.data_ptr(), acc.data_ptr(),
            trace.data_ptr() if trace is not None else None,
            scratch.data_ptr() if scratch is not None else None,
            N, n_mh_steps, int(seed) & 0xFFFFFFFFFFFFFFFF,
            torch.cuda.current_stream().cuda_stream,
        )
    _cuda.check(err, name)
    _count("chain", inp, scratch is not None)
    return xo, acc, trace


# -- public classes ------------------------------------------------------------


def _dynamics_refusal(dynamics: Dynamics) -> Optional[str]:
    for name in ("eps_step", "eps_mat"):
        if getattr(dynamics, name):
            return f"fused kernels do not support {name} (plain path only)"
    if dynamics.net_input_fn is not None:
        return "fused kernels do not support net_input_fn (plain path only)"
    return None


def _check_supported(dynamics: Dynamics) -> None:
    reason = _dynamics_refusal(dynamics)
    if reason is not None:
        raise ValueError(reason)


def kernel_refusal(dynamics: Dynamics, target, hidden: int, *,
                   net_type: str = "dense") -> Optional[str]:
    """Why the chain kernel (the fused evals') cannot serve this dynamics on
    this target with S/T/Q nets of ``net_type`` and ``hidden`` units, or
    None where it can: a pure check, made before any launch (conv nets, an
    unsupported knob, a target with no energy spec, or widths past the
    kernel's caps)."""
    reason = _dynamics_refusal(dynamics)
    if reason is None and net_type != "dense" and not dynamics.hmc:
        reason = f"fused kernels take dense S/T/Q nets, not {net_type} (plain path only)"
    spec = _spec_or_none(target)
    if reason is None and spec is None:
        reason = f"no fused energy spec for target {type(target).__name__}"
    if reason is None:
        reason = _caps_refusal("chain", dynamics.dim, 0 if dynamics.hmc else hidden)
    return reason


def _no_aux(aux) -> None:
    """The spec'd targets' energies take no ``aux``; ``mcmc.propose`` passes
    its own (None for them) to whatever dynamics it is given."""
    if aux is not None:
        raise ValueError("the fused dynamics of a spec'd target take no aux")


@dataclasses.dataclass(frozen=True)
class FusedDynamics:
    """Fused-trajectory path for a Dynamics on a spec'd target:
    ``forward(params, x, v)`` / ``backward(params, x, v)`` return
    (X, V, logdet) as ``Dynamics.forward/backward`` do, on (N, D) state.
    ``compute_dtype`` is the S/T/Q products' operand dtype (float32 by
    default; "bfloat16" runs the kernel's bfloat16 instantiation)."""

    dynamics: Dynamics
    spec: Any
    compute_dtype: Any = None

    def _run(self, params, x, v, reverse: bool):
        inp = prepare(self.dynamics, self.spec, params, x.device,
                      compute_dtype=self.compute_dtype)
        xo, vo, ld = trajectory(
            inp, x.T.contiguous(), v.T.contiguous(), reverse
        )
        return xo.T.contiguous(), vo.T.contiguous(), ld[0]

    def forward(self, params, x, v, aux=None):
        _no_aux(aux)
        return self._run(params, x, v, reverse=False)

    def backward(self, params, x, v, aux=None):
        _no_aux(aux)
        return self._run(params, x, v, reverse=True)

    def p_accept(self, params, x0, v0, x1, v1, log_jac, aux=None):
        _no_aux(aux)
        return self.dynamics.p_accept(params, x0, v0, x1, v1, log_jac)


def fused_for_target(dynamics: Dynamics, target, *, compute_dtype=None) -> FusedDynamics:
    """The fused-trajectory path for a spec-supported target (HMC mode runs
    as exact leapfrog with the nets skipped), with ``compute_dtype``
    operands."""
    _check_supported(dynamics)
    return FusedDynamics(dynamics, energy_spec_for_target(target), compute_dtype)


class _Trajectory(torch.autograd.Function):
    """The fused trajectory as one autograd node whose boundary is the
    kernels': eps (D, 1), x, v (D, N) and the 13 + 13 net weights. Forward
    runs ``trajectory`` (with ``inp.cd``'s operands), backward
    ``trajectory_vjp`` in float32 at the same, unrounded, weights: the JAX
    package's custom VJP, whose backward kernel takes no compute dtype."""

    @staticmethod
    def forward(ctx, inp: KernelInputs, reverse: bool, eps, x, v, *weights):
        ctx.inp = dataclasses.replace(inp, eps=None, xnet_w=[], vnet_w=[])
        ctx.reverse = reverse
        ctx.save_for_backward(eps, x, v, *weights)
        return trajectory(_with_tensors(inp, eps, weights), x, v, reverse)

    @staticmethod
    def backward(ctx, dX, dV, dld):
        eps, x, v, *weights = ctx.saved_tensors
        inp = _with_tensors(dataclasses.replace(ctx.inp, cd=None), eps, weights)
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
    HMC mode runs with zero nets, so only alpha, x and v get gradients.
    With a bfloat16 ``fused``, the forward runs in bfloat16 and the
    backward in float32 (``_Trajectory``)."""

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
        inp = prepare(self.dynamics, self.fused.spec, params, x.device, differentiable=True,
                      compute_dtype=self.fused.compute_dtype)
        X, V, ld = _Trajectory.apply(
            inp, reverse, inp.eps, x.T.contiguous(), v.T.contiguous(),
            *inp.xnet_w, *inp.vnet_w,
        )
        # (N, D) rows, as Dynamics returns them: a transposed view would give
        # the step's later sums over D another order than a state held in a
        # contiguous buffer (the captured route's), and the routes would part
        return X.T.contiguous(), V.T.contiguous(), ld[0]


def differentiable_fused(dynamics: Dynamics, target, *,
                         compute_dtype=None) -> DifferentiableFusedDynamics:
    """The training-path fused dynamics for a spec-supported target, its
    forward with ``compute_dtype`` operands."""
    return DifferentiableFusedDynamics(
        fused_for_target(dynamics, target, compute_dtype=compute_dtype))


@dataclasses.dataclass(frozen=True)
class FusedChainSampler:
    """K MH steps per kernel launch.

    ``run(params, x, seed, n_mh_steps)`` advances every chain by
    ``n_mh_steps`` direction-randomized proposals and MH accepts; returns
    (x_final (N, D), mean acceptance per chain (N,)) and, with
    ``collect_trace``, the (n_mh_steps, N, D) post-MH history as a third
    output (a transposed view of the kernel's (K, D, N) buffer).
    ``compute_dtype`` is the S/T/Q products' operand dtype, as in
    ``FusedDynamics``; energies, Hamiltonians, the accept and the trace
    stay float32."""

    dynamics: Dynamics
    spec: Any
    compute_dtype: Any = None

    def run(self, params, x, seed: int, n_mh_steps: int, *, collect_trace: bool = False):
        inp = prepare(self.dynamics, self.spec, params, x.device,
                      compute_dtype=self.compute_dtype)
        xo, acc, trace = chain(inp, x.T.contiguous(), seed, n_mh_steps, collect_trace)
        if collect_trace:
            return xo.T, acc[0], trace.permute(0, 2, 1)
        return xo.T, acc[0]


def fused_chain_sampler(dynamics: Dynamics, target, *,
                        compute_dtype=None) -> FusedChainSampler:
    """Whole-chain fused sampler for a spec-supported target (HMC mode runs
    as exact leapfrog with the nets skipped), with ``compute_dtype``
    operands. The JAX sampler's
    ``loop_traj`` (a fori_loop trajectory, on by default at dim >= 2048,
    where T unrolled copies overflowed the TPU's scoped VMEM) has no
    counterpart here: the CUDA chain kernel loops over T at run time at
    every width, so there is nothing to switch."""
    _check_supported(dynamics)
    return FusedChainSampler(dynamics, energy_spec_for_target(target), compute_dtype)
