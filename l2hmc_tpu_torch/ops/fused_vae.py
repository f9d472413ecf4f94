"""The VAE half of the fused kernels: the whole-chain posterior sampler and
the single-launch AIS (counterpart of the VAE section of
``l2hmc_tpu/ops/fused_dynamics.py``: ``_make_vae_chain_kernel`` /
``FusedVaeSampler`` and ``_make_vae_ais_kernel`` / ``FusedVaeAis``).

Two kernels, both in ``csrc/`` (see the notes at the top of each source):
  - ``vae_chain`` (``csrc/vae_chain.cu``): K MH steps of the L2HMC sampler on
    the decoder posterior U(z | x) = BCE(decoder(z), x) + |z|^2 / 2, with the
    decoder gradient and the aux-conditioned S/T/Q nets in the kernel,
    optionally the (K, D, N) trace and 1..max op compositions per recorded
    step. Public class ``FusedVaeSampler``.
  - ``vae_ais`` (``csrc/vae_ais.cu``): a whole annealed-importance-sampling
    chain per launch. Public class ``FusedVaeAis``.

Beside each is its plain PyTorch version (``vae_chain_plain``,
``vae_ais_plain``) on the same (D, N) layout with injectable draws. A
wrapper takes the plain version only for a CPU tensor; for a CUDA tensor it
launches the kernel or raises. Each launch adds one to
``fused_dynamics.LAUNCHES[name]``. Only float32 operands are ported: a
``compute_dtype`` other than float32 raises. The VAE training trajectory
and its VJP (``DifferentiableFusedVae``) are not ported yet.

Host prep follows the JAX package: the decoder enters transposed
(A = W.T, (out, in), biases as columns), the nets as ``_extract_net``'s 13
arrays, the aux embedding as an (H, N) input. The kernels read every
weight matrix with the reduction index slowest, so ``_pack_decoder`` hands
them the decoder in both layouts and ``_pack_net`` packs the three heads
side by side.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from l2hmc_tpu_torch.config import resolve_compute_dtype
from l2hmc_tpu_torch.dynamics.core import Dynamics
from l2hmc_tpu_torch.evals.ais import anneal_schedule
from l2hmc_tpu_torch.ops import _cuda
from l2hmc_tpu_torch.ops.fused_dynamics import (
    _MAX_SMEM,
    LAUNCHES,
    KernelInputs,
    _eps_col,
    _extract_net,
    mh_op,
)
from l2hmc_tpu_torch.ops.philox import chain_draws

_THREADS = 256  # threads per block of the VAE kernels (csrc/vae_common.cuh)
TILES = (4, 8)  # chain tiles the kernels are instantiated for


# -- host prep -------------------------------------------------------------------


def decoder_arrays(dec_params) -> list[torch.Tensor]:
    """[A1, B1, A2, B2, A3, B3] from the decoder's params tree: A = W.T
    (out, in), B = bias as a column."""
    lin1, _, lin2, _, lin3 = dec_params
    out = []
    for lin in (lin1, lin2, lin3):
        out += [lin["w"].detach().T, lin["b"].detach().reshape(-1, 1)]
    return out


def _vae_decoder_closures(dec_vals, x_raw):
    """(energy, grad_energy) of the decoder posterior on the transposed
    (D, N) layout; ``x_raw`` is (P, N). The gradient is one forward and one
    transposed sweep: dU/dz = J_dec(z)^T (sigmoid(logits) - x) + z."""
    A1, B1, A2, B2, A3, B3 = dec_vals

    def decoder(z):
        p1 = A1 @ z + B1
        p2 = A2 @ F.softplus(p1) + B2
        return p1, p2, A3 @ F.softplus(p2) + B3

    def grad_energy(z):
        p1, p2, logits = decoder(z)
        d3 = torch.sigmoid(logits) - x_raw
        d2 = (A3.T @ d3) * torch.sigmoid(p2)
        d1 = (A2.T @ d2) * torch.sigmoid(p1)
        return A1.T @ d1 + z

    def energy(z):
        logits = decoder(z)[2]
        bce = torch.sum(
            torch.clamp(logits, min=0.0) - logits * x_raw
            + torch.log1p(torch.exp(-torch.abs(logits))),
            dim=0, keepdim=True,
        )
        return bce + 0.5 * torch.sum(z * z, dim=0, keepdim=True)

    return energy, grad_energy


def prepare_vae(dyn: Dynamics, smp_params, dec_params, x_raw, emb) -> KernelInputs:
    """Everything the sampler kernel and its plain version read besides the
    chain state. ``x_raw`` is the (P, N) conditioning batch, ``emb`` its
    (H, N) aux embedding, both already transposed."""
    if dyn.hmc:
        raise ValueError("the fused VAE sampler needs the S/T/Q nets (hmc=False)")
    if dyn.eps_step or dyn.eps_mat or dyn.net_input_fn is not None or dyn.input_scale is not None:
        raise ValueError(
            "the fused VAE sampler does not support eps_step, eps_mat, net_input_fn "
            "or input_scale")
    device = x_raw.device
    dec = decoder_arrays(dec_params)
    energy, grad_energy = _vae_decoder_closures(dec, x_raw)
    return KernelInputs(
        eps=_eps_col(dyn.eps(smp_params), dyn.dim).to(device).detach(),
        masks=torch.as_tensor(dyn.masks.T.copy(), dtype=torch.float32, device=device),
        consts=dec,
        xnet_w=[w.detach() for w in _extract_net(smp_params["xnet"], dyn.times)],
        vnet_w=[w.detach() for w in _extract_net(smp_params["vnet"], dyn.times)],
        hmc=False,
        energy=energy,
        grad_energy=grad_energy,
        grad_vjp=None,
        emb=emb,
    )


def _flat(parts) -> torch.Tensor:
    return torch.cat([p.reshape(-1) for p in parts]).contiguous()


def _pack_decoder(dec_vals) -> list[torch.Tensor]:
    """The decoder in the kernels' order (csrc/vae_common.cuh,
    ``carve_decoder``): W (in, out) and bias per layer, then the three
    transposes (out, in)."""
    A1, B1, A2, B2, A3, B3 = dec_vals
    return [A1.T, B1, A2.T, B2, A3.T, B3, A1, A2, A3]


def _pack_net(w: list) -> list[torch.Tensor]:
    """One net in the kernels' order (``carve_net``), the three heads side
    by side as (H2, 3 D)."""
    w1, w2, wh, bh, ws, bs, ls, wt, bt, wq, bq, lq, te = w
    return [w1, w2, wh, bh, torch.cat([ws, wt, wq], dim=1), bs, ls, bt, bq, lq, te]


def chain_tile(n_chains: int, n_sms: int) -> int:
    """Chains per block. Both kernels are bound by the latency of one
    block's weight stream, which a tile of 8 lengthens by only a tenth over
    a tile of 4 (measured on an H100), so the rule is: tiles of 4 while they
    give every block an SM of its own, which spreads few chains over more
    SMs; tiles of 8 once tiles of 4 would have to share SMs."""
    return 4 if n_chains <= 4 * n_sms else 8


def _check_tile(tile: Optional[int], n: int, device) -> int:
    if tile is None:
        return chain_tile(n, torch.cuda.get_device_properties(device).multi_processor_count)
    if tile not in TILES:
        raise ValueError(f"tile must be one of {TILES}, got {tile}")
    return tile


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")


def _check_smem(floats: int) -> None:
    if 4 * floats > _MAX_SMEM:
        raise ValueError(
            f"a block's activations take {4 * floats} bytes of shared memory, "
            f"more than the {_MAX_SMEM} a block may use")


# -- plain versions ----------------------------------------------------------------


def vae_chain_plain(
    inp: KernelInputs, z, seed: int, n_mh_steps: int, collect_trace: bool = False,
    nb: Optional[Sequence[int]] = None, draws: Optional[Callable] = None,
):
    """Plain version of the sampler kernel on (D, N) state: per recorded
    step ``nb[step]`` (default 1) full MH ops, each with fresh momentum and
    its own accept. ``draws(step, op)`` gives (v (D, N), direction uniforms
    (N,), accept uniforms (N,)); by default the kernel's own Philox draws.
    Returns (z (D, N), accepted ops over ops run (1, N), trace (K, D, N) or
    None)."""
    D, N = z.shape
    if draws is None:
        def draws(step, op):
            return chain_draws(seed, N, D, step, z.device, op)

    accepted = torch.zeros_like(z[:1])
    ops = 0
    trace = (
        torch.empty((n_mh_steps, D, N), dtype=z.dtype, device=z.device)
        if collect_trace else None
    )
    for k in range(n_mh_steps):
        for j in range(1 if nb is None else int(nb[k])):
            z, acc = mh_op(inp, z, *draws(k, j))
            accepted = accepted + acc.to(z.dtype)
            ops += 1
        if trace is not None:
            trace[k] = z
    return z, accepted / ops, trace


def vae_ais_plain(
    dec_vals, x_raw, z0, seed: int, anneal_steps: int, step_size: float,
    leapfrogs: int, draws: Optional[Callable] = None,
):
    """Plain version of the AIS kernel on (D, N) state: per anneal step the
    weight update before the transition, fresh momentum, ``leapfrogs``
    plain leapfrog steps at the interpolated energy, an MH accept (a
    select). ``draws(step)`` gives (v (D, N), accept uniforms (N,)); by
    default the kernel's own Philox draws. Returns (log_w (1, N), mean
    acceptance probability (1, N))."""
    D, N = z0.shape
    if draws is None:
        def draws(step):
            v, _, u = chain_draws(seed, N, D, step, z0.device)
            return v, u

    e1, grad_e1 = _vae_decoder_closures(dec_vals, x_raw)

    def half_sq(a):
        return 0.5 * torch.sum(a * a, dim=0, keepdim=True)

    beta = anneal_schedule(anneal_steps)
    beta_diff = float(beta[1] - beta[0] if anneal_steps > 1 else beta[0])
    z = z0
    w = torch.zeros_like(z0[:1])
    acc_sum = torch.zeros_like(w)
    for i, b in enumerate(beta.tolist()):
        def grad_at(y, b=b):
            return (1.0 - b) * y + b * grad_e1(y)

        def energy_at(y, b=b):
            return (1.0 - b) * half_sq(y) + b * e1(y)

        w = w + beta_diff * (half_sq(z) - e1(z))
        v, u = draws(i)
        h0 = energy_at(z) + half_sq(v)
        Z, V = z, v
        g = grad_at(Z)
        for _ in range(leapfrogs):
            V = V - 0.5 * step_size * g
            Z = Z + step_size * V
            g = grad_at(Z)  # also the first gradient of the next step
            V = V - 0.5 * step_size * g
        h1 = energy_at(Z) + half_sq(V)
        px = torch.exp(torch.clamp(h0 - h1, max=0.0))
        px = torch.where(torch.isfinite(px), px, torch.zeros_like(px))
        z = torch.where(px - u[None, :] >= 0.0, Z, z)
        acc_sum = acc_sum + px
    return w, acc_sum * (1.0 / anneal_steps)


# -- wrappers ----------------------------------------------------------------------


def vae_chain(
    inp: KernelInputs, x_raw, z, seed: int, n_mh_steps: int,
    collect_trace: bool = False, nb: Optional[Sequence[int]] = None,
    tile: Optional[int] = None,
):
    """K MH steps of the VAE posterior sampler on (D, N) float32 state;
    returns what ``vae_chain_plain`` returns. CPU tensors take the plain
    version; CUDA tensors launch ``csrc/vae_chain.cu`` with ``tile`` chains
    per block (default: ``chain_tile``; the tests pick each instantiation)."""
    D, H, H2, T = inp.dims
    E, P = inp.consts[0].shape[0], inp.consts[4].shape[0]
    N = z.shape[1] if z.dim() == 2 else -1
    dev = inp.eps.device
    _check("z", z, (D, N), dev)
    _check("x_raw", x_raw, (P, N), dev)
    _check("emb", inp.emb, (H, N), dev)
    if n_mh_steps <= 0:
        raise ValueError("n_mh_steps must be positive")
    if nb is not None:
        nb = np.asarray(nb, np.int64)
        if nb.shape != (n_mh_steps,) or nb.min() < 1:
            raise ValueError("nb must hold one positive op count per recorded step")
    if z.device.type == "cpu":
        return vae_chain_plain(inp, z, seed, n_mh_steps, collect_trace, nb)
    if z.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {z.device}")
    C = _check_tile(tile, N, dev)
    _check_smem(C * (2 * E + P + H + H2 + _THREADS // 32 + 10 * D + 6))
    block = _flat([inp.eps, inp.masks, *_pack_decoder(inp.consts),
                   *_pack_net(inp.xnet_w), *_pack_net(inp.vnet_w)])
    nb_dev = None if nb is None else torch.as_tensor(nb, dtype=torch.int32, device=dev)
    zo = torch.empty_like(z)
    acc = torch.empty((1, N), dtype=torch.float32, device=dev)
    trace = (
        torch.empty((n_mh_steps, D, N), dtype=torch.float32, device=dev)
        if collect_trace else None
    )
    lib = _cuda.library("vae_chain")
    with torch.cuda.device(dev):
        err = lib.l2hmc_vae_chain(
            block.data_ptr(), D, H, H2, T, E, P, x_raw.data_ptr(), inp.emb.data_ptr(),
            z.data_ptr(), None if nb_dev is None else nb_dev.data_ptr(),
            zo.data_ptr(), acc.data_ptr(),
            None if trace is None else trace.data_ptr(),
            N, n_mh_steps, C, int(seed) & 0xFFFFFFFFFFFFFFFF,
            torch.cuda.current_stream().cuda_stream,
        )
    _cuda.check(err, "vae_chain")
    LAUNCHES["vae_chain"] += 1
    return zo, acc, trace


def vae_ais(
    dec_vals, x_raw, z0, seed: int, anneal_steps: int, step_size: float,
    leapfrogs: int, tile: Optional[int] = None,
):
    """A whole AIS chain on (D, N) float32 state; returns what
    ``vae_ais_plain`` returns. CPU tensors take the plain version; CUDA
    tensors launch ``csrc/vae_ais.cu``."""
    E, D = dec_vals[0].shape
    P = dec_vals[4].shape[0]
    N = z0.shape[1] if z0.dim() == 2 else -1
    dev = dec_vals[0].device
    _check("z0", z0, (D, N), dev)
    _check("x_raw", x_raw, (P, N), dev)
    if anneal_steps <= 0 or leapfrogs <= 0:
        raise ValueError("anneal_steps and leapfrogs must be positive")
    if z0.device.type == "cpu":
        return vae_ais_plain(dec_vals, x_raw, z0, seed, anneal_steps, step_size, leapfrogs)
    if z0.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {z0.device}")
    C = _check_tile(tile, N, dev)
    _check_smem(C * (2 * E + P + _THREADS // 32 + 5 * D + 5))
    block = _flat(_pack_decoder(dec_vals))
    beta = anneal_schedule(anneal_steps)
    beta_diff = float(beta[1] - beta[0] if anneal_steps > 1 else beta[0])
    beta_dev = torch.as_tensor(beta, device=dev)
    log_w = torch.empty((1, N), dtype=torch.float32, device=dev)
    acc = torch.empty((1, N), dtype=torch.float32, device=dev)
    lib = _cuda.library("vae_ais")
    with torch.cuda.device(dev):
        err = lib.l2hmc_vae_ais(
            block.data_ptr(), D, E, P, beta_dev.data_ptr(), x_raw.data_ptr(),
            z0.data_ptr(), log_w.data_ptr(), acc.data_ptr(),
            float(step_size), beta_diff, N, anneal_steps, leapfrogs, C,
            int(seed) & 0xFFFFFFFFFFFFFFFF, torch.cuda.current_stream().cuda_stream,
        )
    _cuda.check(err, "vae_ais")
    LAUNCHES["vae_ais"] += 1
    return log_w, acc


# -- public classes ----------------------------------------------------------------


def composition_counts(comp_key, n_mh_steps: int, max_composition: int) -> np.ndarray:
    """The ops per recorded step, 1..max_composition - 1 each: drawn from
    ``comp_key`` when it is a ``torch.Generator``, else ``comp_key`` itself
    as an explicit sequence."""
    if comp_key is None:
        raise ValueError("max_composition > 0 needs comp_key")
    if isinstance(comp_key, torch.Generator):
        nb = torch.randint(1, max_composition, (n_mh_steps,), generator=comp_key,
                           device=comp_key.device).cpu().numpy()
    else:
        nb = np.asarray(comp_key, np.int64)
    if nb.shape != (n_mh_steps,) or nb.min() < 1 or nb.max() >= max_composition:
        raise ValueError(
            f"need {n_mh_steps} op counts in 1..{max_composition - 1}")
    return nb


@dataclasses.dataclass(frozen=True)
class FusedVaeSampler:
    """Whole-chain fused sampler for the VAE posterior: one launch per
    ``run``, decoder energy and gradient in the kernel."""

    dynamics: Dynamics  # the VAE sampler dynamics (apps/vae.py build_dynamics)
    compute_dtype: str = ""

    def __post_init__(self):
        resolve_compute_dtype(self.compute_dtype or None)

    def run(
        self, smp_params, dec_params, x_raw, emb, z, seed: int, n_mh_steps: int, *,
        collect_trace: bool = False, max_composition: int = 0, comp_key=None,
    ):
        """Advance all chains ``n_mh_steps`` recorded steps; returns
        (z_final (n, D), mean acceptance (n,)) and, with ``collect_trace``,
        the (n_mh_steps, n, D) post-step history.

        ``x_raw`` is the (n, 784) conditioning batch (already tiled per
        chain), ``emb`` its (n, H) aux embedding. ``max_composition`` > 1
        applies nb ~ U{1..max_composition - 1} MH ops per recorded step,
        the nb sequence drawn from ``comp_key`` (a ``torch.Generator``) or
        given by it (a sequence), the same for every chain."""
        nb = None
        if max_composition - 1 > 0:
            nb = composition_counts(comp_key, n_mh_steps, max_composition)
        xr = x_raw.detach().T.contiguous()
        inp = prepare_vae(self.dynamics, smp_params, dec_params, xr,
                          emb.detach().T.contiguous())
        zo, acc, trace = vae_chain(
            inp, xr, z.detach().T.contiguous(), seed, n_mh_steps, collect_trace, nb,
        )
        if collect_trace:
            return zo.T, acc[0], trace.permute(0, 2, 1)
        return zo.T, acc[0]


@dataclasses.dataclass(frozen=True)
class FusedVaeAis:
    """Single-launch AIS for the VAE decoder log-likelihood protocol:
    ``run`` returns (log_w per chain, mean acceptance probability per
    chain); the caller applies the per-datapoint logmeanexp."""

    latent_dim: int
    compute_dtype: str = ""

    def __post_init__(self):
        resolve_compute_dtype(self.compute_dtype or None)

    def run(
        self, dec_params, x_raw, z0, seed: int, anneal_steps: int, step_size: float,
        leapfrogs: int = 10,
    ):
        if z0.shape[1] != self.latent_dim:
            raise ValueError(f"z0 must be (n, {self.latent_dim}), got {tuple(z0.shape)}")
        w, acc = vae_ais(
            decoder_arrays(dec_params), x_raw.detach().T.contiguous(),
            z0.detach().T.contiguous(), seed, anneal_steps, step_size, leapfrogs,
        )
        return w[0], acc[0]
