"""The VAE half of the fused kernels: the whole-chain posterior sampler, the
single-launch AIS, and the training trajectory with its VJP (counterpart of
the VAE section of ``l2hmc_tpu/ops/fused_dynamics.py``:
``_make_vae_chain_kernel`` / ``FusedVaeSampler``, ``_make_vae_ais_kernel`` /
``FusedVaeAis``, ``_make_vae_traj_kernel`` and ``_make_vae_bwd_kernel`` /
``DifferentiableFusedVae``).

Four kernels, all in ``csrc/`` (see the notes at the top of each source):
  - ``vae_chain`` (``csrc/vae_chain.cu``): K MH steps of the L2HMC sampler on
    the decoder posterior U(z | x) = BCE(decoder(z), x) + |z|^2 / 2, with the
    decoder gradient and the aux-conditioned S/T/Q nets in the kernel,
    optionally the (K, D, N) trace and 1..max op compositions per recorded
    step, on a tile of chains shared by a thread-block cluster
    (``csrc/vae_cluster.cuh``), one configuration, ``CHAIN_CLUSTER``; the
    source reports what the host allocates (``chain_sizes``). Public class
    ``FusedVaeSampler``.
  - ``vae_ais`` (``csrc/vae_ais.cu``): a whole annealed-importance-sampling
    chain per launch, on clusters of CTAs that share one multicast weight
    stream (``csrc/vae_stream.cuh``), one configuration, ``AIS_TILE``.
    Public class ``FusedVaeAis``.
  - ``vae_traj`` (``csrc/vae_traj.cu``): one T-step trajectory on the decoder
    posterior, forward or reverse, and ``vae_traj_bwd``
    (``csrc/vae_traj_bwd.cu``): its vector-Jacobian product with the
    decoder's Hessian-vector products in the kernel and the weight and eps
    cotangents summed over chains. Both run a tile of Ct chains on a
    thread-block cluster of G CTAs (``csrc/vae_cluster.cuh``), one
    configuration, ``CLUSTER``; each source reports what the host allocates
    for it (``kernel_sizes``). Public class
    ``DifferentiableFusedVae``, the training path, whose
    ``torch.autograd.Function`` launches the first forward and the second
    backward.

Beside each is its plain PyTorch version (``vae_chain_plain``,
``vae_ais_plain``, ``vae_trajectory_plain``, ``vae_trajectory_vjp_plain``)
on the same (D, N) layout, with injectable draws where it draws. A wrapper
takes the plain version only for a CPU tensor; for a CUDA tensor it
launches the kernel or raises. Each launch adds one to
``fused_dynamics.LAUNCHES[name]``, and a launch of a bfloat16 instantiation
also to ``LAUNCHES[name:bf16]``.

Operands: float32, or with ``compute_dtype="bfloat16"`` (``prepare_vae``,
the three classes) the JAX package's bf16 recipe: every S/T/Q and decoder
product rounds both operands to bfloat16 and sums in float32, and
everything else (params, biases, eps, energies, logdet, the accept) stays
float32. The plain versions round through ``ops.operands``; each kernel has
a bfloat16 instantiation that reads the weights as bfloat16 (cast once per
launch by the wrapper) and rounds each product's activations where they are
written for a product to read. The VJP rounds every activation cotangent of
a product, and keeps the weight cotangents in float32 (``ops.operands``).

Host prep follows the JAX package: the decoder enters transposed
(A = W.T, (out, in), biases as columns), the nets as ``_extract_net``'s 13
arrays, the aux embedding as an (H, N) input. The AIS kernel streams every
weight matrix with the reduction index slowest, so ``_pack_decoder`` copies
the decoder into one block in both layouts. The sampler and the training
kernels take a pointer to each array instead (``_weight_ptrs``): the decoder
in the params tree's own (in, out) layout, which A.T is, so nothing is
copied per launch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
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
    _trajectory_vjp_plain,
    _with_tensors,
    mh_op,
    trajectory_plain,
)
from l2hmc_tpu_torch.ops.operands import dot, dot_ct
from l2hmc_tpu_torch.ops.philox import chain_draws

_THREADS = 256  # threads per CTA of the VAE kernels (csrc/vae_common.cuh)
# (chains per CTA kC, CTAs per cluster kG) of the AIS kernel, and its ring
# of weight chunks: slots, floats per slot, floats a row group may read past
# a chunk (csrc/vae_stream.cuh)
AIS_TILE = (8, 2)
_AIS_SLOTS, _AIS_SLOT_FLOATS, _AIS_SLOT_PAD = 2, 16384, 4
# (chains per cluster Ct, CTAs per cluster G) of the training kernels, as
# kCt, kG in csrc/vae_cluster.cuh
CLUSTER = (40, 8)
# (chains per cluster Ct, CTAs per cluster G) of the sampler kernel, as
# kChainCt, kChainG in csrc/vae_chain.cu, and its [Ct] arrays (kChainVecs)
CHAIN_CLUSTER = (16, 8)
_CHAIN_VECS = 8
_KC = 32  # reduction rows per staged chunk of a cluster product (vae_cluster.cuh)


# -- host prep -------------------------------------------------------------------


def decoder_arrays(dec_params) -> list[torch.Tensor]:
    """[A1, B1, A2, B2, A3, B3] from the decoder's params tree: A = W.T
    (out, in), B = bias as a column."""
    lin1, _, lin2, _, lin3 = dec_params
    out = []
    for lin in (lin1, lin2, lin3):
        out += [lin["w"].detach().T, lin["b"].detach().reshape(-1, 1)]
    return out


def _vae_decoder_closures(dec_vals, x_raw, cd=None):
    """(energy, grad_energy) of the decoder posterior on the transposed
    (D, N) layout; ``x_raw`` is (P, N). The gradient is one forward and one
    transposed sweep: dU/dz = J_dec(z)^T (sigmoid(logits) - x) + z. ``cd``
    lowers the six products' operands (``ops.operands``)."""
    A1, B1, A2, B2, A3, B3 = dec_vals

    def decoder(z):
        p1 = dot(A1, z, cd) + B1
        p2 = dot(A2, F.softplus(p1), cd) + B2
        return p1, p2, dot(A3, F.softplus(p2), cd) + B3

    def grad_energy(z):
        p1, p2, logits = decoder(z)
        d3 = torch.sigmoid(logits) - x_raw
        d2 = dot(A3.T, d3, cd) * torch.sigmoid(p2)
        d1 = dot(A2.T, d2, cd) * torch.sigmoid(p1)
        return dot(A1.T, d1, cd) + z

    def energy(z):
        logits = decoder(z)[2]
        bce = torch.sum(
            torch.clamp(logits, min=0.0) - logits * x_raw
            + torch.log1p(torch.exp(-torch.abs(logits))),
            dim=0, keepdim=True,
        )
        return bce + 0.5 * torch.sum(z * z, dim=0, keepdim=True)

    return energy, grad_energy


def build_grad_vjp(dec_vals, x_raw, cd=None):
    """VJP of the decoder posterior's ``grad_energy``: (z, u) -> H(z) u with
    H the Hessian of the energy, which is symmetric. The forward sweep of
    the decoder carries the tangent of u beside the primal, the transposed
    sweep the tangent of the gradient (softplus'' = sigmoid (1 - sigmoid)).
    With ``cd`` the primal products lower their operands and each tangent
    product is the cotangent of a lowered product's activation, rounded
    (``ops.operands``): the VJP of ``grad_energy``'s own rounding."""
    A1, B1, A2, B2, A3, B3 = dec_vals

    def grad_vjp(z, u):
        p1 = dot(A1, z, cd) + B1
        s1 = torch.sigmoid(p1)
        t1 = s1 * dot_ct(A1, u, cd)  # tangent of softplus(p1)
        p2 = dot(A2, F.softplus(p1), cd) + B2
        s2 = torch.sigmoid(p2)
        t2 = s2 * dot_ct(A2, t1, cd)
        sl = torch.sigmoid(dot(A3, F.softplus(p2), cd) + B3)
        a2 = dot(A3.T, sl - x_raw, cd)
        a1 = dot(A2.T, a2 * s2, cd)
        dd3 = sl * (1.0 - sl) * dot_ct(A3, t2, cd)
        dd2 = dot_ct(A3.T, dd3, cd) * s2 + a2 * (1.0 - s2) * t2
        dd1 = dot_ct(A2.T, dd2, cd) * s1 + a1 * (1.0 - s1) * t1
        return dot_ct(A1.T, dd1, cd) + u

    return grad_vjp


def prepare_vae(dyn: Dynamics, smp_params, dec_params, x_raw, emb, *,
                differentiable: bool = False, compute_dtype=None) -> KernelInputs:
    """Everything the VAE kernels and their plain versions read besides the
    chain state. ``x_raw`` is the (P, N) conditioning batch, ``emb`` its
    (H, N) aux embedding, both already transposed. The nets, eps and the
    embedding are detached unless ``differentiable`` (the training path,
    where they keep their autograd history back to the params tree); the
    decoder and ``x_raw`` are always detached. ``compute_dtype`` (as
    ``config.resolve_compute_dtype`` takes it) is the products' operand
    dtype; the params stay float32."""
    if dyn.hmc:
        raise ValueError("the fused VAE sampler needs the S/T/Q nets (hmc=False)")
    if dyn.eps_step or dyn.eps_mat or dyn.net_input_fn is not None or dyn.input_scale is not None:
        raise ValueError(
            "the fused VAE sampler does not support eps_step, eps_mat, net_input_fn "
            "or input_scale")
    device = x_raw.device
    x_raw = x_raw.detach()
    cd = resolve_compute_dtype(compute_dtype)
    dec = decoder_arrays(dec_params)
    energy, grad_energy = _vae_decoder_closures(dec, x_raw, cd)
    eps = _eps_col(dyn.eps(smp_params), dyn.dim).to(device)
    xnet_w = _extract_net(smp_params["xnet"], dyn.times)
    vnet_w = _extract_net(smp_params["vnet"], dyn.times)
    if not differentiable:
        eps, emb = eps.detach(), emb.detach()
        xnet_w = [w.detach() for w in xnet_w]
        vnet_w = [w.detach() for w in vnet_w]
    return KernelInputs(
        eps=eps,
        masks=torch.as_tensor(dyn.masks.T.copy(), dtype=torch.float32, device=device),
        consts=dec,
        xnet_w=xnet_w,
        vnet_w=vnet_w,
        hmc=False,
        energy=energy,
        grad_energy=grad_energy,
        grad_vjp=build_grad_vjp(dec, x_raw, cd),
        emb=emb,
        cd=cd,
    )


def _pad16(n: int, item: int) -> int:
    """``n`` elements of ``item`` bytes rounded up to whole 16 bytes."""
    per = 16 // item
    return -(-n // per) * per


def _pack_decoder(dec_vals, cd=None) -> list[torch.Tensor]:
    """The decoder in the kernels' order (csrc/vae_common.cuh,
    ``carve_decoder``): W (in, out) and bias per layer, then the three
    transposes (out, in), each flattened and padded with zeros to whole 16
    bytes, so that every array starts on 16 bytes of the block (the AIS
    kernel streams them with bulk copies). With ``cd`` the six matrices are
    cast to it; the biases stay float32."""
    A1, B1, A2, B2, A3, B3 = dec_vals
    out = []
    for i, a in enumerate((A1.T, B1, A2.T, B2, A3.T, B3, A1, A2, A3)):
        flat = a.reshape(-1)
        if cd is not None and (i % 2 == 0 or i > 5):
            flat = flat.to(cd)
        out.append(F.pad(flat, (0, _pad16(flat.numel(), flat.element_size()) - flat.numel())))
    return out


def _byte_block(parts) -> torch.Tensor:
    """Arrays of mixed dtypes, each a whole number of 16 bytes, as one fresh
    (16-byte aligned) block of bytes."""
    return torch.cat([p.contiguous().view(torch.uint8) for p in parts])


# The AIS kernel's weight stream (csrc/vae_stream.cuh), mirrored for the
# tests on the CPU; the wrapper takes the source's own figures
# (``ais_sizes``), and the card tests hold the two equal. ``item`` is the
# bytes of a streamed weight: 4 (float32) or 2 (bfloat16).


def _chunk_rows(M: int, item: int = 4) -> int:
    """Rows of an M-wide k-major matrix per chunk (``chunk_rows``): as many
    as a slot's bytes hold, with rows x M whole 16 bytes."""
    per = 16 // item
    step = per // math.gcd(M, per)
    return (4 * _AIS_SLOT_FLOATS // item // M) // step * step


def ais_chunk_plan(D: int, E: int, P: int, item: int = 4) -> list[dict]:
    """One decoder sweep of the AIS kernel's weight stream as the source
    plans it: per product, in the order ``decoder_grad`` runs them, its
    matrix's offset in the packed decoder block (``_pack_decoder``; in
    weights of ``item`` bytes, the block's float32 biases counted by their
    bytes) and padded extent, K rows of M weights, the rows per chunk
    ``kc``, and its chunks as (first row, rows, byte offset in the block,
    bytes), each one bulk copy from the L2."""
    sizes = [D * E, E, E * E, E, E * P, P, E * D, E * E, P * E]
    nbytes = [4 * _pad16(n, 4) if i in (1, 3, 5) else item * _pad16(n, item)
              for i, n in enumerate(sizes)]
    offsets = np.concatenate([[0], np.cumsum(nbytes)]) // item
    plan = []
    # (name, index in the packed block, K, M): W1, W2, W3 forward, then
    # the transposes of the sweep back
    for name, idx, K, M in (("W1", 0, D, E), ("W2", 2, E, E), ("W3", 4, E, P),
                            ("W3t", 8, P, E), ("W2t", 7, E, E), ("W1t", 6, E, D)):
        kc = _chunk_rows(M, item)
        chunks = []
        for k0 in range(0, K, kc) if kc > 0 else ():
            rows = min(kc, K - k0)
            chunks.append((k0, rows, item * (int(offsets[idx]) + k0 * M),
                           item * _pad16(rows * M, item)))
        plan.append({"name": name, "offset": int(offsets[idx]),
                     "extent": _pad16(sizes[idx], item), "K": K, "M": M, "kc": kc,
                     "chunks": chunks})
    return plan


def ais_smem_bytes(D: int, E: int, P: int) -> int:
    """Shared-memory bytes of one CTA of the AIS kernel (``ais_smem_bytes``
    in csrc/vae_ais.cu): the ring (a full and an empty mbarrier per slot,
    the slots), the decoder's two hidden layers, its output cotangent and a
    sum's partials for kC chains, five [D][kC] and five [kC] arrays."""
    C = AIS_TILE[0]
    ring = 16 * _AIS_SLOTS + 4 * _AIS_SLOTS * (_AIS_SLOT_FLOATS + _AIS_SLOT_PAD)
    return ring + 4 * (C * (2 * E + P + _THREADS // 32) + C * (5 * D + 5))


def ais_sizes(dims, n: int) -> dict:
    """What the AIS kernel needs for ``n`` chains at ``dims`` = (D, E, P),
    as its source reckons it (``l2hmc_vae_ais_sizes``): chains per CTA
    ``c``, CTAs per cluster ``g``, shared-memory bytes per CTA, ring slots,
    floats per slot and the launch's CTAs."""
    out = (ctypes.c_longlong * 6)()
    err = _cuda.library("vae_ais").l2hmc_vae_ais_sizes(*dims, n, out)
    _cuda.check(err, "vae_ais sizes")
    return dict(zip(("c", "g", "smem_bytes", "slots", "slot_floats", "ctas"), out[:]))


def ais_max_clusters(dims) -> int:
    """How many clusters of the AIS kernel the card holds at once at
    ``dims`` = (D, E, P) (CUDA's occupancy query); a negative CUDA error
    code if it fails."""
    return _cuda.library("vae_ais").l2hmc_vae_ais_clusters(*dims)


def ais_l2_bytes(D: int, E: int, P: int, n: int, anneal_steps: int, leapfrogs: int,
                 item: int = 4) -> int:
    """Weight bytes one AIS launch reads from the L2, reckoned: every
    cluster streams the decoder's chunks (both layouts, weights of ``item``
    bytes) once per sweep, K L + 1 sweeps."""
    C, G = AIS_TILE
    clusters = _slice(_slice(n, C), G)
    sweep = sum(b for prod in ais_chunk_plan(D, E, P, item) for _, _, _, b in prod["chunks"])
    return clusters * (anneal_steps * leapfrogs + 1) * sweep


# The shared memory per CTA as the two training sources carve it, mirrored
# for the tests on the CPU; the wrappers take the sources' own figure
# (``kernel_sizes``), and the card tests hold the two equal.


def _slice(m: int, g: int) -> int:
    return -(-m // g)


def _slice4(m: int, g: int) -> int:
    """The decoder's split (``slice_rows4``): rows per CTA rounded up to a
    multiple of 4, so that each CTA's rows start on a 16-byte boundary."""
    return -(-_slice(m, g) // 4) * 4


def _ring_floats(ct: int) -> int:
    """The ring of a cluster product with ct columns (``ring_floats``): three
    weight slots, each a chunk of 128 rows staged [32][128 + 4] or
    [128][32 + 4], and three input chunks [32][ct]."""
    return 3 * (max(_KC * (128 + 4), 128 * (_KC + 4)) + _KC * ct)


def traj_smem_floats(ct, g, D, H, H2, E, P) -> int:
    """Shared-memory floats of one CTA of the trajectory kernel (as
    ``traj_floats`` in csrc/vae_traj.cu): the decoder's hidden layers and
    the net's on the CTA's rows, eight latent state arrays, the log-det
    partial and the product's ring."""
    return (ct * (2 * _slice4(E, g) + _slice(H, g) + _slice(H2, g) + 8 * _slice(D, g) + 1)
            + _ring_floats(ct))


_BWD_STATE_ARRAYS = 22  # [Dg][Ct] arrays of the backward kernel (kStateArrays)


def bwd_smem_floats(ct, g, D, H, H2, E, P) -> int:
    """Shared-memory floats of one CTA of the backward kernel (as
    ``bwd_floats`` in csrc/vae_traj_bwd.cu): the ring of the widest product
    (or a whole operand of an outer product), the region that the sweeps
    with a tangent share with the other activations, the latent state and
    cotangent arrays, the two [Dg][2 Ct] arrays of a sweep with a tangent,
    the embedding's cotangent and dld. The region is rounded up to 4
    floats: the arrays after it take 16-byte copies."""
    Dg, Hg, H2g = (_slice(m, g) for m in (D, H, H2))
    Eg = _slice4(E, g)
    stage = max(_ring_floats(2 * ct), max(H, H2, D) * ct)
    region = -(-max(2 * ct * 2 * Eg,
                    ct * (2 * Eg + Hg + H2g) + (ct + 1) * (Hg + H2g + 3 * Dg)) // 4) * 4
    return stage + region + ct * (_BWD_STATE_ARRAYS * Dg + 4 * Dg + Hg + 1)


def chain_smem_floats(ct, g, D, H, H2, E, P) -> int:
    """Shared-memory floats of one CTA of the sampler kernel (as
    ``chain_floats`` in csrc/vae_chain.cu): the decoder's hidden layers and
    the net's on the CTA's rows, ten latent state arrays, its [Ct] arrays
    and the product's ring."""
    return (ct * (2 * _slice4(E, g) + _slice(H, g) + _slice(H2, g) + 10 * _slice(D, g)
                  + _CHAIN_VECS)
            + _ring_floats(ct))


def chain_sizes(dims, n: int) -> dict:
    """What the sampler kernel needs for ``n`` chains at ``dims`` = (D, H,
    H2, T, E, P), as its source reckons it (``l2hmc_vae_chain_sizes``): its
    cluster configuration ``ct``, ``g``, the shared-memory bytes per CTA,
    the floats of its activation scratch ``act`` and the launch's CTAs."""
    out = (ctypes.c_longlong * 5)()
    _cuda.library("vae_chain").l2hmc_vae_chain_sizes(*dims, n, out)
    return dict(zip(("ct", "g", "smem_bytes", "act", "ctas"), out[:]))


def chain_max_clusters(dims) -> int:
    """How many clusters of the sampler kernel the card holds at once at
    ``dims`` = (D, H, H2, T, E, P) (CUDA's occupancy query); a negative CUDA
    error code if it fails."""
    return _cuda.library("vae_chain").l2hmc_vae_chain_clusters(*dims)


def weight_l2_bytes(ct, N, D, H, H2, T, E, P, item: int = 4) -> tuple[int, int]:
    """Weight bytes one trajectory launch reads from the L2 (the decoder,
    the nets; weights of ``item`` bytes): every cluster reads each weight
    once per product, the decoder's three matrices twice per gradient
    (forward and transposed), T + 1 gradients and 4 T net applications. The
    backward kernel reads twice as much: the pass forward, then the sweeps
    with a tangent and the nets' transposed products."""
    clusters = -(-N // ct)
    dec = item * 2 * (D * E + E * E + E * P) * (T + 1)
    net = item * (2 * D * H + H * H2 + 3 * H2 * D) * 4 * T
    return clusters * dec, clusters * net


def max_clusters(dims, backward: bool) -> int:
    """How many clusters the card holds at once for one of the two training
    kernels at ``dims`` = (D, H, H2, T, E, P) (CUDA's occupancy query); a
    negative CUDA error code if it fails."""
    name = "vae_traj_bwd" if backward else "vae_traj"
    return getattr(_cuda.library(name), f"l2hmc_{name}_clusters")(*dims)


def kernel_sizes(name: str, dims, n: int) -> dict:
    """What the training kernel ``name`` (``vae_traj`` or ``vae_traj_bwd``)
    needs for ``n`` chains at ``dims`` = (D, H, H2, T, E, P), as its source
    reckons it (``l2hmc_<name>_sizes``): its cluster configuration ``ct``,
    ``g``, the shared-memory bytes per CTA and the floats of each device
    scratch (``act``; the backward kernel's ``partial`` and ``bnd`` too)."""
    out = (ctypes.c_longlong * 6)()
    getattr(_cuda.library(name), f"l2hmc_{name}_sizes")(*dims, n, out)
    keys = ("ct", "g", "smem_bytes", "act", "partial", "bnd")
    return dict(zip(keys, out[:4] if name == "vae_traj" else out[:]))


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
    leapfrogs: int, draws: Optional[Callable] = None, compute_dtype=None,
):
    """Plain version of the AIS kernel on (D, N) state: per anneal step the
    weight update before the transition, fresh momentum, ``leapfrogs``
    plain leapfrog steps at the interpolated energy, an MH accept (a
    select). ``draws(step)`` gives (v (D, N), accept uniforms (N,)); by
    default the kernel's own Philox draws. ``compute_dtype`` lowers the
    decoder products' operands. Returns (log_w (1, N), mean acceptance
    probability (1, N))."""
    D, N = z0.shape
    if draws is None:
        def draws(step):
            v, _, u = chain_draws(seed, N, D, step, z0.device)
            return v, u

    e1, grad_e1 = _vae_decoder_closures(dec_vals, x_raw, resolve_compute_dtype(compute_dtype))

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


def vae_trajectory_plain(inp: KernelInputs, z, v, reverse: bool):
    """Plain version of the trajectory kernel on the decoder posterior:
    (D, N) z, v -> (Z, V, logdet (1, N)); ``inp`` from ``prepare_vae``."""
    return trajectory_plain(inp, z, v, reverse)


def vae_trajectory_vjp_plain(inp: KernelInputs, z, v, dZ, dV, dld, reverse: bool):
    """Plain version of the backward kernel: the VJP of
    ``vae_trajectory_plain`` at (z, v) for the cotangents dZ, dV (D, N) and
    dld (1, N). Returns (xnet grads (13), vnet grads (13), deps (D, 1),
    demb (H, N), dz (D, N), dv (D, N)); the weight and eps cotangents are
    summed over chains. The decoder and x_raw get none."""
    gx, gv, deps, dz, dv, demb = _trajectory_vjp_plain(inp, z, v, dZ, dV, dld, reverse)
    return gx, gv, deps, demb, dz, dv


# -- wrappers ----------------------------------------------------------------------


LAUNCHES.update({f"{k}:bf16": 0 for k in ("vae_chain", "vae_ais", "vae_traj", "vae_traj_bwd")})


def _count(name: str, cd) -> None:
    LAUNCHES[name] += 1
    if cd is not None:
        LAUNCHES[f"{name}:bf16"] += 1


# the arrays of ``_weight_ptrs`` that are products' weights: the decoder's
# three W, each net's w1, w2, wh, ws, wt, wq (``_extract_net``'s 0, 1, 2, 4,
# 7, 9)
_MATRICES = frozenset([2, 4, 6, *(8 + n * 13 + i for n in (0, 1) for i in (0, 1, 2, 4, 7, 9))])


def _bf16(cd) -> int:
    """The entry points' operand flag: 1 for bfloat16, 0 for float32."""
    return int(cd is not None)


def vae_chain(
    inp: KernelInputs, x_raw, z, seed: int, n_mh_steps: int,
    collect_trace: bool = False, nb: Optional[Sequence[int]] = None,
):
    """K MH steps of the VAE posterior sampler on (D, N) float32 state;
    returns what ``vae_chain_plain`` returns. CPU tensors take the plain
    version; CUDA tensors launch ``csrc/vae_chain.cu`` (clusters of
    ``CHAIN_CLUSTER[1]`` CTAs sharing ``CHAIN_CLUSTER[0]`` chains), its
    bfloat16 instantiation where ``inp.cd`` is bfloat16."""
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
    sizes = chain_sizes((D, H, H2, T, E, P), N)
    _check_smem(sizes["smem_bytes"] // 4)
    ptrs, _keep = _weight_ptrs(inp, dev)
    nb_dev = None if nb is None else torch.as_tensor(nb, dtype=torch.int32, device=dev)
    zo = torch.empty_like(z)
    acc = torch.empty((1, N), dtype=torch.float32, device=dev)
    trace = (
        torch.empty((n_mh_steps, D, N), dtype=torch.float32, device=dev)
        if collect_trace else None
    )
    act = torch.empty(sizes["act"], dtype=torch.float32, device=dev)
    lib = _cuda.library("vae_chain")
    with torch.cuda.device(dev):
        err = lib.l2hmc_vae_chain(
            ptrs, D, H, H2, T, E, P, x_raw.data_ptr(), inp.emb.data_ptr(),
            z.data_ptr(), None if nb_dev is None else nb_dev.data_ptr(),
            zo.data_ptr(), acc.data_ptr(),
            None if trace is None else trace.data_ptr(), act.data_ptr(),
            N, n_mh_steps, int(seed) & 0xFFFFFFFFFFFFFFFF, _bf16(inp.cd),
            torch.cuda.current_stream().cuda_stream,
        )
    _cuda.check(err, "vae_chain")
    _count("vae_chain", inp.cd)
    return zo, acc, trace


def vae_ais(
    dec_vals, x_raw, z0, seed: int, anneal_steps: int, step_size: float,
    leapfrogs: int, compute_dtype=None,
):
    """A whole AIS chain on (D, N) float32 state; returns what
    ``vae_ais_plain`` returns. CPU tensors take the plain version; CUDA
    tensors launch ``csrc/vae_ais.cu`` (clusters of ``AIS_TILE[1]`` CTAs
    with ``AIS_TILE[0]`` chains each, sharing one weight stream), its
    bfloat16 instantiation for a bfloat16 ``compute_dtype``, whose stream
    carries the decoder's matrices in bfloat16."""
    E, D = dec_vals[0].shape
    P = dec_vals[4].shape[0]
    N = z0.shape[1] if z0.dim() == 2 else -1
    dev = dec_vals[0].device
    _check("z0", z0, (D, N), dev)
    _check("x_raw", x_raw, (P, N), dev)
    if anneal_steps <= 0 or leapfrogs <= 0:
        raise ValueError("anneal_steps and leapfrogs must be positive")
    cd = resolve_compute_dtype(compute_dtype)
    if z0.device.type == "cpu":
        return vae_ais_plain(dec_vals, x_raw, z0, seed, anneal_steps, step_size, leapfrogs,
                             compute_dtype=cd)
    if z0.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {z0.device}")
    _check_smem(ais_sizes((D, E, P), N)["smem_bytes"] // 4)
    block = _byte_block(_pack_decoder(dec_vals, cd))  # a fresh allocation: 16-byte aligned
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
            float(step_size), beta_diff, N, anneal_steps, leapfrogs,
            int(seed) & 0xFFFFFFFFFFFFFFFF, _bf16(cd), torch.cuda.current_stream().cuda_stream,
        )
    _cuda.check(err, "vae_ais")
    _count("vae_ais", cd)
    return log_w, acc


def _net_sizes(D, H, H2, T) -> list[int]:
    """Sizes of one net's arrays in the backward kernel's cotangent order:
    ``_extract_net``'s 13 with the three heads side by side as (H2, 3 D)."""
    return [D * H, D * H, H * H2, H2, H2 * 3 * D, D, D, D, D, D, H * T]


def _unpack_net_grads(flat: torch.Tensor, D, H, H2, T) -> list[torch.Tensor]:
    """One net's cotangents from the kernel's packed order back to
    ``_extract_net``'s 13 arrays."""
    w1, w2, wh, bh, wo, bs, ls, bt, bq, lq, te = torch.split(flat, _net_sizes(D, H, H2, T))
    wo = wo.view(H2, 3 * D)

    def col(a):
        return a.view(-1, 1)

    return [w1.view(D, H), w2.view(D, H), wh.view(H, H2), col(bh),
            wo[:, :D], col(bs), col(ls), wo[:, D:2 * D], col(bt),
            wo[:, 2 * D:], col(bq), col(lq), te.view(H, T)]


def _traj_args(inp: KernelInputs, x_raw, z, v):
    """Shapes checked for the two trajectory wrappers; returns
    (D, H, H2, T, E, P, N)."""
    D, H, H2, T = inp.dims
    E, P = inp.consts[0].shape[0], inp.consts[4].shape[0]
    N = z.shape[1] if z.dim() == 2 else -1
    dev = inp.eps.device
    _check("z", z, (D, N), dev)
    _check("v", v, (D, N), dev)
    _check("x_raw", x_raw, (P, N), dev)
    _check("emb", inp.emb, (H, N), dev)
    return D, H, H2, T, E, P, N


def _weight_ptrs(inp: KernelInputs, dev):
    """The cluster kernels' weights as a host array of device pointers
    (``carve_weights`` in csrc/vae_cluster.cuh): eps, masks, the decoder's
    W (in, out) and bias per layer, then each net's 13 arrays. W is A.T, the
    params tree's own tensor, and the other arrays are already contiguous,
    so ``contiguous`` copies nothing but eps (a broadcast column of D
    floats). With ``inp.cd`` the products' weight matrices are cast to it,
    once per launch; the params stay float32. Returns the array and the
    tensors it points into."""
    A1, B1, A2, B2, A3, B3 = inp.consts
    arrays = [inp.eps, inp.masks, A1.T, B1, A2.T, B2, A3.T, B3,
              *inp.xnet_w, *inp.vnet_w]
    arrays = [a.detach().contiguous() for a in arrays]
    for a in arrays:
        _check("weight", a, a.shape, dev)
    if inp.cd is not None:
        arrays = [a.to(inp.cd) if i in _MATRICES else a for i, a in enumerate(arrays)]
    return (ctypes.c_void_p * len(arrays))(*(a.data_ptr() for a in arrays)), arrays


def vae_trajectory(inp: KernelInputs, x_raw, z, v, reverse: bool):
    """One T-step trajectory on the decoder posterior on (D, N) float32
    state; returns what ``vae_trajectory_plain`` returns. CPU tensors take
    the plain version; CUDA tensors launch ``csrc/vae_traj.cu``, its
    bfloat16 instantiation where ``inp.cd`` is bfloat16."""
    D, H, H2, T, E, P, N = _traj_args(inp, x_raw, z, v)
    if z.device.type == "cpu":
        return vae_trajectory_plain(inp, z, v, reverse)
    if z.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {z.device}")
    dev = z.device
    sizes = kernel_sizes("vae_traj", (D, H, H2, T, E, P), N)
    _check_smem(sizes["smem_bytes"] // 4)
    ptrs, _keep = _weight_ptrs(inp, dev)
    zo, vo = torch.empty_like(z), torch.empty_like(v)
    ld = torch.empty((1, N), dtype=torch.float32, device=dev)
    act = torch.empty(sizes["act"], dtype=torch.float32, device=dev)
    lib = _cuda.library("vae_traj")
    with torch.cuda.device(dev):
        err = lib.l2hmc_vae_traj(
            ptrs, D, H, H2, T, E, P, x_raw.data_ptr(), inp.emb.data_ptr(),
            z.data_ptr(), v.data_ptr(), zo.data_ptr(), vo.data_ptr(), ld.data_ptr(),
            act.data_ptr(), N, int(reverse), _bf16(inp.cd),
            torch.cuda.current_stream().cuda_stream,
        )
    _cuda.check(err, "vae_traj")
    _count("vae_traj", inp.cd)
    return zo, vo, ld


def vae_trajectory_vjp(inp: KernelInputs, x_raw, z, v, dZ, dV, dld, reverse: bool):
    """VJP of the fused VAE trajectory at (D, N) float32 (z, v) for the
    cotangents dZ, dV (D, N) and dld (1, N); returns what
    ``vae_trajectory_vjp_plain`` returns. CPU tensors take the plain
    version; CUDA tensors launch ``csrc/vae_traj_bwd.cu`` (its bfloat16
    instantiation where ``inp.cd`` is bfloat16): each cluster adds its
    chains' weight and eps cotangents into its own slice of a per-cluster
    scratch, and a second kernel sums the slices in a fixed order."""
    D, H, H2, T, E, P, N = _traj_args(inp, x_raw, z, v)
    dev = inp.eps.device
    _check("dZ", dZ, (D, N), dev)
    _check("dV", dV, (D, N), dev)
    _check("dld", dld, (1, N), dev)
    if z.device.type == "cpu":
        return vae_trajectory_vjp_plain(inp, z, v, dZ, dV, dld, reverse)
    if z.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {z.device}")
    sizes = kernel_sizes("vae_traj_bwd", (D, H, H2, T, E, P), N)
    _check_smem(sizes["smem_bytes"] // 4)
    ptrs, _keep = _weight_ptrs(inp, dev)
    nf = sum(_net_sizes(D, H, H2, T))
    grads = torch.empty(2 * nf + D, dtype=torch.float32, device=dev)
    partial, bnd, act = (torch.empty(sizes[k], dtype=torch.float32, device=dev)
                         for k in ("partial", "bnd", "act"))
    dz, dv = torch.empty_like(z), torch.empty_like(v)
    demb = torch.empty_like(inp.emb)
    lib = _cuda.library("vae_traj_bwd")
    with torch.cuda.device(dev):
        err = lib.l2hmc_vae_traj_bwd(
            ptrs, D, H, H2, T, E, P, x_raw.data_ptr(), inp.emb.data_ptr(),
            z.data_ptr(), v.data_ptr(), dZ.data_ptr(), dV.data_ptr(), dld.data_ptr(),
            dz.data_ptr(), dv.data_ptr(), demb.data_ptr(), grads.data_ptr(),
            partial.data_ptr(), bnd.data_ptr(), act.data_ptr(), N, int(reverse),
            _bf16(inp.cd), torch.cuda.current_stream().cuda_stream,
        )
    _cuda.check(err, "vae_traj_bwd")
    _count("vae_traj_bwd", inp.cd)
    gx = _unpack_net_grads(grads[:nf], D, H, H2, T)
    gv = _unpack_net_grads(grads[nf:2 * nf], D, H, H2, T)
    return gx, gv, grads[2 * nf:].view(D, 1), demb, dz, dv


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
    ``run``, decoder energy and gradient in the kernel. ``compute_dtype``
    "bfloat16" lowers the nets' and the decoder's product operands."""

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
                          emb.detach().T.contiguous(), compute_dtype=self.compute_dtype or None)
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
    chain); the caller applies the per-datapoint logmeanexp.
    ``compute_dtype`` "bfloat16" lowers the decoder products' operands."""

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
            self.compute_dtype or None,
        )
        return w[0], acc[0]


class _VaeTrajectory(torch.autograd.Function):
    """The fused VAE trajectory as one autograd node whose boundary is the
    kernels': eps (D, 1), emb (H, N), z, v (D, N) and the 13 + 13 net
    weights. Forward runs ``vae_trajectory``, backward
    ``vae_trajectory_vjp``; the decoder and x_raw ride along in ``inp`` and
    get no cotangent."""

    @staticmethod
    def forward(ctx, inp: KernelInputs, x_raw, reverse: bool, eps, emb, z, v, *weights):
        ctx.inp = dataclasses.replace(inp, eps=None, emb=None, xnet_w=[], vnet_w=[])
        ctx.x_raw = x_raw
        ctx.reverse = reverse
        ctx.save_for_backward(eps, emb, z, v, *weights)
        full = dataclasses.replace(_with_tensors(inp, eps, weights), emb=emb)
        return vae_trajectory(full, x_raw, z, v, reverse)

    @staticmethod
    def backward(ctx, dZ, dV, dld):
        eps, emb, z, v, *weights = ctx.saved_tensors
        inp = dataclasses.replace(_with_tensors(ctx.inp, eps, weights), emb=emb)
        gx, gv, deps, demb, dz, dv = vae_trajectory_vjp(
            inp, ctx.x_raw, z, v, dZ.contiguous(), dV.contiguous(), dld.contiguous(),
            ctx.reverse,
        )
        return (None, None, None, deps, demb, dz, dv, *gx, *gv)


@dataclasses.dataclass(frozen=True)
class DifferentiableFusedVae:
    """Training-path fused trajectories for the VAE posterior sampler: the
    surface ``mcmc.propose`` reads (``forward``, ``backward``, ``p_accept``,
    ``energy``, ``eps``, ``hmc``) on (n, D) state with
    ``aux = {"raw", "emb", "dec"}`` as ``apps/vae.py`` hands it. One
    forward and one backward kernel launch per trajectory. Gradients reach
    the S/T/Q nets and alpha (through ``_extract_net``'s folds and
    ``eps = exp(alpha)``) and the aux encoder (through ``emb``) by ordinary
    autograd outside the boundary; the decoder and the raw batch are
    detached, as the sampler loss stops their gradient. ``p_accept`` and
    ``energy`` stay on the plain ``Dynamics`` (float32, as in the JAX
    package). ``compute_dtype`` "bfloat16" lowers the trajectories' product
    operands, forward and backward."""

    dynamics: Dynamics  # apps/vae.py build_dynamics
    compute_dtype: str = ""
    hmc: bool = dataclasses.field(default=False, init=False)

    def __post_init__(self):
        resolve_compute_dtype(self.compute_dtype or None)
        if self.dynamics.hmc:
            raise ValueError("the fused VAE trajectory needs the S/T/Q nets (hmc=False)")

    @property
    def energy(self):
        return self.dynamics.energy

    def eps(self, params):
        return self.dynamics.eps(params)

    def p_accept(self, params, x0, v0, x1, v1, log_jac, aux=None):
        return self.dynamics.p_accept(params, x0, v0, x1, v1, log_jac, aux=aux)

    def forward(self, params, z, v, aux=None):
        return self._run(params, z, v, aux, reverse=False)

    def backward(self, params, z, v, aux=None):
        return self._run(params, z, v, aux, reverse=True)

    def _run(self, params, z, v, aux, reverse: bool):
        x_raw = aux["raw"].detach().T.contiguous()
        inp = prepare_vae(self.dynamics, params, aux["dec"], x_raw,
                          aux["emb"].T.contiguous(), differentiable=True,
                          compute_dtype=self.compute_dtype or None)
        Z, V, ld = _VaeTrajectory.apply(
            inp, x_raw, reverse, inp.eps, inp.emb, z.T.contiguous(), v.T.contiguous(),
            *inp.xnet_w, *inp.vnet_w,
        )
        return Z.T, V.T, ld[0]
