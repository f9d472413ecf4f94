"""Lattice-equivariant S/T/Q nets for field-theory targets (counterpart of
``l2hmc_tpu/nets/lattice.py``).

The S/T/Q map of a phi^4 lattice as a small CNN with circular padding:
every output is translation-equivariant by construction, as the lattice
action is under periodic boundary conditions. Same contract as
``nets.stq.stq_net``: apply(params, (primary, secondary, time_trig2, aux))
-> [S, T, Q], each (n, L*L), so the integrator, losses, sampler and trainer
are unchanged. The fused kernels take dense nets only; a conv net runs the
plain path.

The params tree keeps the JAX package's HWIO kernels (``(k, k, in, out)``),
so ``convert.params_from_jax`` carries it across as it is; ``apply``
permutes them to PyTorch's (out, in, k, k). The convolutions go through
cuDNN on the card, with TF32 off (``config``).

bfloat16 operands (``compute_dtype``): the JAX ``conv2d`` keeps float32
operands and asks for ``precision=DEFAULT``, on a TPU one bfloat16 pass
with float32 accumulation (on the CPU plain float32). Here the input and
the kernel are rounded to bfloat16 and the convolution runs in float32, so
the output is not rounded (a bfloat16 cuDNN convolution would round it,
which JAX's ``preferred_element_type=float32`` does not). The gradient is
the VJP of that rounding (the input's and the kernel's cotangents rounded);
a TPU's DEFAULT-precision transposed convolutions round the incoming
cotangent and the kernel instead (ROADMAP C). The time embedding's dense
map stays float32, as JAX's is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from l2hmc_tpu_torch.config import resolve_compute_dtype
from l2hmc_tpu_torch.nets.core import _TRUNC_STD, Module, Params, lowered, scale_tanh


def _trunc_normal(generator: torch.Generator, shape, std: float, device) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    return w.to(device)


def _conv_nchw(params: Params, x: torch.Tensor, pad: int, cd=None) -> torch.Tensor:
    """Circular-padded 'valid' convolution of (n, in, L, L) x with the HWIO
    kernel of ``params``, both operands lowered to ``cd``; (n, out, L, L)."""
    xp = F.pad(lowered(x, cd), (pad, pad, pad, pad), mode="circular")
    out = F.conv2d(xp, lowered(params["w"], cd).permute(3, 2, 0, 1))
    return out + params["b"][None, :, None, None]


def conv2d(in_ch: int, out_ch: int, kernel: int = 3, factor: float = 1.0,
           compute_dtype=None) -> Module:
    """kernel x kernel convolution with circular padding (periodic boundary
    conditions, Phi4Lattice's roll stencil), with the variance-scaling
    truncated-normal init of ``nets.core.linear`` (fan_in = kernel^2 in_ch).

    apply: (n, L, L, in_ch) -> (n, L, L, out_ch), as the JAX module; with
    ``compute_dtype`` bfloat16 both operands rounded, the sum in float32."""
    cd = resolve_compute_dtype(compute_dtype)
    std = (2.0 * factor / (kernel * kernel * in_ch)) ** 0.5 / _TRUNC_STD
    pad = kernel // 2

    def init(generator: torch.Generator, device) -> Params:
        return {
            "w": _trunc_normal(generator, (kernel, kernel, in_ch, out_ch), std, device),
            "b": torch.zeros((out_ch,), dtype=torch.float32, device=device),
        }

    def apply(params: Params, x: torch.Tensor) -> torch.Tensor:
        return _conv_nchw(params, x.permute(0, 3, 1, 2), pad, cd).permute(0, 2, 3, 1)

    return Module(init, apply)


def lattice_stq_net(
    L: int,
    channels: int,
    factor: float,
    *,
    out_factor: float = 0.001,
    embed_factor: float = 1.0 / 3,
    depth: int = 2,
    compute_dtype=None,
) -> Module:
    """Conv S/T/Q for an (L, L) periodic lattice flattened to dim = L*L: the
    dense net's stages (embed -> sum -> relu -> hidden -> relu -> 3 heads,
    S and Q ending in ScaleTanh) with each dense layer a circular conv and
    the time encoding a per-channel bias (a dense 2 -> channels map).
    ``factor`` scales the secondary input's embed init as in ``stq_net``.
    The activations stay (n, channels, L, L) between layers."""
    dim = L * L
    cd = resolve_compute_dtype(compute_dtype)
    embed_p = conv2d(1, channels, factor=embed_factor, compute_dtype=cd)
    embed_s = conv2d(1, channels, factor=factor * embed_factor, compute_dtype=cd)
    mids = [conv2d(channels, channels, compute_dtype=cd) for _ in range(depth)]
    heads = [conv2d(channels, 1, factor=out_factor, compute_dtype=cd) for _ in range(3)]
    st_s, st_q = scale_tanh(dim), scale_tanh(dim)
    t_std = (2.0 * embed_factor / 2) ** 0.5 / _TRUNC_STD

    def init(generator: torch.Generator, device) -> Params:
        # the JAX init's leaves in its order
        return {
            "embed_p": embed_p.init(generator, device),
            "embed_s": embed_s.init(generator, device),
            "time_w": _trunc_normal(generator, (2, channels), t_std, device),
            "mids": tuple(m.init(generator, device) for m in mids),
            "head_s": heads[0].init(generator, device),
            "head_t": heads[1].init(generator, device),
            "head_q": heads[2].init(generator, device),
            "st_s": st_s.init(generator, device),
            "st_q": st_q.init(generator, device),
        }

    def apply(params: Params, xs) -> list:
        primary, secondary, t, _aux = xs
        n = primary.shape[0]
        h = (_conv_nchw(params["embed_p"], primary.reshape(n, 1, L, L), 1, cd)
             + _conv_nchw(params["embed_s"], secondary.reshape(n, 1, L, L), 1, cd))
        h = torch.relu(h + (t @ params["time_w"])[:, :, None, None])
        for p in params["mids"]:
            h = torch.relu(_conv_nchw(p, h, 1, cd))
        s, tt, q = (_conv_nchw(params[k], h, 1, cd).reshape(n, dim)
                    for k in ("head_s", "head_t", "head_q"))
        return [st_s.apply(params["st_s"], s), tt, st_q.apply(params["st_q"], q)]

    return Module(init, apply)


def lattice_net_factory(L: int, factor: float, channels: int = 32, depth: int = 2,
                        compute_dtype=None) -> Module:
    """Conv S/T/Q factory with ``scg_net_factory``'s signature shape."""
    return lattice_stq_net(L, channels, factor, out_factor=0.001, embed_factor=1.0 / 3,
                           depth=depth, compute_dtype=compute_dtype)
