"""bfloat16 operands with float32 accumulation in the plain versions of the
VAE kernels: the counterpart of the JAX package's ``_dot_in``
(``l2hmc_tpu/ops/fused_dynamics.py:151``), which lowers both operands of a
net or decoder product to bfloat16 and accumulates in float32.

``lower(t, cd)`` rounds ``t`` to ``cd`` (round to nearest even) and back
to ``t``'s own dtype, so a product of two lowered operands is exact in
float32 (and in float64, where the tests differentiate) and only the sum
rounds. torch's own bfloat16 matmul is not used: on the CPU it returns
bfloat16 and so rounds the accumulation too.

``dot(w, x, cd)`` is the forward product ``lower(w) @ lower(x)``. Its
autograd backward follows JAX's VJP of ``astype(bf16)``: the cotangent of
the activation ``x`` is rounded, ``lower(lower(w).T @ g)``; the cotangent
of the weight ``w`` stays float32, ``g @ lower(x).T``. JAX rounds that one
too, but per product, substep and JAX tile, which a kernel that sums its
clusters at the end cannot reproduce (ROADMAP C, "Deliberate divergences").
``dot_ct(w, g, cd)`` is that activation cotangent, ``lower(lower(w) @ g)``,
for the hand-written VJPs. With ``cd`` None all three are the plain float32
operations.
"""

from __future__ import annotations

from typing import Optional

import torch

from l2hmc_tpu_torch.nets.core import lowered as lower


class _Dot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, x, cd):
        wl, xl = lower(w, cd), lower(x, cd)
        ctx.save_for_backward(wl, xl)
        ctx.cd = cd
        return wl @ xl

    @staticmethod
    def backward(ctx, g):
        wl, xl = ctx.saved_tensors
        gw = g @ xl.T if ctx.needs_input_grad[0] else None
        gx = lower(wl.T @ g, ctx.cd) if ctx.needs_input_grad[1] else None
        return gw, gx, None


def dot(w: torch.Tensor, x: torch.Tensor, cd: Optional[torch.dtype]) -> torch.Tensor:
    """``w @ x`` with both operands lowered to ``cd`` and the sum in ``w``'s
    dtype; the activation ``x``'s cotangent is rounded, ``w``'s is not."""
    return w @ x if cd is None else _Dot.apply(w, x, cd)


def dot_ct(w: torch.Tensor, g: torch.Tensor, cd: Optional[torch.dtype]) -> torch.Tensor:
    """An activation's cotangent through a lowered product with weight
    ``w``: ``lower(w) @ g`` (``g`` as it is), rounded to ``cd``."""
    return w @ g if cd is None else lower(lower(w, cd) @ g, cd)
