"""The S/T/Q (scale / translation / transformation) network
(counterpart of ``l2hmc_tpu/nets/stq.py``).

The net maps (primary, secondary, time_trig2, aux) -> [S, T, Q]: primary and
secondary are (n, dim) — (x, grad) for VNet, (v, masked x) for XNet —,
time_trig2 is the (n, 2) [cos, sin] time encoding, aux an optional input
(unused by the SCG nets: a constant zero).
"""

from __future__ import annotations

from typing import Optional

import torch

from l2hmc_tpu_torch.nets import core


def stq_net(
    dim: int,
    hidden: int,
    factor: float,
    *,
    out_factor: float = 0.001,
    embed_factor: float = 1.0 / 3,
    hidden2: Optional[int] = None,
    aux_module: Optional[core.Module] = None,
    compute_dtype=None,
) -> core.Module:
    """Zip-embed -> sum -> relu -> Linear(hidden, hidden2) -> relu ->
    Parallel[S=ScaleTanh(Linear), T=Linear, Q=ScaleTanh(Linear)]."""
    h2 = hidden2 if hidden2 is not None else hidden
    aux = aux_module if aux_module is not None else core.constant_zero()
    cd = compute_dtype
    return core.sequential(
        core.zip_modules(
            core.linear(dim, hidden, factor=embed_factor, compute_dtype=cd),
            core.linear(dim, hidden, factor=factor * embed_factor, compute_dtype=cd),
            core.linear(2, hidden, factor=embed_factor, compute_dtype=cd),
            aux,
        ),
        core.add_inputs(),
        core.activation(torch.relu),
        core.linear(hidden, h2, compute_dtype=cd),
        core.activation(torch.relu),
        core.parallel(
            core.sequential(
                core.linear(h2, dim, factor=out_factor, compute_dtype=cd),
                core.scale_tanh(dim),
            ),
            core.linear(h2, dim, factor=out_factor, compute_dtype=cd),
            core.sequential(
                core.linear(h2, dim, factor=out_factor, compute_dtype=cd),
                core.scale_tanh(dim),
            ),
        ),
    )


def scg_net_factory(
    dim: int, factor: float, hidden: int = 10, compute_dtype=None
) -> core.Module:
    """The notebook's ``network()`` (SCGExperiment.ipynb cell 3)."""
    return stq_net(
        dim, hidden, factor, out_factor=0.001, embed_factor=1.0 / 3,
        compute_dtype=compute_dtype,
    )
