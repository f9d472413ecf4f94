"""CUDA-graph capture: the port's counterpart of the JAX package's jitted
``lax.scan`` bodies (its training chunk and its sampling chain).

A body is a function of no arguments that reads and writes only tensors made
before its first call (static buffers: the state it advances in place, the
draws it reads, the outputs it writes). It must copy nothing from the host,
synchronise nothing and branch on no tensor on the host; kernels must launch
on ``torch.cuda.current_stream()``.
"""

from __future__ import annotations

from typing import Callable

import torch

from l2hmc_tpu_torch.ops.fused_dynamics import LAUNCHES

# eager calls of a body before it is recorded: the libraries' lazy set-up
# (cuBLAS handles and workspaces, the wrappers' per-device caches) happens
# in them, and capture rejects it
WARMUP_CALLS = 2


def run_on_side_stream(body: Callable[[], None]) -> None:
    """Runs ``body`` eagerly on a side stream ordered after and before the
    current one, as a warm-up call before recording must."""
    current = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(current)
    with torch.cuda.stream(side):
        body()
    current.wait_stream(side)


class Graph:
    """``body`` recorded once as a CUDA graph; ``replay`` runs it.

    Recording launches nothing, so the kernel launches the wrappers count
    while ``body`` is recorded are taken back out of ``LAUNCHES``, and each
    replay adds them again: the counts stay those of kernels run on the
    card. The body is not kept. A capture that fails raises.
    """

    def __init__(self, body: Callable[[], None]):
        before = dict(LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph):
                body()
        finally:
            recorded = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            LAUNCHES.update(before)
        self.launches = {k: n for k, n in recorded.items() if n}

    def replay(self) -> None:
        self.graph.replay()
        for name, n in self.launches.items():
            LAUNCHES[name] += n
