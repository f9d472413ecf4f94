"""Throughput counter (counterpart of ``l2hmc_tpu/utils/profiling.py``'s
``Throughput``). On the card it times with CUDA events, so the time is the
device's; on the CPU with the host clock."""

from __future__ import annotations

import time

import torch


class Throughput:
    """Steps/sec and chain-leapfrog-steps/sec of a sampling loop.

    Construct just before the timed work, then call ``tick(n_steps)`` after
    each dispatched chunk; ``tick`` waits for the device.
    """

    def __init__(self, n_chains: int, leapfrogs_per_step: int, device="cuda"):
        self.n_chains = n_chains
        self.leapfrogs_per_step = leapfrogs_per_step
        self.steps = 0
        self._cuda = torch.device(device).type == "cuda"
        if self._cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record()
        self._t0 = time.perf_counter()
        self._elapsed = 0.0

    def tick(self, n_steps: int) -> None:
        self.steps += n_steps
        if self._cuda:
            self._end.record()
            self._end.synchronize()
            self._elapsed = self._start.elapsed_time(self._end) / 1e3
        else:
            self._elapsed = time.perf_counter() - self._t0

    @property
    def elapsed(self) -> float:
        """Seconds from construction to the last ``tick``."""
        return self._elapsed

    @property
    def steps_per_sec(self) -> float:
        return self.steps / max(self.elapsed, 1e-9)

    @property
    def leapfrogs_per_sec(self) -> float:
        """Chain-leapfrog steps per second."""
        return self.steps_per_sec * self.leapfrogs_per_step * self.n_chains
