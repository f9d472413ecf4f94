"""Profiling helpers (counterpart of ``l2hmc_tpu/utils/profiling.py``): a
``torch.profiler`` trace context and its summary, a steady-state time per
step, and a throughput counter that on the card times with CUDA events, so
the time is the device's, and on the CPU with the host clock."""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Callable, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """``torch.profiler`` trace of the block, CPU and (where there is a card)
    CUDA activity, written as a Chrome trace ``<logdir>/trace.json``; a no-op
    when ``logdir`` is None. View it in Perfetto or chrome://tracing."""
    if logdir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


TOP_KERNELS = 5  # kernel names trace_summary lists


def trace_summary(path: str) -> Optional[dict]:
    """The device's activity over the CUDA-graph replays of a Chrome trace
    written by ``trace``: from the first ``cudaGraphLaunch`` to the end of
    the last kernel, the window and the time some kernel ran (ms), their
    ratio (the busy share), the kernels per replay, and the ``TOP_KERNELS``
    kernel names' shares of the busy time. None when the trace holds no
    replay."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launches = [e["ts"] for e in events if e.get("name") == "cudaGraphLaunch"]
    if not launches:
        return None
    start = min(launches)
    kernels = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
                     if e.get("cat") == "kernel" and e["ts"] >= start)
    if not kernels:
        return None
    busy, run_start, run_end = 0.0, kernels[0][0], kernels[0][1]
    by_name: dict = {}
    for s, e, name in kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        if s > run_end:
            busy += run_end - run_start
            run_start = s
        run_end = max(run_end, e)
    busy += run_end - run_start
    window = max(e for _, e, _ in kernels) - start
    total = sum(by_name.values())
    return {
        "replays": len(launches),
        "window_ms": window / 1e3,
        "busy_ms": busy / 1e3,
        "busy_share": busy / window,
        "kernels_per_replay": len(kernels) / len(launches),
        "top_kernels": {n[:80]: d / total for n, d in
                        sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]},
    }


def steady_ms(run: Callable[[int], Any], short: int, long: int, device="cuda") -> float:
    """Host ms per step of ``run(n_steps)`` at steady state: the time of a
    ``long``-step run less that of a ``short``-step one, over ``long -
    short``, so what each run does once (a captured route's warm-up steps
    and recording, its first chunk's draws) cancels. One untimed ``short``
    run first takes the process's one-time set-up at these shapes. Each run
    is timed from an idle device to an idle device."""
    cuda = torch.device(device).type == "cuda"

    def timed(n: int) -> float:
        if cuda:
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        run(n)
        if cuda:
            torch.cuda.synchronize(device)
        return time.perf_counter() - t

    run(short)
    t_short = timed(short)
    return 1e3 * (timed(long) - t_short) / (long - short)


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
