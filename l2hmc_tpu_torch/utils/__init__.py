"""Utilities (counterpart of ``l2hmc_tpu/utils``): the profiler trace, the
steady-state step time, the throughput counter, and CUDA-graph capture (``utils.capture``)."""

from l2hmc_tpu_torch.utils.profiling import Throughput, steady_ms, trace, trace_summary

__all__ = ["Throughput", "steady_ms", "trace", "trace_summary"]
