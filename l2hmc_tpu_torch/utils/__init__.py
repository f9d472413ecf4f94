"""Utilities (counterpart of ``l2hmc_tpu/utils``; ``Throughput`` only so far)."""

from l2hmc_tpu_torch.utils.profiling import Throughput

__all__ = ["Throughput"]
