"""Metrics output (counterpart of ``l2hmc_tpu/io``; checkpointing is not
ported yet)."""

from l2hmc_tpu_torch.io.metrics_writer import MetricsWriter

__all__ = ["MetricsWriter"]
