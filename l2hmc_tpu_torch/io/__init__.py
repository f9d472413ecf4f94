"""Metrics output and checkpoints (counterpart of ``l2hmc_tpu/io``)."""

from l2hmc_tpu_torch.io.checkpoint import (
    config_from_dict,
    load_config,
    restore_checkpoint,
    save_checkpoint,
)
from l2hmc_tpu_torch.io.metrics_writer import MetricsWriter

__all__ = [
    "MetricsWriter",
    "config_from_dict",
    "load_config",
    "restore_checkpoint",
    "save_checkpoint",
]
