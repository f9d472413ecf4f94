"""The SCG experiment (counterpart of ``l2hmc_tpu/train``; sampling and
evaluation only so far)."""

from l2hmc_tpu_torch.train.scg import (
    ScgConfig,
    build_dynamics,
    evaluate_ess,
    evaluate_trained,
    hmc_sample_chain,
    sample_chain,
)

__all__ = [
    "ScgConfig",
    "build_dynamics",
    "evaluate_ess",
    "evaluate_trained",
    "hmc_sample_chain",
    "sample_chain",
]
