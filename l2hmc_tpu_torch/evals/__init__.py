"""Sampler-quality metrics (counterpart of ``l2hmc_tpu/evals``; ESS only so far)."""

from l2hmc_tpu_torch.evals.metrics import acl_spectrum, autocovariance, ess, ess_per_step

__all__ = ["acl_spectrum", "autocovariance", "ess", "ess_per_step"]
