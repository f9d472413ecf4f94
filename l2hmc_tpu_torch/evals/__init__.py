"""Sampler-quality metrics and AIS (counterpart of ``l2hmc_tpu/evals``)."""

from l2hmc_tpu_torch.evals.ais import ais_estimate, standard_normal_energy
from l2hmc_tpu_torch.evals.metrics import acl_spectrum, autocovariance, ess, ess_per_step

__all__ = [
    "acl_spectrum",
    "ais_estimate",
    "autocovariance",
    "ess",
    "ess_per_step",
    "standard_normal_energy",
]
