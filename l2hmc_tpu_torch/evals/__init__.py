"""Sampler-quality metrics and AIS (counterpart of ``l2hmc_tpu/evals``)."""

from l2hmc_tpu_torch.evals.ais import ais_estimate, standard_normal_energy
from l2hmc_tpu_torch.evals.metrics import (
    accept_numpy,
    acl_spectrum,
    autocovariance,
    ess,
    ess_per_step,
    gaussian_log_likelihood,
    normal_kl,
    numerical_jacobian,
)

__all__ = [
    "accept_numpy",
    "acl_spectrum",
    "ais_estimate",
    "autocovariance",
    "ess",
    "ess_per_step",
    "gaussian_log_likelihood",
    "normal_kl",
    "numerical_jacobian",
    "standard_normal_energy",
]
