"""MH sampling (counterpart of ``l2hmc_tpu/mcmc``; the sampler only so far)."""

from l2hmc_tpu_torch.mcmc.sampler import (
    ProposeOut,
    metropolis,
    metropolis_mask,
    propose,
)

__all__ = ["ProposeOut", "metropolis", "metropolis_mask", "propose"]
