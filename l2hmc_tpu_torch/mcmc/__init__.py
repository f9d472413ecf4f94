"""MH sampling and the training losses (counterpart of ``l2hmc_tpu/mcmc``;
tempering is not ported yet)."""

from l2hmc_tpu_torch.mcmc.losses import (
    get_loss,
    loss_inverse,
    loss_logsumexp,
    loss_mixed,
    loss_mixed_per_dim,
    loss_std,
    loss_vec,
    scg_joint_loss,
)
from l2hmc_tpu_torch.mcmc.sampler import (
    ProposeOut,
    chain_operator,
    metropolis,
    metropolis_mask,
    propose,
    propose_draws,
)

__all__ = [
    "ProposeOut",
    "chain_operator",
    "get_loss",
    "loss_inverse",
    "loss_logsumexp",
    "loss_mixed",
    "loss_mixed_per_dim",
    "loss_std",
    "loss_vec",
    "metropolis",
    "metropolis_mask",
    "propose",
    "propose_draws",
    "scg_joint_loss",
]
