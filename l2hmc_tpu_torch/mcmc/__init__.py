"""MH sampling, parallel tempering and the training losses (counterpart of
``l2hmc_tpu/mcmc``)."""

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
from l2hmc_tpu_torch.mcmc.tempering import (
    geometric_temps,
    pt_hmc_sample_chain,
    pt_sample_chain,
    swap_step,
)

__all__ = [
    "ProposeOut",
    "chain_operator",
    "geometric_temps",
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
    "pt_hmc_sample_chain",
    "pt_sample_chain",
    "scg_joint_loss",
    "swap_step",
]
