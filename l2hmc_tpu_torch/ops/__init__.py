"""Fused CUDA kernels (counterpart of ``l2hmc_tpu/ops``)."""

from l2hmc_tpu_torch.ops.fused_dynamics import (
    LAUNCHES,
    FusedChainSampler,
    FusedDynamics,
    QuadraticGaussianEnergy,
    energy_spec_for_target,
    fused_chain_sampler,
    fused_for_target,
    reset_launch_counts,
)

__all__ = [
    "LAUNCHES",
    "FusedChainSampler",
    "FusedDynamics",
    "QuadraticGaussianEnergy",
    "energy_spec_for_target",
    "fused_chain_sampler",
    "fused_for_target",
    "reset_launch_counts",
]
