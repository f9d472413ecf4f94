"""Fused CUDA kernels (counterpart of ``l2hmc_tpu/ops``)."""

from l2hmc_tpu_torch.ops.fused_dynamics import (
    LAUNCHES,
    DifferentiableFusedDynamics,
    FunnelEnergy,
    FusedChainSampler,
    FusedDynamics,
    GmmEnergy,
    QuadraticGaussianEnergy,
    RoughWellEnergy,
    differentiable_fused,
    energy_spec_for_target,
    fused_chain_sampler,
    fused_for_target,
    reset_launch_counts,
)
from l2hmc_tpu_torch.ops.fused_vae import DifferentiableFusedVae, FusedVaeAis, FusedVaeSampler

__all__ = [
    "LAUNCHES",
    "DifferentiableFusedDynamics",
    "DifferentiableFusedVae",
    "FunnelEnergy",
    "FusedChainSampler",
    "FusedDynamics",
    "FusedVaeAis",
    "FusedVaeSampler",
    "GmmEnergy",
    "QuadraticGaussianEnergy",
    "RoughWellEnergy",
    "differentiable_fused",
    "energy_spec_for_target",
    "fused_chain_sampler",
    "fused_for_target",
    "reset_launch_counts",
]
