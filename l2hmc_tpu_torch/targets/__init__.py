"""Target distributions (counterpart of ``l2hmc_tpu/targets``)."""

from l2hmc_tpu_torch.targets.base import Target, batched_grad
from l2hmc_tpu_torch.targets.funnel import GaussianFunnel
from l2hmc_tpu_torch.targets.gaussian import (
    Gaussian,
    ill_conditioned_gaussian,
    quadratic_form,
    random_tilted_gaussian,
    scg_gaussian,
    tilted_gaussian,
)
from l2hmc_tpu_torch.targets.gmm import GMM, gen_ring, mog2
from l2hmc_tpu_torch.targets.lattice import Phi4Lattice
from l2hmc_tpu_torch.targets.rough_well import RoughWell
from l2hmc_tpu_torch.targets.transformed import Bijector, FunnelWhiten, TransformedTarget

__all__ = [
    "Bijector",
    "FunnelWhiten",
    "GMM",
    "Gaussian",
    "GaussianFunnel",
    "Phi4Lattice",
    "RoughWell",
    "Target",
    "TransformedTarget",
    "batched_grad",
    "gen_ring",
    "ill_conditioned_gaussian",
    "mog2",
    "quadratic_form",
    "random_tilted_gaussian",
    "scg_gaussian",
    "tilted_gaussian",
]
