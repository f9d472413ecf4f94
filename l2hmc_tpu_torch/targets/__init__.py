"""Target distributions (counterpart of ``l2hmc_tpu/targets``; Gaussian family
only so far)."""

from l2hmc_tpu_torch.targets.base import Target, batched_grad
from l2hmc_tpu_torch.targets.gaussian import (
    Gaussian,
    ill_conditioned_gaussian,
    quadratic_form,
    random_tilted_gaussian,
    scg_gaussian,
)

__all__ = [
    "Gaussian",
    "Target",
    "batched_grad",
    "ill_conditioned_gaussian",
    "quadratic_form",
    "random_tilted_gaussian",
    "scg_gaussian",
]
