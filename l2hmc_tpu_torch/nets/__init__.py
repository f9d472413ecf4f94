"""S/T/Q networks (counterpart of ``l2hmc_tpu/nets``; dense nets only so far)."""

from l2hmc_tpu_torch.nets.core import (
    Module,
    activation,
    add_inputs,
    constant_zero,
    linear,
    parallel,
    scale_tanh,
    sequential,
    zip_modules,
)
from l2hmc_tpu_torch.nets.stq import scg_net_factory, stq_net

__all__ = [
    "Module",
    "activation",
    "add_inputs",
    "constant_zero",
    "linear",
    "parallel",
    "scale_tanh",
    "scg_net_factory",
    "sequential",
    "stq_net",
    "zip_modules",
]
