"""S/T/Q networks (counterpart of ``l2hmc_tpu/nets``): dense and lattice conv nets."""

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
from l2hmc_tpu_torch.nets.lattice import conv2d, lattice_net_factory, lattice_stq_net
from l2hmc_tpu_torch.nets.stq import scg_net_factory, stq_net, vae_net_factory

__all__ = [
    "Module",
    "activation",
    "add_inputs",
    "constant_zero",
    "conv2d",
    "lattice_net_factory",
    "lattice_stq_net",
    "linear",
    "parallel",
    "scale_tanh",
    "scg_net_factory",
    "sequential",
    "stq_net",
    "vae_net_factory",
    "zip_modules",
]
