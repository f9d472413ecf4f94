"""The port's dtype policy against the JAX package's ``config``: the
``Precision`` dataclass and ``resolve_compute_dtype`` case for case, and
the consumers that have no bfloat16 operands yet (the plain dense and conv
nets, ``ScgConfig`` and through it kernels 1-3) refusing them by
themselves, each naming ROADMAP B3."""

import jax.numpy as jnp
import pytest
import torch

from l2hmc_tpu import config as jconfig
from l2hmc_tpu_torch import config, targets
from l2hmc_tpu_torch.nets import core, lattice
from l2hmc_tpu_torch.ops import fused_dynamics as fd
from l2hmc_tpu_torch.train import ScgConfig, build_dynamics

CASES = [None, "float32", "bfloat16", "dtype", "Precision()", "BF16_PRECISION"]


def _spec(case, pkg):
    if case == "dtype":
        return jnp.bfloat16 if pkg is jconfig else torch.bfloat16
    if case == "Precision()":
        return pkg.Precision()
    if case == "BF16_PRECISION":
        return pkg.BF16_PRECISION
    return case


@pytest.mark.parametrize("case", CASES)
def test_resolve_compute_dtype_matches_jax(case):
    """None for float32 in every spelling, bfloat16 for "bfloat16", the
    dtype and ``BF16_PRECISION``: the JAX package's answer in torch's
    dtypes (its ``test_resolve_compute_dtype``)."""
    want = jconfig.resolve_compute_dtype(_spec(case, jconfig))
    got = config.resolve_compute_dtype(_spec(case, config))
    assert (got is None) == (want is None)
    if got is not None:
        assert got == torch.bfloat16 and want == jnp.bfloat16


def test_precision_matches_jax_fields():
    """The same fields with float32 defaults; BF16_PRECISION lowers only the
    products' operands."""
    assert [f for f in vars(config.Precision())] == [f for f in vars(jconfig.Precision())]
    p = config.BF16_PRECISION
    assert (p.param_dtype, p.compute_dtype, p.accum_dtype) == (
        torch.float32, torch.bfloat16, torch.float32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        config.resolve_compute_dtype("float16")


def test_unported_consumers_refuse_bf16_naming_b3():
    """The plain dense and conv layers and ``ScgConfig`` (the route to
    kernels 1-3, fused or not) raise for bfloat16 operands, each pointing
    at ROADMAP B3; float32 in any spelling goes through. Kernels 1-3's
    classes take no operand dtype at all."""
    for make in (lambda cd: core.linear(4, 3, compute_dtype=cd),
                 lambda cd: lattice.conv2d(1, 2, compute_dtype=cd),
                 lambda cd: ScgConfig(compute_dtype=cd),
                 lambda cd: ScgConfig(compute_dtype=cd, fused_train=True)):
        make("float32")
        with pytest.raises(NotImplementedError, match="B3"):
            make("bfloat16")
        with pytest.raises(NotImplementedError, match="B3"):
            make(config.BF16_PRECISION)
    tgt = targets.scg_gaussian()
    dyn, _ = build_dynamics(ScgConfig(T=2), tgt)
    spec = fd.energy_spec_for_target(tgt)
    for cls in (fd.FusedDynamics, fd.FusedChainSampler):
        cls(dyn, spec)
        with pytest.raises(TypeError, match="compute_dtype"):
            cls(dyn, spec, compute_dtype="bfloat16")
