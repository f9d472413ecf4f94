"""The port's dtype policy against the JAX package's ``config``: the
``Precision`` dataclass and ``resolve_compute_dtype`` case for case, and
every consumer of ``compute_dtype`` taking bfloat16 and float32 (the plain
dense and conv nets, ``ScgConfig``, kernels 1 and 3's classes and
factories, ``prepare``)."""

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


def test_consumers_take_bf16_and_f32():
    """Every consumer takes bfloat16 in each spelling and float32: the dense
    and conv layers lower their operands (their bf16 output differs from
    float32's, their params stay float32), ``ScgConfig`` (plain and fused)
    builds nets that do, and kernels 1 and 3's classes and factories carry
    the dtype into ``prepare`` (``KernelInputs.cd``), float32 by default;
    an unknown dtype raises."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((8, 4), generator=gen)
    lin = {cd: core.linear(4, 3, compute_dtype=cd) for cd in (None, "bfloat16")}
    p = lin[None].init(torch.Generator().manual_seed(1), "cpu")
    assert p["w"].dtype == torch.float32
    assert not torch.equal(lin["bfloat16"].apply(p, x), lin[None].apply(p, x))
    xi = torch.randn((2, 4, 4, 1), generator=gen)
    conv = {cd: lattice.conv2d(1, 2, compute_dtype=cd) for cd in (None, "bfloat16")}
    pc = conv[None].init(torch.Generator().manual_seed(2), "cpu")
    assert not torch.equal(conv["bfloat16"].apply(pc, xi), conv[None].apply(pc, xi))
    tgt = targets.scg_gaussian()
    spec = fd.energy_spec_for_target(tgt)
    for cd in ("float32", "bfloat16", config.BF16_PRECISION, torch.bfloat16):
        core.linear(4, 3, compute_dtype=cd)
        lattice.conv2d(1, 2, compute_dtype=cd)
        want = config.resolve_compute_dtype(cd)
        for fused in (False, True):
            dyn, _ = build_dynamics(ScgConfig(T=2, compute_dtype=cd, fused_train=fused), tgt)
        params = dyn.init_params(torch.Generator().manual_seed(0), device="cpu")
        for obj in (fd.FusedDynamics(dyn, spec, compute_dtype=cd),
                    fd.FusedChainSampler(dyn, spec, compute_dtype=cd),
                    fd.fused_for_target(dyn, tgt, compute_dtype=cd),
                    fd.fused_chain_sampler(dyn, tgt, compute_dtype=cd),
                    fd.differentiable_fused(dyn, tgt, compute_dtype=cd).fused):
            assert fd.prepare(dyn, spec, params, "cpu",
                              compute_dtype=obj.compute_dtype).cd == want
    dyn, _ = build_dynamics(ScgConfig(T=2), tgt)
    for obj in (fd.FusedDynamics(dyn, spec), fd.fused_chain_sampler(dyn, tgt)):
        assert obj.compute_dtype is None
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        core.linear(4, 3, compute_dtype="float16")
