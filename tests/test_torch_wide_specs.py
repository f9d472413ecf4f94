"""The rough well, the mixtures and the funnel past 64 wide on the CPU, the
widths at which kernels 1-3 run them on their site-parallel configuration
(``csrc/l2hmc_sites.cuh``): the plain trajectory, its hand-derived VJP and
the plain chain (the versions each kernel is held to on the card) against
the JAX package's Pallas kernels in interpret mode, at dim 72 (the rough
well, easy and hard; the funnel, chains past its clip; a two-component
mixture) and at hidden 72 (the ring); the chain kernel's refusal check on
the configurations that run these specs past 64; and the host mirror of the
specs' prelude in shared memory against the sources."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from l2hmc_tpu import targets as jtargets
from l2hmc_tpu.ops import fused_dynamics as jfd
from l2hmc_tpu.train import ScgConfig as JaxScgConfig
from l2hmc_tpu.train import build_dynamics as jax_build_dynamics
from l2hmc_tpu_torch import targets
from l2hmc_tpu_torch.apps import suite
from l2hmc_tpu_torch.convert import params_from_jax
from l2hmc_tpu_torch.ops import fused_dynamics as fd
from l2hmc_tpu_torch.ops.philox import box_muller
from l2hmc_tpu_torch.train import ScgConfig, build_dynamics
from l2hmc_tpu_torch.train.optim import tree_leaves, tree_unflatten

N, TILE = 16, 8  # chains, and the JAX kernels' tile: two tiles
# Outputs and gradients per leaf within TOL of the leaf's largest entry:
# float32 sums over 72 sites and 16 chains in another order (the JAX
# package's own fused-vs-XLA tolerance is 2e-4 on states).
TOL = 2e-4
CSRC = Path(fd.__file__).resolve().parent.parent / "csrc"


def _jax_mixture(dim):
    m = suite.two_component_mixture(dim)
    return jtargets.GMM(m.mus, m.sigmas, m.pis)


# name -> (JAX target, port target, hidden, eps, weight lift), T = 2
# substeps each. The hard rough well (freq = eps^2: a gradient of amplitude
# 10 at a period of 0.06) at a step of 0.01, where float32 rounding stays
# small.
T = 2
CASES = {
    "rough_well_easy_D72": (lambda: jtargets.RoughWell(dim=72, eps=0.1, easy=True),
                            lambda: targets.RoughWell(dim=72, eps=0.1, easy=True), 8, 0.05,
                            0.003),
    "rough_well_hard_D72": (lambda: jtargets.RoughWell(dim=72, eps=0.1),
                            lambda: targets.RoughWell(dim=72, eps=0.1), 8, 0.01, 0.003),
    "ring_h72": (lambda: jtargets.gen_ring(r=2.0, var=0.1, nb_mixtures=4),
                 lambda: targets.gen_ring(r=2.0, var=0.1, nb_mixtures=4), 72, 0.1, 0.01),
    "funnel_D72": (lambda: jtargets.GaussianFunnel(dim=72),
                   lambda: targets.GaussianFunnel(dim=72), 8, 0.02, 0.003),
    "mixture_D72": (lambda: _jax_mixture(72), lambda: suite.two_component_mixture(72), 8, 0.05,
                    0.003),
}
# the funnel's first chains start past its clip (|v| > 8) on both sides
PAST_CLIP = (8.5, -9.0, 12.0, -12.0)


def _states(name, dim, n, seed=1):
    """(x, v) (n, dim) float32 from a numpy seed: x at the target's scale
    (the ring's radius 2), the funnel's first chains past its clip, their
    necks at the clipped scale."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, dim))
    if name.startswith("funnel"):
        vcol = 2.0 * z[:, 0]
        vcol[:len(PAST_CLIP)] = PAST_CLIP
        x = np.concatenate([vcol[:, None], np.exp(np.clip(vcol, -8, 8) / 2)[:, None] * z[:, 1:]],
                           axis=1)
    elif name.startswith("ring"):
        x = 2.0 * z
    else:
        x = z
    return x.astype(np.float32), rng.standard_normal((n, dim)).astype(np.float32)


def _setup(name):
    """JAX and port dynamics and targets, params (weights lifted) on both
    sides from one JAX init, and numpy states and cotangents."""
    make_j, make_t, hidden, eps, lift = CASES[name]
    jt, tt = make_j(), make_t()
    kw = dict(dim=tt.dim, n_chains=N, T=T, hidden=hidden)
    jd, _ = jax_build_dynamics(JaxScgConfig(**kw), jt)
    td, _ = build_dynamics(ScgConfig(**kw), tt)
    jp = jd.init_params(jax.random.key(0), eps=eps)
    for net in ("xnet", "vnet"):
        jp[net] = jax.tree_util.tree_map(lambda a: a + lift, jp[net])
    jp = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    x, v = _states(name, tt.dim, N)
    rng = np.random.default_rng(3)
    a = {"x": x, "v": v, "cX": rng.standard_normal(x.shape).astype(np.float32),
         "cV": rng.standard_normal(x.shape).astype(np.float32),
         "cld": rng.standard_normal(N).astype(np.float32)}
    return jt, tt, jd, td, jp, params_from_jax(jp, device="cpu"), a


def _close(got, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=TOL * float(np.abs(ref).max()) + 1e-30, err_msg=what)


def _on_sites(td, tt, tp):
    inp = fd.prepare(td, fd.energy_spec_for_target(tt), tp, "cpu")
    return fd.trajectory_on_sites(inp) and fd.chain_on_sites(inp)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_trajectory_matches_jax_kernel(name, direction):
    """The trajectory wrapper on CPU tensors (its plain version, which the
    site-parallel kernel is held to on the card) against the JAX trajectory
    kernel in interpret mode, through ``FusedDynamics``: X, V and the
    log-det within TOL of each output's largest entry, nothing launched."""
    jt, tt, jd, td, jp, tp, a = _setup(name)
    with jax.enable_x64(False):
        jfused = jfd.fused_for_target(jd, jt, tile=TILE, interpret=True)
        ref = getattr(jfused, direction)(jax.tree_util.tree_map(jnp.asarray, jp),
                                         jnp.asarray(a["x"]), jnp.asarray(a["v"]))
    fd.reset_launch_counts()
    got = getattr(fd.fused_for_target(td, tt), direction)(tp, torch.tensor(a["x"]),
                                                          torch.tensor(a["v"]))
    assert fd.LAUNCHES["trajectory"] == 0
    assert _on_sites(td, tt, tp)
    for g, r, what in zip(got, ref, ("X", "V", "logdet")):
        assert np.isfinite(np.asarray(r)).all()
        _close(g.numpy(), r, what)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_vjp_matches_jax_kernel(name, direction):
    """Through the params tree: the gradient of sum(X cX) + sum(V cV) +
    sum(ld cld) with respect to every params leaf (both nets' arrays, alpha),
    x and v, by autograd through ``DifferentiableFusedDynamics`` (the
    backward wrapper's plain version on the CPU, the spec's hand-derived
    gradient VJP inside) against ``jax.grad`` through the JAX package's
    ``differentiable_fused`` (its backward Pallas kernel in interpret mode,
    two tiles): per leaf within TOL of the leaf's largest entry."""
    jt, tt, jd, td, jp, tp, a = _setup(name)
    with jax.enable_x64(False):
        jdfd = jfd.differentiable_fused(jd, jt, tile=TILE, interpret=True)

        def jloss(p, x, v):
            X, V, ld = getattr(jdfd, direction)(p, x, v)
            return jnp.sum(X * a["cX"]) + jnp.sum(V * a["cV"]) + jnp.sum(ld * a["cld"])

        gp, gx, gv = jax.grad(jloss, argnums=(0, 1, 2))(
            jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(a["x"]), jnp.asarray(a["v"]))
    leaves = [leaf.clone().requires_grad_(True) for leaf in tree_leaves(tp)]
    x = torch.tensor(a["x"], requires_grad=True)
    v = torch.tensor(a["v"], requires_grad=True)
    fd.reset_launch_counts()
    X, V, ld = getattr(fd.differentiable_fused(td, tt), direction)(
        tree_unflatten(tp, leaves), x, v)
    loss = ((X * torch.tensor(a["cX"])).sum() + (V * torch.tensor(a["cV"])).sum()
            + (ld * torch.tensor(a["cld"])).sum())
    grads = torch.autograd.grad(loss, leaves + [x, v])
    assert fd.LAUNCHES["trajectory_bwd"] == 0
    ref = jax.tree_util.tree_leaves(gp) + [gx, gv]
    assert len(grads) == len(ref)
    for i, (g, r) in enumerate(zip(grads, ref)):
        assert tuple(g.shape) == np.shape(r), i
        _close(g.numpy(), r, f"leaf {i}")


def _zero_bit_draws(n, d):
    """The draws a Philox stream of zero words gives: v = sqrt(-2 ln 1e-7) in
    every dimension, direction forward, accept always — what the Pallas
    interpreter's zero PRNG bits give the JAX chain kernel."""
    zero = torch.zeros((d, n), dtype=torch.int64)
    u = torch.zeros(n)
    return lambda step: (box_muller(zero, zero), u, u)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_chain_matches_jax_kernel_on_zero_bits(name):
    """The plain chain against the JAX chain kernel under
    force_tpu_interpret_mode, on the zero-bits schedule, 2 MH steps, one tile
    of 8 chains (the funnel's four past its clip among them): acceptance
    exactly, states within TOL, the trace's end the state; the chains
    moved."""
    jt, tt, jd, td, jp, tp, a = _setup(name)
    x = a["x"][:TILE]
    sampler = jfd.fused_chain_sampler(jd, jt, tile=TILE)
    with pltpu.force_tpu_interpret_mode():
        x1, acc = sampler.run(jp, x, seed=7, n_mh_steps=2)
    inp = fd.prepare(td, fd.energy_spec_for_target(tt), tp, "cpu")
    assert fd.chain_on_sites(inp)
    xo, acc_t, trace = fd.chain_plain(inp, torch.tensor(x).T.contiguous(), seed=7, n_mh_steps=2,
                                      collect_trace=True, draws=_zero_bit_draws(TILE, tt.dim))
    np.testing.assert_array_equal(acc_t[0].numpy(), np.asarray(acc))
    np.testing.assert_allclose(xo.T.numpy(), np.asarray(x1), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(trace[-1].numpy(), xo.numpy())
    assert not np.array_equal(np.asarray(x1), x)


# -- the configurations past 64 and the prelude's shared memory -----------------

# The configurations that run these specs past 64 through the normal entry
# points: (name, target, hidden as the entry point passes it, the ScgConfig's
# widths). The suite's ring and rough well at icg's hidden 100 (run_target's
# own dynamics), the rough well and the funnel at D = 100 and a two-component
# mixture at D = 80 through ``train``.
PATH = {
    "ring_hidden100": ("ring", 100),
    "rough_well_hidden100": ("rough_well", 100),
    "rough_well_D100": (lambda: targets.RoughWell(dim=100, eps=0.1), 20),
    "funnel_D100": (lambda: targets.GaussianFunnel(dim=100), 20),
    "mixture_D80": (lambda: suite.two_component_mixture(80), 20),
}


@pytest.mark.parametrize("name", list(PATH))
def test_chain_kernel_serves_the_specs_past_64(name):
    """``kernel_refusal``, the pure check that decides whether the chain
    kernel serves a fused eval, returns None on every configuration that
    runs a rough well, a mixture or a funnel past 64, and the three kernels
    take its inputs on their site-parallel configuration; the widths' caps
    still apply."""
    make, hidden = PATH[name]
    if isinstance(make, str):
        eff = suite.effective_config(make, hidden=hidden)
        target = suite._target_registry()[make]()
        cfg = ScgConfig(dim=target.dim, T=eff["leapfrogs"], hmc=eff["hmc_mode"],
                        **{k: eff[k] for k in suite._SAME_NAME})
    else:
        target = make()
        cfg = ScgConfig(dim=target.dim, hidden=hidden, T=5, fused_train=True)
    dyn, _ = build_dynamics(cfg, target)
    assert fd.kernel_refusal(dyn, target, hidden) is None
    params = dyn.init_params(torch.Generator().manual_seed(0), device="cpu")
    inp = fd.prepare(dyn, fd.energy_spec_for_target(target), params, "cpu")
    assert fd.trajectory_on_sites(inp) and fd.chain_on_sites(inp)
    assert "caps exceeded" in fd.kernel_refusal(dyn, target, 129)


def _spec_inputs(kind, dim):
    """(kind, floats of constants) of an energy spec at ``dim``: the rough
    well's 4, a two-component mixture's, the funnel's 3."""
    if kind == fd.GmmEnergy.KIND:
        return kind, 2 * (dim + dim * dim + 1)
    return kind, {fd.RoughWellEnergy.KIND: 4, fd.FunnelEnergy.KIND: 3}[kind]


@pytest.mark.parametrize("kind", [fd.RoughWellEnergy.KIND, fd.GmmEnergy.KIND,
                                  fd.FunnelEnergy.KIND])
@pytest.mark.parametrize("dim,hidden", [(2, 100), (80, 20), (100, 128), (1024, 128),
                                        (4096, 128)])
def test_site_geometry_holds_the_prelude(kind, dim, hidden):
    """The host mirrors of the three kernels' shared memory a block add the
    spec's prelude, C (2K + 2) floats for a K-component mixture and 2 C for
    the funnel (C = 4 chains a block), none for the rough well, to the
    Gaussian's; every block still fits the 232,448 bytes it may use, the
    widest (dim 4096, hidden 128) included."""
    kind, nc = _spec_inputs(kind, dim)
    pre = {fd.RoughWellEnergy.KIND: 0, fd.GmmEnergy.KIND: 6, fd.FunnelEnergy.KIND: 2}[kind]
    assert fd.site_prelude_floats(kind, nc, dim) == pre
    base = fd.site_geometry(dim, hidden, hidden)
    chain = fd.site_geometry(dim, hidden, hidden, kind, nc)
    assert chain == (4, 256, base[2] + 4 * 4 * pre) and chain[2] <= fd._MAX_SMEM
    for kernel in ("trajectory", "trajectory_bwd"):
        g0 = fd.trajectory_site_geometry(kernel, dim, hidden, hidden, 8)
        g = fd.trajectory_site_geometry(kernel, dim, hidden, hidden, 8, kind, nc)
        assert g == (4, 256, g0[2] + 4 * 4 * pre, g0[3]) and g[2] <= fd._MAX_SMEM
    assert fd.trajectory_site_geometry("trajectory", dim, hidden, hidden, 8, kind, nc)[:3] == chain


def test_site_prelude_floats_match_the_sources():
    """``site_prelude_floats`` is csrc's ``site_pre_floats``: the Gmm spec's
    2 comps + 2 with comps = NC / (D + D^2 + 1), the Funnel's 2, and none
    for the specs without a prelude (Gauss, RoughWell, Phi4: kPrelude
    false)."""
    common = (CSRC / "l2hmc_common.cuh").read_text()
    sites = (CSRC / "l2hmc_sites.cuh").read_text()
    assert "static int pre_floats(Dims d) { return 2 * comps(d) + 2; }" in common
    assert "static int pre_floats(Dims) { return 2; }" in common
    assert "return d.NC / (d.D + d.D * d.D + 1);" in common
    flags = {name: re.search(r"static constexpr bool kPrelude = (\w+);",
                             common.split(f"struct {name} {{")[1].split("\n};")[0]).group(1)
             for name in ("Gauss", "RoughWell", "Gmm", "Funnel", "Phi4")}
    assert flags == {"Gauss": "false", "RoughWell": "false", "Gmm": "true", "Funnel": "true",
                     "Phi4": "false"}
    assert ("return kind == Gmm::kKind      ? Gmm::pre_floats(d)\n"
            "         : kind == Funnel::kKind ? Funnel::pre_floats(d)\n"
            "                                 : 0;") in sites
    for kind in (fd.QuadraticGaussianEnergy.KIND, fd.RoughWellEnergy.KIND, fd.Phi4Energy.KIND):
        assert fd.site_prelude_floats(kind, 100, 64) == 0
    assert fd.site_prelude_floats(fd.GmmEnergy.KIND, 4 * (2 + 4 + 1), 2) == 10
    assert fd.site_prelude_floats(fd.FunnelEnergy.KIND, 3, 100) == 2


def test_backward_library_follows_the_sources_split():
    """The backward kernel's site instantiations live in two sources,
    ``trajectory_bwd.cu`` (Gauss, Phi4) and ``trajectory_bwd_specs.cu``
    (RoughWell, Gmm, Funnel), for the build's clock: the wrapper picks the
    library by the spec on sites, and ``trajectory_bwd`` on the lane groups
    for every spec."""
    bwd = (CSRC / "trajectory_bwd.cu").read_text()
    assert "!(std::is_same_v<En, Gauss> || std::is_same_v<En, Phi4>);" in bwd
    assert '#define L2HMC_BWD_SPECS_UNIT\n#include "trajectory_bwd.cu"' in (
        CSRC / "trajectory_bwd_specs.cu").read_text()
    assert set(fd._BWD_SPECS_KINDS) == {fd.RoughWellEnergy.KIND, fd.GmmEnergy.KIND,
                                        fd.FunnelEnergy.KIND}

    def lib(target, dim, hidden):
        dyn, _ = build_dynamics(ScgConfig(dim=dim, hidden=hidden, T=2), target)
        params = dyn.init_params(torch.Generator().manual_seed(0), device="cpu")
        inp = fd.prepare(dyn, fd.energy_spec_for_target(target), params, "cpu")
        return fd._lib_name("trajectory_bwd", inp)

    assert lib(targets.RoughWell(dim=72, eps=0.1), 72, 8) == "trajectory_bwd_specs"
    assert lib(targets.RoughWell(dim=10, eps=0.1), 10, 8) == "trajectory_bwd"
    assert lib(targets.GaussianFunnel(dim=100), 100, 8) == "trajectory_bwd_specs"
    assert lib(targets.gen_ring(r=2.0, var=0.1, nb_mixtures=4), 2, 100) == (
        "trajectory_bwd_specs")
    assert lib(targets.ill_conditioned_gaussian(50), 50, 100) == "trajectory_bwd"
    assert lib(targets.Phi4Lattice(L=10), 100, 8) == "trajectory_bwd"
