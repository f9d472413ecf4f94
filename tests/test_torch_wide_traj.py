"""Kernels 1 and 2 past 64 wide on the CPU: the plain trajectory and its
hand-derived VJP (``DifferentiableFusedDynamics`` forward and backward)
against the JAX package's fused kernels in interpret mode past dim 64 (the
10 x 10 phi^4 lattice) and past hidden 64 (a Gaussian at hidden 72), the
host mirror of the site-parallel trajectory kernels' geometry against the
sources' constants, the refusals at the new caps, and the fused dynamics'
row layout. Fused training on the lattice against the JAX trainer is in
``test_torch_wide_train.py``."""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu import targets as jtargets
from l2hmc_tpu.ops import fused_dynamics as jfd
from l2hmc_tpu.train import ScgConfig as JaxScgConfig
from l2hmc_tpu.train import build_dynamics as jax_build_dynamics
from l2hmc_tpu_torch import targets
from l2hmc_tpu_torch.apps import phi4
from l2hmc_tpu_torch.convert import params_from_jax
from l2hmc_tpu_torch.ops import fused_dynamics as fd
from l2hmc_tpu_torch.train import ScgConfig, build_dynamics, train
from l2hmc_tpu_torch.train.optim import tree_leaves, tree_unflatten
from torch_wide_util import jax_array_cotangents, port_inputs, reduced_from_factors

N, TILE = 16, 8  # chains, and the JAX kernels' tile: two tiles, so its accumulation runs
# Outputs and gradients per leaf within TOL of the leaf's largest entry:
# float32 sums over 100 sites and 16 chains in another order (the JAX
# package's own fused-vs-XLA tolerance is 2e-4 on states, 2e-3 on gradients).
TOL = 2e-4
CSRC = Path(fd.__file__).resolve().parent.parent / "csrc"

# name -> (JAX target, port target, hidden, T, eps, weight lift, eps_dim):
# past dim 64, the 10 x 10 lattice at the parity cases' lift; past hidden
# 64, an ill-conditioned Gaussian at hidden 72 with per-dimension steps
CASES = {
    "phi4_L10": (lambda: jtargets.Phi4Lattice(L=10, m2=-1.0, lam=0.5),
                 lambda: targets.Phi4Lattice(L=10, m2=-1.0, lam=0.5), 8, 3, 0.1,
                 phi4.PARITY_LIFT, False),
    "gauss_h72": (lambda: jtargets.ill_conditioned_gaussian(8, 2.0),
                  lambda: targets.ill_conditioned_gaussian(8, 2.0), 72, 3, 0.1, 0.01, True),
}


def _setup(name):
    """JAX and port dynamics and targets, params (weights lifted) on both
    sides from one JAX init, and numpy state and cotangents."""
    make_j, make_t, hidden, T, eps, lift, eps_dim = CASES[name]
    jt, tt = make_j(), make_t()
    kw = dict(dim=tt.dim, n_chains=N, T=T, hidden=hidden, eps_dim=eps_dim)
    jd, _ = jax_build_dynamics(JaxScgConfig(**kw), jt)
    td, _ = build_dynamics(ScgConfig(**kw), tt)
    if eps_dim:
        eps = eps * np.sqrt(np.diag(np.asarray(jt.sigma))).astype(np.float32)
    jp = jd.init_params(jax.random.key(0), eps=eps)
    for net in ("xnet", "vnet"):
        jp[net] = jax.tree_util.tree_map(lambda a: a + lift, jp[net])
    jp = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    rng = np.random.default_rng(3)
    x = np.asarray(tt.sample(torch.Generator().manual_seed(1), N, device="cpu"))
    a = {"x": x.astype(np.float32),
         **{k: rng.standard_normal((N, tt.dim)).astype(np.float32) for k in ("v", "cX", "cV")},
         "cld": rng.standard_normal(N).astype(np.float32)}
    return jt, tt, jd, td, jp, params_from_jax(jp, device="cpu"), a


def _close(got, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=TOL * float(np.abs(ref).max()) + 1e-30, err_msg=what)


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
    assert fd.trajectory_on_sites(fd.prepare(td, fd.energy_spec_for_target(tt), tp, "cpu"))
    for g, r, what in zip(got, ref, ("X", "V", "logdet")):
        _close(g.numpy(), r, what)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_vjp_matches_jax_kernel(name, direction):
    """Through the params tree: the gradient of sum(X cX) + sum(V cV) +
    sum(ld cld) with respect to every params leaf (both nets' arrays, alpha),
    x and v, by autograd through ``DifferentiableFusedDynamics`` (the
    backward wrapper's plain version on the CPU) against ``jax.grad``
    through the JAX package's ``differentiable_fused`` (its backward Pallas
    kernel in interpret mode, two tiles): per leaf within TOL of the leaf's
    largest entry."""
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


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_recorded_factors_reduce_to_the_weight_cotangents(name, direction):
    """The site VJP's design on the CPU: the factors each S/T/Q application
    writes (a, b, dus, dut, duq, h, dz1, h2, dz2), recorded on the plain
    VJP in the kernel's K-major layout, reduced by ``reduce_factors``'s
    plain version, give w1, w2, wh, ws, wt and wq's cotangents: those of
    ``trajectory_vjp_plain`` and those of the JAX package's backward kernel
    in interpret mode (two tiles), per array within TOL of its largest
    entry."""
    jt, tt, jd, td, jp, tp, a = _setup(name)
    jx, jv = jax_array_cotangents(jd, jt, jp, a, direction, TILE)
    inp, x, v, dX, dV, dld = port_inputs(td, tt, tp, a)
    reverse = direction == "backward"
    (gx, gv), _, K = reduced_from_factors(inp, x, v, dX, dV, dld, reverse)
    D, H, H2, T = inp.dims
    assert K == -(-N // fd._SITE_CHAINS) * T * 2 * fd._SITE_CHAINS
    px, pv, *_ = fd.trajectory_vjp_plain(inp, x, v, dX, dV, dld, reverse)
    for got, plain, ref in ((gx, px, jx), (gv, pv, jv)):
        for w, i in zip(got, fd._PRODUCT_WEIGHTS):
            assert tuple(w.shape) == tuple(plain[i].shape) == ref[i].shape, i
            _close(w.numpy(), plain[i].numpy(), f"array {i} against the plain VJP")
            _close(w.numpy(), ref[i], f"array {i} against JAX")


@pytest.mark.parametrize("mode", ["ragged", "hmc"])
def test_recorded_factors_at_a_ragged_count_and_in_hmc_mode(mode):
    """At 13 chains (not a multiple of the tile's 4) the factor rows of the
    last tile's three missing chains are zeros and the reduction equals the
    plain VJP's weight cotangents; in HMC mode every factor is zero and so
    is every reduced cotangent, as the plain VJP's."""
    jt, tt, jd, td, jp, tp, a = _setup("phi4_L10")
    n = 13
    inp, x, v, dX, dV, dld = port_inputs(td, tt, tp, a, n)
    if mode == "hmc":
        inp = dataclasses.replace(inp, hmc=True)
    (gx, gv), flat, K = reduced_from_factors(inp, x, v, dX, dV, dld, False)
    D, H, H2, T = inp.dims
    C = fd._SITE_CHAINS
    assert K == 4 * T * 2 * C
    px, pv, *_ = fd.trajectory_vjp_plain(inp, x, v, dX, dV, dld, False)
    views = fd.factor_views(flat, D, H, H2, K)
    for net in views:
        for arr in net.values():
            rows = arr.reshape(4, T, 2, C, -1)
            assert not rows[3, :, :, n - 3 * C:].any()  # the missing chains
            if mode == "hmc":
                assert not arr.any()
    for got, plain in ((gx, px), (gv, pv)):
        for w, i in zip(got, fd._PRODUCT_WEIGHTS):
            if mode == "hmc":
                assert not w.any() and not plain[i].any()
            else:
                _close(w.numpy(), plain[i].numpy(), f"array {i}")


# -- the host mirror of the geometry, the caps ---------------------------------


def _constant(name: str, source: str = "l2hmc_sites.cuh") -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert m, name
    return int(m.group(1))


def test_site_constants_match_the_sources():
    """The host's tile (chains, threads), the backward kernel's shared-memory
    width and the caps are the sources': kSiteChains, kSiteThreads,
    kSiteVjpSmemDim and kSiteVjpMaxDim (kSiteMaxDim) in
    csrc/l2hmc_sites.cuh, kSiteMaxDim and kSiteMaxHidden in
    csrc/l2hmc_lanes.cuh; so are the site VJP's reduction constants and its
    factor scratch's cap in csrc/trajectory_bwd.cu."""
    assert (fd._SITE_CHAINS, fd._SITE_THREADS) == (_constant("kSiteChains"),
                                                   _constant("kSiteThreads"))
    assert fd._SITE_VJP_SMEM_DIM == _constant("kSiteVjpSmemDim")
    assert "constexpr int kSiteVjpMaxDim = kSiteMaxDim;" in (CSRC / "l2hmc_sites.cuh").read_text()
    assert fd._MAX_DIM == _constant("kSiteMaxDim", "l2hmc_lanes.cuh")
    assert fd._MAX_HIDDEN == _constant("kSiteMaxHidden", "l2hmc_lanes.cuh")
    # the site VJP's reduction and its factor scratch's part (trajectory_bwd.cu)
    bwd = "trajectory_bwd.cu"
    assert (fd._RED_TILE, fd._RED_K, fd._RED_TARGET_BLOCKS, fd._RED_MAX_SPLITS) == tuple(
        _constant(k, bwd) for k in ("kRedTile", "kRedK", "kRedTargetBlocks", "kRedMaxSplits"))
    assert "constexpr size_t kSiteFactorCap = size_t(1) << 30;" in (CSRC / bwd).read_text()
    assert fd._SITE_FACTOR_CAP == 1 << 30


# every (D, H) past 64 the trajectory kernels' caps admit, at their edges
WIDTHS = [(d, h) for d in (50, 65, 100, 256, 1024, 4096) for h in (8, 32, 72, 128)
          if max(d, h) > 64]


@pytest.mark.parametrize("dim,hidden", WIDTHS)
def test_trajectory_site_geometry_fits_shared_memory(dim, hidden):
    """The host mirror of the site-parallel trajectory kernels: 4 chains a
    block of 256 threads; the forward kernel's shared memory x', v, g and
    the buffers, no scratch; the backward kernel's
    ten (C, D) arrays (up to dim 1024; past it they lie in its scratch) and
    the buffers (the partial sums, the four applications' hidden layers,
    dz1, dz2), a row of cotangents a block; both within the 232,448 bytes a
    block may use."""
    hm = 64 if hidden <= 64 else 128
    fwd = fd.trajectory_site_geometry("trajectory", dim, hidden, hidden, 1024)
    assert (fwd[0], fwd[1], fwd[3]) == (4, 256, 0)
    assert fwd[2] == 4 * (3 * 4 * dim + 8 * 4 * hm + 2 * 4 * hm + 8 * 3 * 4 + 3 * 4)
    assert fwd[2] <= fd._MAX_SMEM
    bwd = fd.trajectory_site_geometry("trajectory_bwd", dim, hidden, hidden, 1023)
    arrays = 10 * 4 * dim if dim <= 1024 else 0
    assert bwd == (4, 256, 4 * (arrays + 8 * 4 * hm + 10 * 4 * hm), 256)
    assert bwd[2] <= fd._MAX_SMEM


def test_trajectory_site_geometry_at_the_protocols_shapes():
    """The widest tiles and the scratch of the training path: the backward
    kernel at dim 1024 and hidden 128 takes 200,704 bytes a block, past it
    the buffers alone; its scratch at 1024 chains of the 16 x 16 lattice
    (hidden 32, T = 10) is ~264 MB, at the 32 x 32 ~965 MB, at the 64 x 64
    (its parity case: hidden 64, T = 24) ~4.65 GB, most of it the factors
    (K = blocks x T x 2 x 4 rows a net); the 64 x 64's ~8.2 GB of factors run
    in two parts of 128 blocks, each part's factors within
    ``_SITE_FACTOR_CAP``. The compact rows a block of 4 chains."""
    assert fd.trajectory_site_geometry("trajectory_bwd", 1024, 128, 128, 1)[2] == 200704
    assert fd.trajectory_site_geometry("trajectory_bwd", 4096, 128, 128, 1)[2] == 36864
    assert fd.trajectory_site_geometry("trajectory", 4096, 128, 128, 1)[2] == 217520
    with pytest.raises(ValueError, match="lane groups"):
        fd.trajectory_site_geometry("trajectory", 64, 64, 64, 8)
    for L, mb, parts in ((16, 264.0, 1), (32, 965.2, 1), (64, 4654.9, 2)):
        inp, _ = phi4.parity_inputs(f"phi4_L{L}", 4, "cpu")
        D, H, H2, T = inp.dims
        rows = fd.trajectory_site_geometry("trajectory_bwd", D, H, H2, 1024)[3]
        plan = fd.site_bwd_plan(D, H, H2, T, 1024)
        assert (plan["blocks"], plan["parts"]) == (rows, parts)
        assert plan["part_blocks"] * parts == rows and plan["K"] == plan["part_blocks"] * T * 8
        fac = plan["part_blocks"] * 2 * T * 2 * 4 * (5 * D + 2 * H + 2 * H2)  # widths of 4s
        small = 2 * (H2 + 5 * D + H * T) + D
        arrays = plan["part_blocks"] * 10 * 4 * D if D > 1024 else 0
        assert plan["fac"] == fac <= fd._SITE_FACTOR_CAP
        wc = 2 * (2 * D * H + H * H2 + 3 * H2 * D)
        assert fd.bwd_scratch_floats(inp, 1024) == (
            rows * small + plan["part_blocks"] * 2 * T * 4 * D + arrays + fac
            + plan["splits"] * parts * wc)
        assert round(4 * fd.bwd_scratch_floats(inp, 1024) / 1e6, 1) == mb


def test_trajectory_on_sites_follows_pick_lanes():
    """``trajectory_on_sites`` mirrors csrc's ``pick_lanes``: the lane groups
    up to 64 wide and hidden 64 (the lattice at L = 8 included), the sites
    past either."""
    def on_sites(case, n=4):
        return fd.trajectory_on_sites(phi4.parity_inputs(case, n, "cpu")[0])

    assert not on_sites("phi4_L8")
    assert all(on_sites(c) for c in ("phi4_L16", "phi4_L32", "phi4_L64", "gauss_D128"))
    icg = targets.ill_conditioned_gaussian(50)
    dyn, _ = build_dynamics(ScgConfig(dim=50, hidden=100), icg)
    params = dyn.init_params(torch.Generator().manual_seed(0), device="cpu")
    assert fd.trajectory_on_sites(fd.prepare(dyn, fd.energy_spec_for_target(icg), params, "cpu"))


def test_refusals_at_the_new_caps():
    """Past the caps the wrappers' check names the kernel and both caps:
    the trajectory kernel and its backward kernel past dim 4096 or hidden
    128; within them every energy spec is served, the rough well past dim
    64 and the mixture past hidden 64 as the lattice."""
    assert fd._caps_refusal("trajectory", 4096, 128) is None
    assert fd._caps_refusal("trajectory", 16384, 32) == (
        "trajectory kernel caps exceeded: dim 16384, hidden 32 (caps dim 4096, hidden 128)")
    assert fd._caps_refusal("trajectory", 256, 129) == (
        "trajectory kernel caps exceeded: dim 256, hidden 129 (caps dim 4096, hidden 128)")
    for dim in (1024, 1089, 4096):
        assert fd._caps_refusal("trajectory_bwd", dim, 128) is None
    for dim in (4097, 16384):
        assert fd._caps_refusal("trajectory_bwd", dim, 32) == (
            f"trajectory_bwd kernel caps exceeded: dim {dim}, hidden 32 "
            "(caps dim 4096, hidden 128)")
    assert fd._caps_refusal("trajectory_bwd", 50, 129) == (
        "trajectory_bwd kernel caps exceeded: dim 50, hidden 129 (caps dim 4096, hidden 128)")
    assert fd._caps_refusal("trajectory", 100, 32) is None
    assert fd._caps_refusal("trajectory_bwd", 2, 100) is None
    # a CPU tensor takes the plain version at every width; the kernel check
    # is for CUDA tensors only
    inp, x = phi4.parity_inputs("phi4_L64", 2, "cpu")
    with pytest.raises(ValueError, match="no kernel for tensors on cpu"):
        fd._kernel_block(inp, x, "trajectory_bwd")


def test_fused_dynamics_return_contiguous_rows():
    """The fused dynamics return (N, D) rows in a contiguous buffer, as
    ``Dynamics`` does: a transposed view of the kernel's (D, N) output would
    carry its layout into the chains, and a later sum over the sites would
    run in another order than on a contiguous state (the captured route's
    static buffer), so the two training routes would part at D > 2."""
    jt, tt, jd, td, jp, tp, a = _setup("phi4_L10")
    x, v = torch.tensor(a["x"]), torch.tensor(a["v"])
    for dyn in (fd.fused_for_target(td, tt), fd.differentiable_fused(td, tt)):
        for way in ("forward", "backward"):
            X, V, ld = getattr(dyn, way)(tp, x, v)
            assert X.is_contiguous() and V.is_contiguous() and X.shape == (N, tt.dim)
    state, _ = train(ScgConfig(dim=tt.dim, n_chains=N, n_steps=2, T=3, hidden=8,
                               fused_train=True), tt, device="cpu")
    assert state.x.is_contiguous()
