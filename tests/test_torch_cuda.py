"""The CUDA kernels vs their plain versions on the card. Marked
``requires_cuda``; they skip where there is no CUDA device (run them with
``pytest -m requires_cuda`` on a machine with an H100 and nvcc)."""

import dataclasses

import numpy as np
import pytest
import torch

from l2hmc_tpu_torch import targets
from l2hmc_tpu_torch.apps import phi4, suite
from l2hmc_tpu_torch.ops import _cuda
from l2hmc_tpu_torch.ops import fused_dynamics as fd
from l2hmc_tpu_torch.ops import fused_vae as fv
from l2hmc_tpu_torch.train import ScgConfig, build_dynamics, hmc_sample_chain, sample_chain, train
from l2hmc_tpu_torch.train.optim import tree_leaves, tree_unflatten

pytestmark = pytest.mark.requires_cuda

TOL = 5e-4  # bench.py's compiled-parity gate


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _inputs(cuda, hmc=False, dim=2, n=333):
    tgt = targets.scg_gaussian() if dim == 2 else targets.ill_conditioned_gaussian(dim)
    cfg = ScgConfig(dim=dim, T=5, hmc=hmc, net_input_whiten=dim > 2 and not hmc)
    dyn, _ = build_dynamics(cfg, tgt)
    params = dyn.init_params(torch.Generator().manual_seed(0), device=cuda)
    if not hmc:
        for net in ("xnet", "vnet"):
            params[net] = _add(params[net], 0.03)
    inp = fd.prepare(dyn, fd.energy_spec_for_target(tgt), params, cuda)
    x = tgt.sample(torch.Generator().manual_seed(1), n, device=cuda).T.contiguous()
    return inp, x


def _add(tree, c):
    if isinstance(tree, dict):
        return {k: _add(v, c) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_add(v, c) for v in tree)
    return tree + c


@pytest.mark.parametrize("n", [1, 37, 333, 8192])
@pytest.mark.parametrize("hmc,dim", [(False, 2), (True, 2), (False, 50)])
@pytest.mark.parametrize("reverse", [False, True])
def test_trajectory_kernel_matches_plain(cuda, hmc, dim, reverse, n):
    """The lane-group trajectory against its plain version, 5e-4, from one
    chain (one group, the rest of its block past N) through a ragged block
    to many blocks an SM; a second launch repeats the first bit for bit."""
    inp, x = _inputs(cuda, hmc, dim, n)
    v = torch.randn(x.shape, generator=torch.Generator().manual_seed(2)).to(cuda)
    before = fd.LAUNCHES["trajectory"]
    got = fd.trajectory(inp, x, v, reverse)
    assert fd.LAUNCHES["trajectory"] == before + 1
    again = fd.trajectory(inp, x, v, reverse)
    for a, b in zip(got, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    ref = fd.trajectory_plain(inp, x, v, reverse)
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, r, rtol=0, atol=TOL)


def _accepts(trace, x0):
    """(K, N) accept decisions of a (K, D, N) trace from the (D, N) start:
    a step accepted where the state moved."""
    prev = torch.cat([x0[None], trace[:-1]])
    return (trace != prev).any(dim=1)


def _chain_cases():
    return [pytest.param(hmc, dim, n, trace, id=f"{name}-n{n}-{'trace' if trace else 'notrace'}")
            for name, hmc, dim in (("scg", False, 2), ("hmc", True, 2), ("wide", False, 50))
            for n in (37, 333, 8192) for trace in (True, False)]


@pytest.mark.parametrize("hmc,dim,n,trace", _chain_cases())
def test_chain_kernel_matches_plain_on_same_bits(cuda, hmc, dim, n, trace):
    """The lane-group chain against its plain version on the same Philox
    bits, 8 MH steps, from a ragged block (37) to many blocks an SM (8192);
    a second launch repeats the first bit for bit. A flipped accept is
    possible only where |px - u| is within the two versions' rounding of
    the Hamiltonians. So all decisions agree and states (the trace, or the
    final state without one) agree within 1e-3, the trace's end equals the
    state, except in the 50-d case at 8192 chains: 65,536 decisions on
    energies of 50 terms, where phase 3 of chip_smoke.py's limits hold
    instead (at most 5 flipped decisions, 1e-2 on the other chains)."""
    inp, x = _inputs(cuda, hmc, dim, n)
    before = fd.LAUNCHES["chain"]
    xk, acck, trk = fd.chain(inp, x, seed=4, n_mh_steps=8, collect_trace=trace)
    assert fd.LAUNCHES["chain"] == before + 1
    again = fd.chain(inp, x, seed=4, n_mh_steps=8, collect_trace=trace)
    for a, b in zip((xk, acck, trk), again):
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    xp, accp, trp = fd.chain_plain(inp, x, seed=4, n_mh_steps=8, collect_trace=True)
    assert torch.isfinite(xk).all()
    strict = not (dim == 50 and n == 8192)
    if trace:
        torch.testing.assert_close(trk[-1], xk, rtol=0, atol=0)
        flipped = _accepts(trk, x) != _accepts(trp, x)  # (K, N)
        clean = ~flipped.any(dim=0)
        got, ref = trk, trp
    else:
        flipped = acck[0] != accp[0]  # (N,): a chain with a flipped decision
        clean = ~flipped
        got, ref = xk, xp
    if strict:
        assert not bool(flipped.any())
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-3)
    else:
        assert int(flipped.sum()) <= 5
        torch.testing.assert_close(got[..., clean], ref[..., clean], rtol=0, atol=1e-2)
    assert 0.0 < float(accp.mean()) < 1.0


def test_chain_kernel_runs_a_chain_a_warp_across_directions(cuda):
    """Each chain draws its own direction, and the substep's shuffles take
    the whole warp, so the kernel runs one chain a warp (32 lanes) at the
    SCG widths and at the 50-d widths. The four chains of a block take
    different directions in some steps and the same in others, and the
    kernel still matches its plain version and repeats bit for bit."""
    from l2hmc_tpu_torch.ops import _cuda
    from l2hmc_tpu_torch.ops.philox import chain_draws

    lanes = _cuda.library("chain").l2hmc_chain_lanes
    assert lanes(2, 10, 10) == 32 and lanes(50, 10, 10) == 32
    inp, x = _inputs(cuda, n=64)
    D = inp.dims[0]
    forward = torch.stack([chain_draws(4, 64, D, k, cuda)[1] < 0.5 for k in range(8)])
    by_block = forward.view(8, 16, 4)  # 128 threads: four chains a block
    mixed = (by_block != by_block[..., :1]).any(dim=-1)  # (K, blocks)
    assert bool(mixed.any()) and not bool(mixed.all())
    xk, acck, trk = fd.chain(inp, x, seed=4, n_mh_steps=8, collect_trace=True)
    again = fd.chain(inp, x, seed=4, n_mh_steps=8, collect_trace=True)
    for a, b in zip((xk, acck, trk), again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    xp, accp, trp = fd.chain_plain(inp, x, seed=4, n_mh_steps=8, collect_trace=True)
    torch.testing.assert_close(acck, accp, rtol=0, atol=0)
    torch.testing.assert_close(trk, trp, rtol=0, atol=1e-3)


@pytest.mark.parametrize("hmc,dim,n", [(False, 2, 333), (True, 2, 333), (False, 50, 256),
                                       (False, 2, 200)], ids=["scg", "hmc", "wide", "ragged"])
@pytest.mark.parametrize("reverse", [False, True])
def test_trajectory_bwd_kernel_matches_plain(cuda, hmc, dim, n, reverse):
    """Per leaf, max |kernel - plain| <= 5e-4 of the leaf's largest entry:
    the weight and eps cotangents are sums over chains taken in another
    order, and the wide case (every weight lifted by 0.03, whitened input)
    reaches 1.5e-4 on an H100. One chain dropped from a sum over these N
    is about 1/N of the leaf, several times the limit. The kernel's
    fixed-order sum makes it repeat itself exactly."""
    inp, x = _inputs(cuda, hmc, dim, n)
    g = torch.Generator().manual_seed(3)
    v, dX, dV = (torch.randn(x.shape, generator=g).to(cuda) for _ in range(3))
    dld = torch.randn((1, x.shape[1]), generator=g).to(cuda)
    before = fd.LAUNCHES["trajectory_bwd"]
    got = tree_leaves(fd.trajectory_vjp(inp, x, v, dX, dV, dld, reverse))
    assert fd.LAUNCHES["trajectory_bwd"] == before + 1
    ref = tree_leaves(fd.trajectory_vjp_plain(inp, x, v, dX, dV, dld, reverse))
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=5e-4 * float(b.abs().max()) + 1e-30)
    again = tree_leaves(fd.trajectory_vjp(inp, x, v, dX, dV, dld, reverse))
    for a, b in zip(got, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _bwd_scale_cases():
    """SCG (learned and HMC) and the 50-d Gaussian at 333, 2048 and 8192
    chains: the lane groups' two instantiations at a block's worth of
    chains and at many blocks an SM."""
    return [pytest.param(hmc, dim, n, id=f"{name}-n{n}")
            for name, hmc, dim in (("scg", False, 2), ("hmc", True, 2), ("wide", False, 50))
            for n in (333, 2048, 8192)]


@pytest.mark.parametrize("hmc,dim,n", _bwd_scale_cases())
@pytest.mark.parametrize("reverse", [False, True])
def test_trajectory_bwd_kernel_matches_plain_at_scale(cuda, hmc, dim, n, reverse):
    """As above, per leaf within 5e-4 of the leaf's largest entry and twice
    bit for bit, up to 8192 chains. The nets are ReLU nets: a hidden
    pre-activation within rounding of zero can gate differently in the
    kernel and in its plain version and change that chain's cotangents by
    whole terms, which the 8192-chain cases of the wide net make likely.
    Such a chain shows in its own dx, dv, may be at most 1, must have a
    pre-activation of the plain trajectory within 1e-5 of its layer's
    largest (``relu_margins``), and is set aside by a second comparison
    with its incoming cotangents zeroed (the rule of the VAE backward
    kernel's test below)."""
    inp, x = _inputs(cuda, hmc, dim, n)
    g = torch.Generator().manual_seed(3)
    v, dX, dV = (torch.randn(x.shape, generator=g).to(cuda) for _ in range(3))
    dld = torch.randn((1, x.shape[1]), generator=g).to(cuda)
    got = tree_leaves(fd.trajectory_vjp(inp, x, v, dX, dV, dld, reverse))
    again = tree_leaves(fd.trajectory_vjp(inp, x, v, dX, dV, dld, reverse))
    for a, b in zip(got, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    ref = tree_leaves(fd.trajectory_vjp_plain(inp, x, v, dX, dV, dld, reverse))
    flipped = torch.zeros(n, dtype=torch.bool, device=cuda)
    for a, b in zip(got[-2:], ref[-2:]):  # dx, dv: one column per chain
        flipped |= (a - b).abs().amax(dim=0) > 5e-4 * b.abs().max()
    assert int(flipped.sum()) <= 1
    if bool(flipped.any()):
        assert float(fd.relu_margins(inp, x, v, reverse)[flipped].max()) < 1e-5
        keep = (~flipped).float()[None, :]
        got = tree_leaves(fd.trajectory_vjp(inp, x, v, dX * keep, dV * keep, dld * keep,
                                            reverse))
        ref = tree_leaves(fd.trajectory_vjp_plain(inp, x, v, dX * keep, dV * keep,
                                                  dld * keep, reverse))
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=5e-4 * float(b.abs().max()) + 1e-30)


def test_backward_through_function_launches_kernel(cuda):
    """loss.backward() through DifferentiableFusedDynamics launches the
    backward kernel once per trajectory and fills every params gradient."""
    tgt = targets.scg_gaussian()
    dyn, _ = build_dynamics(ScgConfig(T=4), tgt)
    params = dyn.init_params(torch.Generator().manual_seed(0), device=cuda)
    params = {**params, "xnet": _add(params["xnet"], 0.03), "vnet": _add(params["vnet"], 0.03)}
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    dfd = fd.differentiable_fused(dyn, tgt)
    x = tgt.sample(torch.Generator().manual_seed(1), 256, device=cuda)
    v = torch.randn(x.shape, generator=torch.Generator().manual_seed(2)).to(cuda)
    fd.reset_launch_counts()
    X, V, ld = dfd.forward(params, x, v)
    Xb, _, ldb = dfd.backward(params, x, v)
    loss = (X * Xb).mean() + V.mean() + (ld - 2.0 * ldb).mean()
    loss.backward()
    assert fd.LAUNCHES["trajectory"] == 2 and fd.LAUNCHES["trajectory_bwd"] == 2
    for leaf in leaves:
        assert leaf.grad is not None and torch.isfinite(leaf.grad).all()
    assert float(params["alpha"].grad.abs()) > 0


def test_kernel_rejects_bad_input(cuda):
    inp, x = _inputs(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fd.chain(inp, x.T.contiguous().T, seed=0, n_mh_steps=1)
    with pytest.raises(ValueError, match="kernel inputs on"):
        fd.trajectory(inp, x.cpu(), x.cpu(), False)


# -- the suite's energy specs ---------------------------------------------------

# Each spec at its suite row's shapes (``suite.PARITY_CASES``): the ring on
# the SCG lane configurations, the rest on WideLanes, icg (hidden 100) on the
# chain kernel's site-parallel configuration; the trajectory kernels take
# ``suite.TRAJECTORY_CASES``.

@pytest.mark.parametrize("n", [37, 2048])
@pytest.mark.parametrize("case", suite.TRAJECTORY_CASES)
@pytest.mark.parametrize("reverse", [False, True])
def test_spec_trajectory_kernel_matches_plain(cuda, case, reverse, n):
    """Each suite spec's trajectory kernel against its plain version, 5e-4,
    and twice bit for bit."""
    inp, x = suite.parity_inputs(case, n, cuda)
    v = torch.randn(x.shape, generator=torch.Generator().manual_seed(2)).to(cuda)
    before = fd.LAUNCHES["trajectory"]
    got = fd.trajectory(inp, x, v, reverse)
    assert fd.LAUNCHES["trajectory"] == before + 1
    for a, b in zip(got, fd.trajectory(inp, x, v, reverse)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for g, r in zip(got, fd.trajectory_plain(inp, x, v, reverse)):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, r, rtol=0, atol=TOL)


@pytest.mark.parametrize("n", [203, "suite"])
@pytest.mark.parametrize("case", [*suite.PARITY_CASES, *suite.WIDE_CASES])
def test_spec_chain_kernel_matches_plain_on_same_bits(cuda, case, n):
    """Each suite spec's chain kernel against its plain version on the same
    Philox bits, 20 traced MH steps, at a ragged count and at its suite
    row's: at most 5 flipped decisions on the lane groups, 0.2% on the
    site-parallel configuration (icg; the rough well, the mixtures and the
    funnel past 64, ``suite.WIDE_CASES``), 1e-2 on the other chains
    (chip_smoke.py's limits), the trace's end the state, twice bit for
    bit."""
    if n == "suite":
        n = {**suite.PARITY_CASES, **suite.WIDE_CASES}[case].n_chains
    inp, x = suite.parity_inputs(case, n, cuda)
    before = fd.LAUNCHES["chain"]
    xk, acck, trk = fd.chain(inp, x, seed=4, n_mh_steps=20, collect_trace=True)
    assert fd.LAUNCHES["chain"] == before + 1
    for a, b in zip((xk, acck, trk), fd.chain(inp, x, seed=4, n_mh_steps=20, collect_trace=True)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    _, accp, trp = fd.chain_plain(inp, x, seed=4, n_mh_steps=20, collect_trace=True)
    torch.testing.assert_close(trk[-1], xk, rtol=0, atol=0)
    flipped = _accepts(trk, x) != _accepts(trp, x)
    clean = ~flipped.any(dim=0)
    assert int(flipped.sum()) <= (0.002 * flipped.numel() if fd.chain_on_sites(inp) else 5)
    torch.testing.assert_close(trk[..., clean], trp[..., clean], rtol=0, atol=1e-2)
    assert 0.0 < float(accp.mean()) < 1.0


@pytest.mark.parametrize("n", [333, 2048])
@pytest.mark.parametrize("case", suite.TRAJECTORY_CASES)
@pytest.mark.parametrize("reverse", [False, True])
def test_spec_trajectory_bwd_kernel_matches_plain(cuda, case, reverse, n):
    """Each suite spec's backward kernel (its hand-derived gradient VJP at
    both gradient points of a substep) against its plain version: per leaf
    within 5e-4 of the leaf's largest entry, twice bit for bit, with the
    ReLU rule of ``test_trajectory_bwd_kernel_matches_plain_at_scale``."""
    inp, x = suite.parity_inputs(case, n, cuda)
    g = torch.Generator().manual_seed(3)
    v, dX, dV = (torch.randn(x.shape, generator=g).to(cuda) for _ in range(3))
    dld = torch.randn((1, n), generator=g).to(cuda)
    before = fd.LAUNCHES["trajectory_bwd"]
    got = tree_leaves(fd.trajectory_vjp(inp, x, v, dX, dV, dld, reverse))
    assert fd.LAUNCHES["trajectory_bwd"] == before + 1
    for a, b in zip(got, tree_leaves(fd.trajectory_vjp(inp, x, v, dX, dV, dld, reverse))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    ref = tree_leaves(fd.trajectory_vjp_plain(inp, x, v, dX, dV, dld, reverse))
    flipped = torch.zeros(n, dtype=torch.bool, device=cuda)
    for a, b in zip(got[-2:], ref[-2:]):
        flipped |= (a - b).abs().amax(dim=0) > 5e-4 * b.abs().max()
    assert int(flipped.sum()) <= 1
    if bool(flipped.any()):
        assert float(fd.relu_margins(inp, x, v, reverse)[flipped].max()) < 1e-5
        keep = (~flipped).float()[None, :]
        got = tree_leaves(fd.trajectory_vjp(inp, x, v, dX * keep, dV * keep, dld * keep,
                                            reverse))
        ref = tree_leaves(fd.trajectory_vjp_plain(inp, x, v, dX * keep, dV * keep,
                                                  dld * keep, reverse))
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=5e-4 * float(b.abs().max()) + 1e-30)


def test_spec_kernels_refuse_constants_of_another_spec(cuda):
    """The entry points check the constants' count against the spec's kind:
    a Gaussian block announced as a mixture is refused, not misread."""
    import dataclasses

    inp, x = _inputs(cuda)
    bad = dataclasses.replace(inp, kind=fd.GmmEnergy.KIND)
    with pytest.raises(RuntimeError, match="launch failed"):
        fd.trajectory(bad, x, x.clone(), False)
    with pytest.raises(RuntimeError, match="launch failed"):
        fd.chain(dataclasses.replace(inp, kind=9), x, seed=0, n_mh_steps=1)


# -- the phi^4 lattice ------------------------------------------------------------

# The lattice's parity cases (``phi4.PARITY_CASES``): L = 8 on the lane groups
# of kernels 1-2, L = 8, 16 and 32 and a dense 128-d Gaussian on the chain
# kernel's site-parallel configuration.

@pytest.mark.parametrize("reverse", [False, True])
def test_phi4_trajectory_kernels_match_plain_at_L8(cuda, reverse):
    """Phi4 through the trajectory kernel (5e-4) and its backward kernel
    (per leaf within 5e-4 of the leaf's largest entry, the ReLU rule of
    ``test_spec_trajectory_bwd_kernel_matches_plain``) at L = 8, hidden 32,
    512 chains, twice bit for bit."""
    inp, x = phi4.parity_inputs("phi4_L8", 512, cuda)
    g = torch.Generator().manual_seed(3)
    v, dX, dV = (torch.randn(x.shape, generator=g).to(cuda) for _ in range(3))
    dld = torch.randn((1, 512), generator=g).to(cuda)
    got = fd.trajectory(inp, x, v, reverse)
    for a, b in zip(got, fd.trajectory(inp, x, v, reverse)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(got, fd.trajectory_plain(inp, x, v, reverse)):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=TOL)
    got = tree_leaves(fd.trajectory_vjp(inp, x, v, dX, dV, dld, reverse))
    ref = tree_leaves(fd.trajectory_vjp_plain(inp, x, v, dX, dV, dld, reverse))
    flipped = torch.zeros(512, dtype=torch.bool, device=cuda)
    for a, b in zip(got[-2:], ref[-2:]):
        flipped |= (a - b).abs().amax(dim=0) > 5e-4 * b.abs().max()
    assert int(flipped.sum()) <= 1
    if bool(flipped.any()):
        assert float(fd.relu_margins(inp, x, v, reverse)[flipped].max()) < 1e-5
        keep = (~flipped).float()[None, :]
        got = tree_leaves(fd.trajectory_vjp(inp, x, v, dX * keep, dV * keep, dld * keep,
                                            reverse))
        ref = tree_leaves(fd.trajectory_vjp_plain(inp, x, v, dX * keep, dV * keep,
                                                  dld * keep, reverse))
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=5e-4 * float(b.abs().max()) + 1e-30)


@pytest.mark.parametrize("case,n", [("phi4_L16", 512), ("phi4_L16", 37), ("phi4_L32", 256),
                                    ("phi4_L64", 256), ("phi4_L64", 37),
                                    ("gauss_D128", 203), ("phi4_L16_hmc", 203),
                                    ("phi4_L8", 512)])
def test_phi4_chain_kernel_matches_plain_on_same_bits(cuda, case, n):
    """The chain kernel at the lattice's widths (the site-parallel
    configuration, which runs the lattice at every width) against its plain
    version on the same Philox bits, 20 traced MH steps, at a ragged count
    and at the protocol's: at most 0.2% of the decisions flipped
    (chip_smoke.py's PHI4_FLIPS), 1e-2 on the other chains, the trace's end
    the state, twice bit for bit."""
    inp, x = phi4.parity_inputs(case, n, cuda)
    before = fd.LAUNCHES["chain:phi4" if "phi4" in case else "chain:gauss"]
    xk, acck, trk = fd.chain(inp, x, seed=4, n_mh_steps=20, collect_trace=True)
    assert fd.LAUNCHES["chain:phi4" if "phi4" in case else "chain:gauss"] == before + 1
    for a, b in zip((xk, acck, trk), fd.chain(inp, x, seed=4, n_mh_steps=20, collect_trace=True)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    _, accp, trp = fd.chain_plain(inp, x, seed=4, n_mh_steps=20, collect_trace=True)
    torch.testing.assert_close(trk[-1], xk, rtol=0, atol=0)
    flipped = _accepts(trk, x) != _accepts(trp, x)
    clean = ~flipped.any(dim=0)
    assert int(flipped.sum()) <= 0.002 * flipped.numel()
    torch.testing.assert_close(trk[..., clean], trp[..., clean], rtol=0, atol=1e-2)
    assert 0.0 < float(accp.mean()) < 1.0


# The cluster chain kernel (csrc/l2hmc_site_cluster.cuh) at each cluster
# size its plan takes, by chain count at L = 16 (from one CTA a tile at
# 2048 chains to eight at 37), at ranges that do not divide the sites (the
# funnel and the rough well at D = 100), a partial tile (203 chains), HMC
# mode, and on the lattice at L = 64 (weights streamed).
CLUSTER_CASES = [("phi4_L16", 2048), ("phi4_L16", 1024), ("phi4_L16", 512), ("phi4_L16", 203),
                 ("phi4_L16", 37), ("phi4_L8", 512), ("phi4_L32", 256), ("phi4_L64", 203),
                 ("funnel_D100", 512), ("funnel_D100", 203), ("rough_well_D100", 203),
                 ("phi4_L16_hmc", 203)]


@pytest.mark.parametrize("case,n", CLUSTER_CASES)
def test_cluster_chain_kernel_matches_plain_at_its_plans(cuda, case, n):
    """The cluster chain kernel against its plain version on the same Philox
    bits, 20 traced MH steps, at the plan the library takes on this card
    (its G recorded, every G of 1-8 the cases reach): at most 5 flipped
    decisions of 20 a chain's worth (chip_smoke's phase 3 bar, 0.2% at the
    protocols' counts), 1e-2 on the other chains, the trace's end the state,
    the acceptance the trace's, and a second launch equal bit for bit."""
    mod = phi4 if case in phi4.PARITY_CASES else suite
    inp, x = mod.parity_inputs(case, n, cuda, seed=44)
    D, H, H2, _ = inp.dims
    plan = fd.site_tile(D, H, H2, n, *inp.energy_args)
    assert plan == fd.site_geometry(D, H, H2, n, *inp.energy_args,
                                    capacity=fd.site_capacities(D, H, H2, *inp.energy_args))
    assert 1 <= plan.G <= 8 and fd.site_clusters(D, H, H2, n, *inp.energy_args) >= 1
    before = fd.LAUNCHES["chain:sites"]
    xk, acck, trk = fd.chain(inp, x, seed=6, n_mh_steps=20, collect_trace=True)
    assert fd.LAUNCHES["chain:sites"] == before + 1
    for a, b in zip((xk, acck, trk), fd.chain(inp, x, seed=6, n_mh_steps=20, collect_trace=True)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    _, accp, trp = fd.chain_plain(inp, x, seed=6, n_mh_steps=20, collect_trace=True)
    torch.testing.assert_close(trk[-1], xk, rtol=0, atol=0)
    dec = _accepts(trk, x)
    torch.testing.assert_close(acck, dec.float().mean(dim=0, keepdim=True), rtol=0, atol=1e-6)
    flipped = dec != _accepts(trp, x)
    clean = ~flipped.any(dim=0)
    assert int(flipped.sum()) <= max(5, 0.002 * flipped.numel())
    torch.testing.assert_close(trk[..., clean], trp[..., clean], rtol=0, atol=1e-2)
    assert 0.0 < float(accp.mean()) < 1.0


def test_cluster_plans_reach_every_size(cuda):
    """The chain counts of ``CLUSTER_CASES`` at L = 16 take one CTA a tile
    at 2048 chains and more at fewer chains, and the plans at the cases
    span G = 1, 2 and at least one size past 2."""
    gs = set()
    for case, n in CLUSTER_CASES:
        mod = phi4 if case in phi4.PARITY_CASES else suite
        inp, _ = mod.parity_inputs(case, 16, "cpu")
        D, H, H2, _ = inp.dims
        gs.add(fd.site_tile(D, H, H2, n, *inp.energy_args).G)
    assert {1, 2} <= gs and max(gs) > 2, gs


def test_cluster_chain_refusal_raises(cuda, monkeypatch):
    """No fallback: where the library refuses a launch on a CUDA tensor (a
    cluster the card cannot hold returns cudaErrorInvalidConfiguration),
    ``fd.chain`` raises, counts no launch and runs no plain version."""
    inp, x = phi4.parity_inputs("phi4_L16", 64, cuda, seed=44)
    lib = _cuda.library("chain")

    class Refusing:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def l2hmc_chain(*args):
            return 9  # cudaErrorInvalidConfiguration

    real = _cuda.library
    monkeypatch.setattr(_cuda, "library", lambda name: Refusing() if name == "chain" else real(name))
    monkeypatch.setattr(fd, "chain_plain", lambda *a, **k: pytest.fail("fell back to plain"))
    before = dict(fd.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        fd.chain(inp, x, seed=6, n_mh_steps=2)
    assert fd.LAUNCHES == before


def test_kernels_refuse_past_their_caps(cuda):
    """The trajectory kernels and the chain kernel take states up to 4096
    wide and hidden widths up to 128, every energy spec alike: past them each
    raises naming the kernel and its caps; nothing falls back to a plain
    version. Within them a rough well past dim 64 runs on the chain kernel's
    site-parallel configuration."""
    t128 = targets.Phi4Lattice(L=128)
    d128, _ = build_dynamics(ScgConfig(dim=t128.dim, hidden=32), t128)
    inp = fd.prepare(d128, fd.energy_spec_for_target(t128),
                     d128.init_params(torch.Generator(), device=cuda), cuda)
    x = t128.sample(torch.Generator(), 4, device=cuda).T.contiguous()
    with pytest.raises(ValueError, match=r"trajectory kernel caps exceeded: dim 16384, "
                                         r"hidden 32 \(caps dim 4096, hidden 128\)"):
        fd.trajectory(inp, x, x.clone(), False)
    with pytest.raises(ValueError, match=r"trajectory_bwd kernel caps exceeded: dim 16384, "
                                         r"hidden 32 \(caps dim 4096, hidden 128\)"):
        fd.trajectory_vjp(inp, x, x.clone(), x.clone(), x.clone(),
                          torch.zeros((1, 4), device=cuda), False)
    for L, hidden, match in ((128, 32, "chain kernel caps exceeded: dim 16384"),
                             (16, 129, "chain kernel caps exceeded: dim 256, hidden 129")):
        t = targets.Phi4Lattice(L=L)
        dyn, _ = build_dynamics(ScgConfig(dim=t.dim, hidden=hidden), t)
        with pytest.raises(ValueError, match=match + r".*\(caps dim 4096, hidden 128\)"):
            fd.fused_chain_sampler(dyn, t).run(dyn.init_params(torch.Generator(), device=cuda),
                                               t.sample(torch.Generator(), 4, device=cuda),
                                               seed=0, n_mh_steps=1)
    rough = targets.RoughWell(dim=100, eps=0.1, easy=True)
    dyn, _ = build_dynamics(ScgConfig(dim=100, hidden=32), rough)
    before = fd.LAUNCHES["chain:sites"]
    x, acc = fd.fused_chain_sampler(dyn, rough).run(
        dyn.init_params(torch.Generator(), device=cuda),
        rough.sample(torch.Generator(), 4, device=cuda), seed=0, n_mh_steps=1)
    assert fd.LAUNCHES["chain:sites"] == before + 1
    assert torch.isfinite(x).all() and x.shape == (4, 100)


def test_chain_on_sites_and_site_geometry_match_the_library(cuda):
    """Over a grid of widths: the host's ``chain_on_sites`` picks the
    site-parallel configuration exactly where the library's ``pick_lanes``
    gives no lane group (``l2hmc_chain_lanes`` 0), and the host mirror
    ``site_geometry`` at this card's capacities (``site_capacities``) equals
    the library's plan (chains a tile, G, threads, shared memory a CTA,
    staging, the accepted states' place, sites a range, scratch) at 203 and
    2048 chains; both raise past the caps."""
    gauss = targets.ill_conditioned_gaussian
    for dim in (2, 10, 50, 64, 65, 128, 1024, 4096, 4097):
        for hidden in (10, 32, 64, 65, 100, 128, 129):
            h2 = hidden
            nc = dim * dim + dim
            try:
                fd.site_geometry(dim, hidden, h2, 203, 0, nc)
            except ValueError:  # past the caps: the library refuses too
                with pytest.raises(ValueError):
                    fd.site_tile(dim, hidden, h2, 203, 0, nc)
                continue
            cap = fd.site_capacities(dim, hidden, h2, 0, nc)
            for n in (203, 2048):
                assert fd.site_tile(dim, hidden, h2, n, 0, nc) == fd.site_geometry(
                    dim, hidden, h2, n, 0, nc, capacity=cap), (dim, hidden, n)
            if dim > 1024:
                continue  # past the caps; a dense Gaussian past 1024 is not built here
            tgt = targets.scg_gaussian() if dim == 2 else gauss(dim)
            dyn, _ = build_dynamics(ScgConfig(dim=dim, hidden=hidden, T=2), tgt)
            inp = fd.prepare(dyn, fd.energy_spec_for_target(tgt),
                             dyn.init_params(torch.Generator(), device="cpu"), "cpu")
            lanes = _cuda.library("chain").l2hmc_chain_lanes(dim, hidden, h2)
            assert fd.chain_on_sites(inp) == (lanes == 0), (dim, hidden, lanes)


# -- kernels 1-2 on sites (past 64 wide) ---------------------------------------------

SITE_TRAJ_CASES = [("phi4_L16", 1024), ("phi4_L16", 203), ("phi4_L32", 256), ("icg", 2048),
                   ("icg", 37)]


def _site_inputs(cuda, case, n):
    maker = (suite.parity_inputs if case == "icg" or case in suite.WIDE_CASES
             else phi4.parity_inputs)
    inp, x = maker(case, n, cuda, seed=20)
    return inp, x.contiguous()


@pytest.mark.parametrize("case,n", SITE_TRAJ_CASES)
@pytest.mark.parametrize("reverse", [False, True])
def test_site_trajectory_kernels_match_plain(cuda, case, n, reverse):
    """Kernels 1-2 past 64 wide, on the site-parallel configuration, against
    their plain versions at the lattice's L = 16 and 32 and at icg (hidden
    100, eps_dim), at the protocols' chain counts and at ragged ones (a
    tile's chains past N): the trajectory's X and V within 5e-4, its log-det
    within 5e-4 or 2e-6 of its largest magnitude (a sum over D sites and 4 T
    net applications in another order); the VJP per leaf within 1e-4 of
    the leaf's largest entry with the ReLU rule of the L = 8 test; each
    launch twice bit for bit and counted as a site launch."""
    inp, x = _site_inputs(cuda, case, n)
    assert fd.trajectory_on_sites(inp)
    g = torch.Generator().manual_seed(3)
    v, dX, dV = (torch.randn(x.shape, generator=g).to(cuda) for _ in range(3))
    dld = torch.randn((1, n), generator=g).to(cuda)
    before = fd.LAUNCHES["trajectory:sites"]
    got = fd.trajectory(inp, x, v, reverse)
    assert fd.LAUNCHES["trajectory:sites"] == before + 1
    for a, b in zip(got, fd.trajectory(inp, x, v, reverse)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    ref = fd.trajectory_plain(inp, x, v, reverse)
    for a, b in zip(got[:2], ref[:2]):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=TOL)
    torch.testing.assert_close(got[2], ref[2], rtol=0,
                               atol=max(TOL, 2e-6 * float(ref[2].abs().max())))
    before = fd.LAUNCHES["trajectory_bwd:sites"]
    got = tree_leaves(fd.trajectory_vjp(inp, x, v, dX, dV, dld, reverse))
    assert fd.LAUNCHES["trajectory_bwd:sites"] == before + 1
    for a, b in zip(got, tree_leaves(fd.trajectory_vjp(inp, x, v, dX, dV, dld, reverse))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    ref = tree_leaves(fd.trajectory_vjp_plain(inp, x, v, dX, dV, dld, reverse))
    flipped = torch.zeros(n, dtype=torch.bool, device=cuda)
    for a, b in zip(got[-2:], ref[-2:]):
        flipped |= (a - b).abs().amax(dim=0) > 1e-4 * b.abs().max()
    assert int(flipped.sum()) <= 1
    if bool(flipped.any()):
        assert float(fd.relu_margins(inp, x, v, reverse)[flipped].max()) < 1e-5
        keep = (~flipped).float()[None, :]
        got = tree_leaves(fd.trajectory_vjp(inp, x, v, dX * keep, dV * keep, dld * keep,
                                            reverse))
        ref = tree_leaves(fd.trajectory_vjp_plain(inp, x, v, dX * keep, dV * keep,
                                                  dld * keep, reverse))
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * float(b.abs().max()) + 1e-30)


# The rough well, the ring, the funnel and a mixture past 64
# (``suite.WIDE_CASES``), at their rows' chain counts and at ragged ones
SITE_SPEC_CASES = [("rough_well_h100", 2048), ("rough_well_h100", 37), ("ring_h100", 2048),
                   ("ring_h100", 203), ("rough_well_D100", 2048), ("funnel_D100", 512),
                   ("funnel_D100", 37), ("mixture_D80", 512), ("mixture_D80", 37)]
# A chain whose plain trajectory passes within this share of a layer's
# largest pre-activation of a ReLU kink is set aside in the VJP comparison
RELU_MARGIN = 1e-5


@pytest.mark.parametrize("case,n", SITE_SPEC_CASES)
@pytest.mark.parametrize("reverse", [False, True])
def test_site_spec_kernels_match_plain(cuda, case, n, reverse):
    """Kernels 1-2 on sites for the rough well, the mixtures and the funnel
    (the funnel's and the mixture's gradients and VJPs after their
    per-chain prelude) against their plain versions: the trajectory's X and
    V within 5e-4, its log-det within 5e-4 or 2e-6 of its largest
    magnitude; the VJP per leaf within 1e-4 of the leaf's largest entry on
    the chains whose plain trajectory stays farther than RELU_MARGIN from a
    ReLU kink (at hidden 100 and 2048 chains a chain's 4 T net applications
    take 8000 gate decisions, and ~15% of the chains come that near a kink
    somewhere), every chain whose dx or dv differs among those set aside,
    at most a quarter set aside; each launch twice bit for bit and counted
    as a site launch on the spec."""
    inp, x = _site_inputs(cuda, case, n)
    assert fd.trajectory_on_sites(inp) and fd.chain_on_sites(inp)
    spec = fd._SPEC_NAMES[inp.kind]
    g = torch.Generator().manual_seed(3)
    v, dX, dV = (torch.randn(x.shape, generator=g).to(cuda) for _ in range(3))
    dld = torch.randn((1, n), generator=g).to(cuda)
    before = fd.LAUNCHES[f"trajectory:{spec}"], fd.LAUNCHES["trajectory:sites"]
    got = fd.trajectory(inp, x, v, reverse)
    assert (fd.LAUNCHES[f"trajectory:{spec}"], fd.LAUNCHES["trajectory:sites"]) == (
        before[0] + 1, before[1] + 1)
    for a, b in zip(got, fd.trajectory(inp, x, v, reverse)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    ref = fd.trajectory_plain(inp, x, v, reverse)
    for a, b in zip(got[:2], ref[:2]):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=TOL)
    torch.testing.assert_close(got[2], ref[2], rtol=0,
                               atol=max(TOL, 2e-6 * float(ref[2].abs().max())))
    before = fd.LAUNCHES["trajectory_bwd:sites"]
    got = tree_leaves(fd.trajectory_vjp(inp, x, v, dX, dV, dld, reverse))
    assert fd.LAUNCHES["trajectory_bwd:sites"] == before + 1
    for a, b in zip(got, tree_leaves(fd.trajectory_vjp(inp, x, v, dX, dV, dld, reverse))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    ref = tree_leaves(fd.trajectory_vjp_plain(inp, x, v, dX, dV, dld, reverse))
    differ = torch.zeros(n, dtype=torch.bool, device=cuda)
    for a, b in zip(got[-2:], ref[-2:]):
        differ |= (a - b).abs().amax(dim=0) > 1e-4 * b.abs().max()
    aside = fd.relu_margins(inp, x, v, reverse) < RELU_MARGIN
    assert not bool((differ & ~aside).any()) and int(aside.sum()) <= n // 4
    keep = (~aside).float()[None, :]
    got = tree_leaves(fd.trajectory_vjp(inp, x, v, dX * keep, dV * keep, dld * keep, reverse))
    ref = tree_leaves(fd.trajectory_vjp_plain(inp, x, v, dX * keep, dV * keep, dld * keep,
                                              reverse))
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * float(b.abs().max()) + 1e-30)


def test_site_trajectory_at_L64(cuda):
    """Kernels 1-2 at the 64 x 64 lattice (dim 4096, A_control's shape:
    hidden 32, T = 10, eps 0.03; the backward kernel's intermediates in its
    global scratch) against their plain versions at a ragged 37 chains, both
    directions: X and V within 5e-4, the log-det within 2e-6 of its largest
    magnitude; the VJP per leaf within 1e-4 of the leaf's largest entry with
    the ReLU rule; each launch twice bit for bit."""
    t = targets.Phi4Lattice(L=64, m2=-1.0, lam=0.5)
    dyn, _ = build_dynamics(ScgConfig(dim=t.dim, hidden=32, T=10), t)
    params = dyn.init_params(torch.Generator().manual_seed(20), eps=0.03, device=cuda)
    for net in ("xnet", "vnet"):
        params[net] = _add(params[net], phi4.PARITY_LIFT)
    inp = fd.prepare(dyn, fd.energy_spec_for_target(t), params, cuda)
    x = t.sample(torch.Generator().manual_seed(21), 37, device=cuda).T.contiguous()
    g = torch.Generator().manual_seed(22)
    v, dX, dV = (torch.randn(x.shape, generator=g).to(cuda) for _ in range(3))
    dld = torch.randn((1, 37), generator=g).to(cuda)
    for reverse in (False, True):
        got = fd.trajectory(inp, x, v, reverse)
        for a, b in zip(got, fd.trajectory(inp, x, v, reverse)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        ref = fd.trajectory_plain(inp, x, v, reverse)
        for a, b in zip(got[:2], ref[:2]):
            torch.testing.assert_close(a, b, rtol=0, atol=TOL)
        torch.testing.assert_close(got[2], ref[2], rtol=0,
                                   atol=max(TOL, 2e-6 * float(ref[2].abs().max())))
        got = tree_leaves(fd.trajectory_vjp(inp, x, v, dX, dV, dld, reverse))
        for a, b in zip(got, tree_leaves(fd.trajectory_vjp(inp, x, v, dX, dV, dld, reverse))):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        ref = tree_leaves(fd.trajectory_vjp_plain(inp, x, v, dX, dV, dld, reverse))
        flipped = torch.zeros(37, dtype=torch.bool, device=cuda)
        for a, b in zip(got[-2:], ref[-2:]):
            flipped |= (a - b).abs().amax(dim=0) > 1e-4 * b.abs().max()
        assert int(flipped.sum()) <= 1
        if bool(flipped.any()):
            assert float(fd.relu_margins(inp, x, v, reverse)[flipped].max()) < 1e-5
            keep = (~flipped).float()[None, :]
            got = tree_leaves(fd.trajectory_vjp(inp, x, v, dX * keep, dV * keep, dld * keep,
                                                reverse))
            ref = tree_leaves(fd.trajectory_vjp_plain(inp, x, v, dX * keep, dV * keep,
                                                      dld * keep, reverse))
        for a, b in zip(got, ref):
            assert torch.isfinite(a).all()
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * float(b.abs().max()) + 1e-30)


@pytest.mark.parametrize("kind,nc_of", [
    (fd.RoughWellEnergy.KIND, lambda d: 4), (fd.FunnelEnergy.KIND, lambda d: 3),
    (fd.GmmEnergy.KIND, lambda d: 2 * (d + d * d + 1)),
    (fd.GmmEnergy.KIND, lambda d: 4 * (d + d * d + 1))])
def test_site_geometry_with_a_prelude_matches_the_library(cuda, kind, nc_of):
    """With an energy spec's prelude (the funnel's 2 floats a chain, a
    K-component mixture's 2K + 2) the host mirrors ``site_geometry`` (at this
    card's capacities, 512 chains) and ``trajectory_site_geometry`` equal
    each library's plan and shared memory a block (zeros where the lane
    groups serve the widths or past the caps)."""
    for dim in (2, 50, 65, 100, 1024, 4096):
        for hidden in (10, 64, 100, 128):
            nc = nc_of(dim)
            cap = fd.site_capacities(dim, hidden, hidden, kind, nc)
            assert fd.site_tile(dim, hidden, hidden, 512, kind, nc) == fd.site_geometry(
                dim, hidden, hidden, 512, kind, nc, capacity=cap), (dim, hidden)
            for kernel in ("trajectory", "trajectory_bwd"):
                try:
                    host = fd.trajectory_site_geometry(kernel, dim, hidden, hidden, 8, kind,
                                                       nc)[:3]
                except ValueError:
                    host = (0, 0, 0)
                assert fd.trajectory_site_tile(kernel, dim, hidden, hidden, kind, nc) == host, (
                    kernel, dim, hidden)


def test_trajectory_site_geometry_matches_the_library(cuda):
    """Over a grid of widths the host mirror ``trajectory_site_geometry``
    equals each library's chains, threads and shared memory a block (zeros
    where the lane groups serve the widths or past the caps)."""
    for kernel in ("trajectory", "trajectory_bwd"):
        for dim in (2, 50, 64, 65, 256, 1024, 1025, 4096, 4097):
            for hidden in (10, 32, 64, 65, 100, 128, 129):
                try:
                    host = fd.trajectory_site_geometry(kernel, dim, hidden, hidden, 8)[:3]
                except ValueError:
                    host = (0, 0, 0)
                assert fd.trajectory_site_tile(kernel, dim, hidden, hidden) == host, (
                    kernel, dim, hidden)


def test_site_bwd_plan_matches_the_library(cuda):
    """Over a grid of widths, T and chain counts (ragged, and the 64 x 64
    lattice at hidden 64, T = 24 and 1024 chains, whose factors run in two
    parts) the host mirror ``site_bwd_plan`` equals the library's plan of
    the site VJP's blocks, parts, factor rows, reduction splits and scratch
    regions (None where the lane groups serve the widths)."""
    for D in (50, 65, 100, 256, 1024, 4096):
        for H in (10, 32, 64, 100, 128):
            for T, n in ((10, 1024), (24, 1024), (5, 37), (10, 8192)):
                host = fd.site_bwd_plan(D, H, H, T, n) if max(D, H) > 64 else None
                assert fd.site_bwd_plan_of_library(D, H, H, T, n) == host, (D, H, T, n)
    assert fd.site_bwd_plan(4096, 64, 64, 24, 1024)["parts"] == 2


@pytest.mark.parametrize("D,H,H2,K", [(256, 32, 32, 20480), (50, 100, 100, 40960),
                                      (100, 20, 20, 1000), (4096, 32, 32, 5120),
                                      (1024, 32, 32, 24), (65, 7, 9, 40)])
def test_site_reduce_kernel_matches_plain(cuda, D, H, H2, K):
    """The site VJP's reduction kernel (its twelve products over K factor
    rows a net, ragged tiles and K included) against its plain version
    (float32 matrix products) on seeded normal factors: per product within
    1e-5 of its largest entry, a second launch bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(K)
    flat = torch.randn(2 * K * fd._factor_row_floats(D, H, H2), generator=g, device=cuda)
    fd.reset_launch_counts()
    got = fd.reduce_factors(flat, D, H, H2, K)
    assert fd.LAUNCHES["trajectory_bwd_reduce"] == 1
    torch.testing.assert_close(fd.reduce_factors(flat, D, H, H2, K), got, rtol=0, atol=0)
    ref = fd.reduce_factors_plain(flat, D, H, H2, K)
    for ga, gb in zip(fd.reduced_weights(got, D, H, H2), fd.reduced_weights(ref, D, H, H2)):
        for a, b in zip(ga, gb):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))


def test_site_vjp_factors_reduce_as_the_kernel_sums(cuda):
    """The factors the plain VJP records at L = 16 (37 chains: a ragged
    tile), reduced by the kernel, against the site backward kernel's weight
    cotangents: per array within 1e-4 of its largest entry (BWD_TOL; the
    kernel's recompute rounds apart from the plain one's)."""
    inp, x = phi4.parity_inputs("phi4_L16", 37, cuda, seed=20)
    x = x.contiguous()
    D, H, H2, T = inp.dims
    g = torch.Generator().manual_seed(61)
    v, dX, dV = (torch.randn(x.shape, generator=g).to(cuda) for _ in range(3))
    dld = torch.randn((1, 37), generator=g).to(cuda)
    flat, K = fd.site_factors_plain(inp, x, v, dX, dV, dld, False)
    got = fd.reduced_weights(fd.reduce_factors(flat, D, H, H2, K), D, H, H2)
    gx, gv, *_ = fd.trajectory_vjp(inp, x, v, dX, dV, dld, False)
    for mine, ref in zip(got, (gx, gv)):
        for a, i in zip(mine, fd._PRODUCT_WEIGHTS):
            torch.testing.assert_close(a, ref[i], rtol=0, atol=1e-4 * float(ref[i].abs().max()))


def test_captured_fused_step_equals_eager_at_L16(cuda):
    """One fused training step at L = 16 (hidden 32, T = 10, 256 chains) on
    the site-parallel kernels, recorded as a CUDA graph after the captured
    route's warm-up calls on a side stream, against the eager step on the
    same state and draws: the loss and every state tensor bit for bit."""
    from l2hmc_tpu_torch.train import (StepDraws, TrainState, draw_step, init_state,
                                       make_optimizer, make_train_step)
    from l2hmc_tpu_torch.train.optim import AdamState
    from l2hmc_tpu_torch.utils import capture

    t = targets.Phi4Lattice(L=16, m2=-1.0, lam=0.5)
    cfg = ScgConfig(dim=t.dim, n_chains=256, T=10, hidden=32, seed=0)
    dyn, _ = build_dynamics(cfg, t)
    opt, _ = make_optimizer(cfg)
    step = make_train_step(cfg, fd.differentiable_fused(dyn, t), opt)
    state = init_state(cfg, dyn, opt, device=cuda)
    state = state._replace(step=torch.as_tensor(0, dtype=torch.int32, device=cuda))
    d = StepDraws(*(None if a is None else a.to(cuda) for a in draw_step(
        torch.Generator().manual_seed(5), cfg.n_chains, cfg.dim, z_burn_in=True)))

    def copy(s):
        return TrainState(tree_unflatten(s.params, [a.detach().clone() for a in
                                                    tree_leaves(s.params)]),
                          AdamState(*(a.clone() for a in s.opt_state)), s.x.clone(), None,
                          s.step.clone())

    def tensors(s):
        return [*tree_leaves(s.params), *s.opt_state, s.x, s.step]

    before = fd.LAUNCHES["trajectory_bwd:sites"]
    eager, me = step(copy(state), d)
    assert fd.LAUNCHES["trajectory_bwd:sites"] == before + 4
    static, box = copy(state), {}

    def body():
        box["out"] = step(static, d)

    for _ in range(capture.WARMUP_CALLS):
        capture.run_on_side_stream(body)
    capture.Graph(body).replay()
    torch.cuda.synchronize()
    rep, mr = box["out"]
    torch.testing.assert_close(mr["loss"], me["loss"], rtol=0, atol=0)
    for a, b in zip(tensors(rep), tensors(eager)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_captured_fused_lattice_training_equals_eager(cuda):
    """``train``'s captured route against its eager one over 10 fused steps
    at L = 16 (256 chains, the site-parallel kernels): losses, params, Adam
    state, chains and step bit for bit. The fused dynamics return (N, D)
    rows, so the chains' layout, and with it the order of every later sum
    over the sites, is the same on both routes."""
    t = targets.Phi4Lattice(L=16, m2=-1.0, lam=0.5)
    cfg = ScgConfig(dim=t.dim, n_chains=256, T=10, hidden=32, n_steps=10, seed=0,
                    fused_train=True)
    (se, he), (sc, hc) = (train(cfg, t, device=cuda, capture=c) for c in (False, True))
    for k in he:
        np.testing.assert_array_equal(hc[k], he[k], err_msg=k)
    for a, b in zip([*tree_leaves(sc.params), *sc.opt_state, sc.x, sc.step],
                    [*tree_leaves(se.params), *se.opt_state, se.x, se.step]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_suite_icg_runs_its_fused_cross_check(cuda):
    """The suite's icg row (hidden 100, eps_dim) at a tiny depth on the card:
    its fused cross-check runs on the chain kernel's site-parallel
    configuration."""
    before = fd.LAUNCHES["chain:sites"]
    row = suite.run_target("icg", device=cuda, verbose=False, n_chains=64, n_steps=6,
                           eval_steps=20, n_train_seeds=1, val_steps=10)
    assert row["fused_cross_check"] == "ran"
    assert fd.LAUNCHES["chain:sites"] >= before + 2  # the warm-up and the traced eval
    assert np.isfinite(row["ess_l2hmc_fused_trace"])


def test_conv_training_on_the_card_keeps_tf32_off(cuda):
    """Conv S/T/Q training at L = 16 on the card (cuDNN), captured and
    eager: TF32 stays off for matmul and cuDNN, and the two routes' losses
    agree to the SCG training bar (rtol 2e-3, atol 1e-2)."""
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    tgt = targets.Phi4Lattice(L=16, m2=-1.0, lam=0.5)
    cfg = ScgConfig(dim=tgt.dim, n_chains=64, n_steps=5, T=3, net_type="conv", eps=0.05)
    _, he = train(cfg, tgt, device=cuda, capture=False)
    _, hc = train(cfg, tgt, device=cuda, capture=True)
    assert np.isfinite(hc["loss"]).all()
    np.testing.assert_allclose(hc["loss"], he["loss"], rtol=2e-3, atol=1e-2)


# -- the VAE kernels ------------------------------------------------------------


def _scale_heads(net, c):
    """The S, T and Q heads' weights of a ``stq_net`` params tree times c."""
    (s_lin, s_st), t_lin, (q_lin, q_st) = net[5]

    def scaled(lin):
        return {"w": lin["w"] * c, "b": lin["b"]}

    return (*net[:5], ((scaled(s_lin), s_st), scaled(t_lin), (scaled(q_lin), q_st)))


def _vae_setup(cuda, full: bool, n: int, latent_dim: int = 8, hidden: int = 16):
    """A seeded VAE at the full or the small width with a {0, 1} batch, its
    embedding and a start state on the card. The decoder's last layer
    (init factor 0.01) is scaled by 10 so that logits are O(1). At the full
    width the embedding already drives S, T, Q to ~0.2 and the heads are
    halved; at the small width (latent ``latent_dim``, the nets' first
    layer ``hidden`` wide) every net weight is lifted by 0.02."""
    from l2hmc_tpu_torch.apps import vae

    cfg = vae.VaeConfig() if full else vae.VaeConfig(
        latent_dim=latent_dim, leapfrogs=3, enc_hidden=32, sampler_size1=hidden,
        sampler_size2=16)
    model = vae.VaeModel.build(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), device=cuda)
    smp = dict(params["smp"])
    for net in ("xnet", "vnet"):
        smp[net] = _scale_heads(smp[net], 0.5) if full else _add(smp[net], 0.02)
    dec = list(params["dec"])
    dec[4] = {"w": dec[4]["w"] * 10.0, "b": dec[4]["b"] + 0.1}
    params = {**params, "smp": smp, "dec": tuple(dec)}
    g = torch.Generator().manual_seed(1)
    x_raw = (torch.rand((n, 784), generator=g) < 0.3).float().to(cuda)
    z0 = torch.randn((n, cfg.latent_dim), generator=g).to(cuda)
    emb = model.aux_encoder.apply(params["smp"]["aux_enc"], x_raw)
    return model, params, x_raw, emb, z0


@pytest.mark.parametrize("composed", [False, True], ids=["single", "composed"])
@pytest.mark.parametrize("full,n", [(True, 9), (True, 16), (True, 203), (True, 256),
                                    (False, 77)],
                         ids=["full-n9", "full-n16", "full-n203", "full-n256", "small-n77"])
def test_vae_chain_kernel_matches_plain_on_same_bits(cuda, full, n, composed):
    """Same Philox bits, 3 recorded steps, at chain counts under one
    cluster's 16, exactly one cluster, a ragged last cluster and whole
    clusters. A flipped accept needs |px - u| within the float32 gap of the
    two Hamiltonians (~1e-4 of energies of a few hundred), so at most 2 of
    these decisions may flip; chains with no flip agree to 2e-3 (sums of
    1024 terms in another order, through up to 9 trajectories). A second
    launch repeats the first bit for bit (the ranks' shares of the energy
    are added in rank order, no atomics)."""
    model, params, x_raw, emb, z0 = _vae_setup(cuda, full, n)
    xr = x_raw.T.contiguous()
    inp = fv.prepare_vae(model.dynamics, params["smp"], params["dec"], xr, emb.T.contiguous())
    nb = [2, 1, 3] if composed else None
    zT = z0.T.contiguous()
    before = fd.LAUNCHES["vae_chain"]
    zk, acck, trk = fv.vae_chain(inp, xr, zT, seed=4, n_mh_steps=3, collect_trace=True, nb=nb)
    assert fd.LAUNCHES["vae_chain"] == before + 1
    again = fv.vae_chain(inp, xr, zT, seed=4, n_mh_steps=3, collect_trace=True, nb=nb)
    for a, b in zip((zk, acck, trk), again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    zp, accp, trp = fv.vae_chain_plain(inp, zT, seed=4, n_mh_steps=3, collect_trace=True, nb=nb)
    torch.testing.assert_close(trk[-1], zk, rtol=0, atol=0)
    assert torch.isfinite(trk).all()
    ops = 6 if composed else 3
    flipped = (acck - accp).abs()[0] * ops > 0.5
    assert int(flipped.sum()) <= 2
    torch.testing.assert_close(trk[:, :, ~flipped], trp[:, :, ~flipped], rtol=0, atol=2e-3)
    # a mean acceptance strictly inside (0, 1) is asked of the wide batches
    # only: all 9 or 16 chains may accept all of their ops
    assert 0.0 < float(acck.mean()) < 1.0 or not full or n < 200
    assert float((zk - zT).abs().max()) > 0.05  # the chains moved


@pytest.mark.parametrize("dims", [(50, 200, 200, 5, 1024, 784), (8, 16, 16, 3, 32, 784)],
                         ids=["reference", "small"])
def test_vae_chain_sizes_match_the_host_mirror(cuda, dims):
    """What the sampler's source reports for the host to allocate: its
    cluster configuration is ``fused_vae.CHAIN_CLUSTER``, its shared memory
    per CTA the host's mirror of its carve, its scratch one act_floats slice
    per cluster, and at the protocol's 200 chains 13 clusters of 8 CTAs,
    which the card holds at once."""
    D, H, H2, T, E, P = dims
    got = fv.chain_sizes(dims, 200)
    ct, g = fv.CHAIN_CLUSTER
    assert (got["ct"], got["g"]) == (ct, g)
    assert got["smem_bytes"] == 4 * fv.chain_smem_floats(ct, g, D, H, H2, E, P)
    assert got["act"] == 13 * ct * (2 * E + P + H + H2)
    assert got["ctas"] == 104
    assert fv.chain_max_clusters(dims) * g >= got["ctas"]


@pytest.mark.parametrize("anneal_steps", [1, 20])
@pytest.mark.parametrize("n", [1000, 203, 77])
@pytest.mark.parametrize("full", [True, False], ids=["full", "small"])
def test_vae_ais_kernel_matches_plain_on_same_bits(cuda, full, n, anneal_steps):
    """Same Philox bits, at the protocol's 1000 chains and at two counts
    that leave the last cluster ragged. A flipped accept sends a chain down
    another path and moves its log w by O(1); chains within 0.05 count as
    unflipped, at most 2 may flip, and on the others log w (values of
    700-1300) agrees to 5e-3 and the mean acceptance probability to 5e-3 (a
    Hamiltonian difference of energies near 1e3 carries ~1e-3 of float32
    rounding). A second launch repeats the first bit for bit."""
    model, params, x_raw, _, z0 = _vae_setup(cuda, full, n)
    dec = fv.decoder_arrays(params["dec"])
    xr, zT = x_raw.T.contiguous(), z0.T.contiguous()
    before = fd.LAUNCHES["vae_ais"]
    wk, acck = fv.vae_ais(dec, xr, zT, seed=6, anneal_steps=anneal_steps, step_size=0.05,
                          leapfrogs=10)
    assert fd.LAUNCHES["vae_ais"] == before + 1
    wk2, acck2 = fv.vae_ais(dec, xr, zT, seed=6, anneal_steps=anneal_steps, step_size=0.05,
                            leapfrogs=10)
    torch.testing.assert_close(wk2, wk, rtol=0, atol=0)
    torch.testing.assert_close(acck2, acck, rtol=0, atol=0)
    wp, accp = fv.vae_ais_plain(dec, xr, zT, seed=6, anneal_steps=anneal_steps,
                                step_size=0.05, leapfrogs=10)
    assert torch.isfinite(wk).all()
    clean = (wk - wp).abs()[0] < 0.05
    assert int((~clean).sum()) <= 2
    torch.testing.assert_close(wk[:, clean], wp[:, clean], rtol=0, atol=5e-3)
    torch.testing.assert_close(acck[:, clean], accp[:, clean], rtol=0, atol=5e-3)
    assert float(acck.min()) > 0.0 and float(acck.max()) <= 1.0


@pytest.mark.parametrize("dims", [(50, 1024, 784), (8, 32, 784)], ids=["reference", "small"])
def test_vae_ais_sizes_match_the_host_mirror(cuda, dims):
    """What the AIS source reports for the host to check (its chains per CTA
    and CTAs per cluster, shared memory per CTA, ring and grid) is the
    host's mirror of its plan, and the card holds its clusters: at the
    protocol's 1000 chains, 126 CTAs in one wave."""
    D, E, P = dims
    got = fv.ais_sizes(dims, 1000)
    c, g = fv.AIS_TILE
    assert (got["c"], got["g"]) == (c, g)
    assert got["smem_bytes"] == fv.ais_smem_bytes(D, E, P)
    assert (got["slots"], got["slot_floats"]) == (fv._AIS_SLOTS, fv._AIS_SLOT_FLOATS)
    assert got["ctas"] == 126  # 125 CTAs of 8 chains, rounded up to whole clusters
    assert fv.ais_max_clusters(dims) * g >= got["ctas"]


def test_vae_wrappers_reject_bad_input(cuda):
    model, params, x_raw, emb, z0 = _vae_setup(cuda, False, 16)
    xr = x_raw.T.contiguous()
    inp = fv.prepare_vae(model.dynamics, params["smp"], params["dec"], xr, emb.T.contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        fv.vae_chain(inp, xr, z0.T, seed=0, n_mh_steps=1)
    with pytest.raises(ValueError, match="expected"):
        fv.vae_chain(inp, xr, z0.T.contiguous().cpu(), seed=0, n_mh_steps=1)
    with pytest.raises(ValueError, match="op count"):
        fv.vae_chain(inp, xr, z0.T.contiguous(), seed=0, n_mh_steps=2, nb=[1, 0])


# -- the VAE training kernels -----------------------------------------------------


def _vae_traj_inputs(cuda, full, n, latent_dim=8, hidden=16):
    model, params, x_raw, emb, z0 = _vae_setup(cuda, full, n, latent_dim, hidden)
    xr = x_raw.T.contiguous()
    inp = fv.prepare_vae(model.dynamics, params["smp"], params["dec"], xr, emb.T.contiguous())
    g = torch.Generator().manual_seed(2)
    v, dZ, dV = (torch.randn(z0.T.shape, generator=g).to(cuda) for _ in range(3))
    dld = torch.randn((1, n), generator=g).to(cuda)
    return model, params, inp, xr, z0.T.contiguous(), v, dZ, dV, dld


def _cluster_cases():
    """The kernels' cluster configuration (Ct chains per cluster) at the
    full width on the chain counts at its edges (one chain, one short of and
    one past a cluster, a ragged last cluster, the training batch), and at
    the small width once; and at a latent of 128, where the first product of
    a net (K = 256) and of the decoder (K = 128) have more chunks than the
    ring holds at once and stream their inputs through it from the
    cluster's shared memory."""
    ct, g = fv.CLUSTER
    cases = [pytest.param(True, n, 8, id=f"ct{ct}g{g}-full-n{n}")
             for n in (1, ct - 1, ct + 1, 203, 512)]
    cases.append(pytest.param(False, 77, 8, id=f"ct{ct}g{g}-small-n77"))
    cases.append(pytest.param(False, 45, 128, id=f"ct{ct}g{g}-latent128-n45"))
    return cases


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("full,n,latent", _cluster_cases())
def test_vae_traj_kernel_matches_plain(cuda, full, n, latent, reverse):
    """The training trajectory against its plain version, 5e-4 (bench.py's
    gate); forward then reverse inverts."""
    _, _, inp, xr, z, v, _, _, _ = _vae_traj_inputs(cuda, full, n, latent)
    before = fd.LAUNCHES["vae_traj"]
    got = fv.vae_trajectory(inp, xr, z, v, reverse)
    assert fd.LAUNCHES["vae_traj"] == before + 1
    want = fv.vae_trajectory_plain(inp, z, v, reverse)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=TOL)
    z2, v2, ld2 = fv.vae_trajectory(inp, xr, got[0], got[1], not reverse)
    torch.testing.assert_close(z2, z, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(ld2, -got[2], rtol=1e-3, atol=1e-3)
    assert float((got[0] - z).abs().max()) > 0.05  # the chains moved


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("full,n,latent", _cluster_cases())
def test_vae_traj_bwd_kernel_matches_plain(cuda, full, n, latent, reverse):
    """The VJP kernel against its plain version: every leaf within 1e-4 of
    the leaf's largest entry (sums over chains and over up to 1024 terms in
    another order), and twice in a row bit for bit (no atomics). The nets
    are ReLU nets, so a hidden pre-activation within rounding of zero can
    gate differently in the two and change that chain's cotangents by whole
    terms: such chains show in their own outputs (demb, dz, dv), may be at
    most 1, must have a pre-activation of the plain trajectory within 1e-5
    of its layer's largest (``relu_margins``), and are set aside by a second
    comparison with their incoming cotangents zeroed."""
    _, _, inp, xr, z, v, dZ, dV, dld = _vae_traj_inputs(cuda, full, n, latent)
    before = fd.LAUNCHES["vae_traj_bwd"]
    got = fv.vae_trajectory_vjp(inp, xr, z, v, dZ, dV, dld, reverse)
    assert fd.LAUNCHES["vae_traj_bwd"] == before + 1
    again = fv.vae_trajectory_vjp(inp, xr, z, v, dZ, dV, dld, reverse)
    for a, b in zip(tree_leaves(list(got)), tree_leaves(list(again))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    want = fv.vae_trajectory_vjp_plain(inp, z, v, dZ, dV, dld, reverse)
    flipped = torch.zeros(n, dtype=torch.bool, device=cuda)
    for a, b in zip(got[3:], want[3:]):
        flipped |= (a - b).abs().amax(dim=0) > 1e-4 * b.abs().max()
    assert int(flipped.sum()) <= 1
    if bool(flipped.any()):
        assert float(fd.relu_margins(inp, z, v, reverse)[flipped].max()) < 1e-5
        keep = (~flipped).float()[None, :]
        got = fv.vae_trajectory_vjp(inp, xr, z, v, dZ * keep, dV * keep, dld * keep, reverse)
        want = fv.vae_trajectory_vjp_plain(inp, z, v, dZ * keep, dV * keep, dld * keep, reverse)
    for a, b in zip(tree_leaves(list(got)), tree_leaves(list(want))):
        assert float(b.abs().max()) > 0
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * float(b.abs().max()))


def test_vae_backward_through_function_launches_kernels(cuda):
    """``DifferentiableFusedVae`` on CUDA tensors: forward launches the
    trajectory kernel, ``backward()`` the VJP kernel, never the plain
    versions; the gradients reach alpha, both nets and the aux encoder and
    agree with the plain ``Dynamics`` under autograd to 2e-3 of each leaf's
    largest entry (a ReLU gate may flip in one of 64 chains)."""
    from l2hmc_tpu_torch.ops import DifferentiableFusedVae
    from l2hmc_tpu_torch.train.optim import tree_unflatten

    model, params, x_raw, _, z0 = _vae_setup(cuda, False, 64)
    v0 = torch.randn(z0.shape, generator=torch.Generator().manual_seed(5)).to(cuda)

    def grads(dyn):
        leaves = [leaf.detach().requires_grad_(True) for leaf in tree_leaves(params["smp"])]
        smp = tree_unflatten(params["smp"], leaves)
        aux = {"raw": x_raw, "emb": model.aux_encoder.apply(smp["aux_enc"], x_raw),
               "dec": params["dec"]}
        Z, V, ld = dyn.forward(smp, z0, v0, aux=aux)
        Zb, Vb, ldb = dyn.backward(smp, z0, v0, aux=aux)
        loss = torch.mean(Z * Zb) + torch.mean(V + Vb) + torch.mean(ld - 2.0 * ldb)
        return torch.autograd.grad(loss, leaves)

    def forbidden(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    before = dict(fd.LAUNCHES)
    plain, plain_vjp = fv.vae_trajectory_plain, fv.vae_trajectory_vjp_plain
    fv.vae_trajectory_plain = fv.vae_trajectory_vjp_plain = forbidden
    try:
        fused = grads(DifferentiableFusedVae(model.dynamics))
    finally:
        fv.vae_trajectory_plain, fv.vae_trajectory_vjp_plain = plain, plain_vjp
    assert fd.LAUNCHES["vae_traj"] == before["vae_traj"] + 2
    assert fd.LAUNCHES["vae_traj_bwd"] == before["vae_traj_bwd"] + 2
    for a, b in zip(fused, grads(model.dynamics)):
        assert float(b.abs().max()) > 0
        torch.testing.assert_close(a, b, rtol=0, atol=2e-3 * float(b.abs().max()))


def test_vae_traj_wrappers_reject_bad_input(cuda):
    _, _, inp, xr, z, v, dZ, dV, dld = _vae_traj_inputs(cuda, False, 16)
    with pytest.raises(ValueError, match="contiguous"):
        fv.vae_trajectory(inp, xr, z, v.T.contiguous().T, False)
    with pytest.raises(ValueError, match="expected"):
        fv.vae_trajectory(inp, xr, z.cpu(), v, False)
    with pytest.raises(ValueError, match="shape"):
        fv.vae_trajectory_vjp(inp, xr, z, v, dZ, dV, dld[0], False)
    # nets 6000 wide: the backward kernel's outer products would stage a
    # [6000][Ct] operand, past a CTA's shared memory by the source's reckoning
    _, _, inp, xr, z, v, dZ, dV, dld = _vae_traj_inputs(cuda, False, 16, hidden=6000)
    with pytest.raises(ValueError, match="shared memory"):
        fv.vae_trajectory_vjp(inp, xr, z, v, dZ, dV, dld, False)


# (D, H, H2, T, E, P): the reference model, the small width, a latent of 128
_WIDTHS = [(50, 200, 200, 5, 1024, 784), (8, 16, 16, 3, 32, 784), (128, 16, 16, 3, 32, 784)]


@pytest.mark.parametrize("dims", _WIDTHS, ids=["reference", "small", "latent128"])
def test_vae_traj_sizes_match_the_host_reckoning(cuda, dims):
    """What the sources report for the host to allocate: their cluster
    configuration is ``fused_vae.CLUSTER``, their shared memory per CTA is
    the host's mirror of their carve, and at the training batch of 512
    chains (13 clusters of 40) the scratches are those the source notes
    reckon."""
    D, H, H2, T, E, P = dims
    n = 512
    fwd = fv.kernel_sizes("vae_traj", dims, n)
    bwd = fv.kernel_sizes("vae_traj_bwd", dims, n)
    ct, g = fv.CLUSTER
    assert (fwd["ct"], fwd["g"]) == (bwd["ct"], bwd["g"]) == (ct, g)
    assert fwd["smem_bytes"] == 4 * fv.traj_smem_floats(ct, g, D, H, H2, E, P)
    assert bwd["smem_bytes"] == 4 * fv.bwd_smem_floats(ct, g, D, H, H2, E, P)
    clusters = -(-n // ct)
    n_grads = 2 * sum(fv._net_sizes(D, H, H2, T)) + D
    assert fwd["act"] == clusters * ct * (2 * E + P + H + H2)
    assert bwd["act"] == clusters * ct * (2 * (2 * E + P) + 2 * H + 2 * H2 + 3 * D
                                          + 4 * T * (H + H2 + 3 * D))
    assert bwd["partial"] == clusters * n_grads
    assert bwd["bnd"] == (5 * T + 3) * D * n
    if dims == _WIDTHS[0]:
        assert bwd["act"] == 13 * 704560 and n_grads == 182950
    assert fv.max_clusters(dims, False) > 0 and fv.max_clusters(dims, True) > 0


# -- bfloat16 operands in the VAE kernels -----------------------------------------
#
# Each kernel's bf16 instantiation against its plain version with the same
# operands (ops/operands.py): both round at the same sites, so they differ
# only where float32 sums in another order cross a bf16 rounding boundary,
# and each comparison is held to a share of the gap between the plain bf16
# and plain float32 results on the same inputs, chip_smoke's phase 12 bars
# (BF16_GAP_SHARE; the VJP at the full width BF16_VJP_GAP_SHARE and its
# signal shares, chip_smoke's own check; at most a fifth of the chains may
# flip, BF16_FLIP_SHARE).

BF16_SHARE = 0.5
BF16_FLIPS = 0.2


def _gap(a, b, mask=None):
    d = (a - b).abs()
    if mask is not None:
        d = d[..., mask]
    return float(d.max()) if d.numel() else 0.0


def _rms(a, b, mask=None):
    d = (a - b).double()
    if mask is not None:
        d = d[..., mask]
    return float(d.pow(2).mean().sqrt()) if d.numel() else 0.0


def _bf16_inputs(model, params, xr, emb):
    return fv.prepare_vae(model.dynamics, params["smp"], params["dec"], xr, emb,
                          compute_dtype="bfloat16")


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("full,n", [(True, 41), (True, 203), (False, 77)],
                         ids=["full-n41", "full-n203", "small-n77"])
def test_vae_bf16_training_kernels_match_plain(cuda, full, n, reverse):
    """The bf16 trajectory and VJP kernels against their plain bf16
    versions: the trajectory within half the plain bf16-float32 gap in RMS
    and in max-norm (at the full width, where a flipped rounding moves a
    chain, within the gap), apart from the float32 kernel's, inverting as
    the plain version does (at most a fifth of the chains miss by more than
    1e-4, none by more than 2e-2), twice bit for bit; the VJP at chip_smoke's
    bars (``_vjp_bars_hold``: every leaf within its bf16-float32 gap in RMS
    at the full width, half of it at the small one, and carrying the plain
    version's bf16 signals, which the float32 kernel and a VJP without the
    cotangents' rounding miss), twice bit for bit; each launch counted as a
    bf16 one."""
    model, params, inp32, xr, z, v, dZ, dV, dld = _vae_traj_inputs(cuda, full, n)
    inp = _bf16_inputs(model, params, xr, inp32.emb)
    before = dict(fd.LAUNCHES)
    got = fv.vae_trajectory(inp, xr, z, v, reverse)
    assert fd.LAUNCHES["vae_traj:bf16"] == before["vae_traj:bf16"] + 1
    again = fv.vae_trajectory(inp, xr, z, v, reverse)
    for a, b in zip(got, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    ref = fv.vae_trajectory_plain(inp, z, v, reverse)
    ref32 = fv.vae_trajectory_plain(inp32, z, v, reverse)
    k32 = fv.vae_trajectory(inp32, xr, z, v, reverse)
    full_share = 1.0 if full else BF16_SHARE
    for a, b, c, d in zip(got, ref, ref32, k32):
        assert torch.isfinite(a).all()
        assert _gap(a, b) <= full_share * _gap(b, c)
        assert _rms(a, b) <= BF16_SHARE * _rms(b, c)
        assert _gap(a, d) > 0
    z2, v2, _ = fv.vae_trajectory(inp, xr, got[0], got[1], not reverse)
    miss = torch.maximum((z2 - z).abs().amax(0), (v2 - v).abs().amax(0))
    assert int((miss > 1e-4).sum()) <= BF16_FLIPS * n and float(miss.max()) <= 2e-2

    from chip_smoke import BF16_VJP_GAP_SHARE, _bf16_vjp_compare, _vjp_bars_hold

    before = fd.LAUNCHES["vae_traj_bwd:bf16"]
    case = _bf16_vjp_compare(fv, inp, inp32, xr, z, v, dZ, dV, dld, reverse)
    assert fd.LAUNCHES["vae_traj_bwd:bf16"] == before + 2
    assert case["repeats_bit_for_bit"]
    assert _vjp_bars_hold(case, BF16_VJP_GAP_SHARE if full else BF16_SHARE), case


@pytest.mark.parametrize("composed", [False, True], ids=["single", "composed"])
@pytest.mark.parametrize("full,n", [(True, 9), (True, 203), (False, 77)],
                         ids=["full-n9", "full-n203", "small-n77"])
def test_vae_bf16_chain_kernel_matches_plain_on_same_bits(cuda, full, n, composed):
    """The bf16 sampler on the same Philox bits as its plain bf16 version,
    3 recorded steps: at most a fifth of the chains (or 2) flip an accept or
    a step's move or part by 0.1, and the chains that flipped in neither
    comparison agree within half the plain bf16-float32 gap in RMS; apart
    from the float32 kernel; twice bit for bit."""
    model, params, x_raw, emb, z0 = _vae_setup(cuda, full, n)
    xr, embT, zT = x_raw.T.contiguous(), emb.T.contiguous(), z0.T.contiguous()
    inp = _bf16_inputs(model, params, xr, embT)
    inp32 = fv.prepare_vae(model.dynamics, params["smp"], params["dec"], xr, embT)
    kw = dict(seed=4, n_mh_steps=3, collect_trace=True, nb=[2, 1, 3] if composed else None)
    before = fd.LAUNCHES["vae_chain:bf16"]
    zk, acck, trk = fv.vae_chain(inp, xr, zT, **kw)
    assert fd.LAUNCHES["vae_chain:bf16"] == before + 1
    for a, b in zip((zk, acck, trk), fv.vae_chain(inp, xr, zT, **kw)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    _, accp, trp = fv.vae_chain_plain(inp, zT, **kw)
    _, acc3, tr3 = fv.vae_chain_plain(inp32, zT, **kw)
    ops = 6 if composed else 3

    def moved(tr):
        return (tr != torch.cat([zT[None], tr[:-1]])).any(dim=1)

    def flips(tr_a, acc_a, tr_b, acc_b):
        return (((acc_a - acc_b).abs()[0] * ops > 0.5) | (moved(tr_a) != moved(tr_b)).any(0)
                | ((tr_a - tr_b).abs().amax(dim=(0, 1)) > 0.1))

    flipped, flip32 = flips(trk, acck, trp, accp), flips(trp, accp, tr3, acc3)
    clean = ~(flipped | flip32)
    assert int(flipped.sum()) <= max(2, BF16_FLIPS * n)
    assert _rms(trk, trp, clean) <= BF16_SHARE * _rms(trp, tr3, clean)
    assert _gap(zk, fv.vae_chain(inp32, xr, zT, **kw)[0]) > 0
    assert torch.isfinite(trk).all() and float((zk - zT).abs().max()) > 0.05


@pytest.mark.parametrize("n", [1000, 203])
@pytest.mark.parametrize("full", [True, False], ids=["full", "small"])
def test_vae_bf16_ais_kernel_matches_plain_on_same_bits(cuda, full, n):
    """The bf16 AIS kernel (its stream in bfloat16) on the same bits as its
    plain bf16 version, 20 anneal steps: at most a fifth of the chains (or
    2) with log w apart by 0.5 or more (a flipped accept), log w within half
    the plain bf16-float32 gap in median over 20 steps and in RMS over one;
    apart from the float32 kernel; twice bit for bit."""
    model, params, x_raw, _, z0 = _vae_setup(cuda, full, n)
    dec = fv.decoder_arrays(params["dec"])
    xr, zT = x_raw.T.contiguous(), z0.T.contiguous()
    kw = dict(seed=6, anneal_steps=20, step_size=0.05, leapfrogs=10)
    before = fd.LAUNCHES["vae_ais:bf16"]
    wk, acck = fv.vae_ais(dec, xr, zT, **kw, compute_dtype="bfloat16")
    assert fd.LAUNCHES["vae_ais:bf16"] == before + 1
    wk2, acck2 = fv.vae_ais(dec, xr, zT, **kw, compute_dtype="bfloat16")
    assert torch.equal(wk, wk2) and torch.equal(acck, acck2)
    wp, _ = fv.vae_ais_plain(dec, xr, zT, **kw, compute_dtype="bfloat16")
    w3, _ = fv.vae_ais_plain(dec, xr, zT, **kw)
    assert int(((wk - wp).abs()[0] >= 0.5).sum()) <= max(2, BF16_FLIPS * n)
    assert float((wk - wp).abs().median()) <= BF16_SHARE * float((wp - w3).abs().median())
    kw1 = dict(kw, anneal_steps=1)
    w1k, _ = fv.vae_ais(dec, xr, zT, **kw1, compute_dtype="bfloat16")
    w1p, _ = fv.vae_ais_plain(dec, xr, zT, **kw1, compute_dtype="bfloat16")
    w13, _ = fv.vae_ais_plain(dec, xr, zT, **kw1)
    assert _rms(w1k, w1p) <= BF16_SHARE * _rms(w1p, w13)
    assert _gap(wk, fv.vae_ais(dec, xr, zT, **kw)[0]) > 0
    assert torch.isfinite(wk).all()


# -- captured steps against eager on the card ------------------------------------

# the reference architecture plain and fused, and bench's best recipe (plain)
CAPTURE_CASES = {
    "reference_plain": dict(),
    "reference_fused": dict(fused_train=True),
    "best_recipe": dict(eps_mat=True, whiten_full=True, per_dim_loss=True,
                        z_burn_in_loss=False, autocorr_penalty=200.0),
}


@pytest.mark.parametrize("case", list(CAPTURE_CASES))
def test_captured_training_equals_eager(cuda, case):
    """20 training steps at 1024 chains from one seed, eager (the generator
    drawing inside each step) and captured (one step replayed as a CUDA
    graph, in two chunks, on draws made ahead): losses, metrics, params,
    Adam state, chains and step bit for bit, and the same kernel launches."""
    cfg = ScgConfig(n_chains=1024, n_steps=20, **CAPTURE_CASES[case])
    runs = {}
    for capture in (False, True):
        fd.reset_launch_counts()
        state, hist = train(cfg, device=cuda, capture=capture, log_every=10 if capture else 0)
        runs[capture] = (state, hist, dict(fd.LAUNCHES))
    (se, he, le), (sc, hc, lc) = runs[False], runs[True]
    for k in he:
        np.testing.assert_array_equal(hc[k], he[k], err_msg=k)
    for a, b in zip([*tree_leaves(sc.params), *sc.opt_state, sc.x, sc.step],
                    [*tree_leaves(se.params), *se.opt_state, se.x, se.step]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert lc == le
    if cfg.fused_train:
        assert lc["trajectory"] == lc["trajectory_bwd"] == 4 * 20


# an annealed ring (the temperature from the device step counter) and the
# funnel with its net-input features
SUITE_CAPTURE_CASES = {
    "ring_annealed": (lambda: targets.gen_ring(r=2.0, var=0.1, nb_mixtures=4),
                      dict(init_temperature=5.0, eps=0.2)),
    "funnel_net_input": (lambda: targets.GaussianFunnel(dim=10),
                         dict(net_input_target_fn=True, hidden=20, grad_clip=5.0)),
}


@pytest.mark.parametrize("case", list(SUITE_CAPTURE_CASES))
def test_captured_suite_training_equals_eager(cuda, case):
    """20 training steps of the suite's annealed and net-input recipes at
    1024 chains, eager and captured: losses, metrics (the temperature
    among them), params, Adam state, chains and step bit for bit."""
    make, kw = SUITE_CAPTURE_CASES[case]
    tgt = make()
    cfg = ScgConfig(dim=tgt.dim, n_chains=1024, n_steps=20, **kw)
    runs = {}
    for capture in (False, True):
        runs[capture] = train(cfg, tgt, device=cuda, capture=capture,
                              log_every=10 if capture else 0)
    (se, he), (sc, hc) = runs[False], runs[True]
    for k in he:
        np.testing.assert_array_equal(hc[k], he[k], err_msg=k)
    for a, b in zip([*tree_leaves(sc.params), *sc.opt_state, sc.x, sc.step],
                    [*tree_leaves(se.params), *se.opt_state, se.x, se.step]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    if cfg.init_temperature > 1.0:
        assert hc["temperature"][0] == 5.0 and hc["temperature"][-1] < 5.0


@pytest.mark.parametrize("hmc", [False, True], ids=["l2hmc", "hmc"])
def test_captured_sample_chain_equals_eager(cuda, hmc):
    """50 MH steps of the plain sampler at 1024 chains, eager and captured
    (one MH step replayed, the draws made ahead in the eager order): the
    traces and final states bit for bit."""
    dyn, tgt = build_dynamics(ScgConfig(n_chains=1024))
    params = dyn.init_params(torch.Generator().manual_seed(0), device=cuda)
    for net in ("xnet", "vnet"):
        params[net] = _add(params[net], 0.03)
    x0 = tgt.sample(torch.Generator().manual_seed(1), 1024, device=cuda)
    runs = []
    for capture in (False, True):
        gen = torch.Generator().manual_seed(2)
        if hmc:
            runs.append(hmc_sample_chain(tgt, 0.15, 10, x0, 50, gen, capture=capture))
        else:
            runs.append(sample_chain(dyn, params, x0, 50, gen, capture=capture))
    for a, b in zip(*runs):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# -- bfloat16 operands in kernels 1 and 3 -------------------------------------------
#
# The trajectory and chain kernels' bf16 instantiations against their plain
# versions with the same operands (``KernelInputs.cd``), at chip_smoke's
# phase 13 shapes and bars (``_bf16_traj_compare``, ``_bf16_chain_compare``:
# shares of the plain bf16-float32 gap, at most a fifth of the chains
# flipped or missing the inverse by more than 1e-4, twice bit for bit).


def _bf16_case(cuda, case, n, seed):
    """Float32 kernel inputs and (D, n) states of a phase-13 case."""
    from chip_smoke import _phi4_inputs

    if case == "scg":
        dyn, tgt = build_dynamics(ScgConfig())
        params = dyn.init_params(torch.Generator().manual_seed(seed), eps=0.1, device=cuda)
        for net in ("xnet", "vnet"):
            params[net] = _add(params[net], 0.03)
        inp = fd.prepare(dyn, fd.energy_spec_for_target(tgt), params, cuda)
        x = tgt.sample(torch.Generator().manual_seed(seed + 1), n, device=cuda).T
    elif case in ("rough_well_easy", "icg"):
        inp, x = suite.parity_inputs(case, n, cuda, seed=seed)
    elif case == "phi4_L8":
        inp, x = phi4.parity_inputs(case, n, cuda, seed=seed)
    else:
        inp, x = _phi4_inputs(fd, cuda, case, seed)
    return inp, x.contiguous()


def _bf16(inp):
    return dataclasses.replace(inp, cd=torch.bfloat16)


@pytest.mark.parametrize("case,n", [("scg", 2048), ("scg", 203), ("scg", 37),
                                    ("rough_well_easy", 2048), ("rough_well_easy", 203),
                                    ("phi4_L8", 512)])
def test_bf16_trajectory_kernel_matches_plain(cuda, case, n):
    """The bf16 trajectory kernel (SCG on ScgLanes, the rough well and phi^4
    at L = 8 on WideLanes) against its plain bf16 version, both directions:
    within half the plain bf16-float32 gap in max-norm and RMS, apart from
    the float32 kernel, inverting as the plain version does, twice bit for
    bit; three bf16 launches a direction."""
    from chip_smoke import _bf16_traj_compare

    inp32, x = _bf16_case(cuda, case, n, 20)
    v = torch.randn(x.shape, generator=torch.Generator().manual_seed(22)).to(cuda)
    before = fd.LAUNCHES["trajectory:bf16"]
    _bf16_traj_compare(fd, _bf16(inp32), inp32, x, v, f"trajectory bf16 {case} {n}")
    assert fd.LAUNCHES["trajectory:bf16"] == before + 6


@pytest.mark.parametrize("case,n", [("scg", 1024), ("scg", 203), ("scg", 37),
                                    ("rough_well_easy", 2048), ("L16", 512), ("L64", 256),
                                    ("icg", 2048), ("icg", 203)])
def test_bf16_chain_kernel_matches_plain_on_same_bits(cuda, case, n):
    """The bf16 chain kernel on the same Philox bits as its plain bf16
    version, 20 traced MH steps: lane groups (SCG, the rough well) and the
    site-parallel configuration (phi^4 at L = 16 and at L = 64, dim 4096;
    icg at hidden 100, 128 hidden units): at most a fifth of the chains with
    a flipped decision, the others within half the plain bf16-float32 gap in
    RMS, apart from the float32 kernel, twice bit for bit."""
    from chip_smoke import _bf16_chain_compare

    inp32, xc = _bf16_case(cuda, case, n, 40)
    xc = xc[:, :n].contiguous()
    before = fd.LAUNCHES["chain:bf16"]
    _bf16_chain_compare(fd, _bf16(inp32), inp32, xc, f"chain bf16 {case} {n}")
    assert fd.LAUNCHES["chain:bf16"] == before + 2


def test_differentiable_fused_bf16_on_the_card(cuda):
    """``differentiable_fused(compute_dtype="bfloat16")`` on the card: the
    forward launches the bf16 trajectory kernel and equals it, the backward
    launches the float32 backward kernel, and the gradients of a linear
    projection of the outputs equal the float32 route's bit for bit (the
    VJP reads the unrounded inputs, not the forward's outputs)."""
    dyn, tgt = build_dynamics(ScgConfig())
    params = dyn.init_params(torch.Generator().manual_seed(0), eps=0.1, device=cuda)
    for net in ("xnet", "vnet"):
        params[net] = _add(params[net], 0.03)
    x = tgt.sample(torch.Generator().manual_seed(1), 333, device=cuda)
    v = torch.randn(x.shape, generator=torch.Generator().manual_seed(2)).to(cuda)
    cot = [torch.randn(s, generator=torch.Generator().manual_seed(3)).to(cuda)
           for s in (x.shape, x.shape, (333,))]
    grads = {}
    for cd in ("bfloat16", None):
        leaves = [l.clone().requires_grad_(True) for l in tree_leaves(params)]
        p = tree_unflatten(params, leaves)
        before = dict(fd.LAUNCHES)
        out = fd.differentiable_fused(dyn, tgt, compute_dtype=cd).forward(p, x, v)
        loss = sum((o * c).sum() for o, c in zip(out, cot))
        grads[cd] = torch.autograd.grad(loss, leaves)
        assert fd.LAUNCHES["trajectory:bf16"] - before["trajectory:bf16"] == (1 if cd else 0)
        assert fd.LAUNCHES["trajectory_bwd"] - before["trajectory_bwd"] == 1
        if cd:
            inp = fd.prepare(dyn, fd.energy_spec_for_target(tgt), params, cuda, compute_dtype=cd)
            ref = fd.trajectory(inp, x.T.contiguous(), v.T.contiguous(), False)
            for a, b in zip(out, (ref[0].T, ref[1].T, ref[2][0])):
                torch.testing.assert_close(a.detach(), b, rtol=0, atol=0)
    for a, b in zip(grads["bfloat16"], grads[None]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
