"""The chain kernel's widest forms on the CPU: the 64 x 64 phi^4 lattice
(dim 4096, the JAX sampler's ``loop_traj`` form) and the suite's
ill-conditioned Gaussian at hidden 100, the plain chain against the JAX chain
kernel in interpret mode; the host mirror of the site-parallel
configuration's plan (a cluster of G CTAs a tile of 16 chains,
``csrc/l2hmc_site_cluster.cuh``) and an emulation of its partition
(``torch_cluster_util.py``) against the plain chain and the JAX kernel; and
the phi^4 app at L = 64 on the CPU."""

import functools
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from l2hmc_tpu import targets as jtargets
from l2hmc_tpu.ops import fused_dynamics as jfd
from l2hmc_tpu.train import ScgConfig as JaxScgConfig
from l2hmc_tpu.train import build_dynamics as jax_build_dynamics
from l2hmc_tpu_torch import targets
from l2hmc_tpu_torch.apps import phi4, suite
from l2hmc_tpu_torch.convert import params_from_jax
from l2hmc_tpu_torch.ops import fused_dynamics as fd
from l2hmc_tpu_torch.ops.philox import box_muller
from l2hmc_tpu_torch.train import ScgConfig, build_dynamics
from torch_cluster_util import _Spec, cluster_chain, ranges

CSRC = Path(fd.__file__).resolve().parent.parent / "csrc"
N = 8  # chains, one JAX tile
TOL = 2e-4  # the JAX package's own fused-vs-XLA tolerance

# name -> (JAX target, port target, hidden, T, eps, weight lift, eps_dim).
# phi4_L64: the shipped 64 x 64 recipe's kernel shape (hidden 64, T = 24,
# eps 0.03) with the lattice parity cases' lift; icg: the suite recipe's
# widths with the suite parity case's per-dimension steps (0.02 sigma_i) and
# lift.
CASES = {
    "phi4_L64": (lambda: jtargets.Phi4Lattice(L=64, m2=-1.0, lam=0.5),
                 lambda: targets.Phi4Lattice(L=64, m2=-1.0, lam=0.5), 64, 24, 0.03,
                 phi4.PARITY_LIFT, False),
    "icg": (lambda: jtargets.ill_conditioned_gaussian(50, 4.0),
            lambda: targets.ill_conditioned_gaussian(50, 4.0), 100, 10, 0.02, 0.001, True),
}


def _setup(name):
    make_j, make_t, hidden, T, eps, lift, eps_dim = CASES[name]
    jt, tt = make_j(), make_t()
    kw = dict(dim=tt.dim, n_chains=N, T=T, hidden=hidden, eps_dim=eps_dim)
    jd, _ = jax_build_dynamics(JaxScgConfig(**kw), jt)
    td, _ = build_dynamics(ScgConfig(**kw), tt)
    if eps_dim:
        eps = eps * np.sqrt(np.diag(np.asarray(tt.sigma))).astype(np.float32)
    jp = jd.init_params(jax.random.key(0), eps=eps)
    for net in ("xnet", "vnet"):
        jp[net] = jax.tree_util.tree_map(lambda a: a + lift, jp[net])
    jp = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    x = np.asarray(tt.sample(torch.Generator().manual_seed(1), N, device="cpu"))
    return jt, tt, jd, td, jp, params_from_jax(jp, device="cpu"), x


def _zero_bit_draws(n, d):
    """The draws a Philox stream of zero words gives: v = sqrt(-2 ln 1e-7) in
    every dimension, direction forward, accept always — what the Pallas
    interpreter's zero PRNG bits give the JAX chain kernel."""
    zero = torch.zeros((d, n), dtype=torch.int64)
    u = torch.zeros(n)
    return lambda step: (box_muller(zero, zero), u, u)


@functools.lru_cache(maxsize=None)
def _jax_chain(name):
    """The JAX chain kernel under force_tpu_interpret_mode on the zero-bits
    schedule, 2 MH steps, one tile of 8 chains: (x1, acceptance)."""
    jt, tt, jd, td, jp, tp, x = _setup(name)
    sampler = jfd.fused_chain_sampler(jd, jt, tile=N)
    assert sampler.loop_traj == (tt.dim >= 2048)
    with pltpu.force_tpu_interpret_mode():
        x1, acc = sampler.run(jp, x, seed=7, n_mh_steps=2)
    return np.asarray(x1), np.asarray(acc)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_chain_matches_jax_kernel_on_zero_bits(name):
    """The plain chain against the JAX chain kernel under
    force_tpu_interpret_mode, on the zero-bits schedule, 2 MH steps, one tile
    of 8 chains: at dim 4096 the JAX sampler takes its ``loop_traj`` form by
    default (dim >= 2048), the form the 64 x 64 lattice runs. Acceptance
    exactly, states within 2e-4, the trace's end the state."""
    jt, tt, jd, td, jp, tp, x = _setup(name)
    x1, acc = _jax_chain(name)
    inp = fd.prepare(td, fd.energy_spec_for_target(tt), tp, "cpu")
    assert fd.chain_on_sites(inp)
    xo, acc_t, trace = fd.chain_plain(inp, torch.tensor(x).T.contiguous(), seed=7, n_mh_steps=2,
                                      collect_trace=True, draws=_zero_bit_draws(N, tt.dim))
    np.testing.assert_array_equal(acc_t[0].numpy(), acc)
    np.testing.assert_allclose(xo.T.numpy(), x1, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(trace[-1].numpy(), xo.numpy())
    assert not np.array_equal(x1, x)  # the chains moved


@pytest.mark.parametrize("name", list(CASES))
def test_cluster_emulation_matches_jax_kernel_on_zero_bits(name):
    """The emulation of the cluster chain kernel's partition, at the G its
    plan takes for one tile (the 64 x 64 lattice: 8 ranges of 8 rows, the
    stencil's halo rows from the neighbouring ranges; icg: the Gaussian at
    G = 1), against the JAX chain kernel in interpret mode on the zero-bits
    schedule, as the plain chain is: acceptance exactly, states within
    2e-4."""
    jt, tt, jd, td, jp, tp, x = _setup(name)
    x1, acc = _jax_chain(name)
    inp = fd.prepare(td, fd.energy_spec_for_target(tt), tp, "cpu")
    D, H, H2, _ = inp.dims
    G = fd.site_geometry(D, H, H2, N, *inp.energy_args).G
    assert G == {"phi4_L64": 8, "icg": 1}[name]
    xo, acc_t, trace = cluster_chain(inp, torch.tensor(x).T.contiguous(), 7, 2, G,
                                     collect_trace=True, draws=_zero_bit_draws(N, tt.dim))
    np.testing.assert_array_equal(acc_t[0].numpy(), acc)
    np.testing.assert_allclose(xo.T.numpy(), x1, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(trace[-1].numpy(), xo.numpy())


# every (D, H) the chain kernel's caps admit on its site-parallel
# configuration, at its edges, and past them
WIDTHS = [(d, h) for d in (2, 64, 65, 256, 1024, 2048, 4095, 4096)
          for h in (8, 32, 64, 65, 100, 128)]
KINDS = {"gauss": (fd.QuadraticGaussianEnergy.KIND, lambda d: d * d + d),
         "rough_well": (fd.RoughWellEnergy.KIND, lambda d: 4),
         "mixture": (fd.GmmEnergy.KIND, lambda d: 2 * (d + d * d + 1)),
         "funnel": (fd.FunnelEnergy.KIND, lambda d: 3),
         "phi4": (fd.Phi4Energy.KIND, lambda d: 3)}


def _check_plan(plan, dim, hidden, hidden2, n, kind, nc):
    """A plan's invariants: a tile of 16, 8 or 4 chains on 256 threads a CTA,
    1 <= G <= 8 ranks that all hold sites, contiguous ranges of an even
    count of sites (whole rows for phi^4), its shared memory the host's count
    within the 232,448 bytes a CTA may use, scratch only for accepted states
    kept out of it."""
    assert plan.chains in (4, 8, 16) and plan.threads == 256
    assert 1 <= plan.G <= 8
    assert (plan.G - 1) * plan.chunk < dim <= plan.G * plan.chunk
    assert plan.chunk % fd._cl_unit(dim, kind) == 0 and plan.chunk % 2 == 0
    pre = fd.site_prelude_floats(kind, nc, dim)
    assert plan.smem == 4 * fd.cl_smem_floats(dim, hidden, hidden2, pre, plan.chains, plan.chunk,
                                              plan.x_in_smem, plan.staged)
    assert plan.smem <= fd._MAX_SMEM - fd._CL_STATIC_SMEM and plan.staged in (0, 1, 2, 3)
    tiles = -(-n // plan.chains)
    assert plan.scratch == (0 if plan.x_in_smem else tiles * plan.G * plan.chunk * plan.chains)


@pytest.mark.parametrize("dim,hidden", WIDTHS)
def test_site_geometry_fits_shared_memory(dim, hidden):
    """The host mirror of the site-parallel configuration's plan at every
    width and spec, at 203 and 2048 chains: each CTA's shared memory within
    the 232,448 bytes it may use; at 2048 chains one CTA a tile of 16 chains
    (128 tiles fill the card; a weight load serves 16 chains) wherever that
    state fits; the Gaussian and the mixture one CTA a tile wherever a
    tile's state fits; a plan with both nets' slices staged in one wave."""
    for n in (203, 2048):
        for name, (kind, nc_of) in KINDS.items():
            if kind == fd.Phi4Energy.KIND and dim not in (64, 256, 1024, 4096):
                continue
            plan = fd.site_geometry(dim, hidden, hidden, n, kind, nc_of(dim))
            _check_plan(plan, dim, hidden, hidden, n, kind, nc_of(dim))
            fits16 = fd._cl_candidate(dim, hidden, hidden, fd.site_prelude_floats(
                kind, nc_of(dim), dim), 16, 1, fd._cl_unit(dim, kind))[1]
            if n == 2048 and fits16:
                assert (plan.chains, plan.G) == (16, 1), (name, plan)
            if name in ("gauss", "mixture") and dim <= 1024:
                assert plan.G == 1, (name, plan)
            if plan.staged == 3:  # a staged plan runs its tiles in one wave
                assert -(-n // plan.chains) <= fd._CL_TARGET_CTAS // plan.G, (name, plan)


def test_site_geometry_refuses_past_the_caps():
    """Past dim 4096 or hidden 128 the plan raises with both caps named; at
    the caps (dim 4096, hidden 128) every spec's plan still fits: 16 chains
    on 8 CTAs a cluster, 512 sites a CTA, the weights streamed; the Gaussian
    and the mixture one CTA a tile of 4 chains, its accepted states in the
    scratch."""
    for name, (kind, nc_of) in KINDS.items():
        plan = fd.site_geometry(4096, 128, 128, 256, kind, nc_of(4096))
        _check_plan(plan, 4096, 128, 128, 256, kind, nc_of(4096))
        want = ((4, 1, 4096, 0) if name in ("gauss", "mixture") else (16, 8, 512, 0))
        assert (plan.chains, plan.G, plan.chunk, plan.staged) == want, name
    for dim, h, h2 in ((4097, 32, 32), (16384, 64, 64), (256, 129, 32), (256, 32, 129)):
        with pytest.raises(ValueError, match="caps dim 4096, hidden 128"):
            fd.site_geometry(dim, h, h2, 256)


# The clusters of each size (G = 1 .. 8) an H100 SXM holds at once for the
# chain kernel, one CTA an SM (``fd.site_capacities`` on the card, which
# chip_smoke.py's phase 11b reports): its GPCs take 30 clusters of 4 and 15
# of 8, not 33 and 16.
H100_CAPACITY = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}

# rows 3e-3l (3f-bf16 and 3h-bf16 at 3f's and 3h's shapes): (D, H, T,
# chains, spec) -> (chains a tile, G, sites a CTA, staged parts, accepted
# states in shared memory) at H100_CAPACITY
ROW_PLANS = {
    "3e": ((64, 32, 10, 512, "phi4"), (4, 1, 64, 3, True)),
    "3f": ((256, 32, 10, 512, "phi4"), (8, 2, 128, 3, True)),
    "3g": ((1024, 32, 10, 256, "phi4"), (16, 6, 192, 2, True)),
    "3h": ((4096, 32, 10, 256, "phi4"), (16, 6, 704, 0, True)),
    "3h_recipe": ((4096, 64, 24, 256, "phi4"), (16, 6, 704, 0, True)),
    "3i": ((50, 100, 10, 2048, "gauss"), (16, 1, 50, 2, True)),
    "3j": ((100, 20, 5, 2048, "rough_well"), (16, 1, 100, 3, True)),
    "3k": ((2, 100, 10, 2048, "ring"), (16, 1, 2, 3, True)),
    "3l": ((100, 20, 10, 512, "funnel"), (4, 1, 100, 3, True)),
}


@pytest.mark.parametrize("row", list(ROW_PLANS))
def test_site_plan_at_the_rows_shapes(row):
    """The plan at each site row's shape on an H100's capacities: 128 CTAs
    where 512 chains of the lattice at L = 8 and 16 or of the funnel run
    staged in one wave (4 chains a tile at L = 8 and on the funnel, 8 on
    clusters of 2 at L = 16), 2048 chains of the rough well, the ring and
    icg on one CTA a tile of 16 chains; at L = 32 and 64 (16 tiles, where
    clusters of 8 would need a second wave: the card holds 15) clusters of
    6 CTAs, 96 in all, the heads' columns staged at L = 32 and the weights
    streamed at L = 64. Every plan runs its tiles in one wave."""
    (D, H, T, n, name), want = ROW_PLANS[row]
    kind = {"ring": fd.GmmEnergy.KIND}.get(name) or KINDS[name][0]
    nc = 4 * (D + D * D + 1) if name == "ring" else KINDS[name][1](D)
    plan = fd.site_geometry(D, H, H, n, kind, nc, capacity=H100_CAPACITY)
    _check_plan(plan, D, H, H, n, kind, nc)
    assert (plan.chains, plan.G, plan.chunk, plan.staged, plan.x_in_smem) == want
    assert -(-n // plan.chains) <= H100_CAPACITY[plan.G]


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);",
                  (CSRC / "l2hmc_site_cluster.cuh").read_text())
    assert m, name
    return int(m.group(1))


def test_cluster_constants_match_the_source():
    """The host's plan constants are csrc/l2hmc_site_cluster.cuh's: tiles of
    up to 16 chains, 256 threads a CTA, 132 CTAs aimed at, clusters of up to
    8 CTAs (portable sizes: the widest state, dim 4096 at hidden 128, fits a
    CTA at G = 8); the kernel's 224 bytes of static shared memory, which
    the plan's dynamic shared memory leaves out."""
    assert (fd._CL_CHAINS, fd._CL_THREADS, fd._CL_TARGET_CTAS, fd._CL_MAX_G,
            fd._CL_STATIC_SMEM) == tuple(_constant(k) for k in (
                "kClChains", "kClThreads", "kClTargetCtas", "kClMaxG", "kClStaticSmem"))


@pytest.mark.parametrize("L,G", [(8, 2), (8, 4), (16, 8), (9, 4)])
def test_cluster_ranges_and_halo(L, G):
    """The partition of the lattice: ranges of whole rows (two at a time
    where L is odd, so that every range starts on an even site), covering
    the sites once in order; the emulation's stencil on each range with one
    halo row from each neighbouring range equals the whole lattice's
    gradient, and its rank-ordered energy the plain energy to float32
    rounding."""
    tgt = targets.Phi4Lattice(L=L, m2=-1.0, lam=0.5)
    dyn, _ = build_dynamics(ScgConfig(dim=tgt.dim, hidden=8, T=2), tgt)
    inp = fd.prepare(dyn, fd.energy_spec_for_target(tgt),
                     dyn.init_params(torch.Generator().manual_seed(0), device="cpu"), "cpu")
    rg = ranges(L * L, G, inp.kind)
    assert rg[0][0] == 0 and rg[-1][1] == L * L and len(rg) <= G
    assert all(a[1] == b[0] for a, b in zip(rg, rg[1:]))
    assert all(lo % L == 0 and lo % 2 == 0 for lo, _ in rg)
    x = tgt.sample(torch.Generator().manual_seed(3), 16, device="cpu").T.contiguous()
    spec = _Spec(inp, rg)
    torch.testing.assert_close(spec.grad(x), inp.grad_energy(x), rtol=0, atol=0)
    torch.testing.assert_close(spec.energy(x), inp.energy(x), rtol=1e-6, atol=1e-4)


# (module, case, chains, G): the lattice at L = 8 on 2 and 4 CTAs a cluster,
# a partial tile (37 chains) at L = 16 on 8, the funnel at D = 100 on 4 (its
# prelude's rank-ordered sums, v = x_0 from rank 0, a last range of 22 of 26
# sites), the rough well at D = 100 on 8 (a last range of 2 sites), HMC mode
EMULATED = [(phi4, "phi4_L8", 64, 2), (phi4, "phi4_L8", 64, 4), (phi4, "phi4_L16", 37, 8),
            (suite, "funnel_D100", 48, 4), (suite, "rough_well_D100", 40, 8),
            (phi4, "phi4_L16_hmc", 32, 4)]


@pytest.mark.parametrize("mod,name,n,G", EMULATED)
def test_cluster_emulation_matches_plain_chain(mod, name, n, G):
    """The emulation of the cluster kernel's partition against
    ``fd.chain_plain`` on the same Philox draws, 10 traced MH steps: no
    accept decision flips, and the states agree within 2e-5 (they differ
    only in the order of the sums over sites, which the partition moves)."""
    inp, x = mod.parity_inputs(name, n, "cpu", seed=40)
    assert len(ranges(x.shape[0], G, inp.kind)) == G
    xe, ae, te = cluster_chain(inp, x, 9, 10, G, collect_trace=True)
    xp, ap, tp = fd.chain_plain(inp, x, 9, 10, collect_trace=True)
    torch.testing.assert_close(ae, ap, rtol=0, atol=0)
    torch.testing.assert_close(te, tp, rtol=0, atol=2e-5)
    torch.testing.assert_close(te[-1], xe, rtol=0, atol=0)
    assert 0.0 < float(ae.mean()) < 1.0


def test_chain_on_sites_follows_pick_lanes():
    """``chain_on_sites`` mirrors csrc's ``pick_lanes``: the lane groups up
    to 64 wide and hidden 64 (the SCG widths and WideLanes), the sites past
    either, and the lattice everywhere."""
    def on_sites(dim, hidden, target):
        dyn, _ = build_dynamics(ScgConfig(dim=dim, hidden=hidden, T=2), target)
        params = dyn.init_params(torch.Generator().manual_seed(0), device="cpu")
        return fd.chain_on_sites(fd.prepare(dyn, fd.energy_spec_for_target(target), params,
                                            "cpu"))

    assert not on_sites(2, 10, targets.scg_gaussian())
    assert not on_sites(50, 64, targets.ill_conditioned_gaussian(50))
    assert on_sites(50, 65, targets.ill_conditioned_gaussian(50))
    assert on_sites(50, 100, targets.ill_conditioned_gaussian(50))
    assert on_sites(64, 8, targets.Phi4Lattice(L=8))
    assert on_sites(4096, 64, targets.Phi4Lattice(L=64))


def test_phi4_run_at_L64_on_the_cpu():
    """``apps.phi4.run`` at L = 64 at a tiny depth on the CPU: the chain
    kernel's caps admit the lattice, so the eval's reason to go plain is the
    device alone; finite rates and ESS."""
    r = phi4.run(L=64, n_chains=4, n_steps=2, leapfrogs=2, hidden=8, eval_steps=6, eps=0.03,
                 hmc_eps=0.03, device="cpu")
    assert r["fused_eval"] == "the fused eval runs on a CUDA device"
    t = targets.Phi4Lattice(L=64)
    assert fd.kernel_refusal(build_dynamics(ScgConfig(dim=t.dim, hidden=8), t)[0], t, 8) is None
    assert all(np.isfinite(r[k]) for k in ("tunneling_rate_l2hmc", "ess_m_l2hmc", "ess_m_hmc"))
