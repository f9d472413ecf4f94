"""The chain kernel's widest forms on the CPU: the 64 x 64 phi^4 lattice
(dim 4096, the JAX sampler's ``loop_traj`` form) and the suite's
ill-conditioned Gaussian at hidden 100, the plain chain against the JAX chain
kernel in interpret mode; the host mirror of the site-parallel
configuration's geometry; and the phi^4 app at L = 64 on the CPU."""

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
from l2hmc_tpu_torch.apps import phi4
from l2hmc_tpu_torch.convert import params_from_jax
from l2hmc_tpu_torch.ops import fused_dynamics as fd
from l2hmc_tpu_torch.ops.philox import box_muller
from l2hmc_tpu_torch.train import ScgConfig, build_dynamics

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


@pytest.mark.parametrize("name", list(CASES))
def test_plain_chain_matches_jax_kernel_on_zero_bits(name):
    """The plain chain against the JAX chain kernel under
    force_tpu_interpret_mode, on the zero-bits schedule, 2 MH steps, one tile
    of 8 chains: at dim 4096 the JAX sampler takes its ``loop_traj`` form by
    default (dim >= 2048), the form the 64 x 64 lattice runs. Acceptance
    exactly, states within 2e-4, the trace's end the state."""
    jt, tt, jd, td, jp, tp, x = _setup(name)
    sampler = jfd.fused_chain_sampler(jd, jt, tile=N)
    assert sampler.loop_traj == (tt.dim >= 2048)
    with pltpu.force_tpu_interpret_mode():
        x1, acc = sampler.run(jp, x, seed=7, n_mh_steps=2)
    inp = fd.prepare(td, fd.energy_spec_for_target(tt), tp, "cpu")
    assert fd.chain_on_sites(inp)
    xo, acc_t, trace = fd.chain_plain(inp, torch.tensor(x).T.contiguous(), seed=7, n_mh_steps=2,
                                      collect_trace=True, draws=_zero_bit_draws(N, tt.dim))
    np.testing.assert_array_equal(acc_t[0].numpy(), np.asarray(acc))
    np.testing.assert_allclose(xo.T.numpy(), np.asarray(x1), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(trace[-1].numpy(), xo.numpy())
    assert not np.array_equal(np.asarray(x1), x)  # the chains moved


# every (D, H) the chain kernel's caps admit on its site-parallel
# configuration, at its edges, and past them
WIDTHS = [(d, h) for d in (2, 64, 65, 256, 1024, 2048, 4095, 4096)
          for h in (8, 32, 64, 65, 100, 128)]


@pytest.mark.parametrize("dim,hidden", WIDTHS)
def test_site_geometry_fits_shared_memory(dim, hidden):
    """The host mirror of the site-parallel configuration: 4 chains a block
    of 256 threads (a weight load serves 4 chains at every width), its
    shared memory within the 232,448 bytes a block may use, the buffers of
    128 hidden units past 64."""
    chains, threads, smem = fd.site_geometry(dim, hidden, hidden)
    assert (chains, threads) == (4, 256)
    assert smem <= fd._MAX_SMEM
    hm = 64 if hidden <= 64 else 128
    assert smem == 4 * (3 * 4 * dim + 8 * 4 * hm + 2 * 4 * hm + 8 * 3 * 4 + 3 * 4)


def test_site_geometry_refuses_past_the_caps():
    """Past dim 4096 or hidden 128 the geometry raises with both caps named;
    at the caps the widest tile (212.4 KB at hidden 128) still fits."""
    assert fd.site_geometry(4096, 128, 128)[2] == 217520
    for dim, h, h2 in ((4097, 32, 32), (16384, 64, 64), (256, 129, 32), (256, 32, 129)):
        with pytest.raises(ValueError, match="caps dim 4096, hidden 128"):
            fd.site_geometry(dim, h, h2)


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
