"""Parallel tempering on the CPU: ``swap_step`` and ``pt_sample_chain``
against the JAX package's on the same random numbers (the JAX functions'
own key splits, reproduced here and injected into the port), and the JAX
tests' properties (the swap move's edge cases, mode recovery on a bimodal
target plain HMC cannot cross)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu import targets as jtargets
from l2hmc_tpu.dynamics import Dynamics as JaxDynamics
from l2hmc_tpu.mcmc import tempering as jtemp
from l2hmc_tpu.train import ScgConfig as JaxScgConfig
from l2hmc_tpu.train import build_dynamics as jax_build_dynamics
from l2hmc_tpu_torch import targets
from l2hmc_tpu_torch.convert import params_from_jax
from l2hmc_tpu_torch.dynamics import Dynamics
from l2hmc_tpu_torch.mcmc import geometric_temps, pt_hmc_sample_chain, pt_sample_chain, swap_step
from l2hmc_tpu_torch.train import hmc_sample_chain


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("t_max,k", [(16.0, 5), (8.0, 24), (50.0, 8), (3.0, 1)])
def test_geometric_temps_matches_jax(t_max, k):
    t = geometric_temps(t_max, k)
    assert t.dtype == torch.float32 and t.shape == (max(k, 1),)
    np.testing.assert_allclose(t.numpy(), np.asarray(jtemp.geometric_temps(t_max, k)),
                               rtol=1e-6)
    if k > 1:
        np.testing.assert_allclose(float(t[-1]), t_max, rtol=1e-6)
        ratios = (t[1:] / t[:-1]).numpy()
        np.testing.assert_allclose(ratios, ratios[0], rtol=1e-5)


def test_swap_equal_temps_always_swaps_parity_pairs():
    """With all temperatures equal logA = 0 and every pair of the parity
    swaps (log u < 0): rungs 0/1 and 2/3 exchange states exactly; at odd
    parity 1/2 exchange and the ends stay."""
    K, n, d = 4, 8, 2
    x = torch.randn((K, n, d), generator=_gen(0))
    U, temps = torch.zeros((K, n)), torch.ones(K)
    out = swap_step(_gen(1), x, U, temps, parity=0)
    for a, b in ((0, 1), (1, 0), (2, 3), (3, 2)):
        torch.testing.assert_close(out[a], x[b], rtol=0, atol=0)
    out = swap_step(_gen(1), x, U, temps, parity=1)
    for a, b in ((0, 0), (1, 2), (2, 1), (3, 3)):
        torch.testing.assert_close(out[a], x[b], rtol=0, atol=0)


def test_swap_one_sided_rule():
    """A colder rung already at much lower energy never swaps; reversed
    energies always swap; u = 0 is clamped before the log."""
    K, n, d = 2, 64, 2
    x = torch.randn((K, n, d), generator=_gen(0))
    temps = torch.tensor([1.0, 100.0])
    U = torch.stack([torch.full((n,), -100.0), torch.full((n,), 100.0)])
    torch.testing.assert_close(swap_step(_gen(2), x, U, temps, 0), x, rtol=0, atol=0)
    out = swap_step(_gen(3), x, U.flip(0), temps, 0)
    torch.testing.assert_close(out[0], x[1], rtol=0, atol=0)
    out = swap_step(None, x, U.flip(0), temps, 0, u=torch.zeros((1, n)))
    torch.testing.assert_close(out[1], x[0], rtol=0, atol=0)


@pytest.mark.parametrize("parity", [0, 1])
def test_swap_step_matches_jax_on_the_same_uniforms(parity):
    K, n, d = 5, 16, 3
    rng = np.random.default_rng(7)
    x = rng.standard_normal((K, n, d)).astype(np.float32)
    U = (5.0 * rng.standard_normal((K, n))).astype(np.float32)
    temps = np.asarray(jtemp.geometric_temps(4.0, K), np.float32)
    key = jax.random.key(11)
    u = np.asarray(jax.random.uniform(key, (K - 1, n), jnp.float32))
    ref = jtemp.swap_step(key, jnp.asarray(x), jnp.asarray(U), jnp.asarray(temps), parity)
    got = swap_step(None, torch.tensor(x), torch.tensor(U), torch.tensor(temps), parity,
                    u=torch.tensor(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not np.array_equal(got.numpy(), x)  # some pair swapped


def _jax_pt_draws(key, n_steps, K, n, d, swap_every, hmc):
    """The numbers JAX's ``pt_sample_chain`` draws from ``key``, in the
    port's ``draws(step)`` form: its per-step split (proposals, swap), the
    proposals' split over the rungs and ``propose``'s split (momentum,
    direction, accept)."""
    out = []
    for step, k in enumerate(jax.random.split(key, n_steps)):
        k_prop, k_swap = jax.random.split(k)
        rungs = []
        for rk in jax.random.split(k_prop, K):
            k_v, k_dir, k_mh = jax.random.split(rk, 3)
            v = torch.tensor(np.asarray(jax.random.normal(k_v, (n, d), jnp.float32)))
            u_dir = None if hmc else torch.tensor(
                np.asarray(jax.random.uniform(k_dir, (n,), jnp.float32)))
            u_acc = torch.tensor(np.asarray(jax.random.uniform(k_mh, (n,), jnp.float32)))
            rungs.append((v, u_dir, u_acc))
        swap_u = None
        if step % swap_every == 0:
            swap_u = torch.tensor(np.asarray(jax.random.uniform(k_swap, (K - 1, n), jnp.float32)))
        out.append((rungs, swap_u))
    return lambda step: out[step]


@pytest.mark.parametrize("swap_every", [1, 2])
def test_pt_sample_chain_matches_jax_on_the_same_draws(swap_every):
    """L2HMC on the phi^4 lattice (L = 4, the JAX test's couplings), three
    rungs: the rung-0 trace and every rung's final state against the JAX
    package's on its own draws, 1e-4; the parity alternates every
    ``swap_every`` steps."""
    K, n, steps = 3, 8, 6
    jt, tt = jtargets.Phi4Lattice(L=4, m2=-4.0, lam=1.0), targets.Phi4Lattice(L=4, m2=-4.0,
                                                                              lam=1.0)
    jd0, _ = jax_build_dynamics(JaxScgConfig(dim=16, T=3, hidden=8), jt)
    jd = JaxDynamics(dim=16, energy=jt.energy, T=3, xnet=jd0.xnet, vnet=jd0.vnet,
                     use_temperature=True)
    from l2hmc_tpu_torch.train import ScgConfig, build_dynamics

    td0, _ = build_dynamics(ScgConfig(dim=16, T=3, hidden=8), tt)
    td = Dynamics(dim=16, energy=tt.energy, grad_energy=tt.grad_energy, T=3, xnet=td0.xnet,
                  vnet=td0.vnet, use_temperature=True)
    jp = jd.init_params(jax.random.key(0), eps=0.1)
    jp = jax.tree_util.tree_map(lambda a: np.asarray(a + 0.03 if a.ndim else a, np.float32), jp)
    tp = params_from_jax(jp, device="cpu")
    x0 = np.asarray(jt.sample(jax.random.key(1), n), np.float32)
    x0 = np.repeat(x0[None], K, axis=0)
    temps = np.asarray(jtemp.geometric_temps(8.0, K), np.float32)
    key = jax.random.key(5)
    xj, trj = jtemp.pt_sample_chain(jd, jax.tree_util.tree_map(jnp.asarray, jp),
                                    jnp.asarray(x0), jnp.asarray(temps), steps, key,
                                    swap_every=swap_every)
    xt, trt = pt_sample_chain(td, tp, torch.tensor(x0), torch.tensor(temps), steps, None,
                              swap_every=swap_every,
                              draws=_jax_pt_draws(key, steps, K, n, 16, swap_every, False))
    assert trt.shape == (steps, n, 16)
    np.testing.assert_allclose(trt.numpy(), np.asarray(trj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-4, atol=1e-4)
    _, acc = pt_sample_chain(td, tp, torch.tensor(x0), torch.tensor(temps), steps, _gen(0),
                             collect=False)
    assert acc.shape == (steps,) and bool(((acc >= 0) & (acc <= 1)).all())


def test_pt_hmc_sample_chain_matches_jax_on_the_same_draws():
    K, n, steps = 4, 8, 5
    jt, tt = jtargets.mog2(distance=4.0, var=0.1), targets.mog2(distance=4.0, var=0.1)
    x0 = np.repeat(np.asarray(jt.sample(jax.random.key(1), n), np.float32)[None], K, axis=0)
    temps = np.asarray(jtemp.geometric_temps(10.0, K), np.float32)
    key = jax.random.key(9)
    xj, trj = jtemp.pt_hmc_sample_chain(jt, 0.25, 5, jnp.asarray(x0), jnp.asarray(temps),
                                        steps, key)
    xt, trt = pt_hmc_sample_chain(tt, 0.25, 5, torch.tensor(x0), torch.tensor(temps), steps,
                                  _gen(0), draws=_jax_pt_draws(key, steps, K, n, 2, 1, True))
    np.testing.assert_allclose(trt.numpy(), np.asarray(trj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-4, atol=1e-4)


def test_pt_needs_use_temperature():
    tt = targets.mog2(distance=4.0, var=0.1)
    dyn = Dynamics(dim=2, energy=tt.energy, T=2, hmc=True)
    with pytest.raises(ValueError, match="use_temperature"):
        pt_sample_chain(dyn, dyn.init_params(_gen(0), device="cpu"), torch.zeros((2, 4, 2)),
                        torch.ones(2), 1, _gen(0))


def test_pt_recovers_bimodal_modes():
    """mog2 with far modes, all chains started in the +x mode: plain HMC stays
    there, parallel-tempered HMC with a hot rung visits both modes in rung 0
    (the JAX test's protocol on the port's own random numbers, cut from 800
    steps of 10 leapfrogs to 200 of 5 for time)."""
    target = targets.mog2(distance=6.0, var=0.1)
    n, K, steps, T = 64, 5, 200, 5
    temps = geometric_temps(50.0, K)
    x0_single = torch.ones((n, 2)) * torch.tensor([3.0, 0.0])
    x0 = x0_single[None].repeat(K, 1, 1)
    _, hmc_trace = hmc_sample_chain(target, 0.25, T, x0_single, steps, _gen(5))
    assert float(hmc_trace[..., 0].min()) > 0.5, "plain HMC unexpectedly crossed the barrier"
    _, pt_trace = pt_hmc_sample_chain(target, 0.25, T, x0, temps, steps, _gen(7))
    frac_neg = float((pt_trace[steps // 2:, :, 0] < 0).float().mean())
    assert 0.2 < frac_neg < 0.8, f"PT rung-0 mode fraction {frac_neg}"


@pytest.mark.parametrize("hmc", [True, False], ids=["hmc", "l2hmc"])
def test_pt_matches_jax_at_the_protocol_shape(hmc):
    """The phi^4 protocol's tempered eval at its own shape (L = 16, m^2 = -4,
    lam = 0.5; 24 rungs to t_max 8, 32 chains a rung, 10 leapfrogs, eps 0.1;
    L2HMC with dense nets at hidden 32) for 3 steps on the JAX package's
    draws: the rung-0 trace and every rung's state, 1e-4. Rung k's chains
    carry temperature k through one proposal of all 768 chains."""
    K, n, steps, L = 24, 32, 3, 16
    jt = jtargets.Phi4Lattice(L=L, m2=-4.0, lam=0.5)
    tt = targets.Phi4Lattice(L=L, m2=-4.0, lam=0.5)
    x0 = np.repeat(np.asarray(jt.sample(jax.random.key(1), n), np.float32)[None], K, axis=0)
    temps = np.asarray(jtemp.geometric_temps(8.0, K), np.float32)
    key = jax.random.key(4)
    draws = _jax_pt_draws(key, steps, K, n, L * L, 1, hmc)
    if hmc:
        xj, trj = jtemp.pt_hmc_sample_chain(jt, 0.1, 10, jnp.asarray(x0), jnp.asarray(temps),
                                            steps, key)
        xt, trt = pt_hmc_sample_chain(tt, 0.1, 10, torch.tensor(x0), torch.tensor(temps), steps,
                                      None, draws=draws)
    else:
        from l2hmc_tpu_torch.train import ScgConfig, build_dynamics

        jd0, _ = jax_build_dynamics(JaxScgConfig(dim=L * L, T=10, hidden=32), jt)
        jd = JaxDynamics(dim=L * L, energy=jt.energy, T=10, xnet=jd0.xnet, vnet=jd0.vnet,
                         use_temperature=True)
        td0, _ = build_dynamics(ScgConfig(dim=L * L, T=10, hidden=32), tt)
        td = Dynamics(dim=L * L, energy=tt.energy, grad_energy=tt.grad_energy, T=10,
                      xnet=td0.xnet, vnet=td0.vnet, use_temperature=True)
        jp = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    jd.init_params(jax.random.key(0), eps=0.1))
        xj, trj = jtemp.pt_sample_chain(jd, jax.tree_util.tree_map(jnp.asarray, jp),
                                        jnp.asarray(x0), jnp.asarray(temps), steps, key)
        xt, trt = pt_sample_chain(td, params_from_jax(jp, device="cpu"), torch.tensor(x0),
                                  torch.tensor(temps), steps, None, draws=draws)
    assert trt.shape == (steps, n, L * L)
    np.testing.assert_allclose(trt.numpy(), np.asarray(trj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-4, atol=1e-4)


def test_pt_stats_count_rung_acceptance_and_swaps():
    """``stats``: with every temperature 1 each tried pair swaps (logA = 0),
    so the rate is 1 for all pairs, each tried on every other step; the rung
    acceptance is the mean of the collected acceptance probabilities."""
    target = targets.mog2(distance=4.0, var=0.1)
    K, n, steps = 4, 8, 5
    dyn = Dynamics(dim=2, energy=target.energy, T=3, hmc=True, use_temperature=True)
    params = dyn.init_params(_gen(0), eps=0.2, device="cpu")
    x0 = target.sample(_gen(1), n, device="cpu")[None].repeat(K, 1, 1)
    st = {}
    _, acc = pt_sample_chain(dyn, params, x0, torch.ones(K), steps, _gen(2), collect=False,
                             stats=st)
    torch.testing.assert_close(st["swap_rate"], torch.ones(K - 1), rtol=0, atol=0)
    assert st["rung_accept"].shape == (K,)
    torch.testing.assert_close(st["rung_accept"].mean(), acc.mean(), rtol=1e-6, atol=1e-6)
    _, _ = pt_sample_chain(dyn, params, x0, torch.tensor([1.0, 1e6, 1.0, 1e6]), 1, _gen(2),
                           stats=st)
    assert bool(torch.isnan(st["swap_rate"][1]))  # odd pairs are not tried on step 0
