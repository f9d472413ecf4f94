"""Port's propose / metropolis vs the JAX package's forward / backward /
p_accept / metropolis composed on the same draws (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu.train import ScgConfig as JaxScgConfig
from l2hmc_tpu.train import build_dynamics as jax_build_dynamics
from l2hmc_tpu_torch import mcmc
from l2hmc_tpu_torch.convert import params_from_jax
from l2hmc_tpu_torch.train import ScgConfig, build_dynamics

N = 128
TOL = 2e-5  # float32 trajectories of T=4 substeps, summation order differs


def _jax_propose(jd, jp, x, v, u_dir, u_acc):
    """The JAX propose + metropolis, composed from its parts with the draws
    given (jax.random cannot be fed numbers)."""
    if jd.hmc:
        xp, vp, lj = jd.forward(jp, x, v)
    else:
        fwd = (u_dir < 0.5).astype(x.dtype)
        xf, vf, ljf = jd.forward(jp, x, v)
        xb, vb, ljb = jd.backward(jp, x, v)
        m = fwd[:, None]
        xp = m * xf + (1 - m) * xb
        vp = m * vf + (1 - m) * vb
        lj = fwd * ljf + (1 - fwd) * ljb
    px = jd.p_accept(jp, x, v, xp, vp, lj)
    x_next = jnp.where((px - u_acc >= 0.0)[:, None], xp, x)
    return xp, vp, px, lj, x_next


@pytest.mark.parametrize("hmc", [False, True], ids=["l2hmc", "hmc"])
def test_propose_matches_jax_on_same_draws(hmc):
    kw = dict(n_chains=N, T=4, hmc=hmc)
    jd, _ = jax_build_dynamics(JaxScgConfig(**kw))
    td, _ = build_dynamics(ScgConfig(**kw))
    jp = jd.init_params(jax.random.key(0), eps=0.1)
    for net in ("xnet", "vnet"):
        jp[net] = jax.tree_util.tree_map(lambda a: a + 0.03, jp[net])
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(4)
    x = (3.0 * rng.standard_normal((N, 2))).astype(np.float32)
    v = rng.standard_normal((N, 2)).astype(np.float32)
    u_dir = rng.uniform(size=N).astype(np.float32)
    u_acc = rng.uniform(size=N).astype(np.float32)

    ref = _jax_propose(jd, jp, *map(jnp.asarray, (x, v, u_dir, u_acc)))
    out = mcmc.propose(
        None, td, tp, torch.tensor(x), init_v=torch.tensor(v),
        dir_u=torch.tensor(u_dir), accept_u=torch.tensor(u_acc), do_mh_step=True,
    )
    got = (out.x_prop, out.v_prop, out.p_accept, out.log_jac, out.x_next)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=TOL, atol=TOL)
    # both outcomes occur, so the accept rule itself is exercised
    accepted = np.all(out.x_next.numpy() == out.x_prop.numpy(), axis=1)
    assert 0 < accepted.sum() < N


def test_metropolis_rule():
    x = torch.zeros(4, 2)
    xp = torch.ones(4, 2)
    p = torch.tensor([0.0, 0.5, 0.5, 1.0])
    u = torch.tensor([0.0, 0.4, 0.6, 0.99])
    out = mcmc.metropolis(None, x, xp, p, u)
    np.testing.assert_array_equal(out[:, 0].numpy(), [1.0, 1.0, 0.0, 1.0])
    mask = mcmc.metropolis_mask(None, p, u)
    np.testing.assert_array_equal(mask.numpy(), [True, True, False, True])


def test_propose_draws_from_generator_reproducibly():
    td, tgt = build_dynamics(ScgConfig(T=2))
    tp = td.init_params(torch.Generator().manual_seed(0), device="cpu")
    x = tgt.sample(torch.Generator().manual_seed(1), 32, device="cpu")
    a = mcmc.propose(torch.Generator().manual_seed(2), td, tp, x, do_mh_step=True)
    b = mcmc.propose(torch.Generator().manual_seed(2), td, tp, x, do_mh_step=True)
    torch.testing.assert_close(a.x_next, b.x_next, rtol=0, atol=0)
    assert torch.isfinite(a.p_accept).all()
