"""The port's AIS (``evals/ais.py``) vs the JAX package's: the leapfrog, the
whole estimate on the JAX run's own draws, a known-logZ Gaussian pair, and
the split-sum protocol."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu import evals as jevals
from l2hmc_tpu.evals.ais import _leapfrog as jax_leapfrog
from l2hmc_tpu_torch.evals import ais as tais

SIGMA = np.array([[2.0, 0.3], [0.3, 0.5]])
PREC = np.linalg.inv(SIGMA).astype(np.float32)


def _jax_energy(z, aux=None):
    return 0.5 * jnp.einsum("ni,ij,nj->n", z, jnp.asarray(PREC, z.dtype), z)


def _torch_energy(z, aux=None):
    return 0.5 * torch.einsum("ni,ij,nj->n", z, torch.tensor(PREC), z)


def _torch_grad(z, aux=None):
    p = torch.tensor(PREC)
    return 0.5 * z @ (p + p.T)


def _jax_draws(key, shape, anneal_steps):
    """The draws ``l2hmc_tpu.evals.ais.ais_estimate`` makes from ``key``."""
    k_init, k_scan = jax.random.split(key)
    v0 = np.asarray(jax.random.normal(k_init, shape, jnp.float32))
    xs, us = [], []
    for k in jax.random.split(k_scan, anneal_steps):
        k_v, k_mh = jax.random.split(k)
        xs.append(torch.tensor(np.asarray(jax.random.normal(k_v, shape, jnp.float32))))
        us.append(torch.tensor(np.asarray(jax.random.uniform(k_mh, shape[:1], jnp.float32))))
    return torch.tensor(v0), lambda i: (xs[i], us[i])


@pytest.mark.parametrize("analytic", [False, True], ids=["autograd", "analytic"])
def test_leapfrog_matches_jax(analytic):
    rng = np.random.default_rng(0)
    x, v = (rng.standard_normal((32, 2)).astype(np.float32) for _ in range(2))
    jX, jV = jax_leapfrog(_jax_energy, jnp.asarray(x), jnp.asarray(v), 0.1, 7)
    tX, tV = tais._leapfrog(_torch_energy, torch.tensor(x), torch.tensor(v), 0.1, 7,
                            grad_energy=_torch_grad if analytic else None)
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tV.numpy(), np.asarray(jV), rtol=1e-5, atol=1e-5)


def test_leapfrog_passes_aux():
    x = torch.ones((4, 2))
    X, _ = tais._leapfrog(lambda z, aux=None: aux * torch.sum(z * z, dim=1), x,
                          torch.zeros((4, 2)), 0.1, 1, aux=0.5)
    torch.testing.assert_close(X, x * (1 - 0.5 * 0.1 * 0.1))


@pytest.mark.parametrize("refresh", [False, True])
@pytest.mark.parametrize("num_splits", [1, 4])
def test_ais_estimate_matches_jax_on_its_draws(refresh, num_splits):
    """The same chain on the JAX run's own momentum and accept draws:
    estimate to 1e-4, mean acceptance to 1e-5."""
    n, K = 64, 12
    x0 = np.random.default_rng(1).standard_normal((n, 2)).astype(np.float32)
    key = jax.random.key(7)
    kw = dict(step_size=0.3, leapfrogs=4, num_splits=num_splits, refresh=refresh,
              refreshment=0.2)
    jest, jacc = jevals.ais_estimate(key, jevals.standard_normal_energy, _jax_energy, K,
                                     jnp.asarray(x0), **kw)
    v0, draws = _jax_draws(key, (n, 2), K)
    test_, tacc = tais.ais_estimate(None, tais.standard_normal_energy, _torch_energy, K,
                                    torch.tensor(x0), init_v=v0, draws=draws, **kw)
    np.testing.assert_allclose(float(test_), float(jest), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(tacc), float(jacc), rtol=1e-5, atol=1e-5)


def test_ais_estimate_known_logz_gaussian_pair():
    """N(0, I) -> N(0, Sigma): log Z ratio = 0.5 log det Sigma, within the
    JAX test's 0.1, with the analytic gradients."""
    g = torch.Generator().manual_seed(1)
    x0 = torch.randn((512, 2), generator=g)
    est, acc = tais.ais_estimate(
        g, tais.standard_normal_energy, _torch_energy, 200, x0, step_size=0.3, leapfrogs=5,
        init_grad=tais.standard_normal_grad, final_grad=_torch_grad)
    assert 0.3 < float(acc) <= 1.0
    np.testing.assert_allclose(float(est), 0.5 * np.linalg.slogdet(SIGMA)[1], atol=0.1)


def test_ais_analytic_gradient_path_equals_autograd_path():
    x0 = torch.randn((32, 2), generator=torch.Generator().manual_seed(2))
    out = []
    for kw in ({}, {"init_grad": tais.standard_normal_grad, "final_grad": _torch_grad}):
        out.append(tais.ais_estimate(torch.Generator().manual_seed(3),
                                     tais.standard_normal_energy, _torch_energy, 10, x0,
                                     step_size=0.2, leapfrogs=3, **kw))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out[0][1], out[1][1], rtol=1e-5, atol=1e-5)


def test_ais_num_splits_sums_group_estimates():
    """A logZ shift of -1 per group: the split-sum estimate is about
    -num_splits (the JAX test's tolerance 0.2); chains must divide."""
    def final_energy(z, aux=None):
        return 0.5 * torch.sum(z * z, dim=1) + 1.0

    g = torch.Generator().manual_seed(4)
    x0 = torch.randn((64, 2), generator=g)
    est, _ = tais.ais_estimate(g, tais.standard_normal_energy, final_energy, 50, x0,
                               step_size=0.2, leapfrogs=3, num_splits=8)
    np.testing.assert_allclose(float(est), -8.0, atol=0.2)
    with pytest.raises(ValueError, match="split"):
        tais.ais_estimate(g, tais.standard_normal_energy, final_energy, 2, x0[:10],
                          num_splits=4)


def test_anneal_schedule_and_single_step():
    np.testing.assert_array_equal(tais.anneal_schedule(4),
                                  np.array([0.25, 0.5, 0.75, 1.0], np.float32))
    x0 = torch.randn((16, 2), generator=torch.Generator().manual_seed(5))
    est, _ = tais.ais_estimate(torch.Generator().manual_seed(6), tais.standard_normal_energy,
                               _torch_energy, 1, x0, step_size=0.1, leapfrogs=2)
    w = tais.standard_normal_energy(x0) - _torch_energy(x0)  # beta_diff = beta[0] = 1
    torch.testing.assert_close(est, tais.logmeanexp(w), rtol=1e-5, atol=1e-5)
