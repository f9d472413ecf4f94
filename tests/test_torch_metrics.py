"""Port's ESS metrics vs the JAX package's on one numpy trace (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu import evals as jevals
from l2hmc_tpu.train import evaluate_ess as jax_evaluate_ess
from l2hmc_tpu_torch import evals
from l2hmc_tpu_torch.train import evaluate_ess


@pytest.fixture(scope="module")
def trace():
    """An AR(1) trace (T, N, D) with lag-1 correlation 0.9, so the spectrum
    crosses the 0.05 threshold after ~30 lags."""
    rng = np.random.default_rng(0)
    T, N, D = 300, 16, 2
    x = np.empty((T, N, D), np.float32)
    x[0] = rng.standard_normal((N, D))
    for t in range(1, T):
        x[t] = 0.9 * x[t - 1] + np.sqrt(1 - 0.81) * rng.standard_normal((N, D))
    return x


def test_acl_spectrum_and_ess_match_jax(trace):
    """Same trace -> same spectrum (atol 1e-5: float32 sums over 10^4
    products in another order) and same ESS (1e-4)."""
    ref = np.asarray(jevals.acl_spectrum(jnp.asarray(trace), 1.7, max_lag=100))
    got = evals.acl_spectrum(torch.tensor(trace), 1.7, max_lag=100).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        float(evals.ess(torch.tensor(got))), float(jevals.ess(jnp.asarray(ref))),
        rtol=1e-4,
    )
    np.testing.assert_allclose(
        float(evals.autocovariance(torch.tensor(trace), 3)),
        float(jevals.autocovariance(jnp.asarray(trace), 3)), rtol=1e-5,
    )


def test_evaluate_ess_full_spectrum_matches_jax(trace):
    cov = np.diag([2.0, 0.5])
    got = evaluate_ess(torch.tensor(trace), cov)
    ref = jax_evaluate_ess(jnp.asarray(trace), cov)
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert 0.0 < got < 0.2  # rho_1 = 0.9: ESS near (1-0.9)/(1+0.9)
    np.testing.assert_allclose(
        float(evals.ess_per_step(torch.tensor(trace), np.sqrt(2.5))), got, rtol=1e-6
    )


def test_normal_kl_matches_jax():
    """KL of diagonal normals against the JAX package's, against numbers and
    against arrays on the p side (rtol 1e-6), and zero for q = p."""
    rng = np.random.default_rng(1)
    mu = rng.standard_normal((5, 7)).astype(np.float32)
    sd = np.exp(0.3 * rng.standard_normal((5, 7))).astype(np.float32)
    pm = rng.standard_normal((5, 7)).astype(np.float32)
    ps = np.exp(0.2 * rng.standard_normal((5, 7))).astype(np.float32)
    for p_mean, p_sd in ((0.0, 1.0), (pm, ps)):
        ref = np.asarray(jevals.normal_kl(jnp.asarray(mu), jnp.asarray(sd), p_mean, p_sd))
        got = evals.normal_kl(torch.tensor(mu), torch.tensor(sd), p_mean, p_sd).numpy()
        assert got.shape == (5,)
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    same = evals.normal_kl(torch.tensor(mu), torch.tensor(sd), mu, sd)
    np.testing.assert_allclose(same.numpy(), 0.0, atol=1e-6)


def test_accept_numpy_matches_jax():
    """The host-side accept draws from numpy's global generator: the same
    seed gives the JAX package's result."""
    rng = np.random.default_rng(2)
    x_i, x_p = rng.standard_normal((2, 50, 3))
    p = rng.uniform(size=50)
    np.random.seed(4)
    ref = jevals.accept_numpy(x_i, x_p, p)
    np.random.seed(4)
    got = evals.accept_numpy(x_i, x_p, p)
    np.testing.assert_array_equal(got, ref)
    took = (got == x_p).all(axis=1)
    assert 0 < took.sum() < 50


def test_gaussian_log_likelihood_and_numerical_jacobian_match_jax():
    from l2hmc_tpu import targets as jtargets
    from l2hmc_tpu_torch import targets as ttargets

    x = np.random.default_rng(3).standard_normal((40, 2)).astype(np.float32)
    ref = jevals.gaussian_log_likelihood(x, jtargets.scg_gaussian())
    got = evals.gaussian_log_likelihood(x, ttargets.scg_gaussian())
    np.testing.assert_allclose(got, ref, rtol=1e-5)

    a = np.asarray([[1.0, 2.0, 0.5], [0.0, -1.0, 3.0]], np.float32)
    x0 = np.asarray([0.3, -0.2, 0.9], np.float32)
    ref = np.asarray(jevals.numerical_jacobian(lambda y: jnp.tanh(jnp.asarray(a) @ y),
                                               jnp.asarray(x0)))
    got = evals.numerical_jacobian(lambda y: torch.tanh(torch.tensor(a) @ y), torch.tensor(x0))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
