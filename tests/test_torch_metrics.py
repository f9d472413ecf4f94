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
