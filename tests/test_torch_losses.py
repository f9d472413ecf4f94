"""The port's ESJD losses vs the JAX package's on the same inputs (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu.mcmc import losses as jlosses
from l2hmc_tpu_torch import mcmc

N, D = 64, 3
TOL = 1e-5  # float32 sums over 64 chains, relative


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    xp = (x + 0.5 * rng.standard_normal((N, D))).astype(np.float32)
    p = rng.uniform(size=N).astype(np.float32)
    return x, xp, p


@pytest.mark.parametrize("name", [
    "loss_vec", "loss_std", "loss_inverse", "loss_logsumexp", "loss_mixed",
    "loss_mixed_per_dim",
])
def test_loss_matches_jax(name):
    x, xp, p = _inputs()
    with jax.enable_x64(False):
        ref = np.asarray(getattr(jlosses, name)(*map(jnp.asarray, (x, xp, p))))
    got = getattr(mcmc, name)(*map(torch.tensor, (x, xp, p))).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=0)


@pytest.mark.parametrize("name", ["loss_mixed", "loss_mixed_per_dim"])
def test_scaled_loss_matches_jax(name):
    x, xp, p = _inputs(1)
    with jax.enable_x64(False):
        ref = float(getattr(jlosses, name)(*map(jnp.asarray, (x, xp, p)), scale=0.1))
    got = float(getattr(mcmc, name)(*map(torch.tensor, (x, xp, p)), scale=0.1))
    np.testing.assert_allclose(got, ref, rtol=TOL)


def test_scg_joint_loss_matches_jax():
    x, xp, p = _inputs(2)
    z, zp, pz = _inputs(3)
    with jax.enable_x64(False):
        ref = float(jlosses.scg_joint_loss(*map(jnp.asarray, (x, xp, p, z, zp, pz)), scale=0.1))
    got = float(mcmc.scg_joint_loss(*map(torch.tensor, (x, xp, p, z, zp, pz)), scale=0.1))
    np.testing.assert_allclose(got, ref, rtol=TOL)


def test_get_loss_registry():
    for name in ("mixed", "standard", "inverse", "logsumexp"):
        assert mcmc.get_loss(name).__name__ == jlosses.get_loss(name).__name__
    with pytest.raises(KeyError):
        mcmc.get_loss("nope")


def test_loss_gradients_match_jax():
    """d loss / d x_prop and d p_accept of the joint loss: the gradient the
    training step sends into the trajectories."""
    x, xp, p = _inputs(4)
    z, zp, pz = _inputs(5)
    with jax.enable_x64(False):
        gj = jax.grad(jlosses.scg_joint_loss, argnums=(1, 2, 4, 5))(
            *map(jnp.asarray, (x, xp, p, z, zp, pz)))
    t = [torch.tensor(a, requires_grad=i in (1, 2, 4, 5))
         for i, a in enumerate((x, xp, p, z, zp, pz))]
    gt = torch.autograd.grad(mcmc.scg_joint_loss(*t), [t[1], t[2], t[4], t[5]])
    for a, b in zip(gt, gj):
        scale = float(np.abs(np.asarray(b)).max())
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5 * scale)
