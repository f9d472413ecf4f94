"""The suite's targets (rough well, GMM ring and mog2, Gaussian funnel with its
net-input features, the funnel's whitening bijector and pullback, the tilted
Gaussian) against the JAX package's on the same inputs: energy, the analytic
gradient against ``jax.grad`` and against autograd, and sample moments."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu import targets as jtargets
from l2hmc_tpu_torch import targets
from l2hmc_tpu_torch.targets import batched_grad

RTOL = 1e-5  # float32

CASES = {
    "rough_well_hard": (lambda: jtargets.RoughWell(dim=10, eps=0.1),
                        lambda: targets.RoughWell(dim=10, eps=0.1)),
    "rough_well_easy": (lambda: jtargets.RoughWell(dim=10, eps=0.1, easy=True),
                        lambda: targets.RoughWell(dim=10, eps=0.1, easy=True)),
    "ring": (lambda: jtargets.gen_ring(r=2.0, var=0.1, nb_mixtures=4),
             lambda: targets.gen_ring(r=2.0, var=0.1, nb_mixtures=4)),
    "mog2": (lambda: jtargets.mog2(distance=4.0, var=0.1),
             lambda: targets.mog2(distance=4.0, var=0.1)),
    "funnel": (lambda: jtargets.GaussianFunnel(dim=10), lambda: targets.GaussianFunnel(dim=10)),
}


def _x(name, dim, n=64):
    """States from a numpy seed at the target's scale; the funnel's first rows
    past its clip (|v| > 8) on both sides."""
    z = np.random.default_rng(0).standard_normal((n, dim))
    if name == "funnel":
        v = 3.0 * z[:, 0]
        v[:6] = (8.5, -8.5, 12.0, -12.0, 20.0, -20.0)
        z = np.concatenate([v[:, None], np.exp(np.clip(v, -8, 8) / 2)[:, None] * z[:, 1:]], 1)
    elif name in ("ring", "mog2"):
        z = 2.0 * z
    return z.astype(np.float32)


def _close(got, ref, rtol=RTOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("name", list(CASES))
def test_energy_and_gradient_match_jax(name):
    """Energy against JAX's; the analytic gradient against ``jax.grad`` of
    JAX's energy and against autograd of the port's own, 1e-5."""
    jt, tt = CASES[name][0](), CASES[name][1]()
    assert tt.dim == jt.dim
    x = _x(name, tt.dim)
    xt = torch.tensor(x)
    _close(tt.energy(xt).numpy(), jt.energy(jnp.asarray(x)))
    g = tt.grad_energy(xt)
    _close(g.numpy(), jt.grad_energy(jnp.asarray(x)))
    _close(g.numpy(), batched_grad(tt.energy)(xt).numpy())
    assert not g.requires_grad


@pytest.mark.parametrize("name", list(CASES))
def test_analytic_gradient_stays_differentiable(name):
    """A training loss differentiates through the gradient: the analytic
    gradient's own derivative equals autograd's second derivative of the
    energy, in float64."""
    tt = CASES[name][1]()
    x = torch.tensor(_x(name, tt.dim, 16), dtype=torch.float64, requires_grad=True)
    d = torch.tensor(np.random.default_rng(1).standard_normal(x.shape))
    (got,) = torch.autograd.grad((tt.grad_energy(x) * d).sum(), x)
    g_auto = torch.autograd.grad(tt.energy(x).sum(), x, create_graph=True)[0]
    (ref,) = torch.autograd.grad((g_auto * d).sum(), x)
    torch.testing.assert_close(got, ref, rtol=1e-9, atol=1e-9)


def _moments(s):
    s = np.asarray(s, np.float64)
    return s.mean(0), np.cov(s.T)


@pytest.mark.parametrize("name", ["rough_well_hard", "ring", "mog2", "funnel"])
def test_sample_moments_match_jax(name):
    """The exact samplers' first two moments against JAX's on 20000 draws
    each (two streams): means within 0.1, covariances within 10% of the
    largest variance; the funnel's neck on its log-variance scale (heavy
    tails)."""
    jt, tt = CASES[name][0](), CASES[name][1]()
    s_t = tt.sample(torch.Generator().manual_seed(3), 20000, device="cpu").numpy()
    s_j = np.asarray(jt.sample(jax.random.key(3), 20000))
    assert s_t.shape == s_j.shape == (20000, tt.dim) and s_t.dtype == np.float32
    if name == "funnel":
        s_t, s_j = (np.stack([s[:, 0], np.log(s[:, 1] ** 2)], 1) for s in (s_t, s_j))
    (m_t, c_t), (m_j, c_j) = _moments(s_t), _moments(s_j)
    np.testing.assert_allclose(m_t, m_j, atol=0.1)
    np.testing.assert_allclose(c_t, c_j, atol=0.1 * np.abs(np.diag(c_j)).max())


def test_gmm_constants_match_jax():
    for jt, tt in ((jtargets.gen_ring(2.0, 0.1, 4), targets.gen_ring(2.0, 0.1, 4)),
                   (jtargets.mog2(4.0, 0.1), targets.mog2(4.0, 0.1))):
        for k in ("mus", "sigmas", "pis", "_precs", "_chols", "_log_consts"):
            np.testing.assert_array_equal(getattr(tt, k), getattr(jt, k))
        assert tt.n_components == jt.n_components
    with pytest.raises(ValueError, match="sum to 1"):
        targets.GMM(np.zeros((2, 2)), np.stack([np.eye(2)] * 2), np.array([0.5, 0.4]))


@pytest.mark.parametrize("net", ["vnet", "xnet"])
def test_funnel_net_input_transform_matches_jax(net):
    """The funnel's net-input features against JAX's, past the clip too."""
    jt, tt = jtargets.GaussianFunnel(dim=10), targets.GaussianFunnel(dim=10)
    rng = np.random.default_rng(2)
    a = _x("funnel", 10)
    b = rng.standard_normal(a.shape).astype(np.float32)
    t = rng.standard_normal((a.shape[0], 2)).astype(np.float32)
    got = tt.net_input_transform()(net, [torch.tensor(a), torch.tensor(b), torch.tensor(t), None])
    ref = jt.net_input_transform()(net, [jnp.asarray(a), jnp.asarray(b), jnp.asarray(t), None])
    assert len(got) == len(ref) == 4 and got[3] is None
    for g, r in zip(got[:3], ref[:3]):
        _close(g.numpy(), r)


def test_funnel_whiten_round_trip_and_log_det():
    """``FunnelWhiten``: inverse(forward(y)) = y, forward and its log-det equal
    JAX's, and the log-det equals log |det J| of autograd's Jacobian."""
    jb, tb = jtargets.FunnelWhiten(dim=6), targets.FunnelWhiten(dim=6)
    y = _x("funnel", 6, 16)
    yt = torch.tensor(y)
    torch.testing.assert_close(tb.inverse(tb.forward(yt)), yt, rtol=1e-5, atol=1e-5)
    _close(tb.forward(yt).numpy(), jb.forward(jnp.asarray(y)))
    _close(tb.forward_log_det(yt).numpy(), jb.forward_log_det(jnp.asarray(y)))
    y64 = torch.tensor(y, dtype=torch.float64)
    for row in range(y64.shape[0]):
        jac = torch.autograd.functional.jacobian(lambda r: tb.forward(r[None])[0], y64[row])
        logdet = torch.linalg.slogdet(jac)[1]
        torch.testing.assert_close(tb.forward_log_det(y64[row:row + 1])[0], logdet)


def test_transformed_funnel_matches_jax():
    """The funnel's pullback: energy and its (autograd) gradient against
    JAX's, and the sampler's draws pulled back to about unit scale."""
    jtt = jtargets.TransformedTarget(jtargets.GaussianFunnel(6), jtargets.FunnelWhiten(6))
    ttt = targets.TransformedTarget(targets.GaussianFunnel(6), targets.FunnelWhiten(6))
    assert ttt.dim == 6 and ttt.sigma is None
    y = np.random.default_rng(4).standard_normal((64, 6)).astype(np.float32)
    _close(ttt.energy(torch.tensor(y)).numpy(), jtt.energy(jnp.asarray(y)))
    _close(ttt.grad_energy(torch.tensor(y)).numpy(), jtt.grad_energy(jnp.asarray(y)))
    s = ttt.sample(torch.Generator().manual_seed(0), 20000, device="cpu").numpy()
    np.testing.assert_allclose(s[:, 1:].std(0), 1.0, atol=0.05)
    np.testing.assert_allclose(s[:, 0].std(), 2.0, atol=0.1)


def test_tilted_gaussian_is_the_random_tilted_law():
    """``tilted_gaussian`` is ``random_tilted_gaussian`` (the JAX package's
    definition): eigenvalues log-uniform in [10^log_min, 10^log_max] up to
    the 1e-6 jitter, and the energy of a port target equals the JAX
    Gaussian's with the same covariance."""
    tt = targets.tilted_gaussian(3, 5, -1.0, 1.0)
    np.testing.assert_array_equal(tt.sigma, targets.random_tilted_gaussian(3, 5, -1.0, 1.0).sigma)
    ev = np.linalg.eigvalsh(tt.sigma)
    assert ev.min() >= 0.1 - 1e-5 and ev.max() <= 10.0 + 1e-5
    jt = jtargets.Gaussian(np.zeros(5), tt.sigma)
    x = np.random.default_rng(5).standard_normal((16, 5)).astype(np.float32)
    _close(tt.energy(torch.tensor(x)).numpy(), jt.energy(jnp.asarray(x)))
    jj = jtargets.tilted_gaussian(jax.random.key(0), 5, -1.0, 1.0)
    ev = np.linalg.eigvalsh(jj.sigma)
    assert ev.min() >= 0.1 - 1e-5 and ev.max() <= 10.0 + 1e-5
