"""Port's Dynamics vs the JAX package's Dynamics on converted params (CPU),
plus the integrator's own oracles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu import dynamics as jdynamics
from l2hmc_tpu import targets as jtargets
from l2hmc_tpu.train import ScgConfig as JaxScgConfig
from l2hmc_tpu.train import build_dynamics as jax_build_dynamics
from l2hmc_tpu_torch import dynamics, targets
from l2hmc_tpu_torch.convert import params_from_jax
from l2hmc_tpu_torch.train import ScgConfig, build_dynamics

N = 128
TOL = 2e-5  # float32 trajectories of T=4 substeps, summation order differs

MODES = {
    "plain": dict(),
    "hmc": dict(hmc=True),
    "eps_dim": dict(eps_dim=True),
    "input_scale": dict(net_input_whiten=True),
}


def _pair(mode, dim=2):
    """(jax dyn, jax params, port dyn, port params) for one mode."""
    kw = dict(n_chains=N, T=4, dim=dim, **MODES[mode])
    jt = jtargets.scg_gaussian() if dim == 2 else jtargets.ill_conditioned_gaussian(dim)
    tt = targets.scg_gaussian() if dim == 2 else targets.ill_conditioned_gaussian(dim)
    jd, _ = jax_build_dynamics(JaxScgConfig(**kw), jt)
    td, _ = build_dynamics(ScgConfig(**kw), tt)
    eps = 0.1
    if mode == "eps_dim":
        eps = np.linspace(0.05, 0.15, dim).astype(np.float32)
    jp = jd.init_params(jax.random.key(0), eps=eps)
    # lift the 0.001 output factor so S/T/Q are O(0.1-1), not ~0
    for net in ("xnet", "vnet"):
        jp[net] = jax.tree_util.tree_map(lambda a: a + 0.03, jp[net])
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jd, jp, td, tp


def _state(dim=2, seed=1):
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal((N, dim))).astype(np.float32)
    v = rng.standard_normal((N, dim)).astype(np.float32)
    return x, v


def test_masks_bit_identical():
    for seed, T, dim in [(0, 10, 2), (3, 4, 50), (7, 25, 9)]:
        np.testing.assert_array_equal(
            dynamics.make_masks(seed, T, dim), jdynamics.make_masks(seed, T, dim)
        )
    np.testing.assert_array_equal(
        dynamics.time_encoding(10), jdynamics.time_encoding(10)
    )


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_trajectory_matches_jax(mode, direction):
    dim = 6 if mode == "input_scale" else 2
    jd, jp, td, tp = _pair(mode, dim)
    x, v = _state(dim)
    Xr, Vr, ldr = getattr(jd, direction)(jp, jnp.asarray(x), jnp.asarray(v))
    Xt, Vt, ldt = getattr(td, direction)(tp, torch.tensor(x), torch.tensor(v))
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xr), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(Vt.numpy(), np.asarray(Vr), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldr), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mode", ["plain", "hmc"])
def test_p_accept_matches_jax(mode):
    jd, jp, td, tp = _pair(mode)
    x, v = _state()
    x1, v1 = _state(seed=2)
    lj = np.random.default_rng(3).standard_normal(N).astype(np.float32)
    lj[:3] = np.nan  # the NaN guard maps these to 0
    ref = jd.p_accept(jp, *map(jnp.asarray, (x, v, x1, v1, lj)))
    out = td.p_accept(tp, *map(torch.tensor, (x, v, x1, v1, lj)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    assert np.all(out.numpy()[:3] == 0.0)


def test_exact_inverse():
    _, _, td, tp = _pair("plain")
    x, v = map(torch.tensor, _state())
    X, V, ld = td.forward(tp, x, v)
    x2, v2, ld_b = td.backward(tp, X, V)
    torch.testing.assert_close(x2, x, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(v2, v, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ld + ld_b, torch.zeros_like(ld), rtol=0, atol=1e-5)


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_logdet_equals_jacobian_slogdet(direction):
    """The accumulated logdet equals log|det J| of the (x, v) -> (X, V) map,
    with J from autograd at D=2 (float64 for a sharp oracle)."""
    _, _, td, tp = _pair("plain")
    tp64 = jax.tree_util.tree_map(torch.Tensor.double, tp)
    fn = getattr(td, direction)
    x, v = _state()
    for i in range(4):
        z0 = torch.tensor(np.concatenate([x[i], v[i]]), dtype=torch.float64)

        def f(z):
            X, V, _ = fn(tp64, z[None, :2], z[None, 2:])
            return torch.cat([X[0], V[0]])

        J = torch.autograd.functional.jacobian(f, z0)
        ld = fn(tp64, z0[None, :2], z0[None, 2:])[2]
        sign, logabs = torch.linalg.slogdet(J)
        assert sign != 0
        np.testing.assert_allclose(float(ld[0]), float(logabs), rtol=0, atol=1e-8)


def test_hmc_reduction_is_plain_leapfrog():
    """HMC mode is exactly the leapfrog v -= eps/2 g; x += eps v;
    v -= eps/2 g, with zero logdet."""
    _, _, td, tp = _pair("hmc")
    tgt = targets.scg_gaussian()
    x, v = map(torch.tensor, _state())
    X, V, ld = td.forward(tp, x, v)
    eps = 0.1
    xr, vr = x.clone(), v.clone()
    for _ in range(td.T):
        vr = vr - 0.5 * eps * tgt.grad_energy(xr)
        xr = xr + eps * vr
        vr = vr - 0.5 * eps * tgt.grad_energy(xr)
    torch.testing.assert_close(X, xr, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(V, vr, rtol=1e-5, atol=1e-5)
    assert torch.all(ld == 0.0)


def test_unported_knobs_raise():
    tgt = targets.scg_gaussian()
    for kw in (dict(eps_step=True), dict(eps_mat=True), dict(use_temperature=True),
               dict(net_input_fn=lambda net, xs: xs)):
        with pytest.raises(NotImplementedError):
            dynamics.Dynamics(dim=2, energy=tgt.energy, T=2, hmc=True, **kw)
    for kw in (dict(eps_mat=True), dict(net_type="conv"), dict(compute_dtype="bfloat16")):
        with pytest.raises(NotImplementedError):
            ScgConfig(**kw)


def test_default_device_is_cuda(monkeypatch):
    """Without a card, an entry point given no device raises rather than
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    td, tgt = build_dynamics(ScgConfig(T=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.init_params(torch.Generator(), eps=0.1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgt.sample(torch.Generator(), 4)
