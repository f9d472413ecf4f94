"""Port's Dynamics vs the JAX package's Dynamics on converted params (CPU),
plus the integrator's own oracles."""

import dataclasses

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
    """eps_step still raises; use_temperature, net_input_fn (exclusive with
    input_scale, with JAX's error), the lattice conv nets and bf16 operands
    are ported."""
    tgt = targets.scg_gaussian()
    with pytest.raises(NotImplementedError):
        dynamics.Dynamics(dim=2, energy=tgt.energy, T=2, hmc=True, eps_step=True)
    for kw in (dict(use_temperature=True), dict(net_input_fn=lambda net, xs: xs)):
        dynamics.Dynamics(dim=2, energy=tgt.energy, T=2, hmc=True, **kw)
    with pytest.raises(ValueError, match="mutually exclusive"):
        dynamics.Dynamics(dim=2, energy=tgt.energy, T=2, hmc=True, input_scale=(1.0, 2.0),
                          net_input_fn=lambda net, xs: xs)
    ScgConfig(dim=16, net_type="conv")  # ported now
    ScgConfig(compute_dtype="bfloat16")  # ported now


def _suite_pair(kw, jt, tt):
    """(jax dyn, jax params, port dyn, port params) for a suite recipe on a
    suite target, the nets lifted as in ``_pair``."""
    kw = dict(n_chains=N, T=4, dim=tt.dim, **kw)
    jd, _ = jax_build_dynamics(JaxScgConfig(**kw), jt)
    td, _ = build_dynamics(ScgConfig(**kw), tt)
    jp = jd.init_params(jax.random.key(0), eps=0.1)
    for net in ("xnet", "vnet"):
        jp[net] = jax.tree_util.tree_map(lambda a: a + 0.03, jp[net])
    return jd, jp, td, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_temperature_trajectory_and_p_accept_match_jax(direction):
    """``use_temperature`` (the ring's annealed recipe) at temperature 3.4:
    trajectory, logdet and acceptance against JAX's; at 1.0 they equal the
    untempered dynamics' exactly."""
    jd, jp, td, tp = _suite_pair(dict(init_temperature=5.0),
                                 jtargets.gen_ring(2.0, 0.1, 4), targets.gen_ring(2.0, 0.1, 4))
    assert td.use_temperature and jd.use_temperature
    x, v = _state()
    temp = np.float32(3.4)
    ref = getattr(jd, direction)(jp, jnp.asarray(x), jnp.asarray(v), temperature=temp)
    got = getattr(td, direction)(tp, torch.tensor(x), torch.tensor(v),
                                 temperature=torch.tensor(temp))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=TOL, atol=TOL)
    pr = jd.p_accept(jp, jnp.asarray(x), jnp.asarray(v), *ref, temperature=temp)
    pt = td.p_accept(tp, torch.tensor(x), torch.tensor(v), *got, temperature=torch.tensor(temp))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pr), rtol=TOL, atol=TOL)
    cold = dataclasses.replace(td, use_temperature=False)
    for a, b in zip(getattr(td, direction)(tp, torch.tensor(x), torch.tensor(v)),
                    getattr(cold, direction)(tp, torch.tensor(x), torch.tensor(v))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_net_input_fn_trajectory_matches_jax(direction):
    """The funnel's net-input features (``net_input_target_fn``):
    trajectory and logdet against JAX's, chains past the clip included."""
    jd, jp, td, tp = _suite_pair(dict(net_input_target_fn=True),
                                 jtargets.GaussianFunnel(dim=4), targets.GaussianFunnel(dim=4))
    assert td.net_input_fn is not None
    x, v = _state(4)
    x[:4, 0] = (9.0, -9.0, 12.0, -12.0)
    x[:4, 1:] *= 0.02  # the neck at the clipped scale past the negative clip
    ref = getattr(jd, direction)(jp, jnp.asarray(x), jnp.asarray(v))
    got = getattr(td, direction)(tp, torch.tensor(x), torch.tensor(v))
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)


def test_net_input_fn_keeps_the_logdet():
    """With the funnel's features the accumulated logdet still equals
    log |det J| of the (x, v) -> (X, V) map (float64, autograd's J)."""
    _, _, td, tp = _suite_pair(dict(net_input_target_fn=True),
                               jtargets.GaussianFunnel(dim=2), targets.GaussianFunnel(dim=2))
    tp64 = jax.tree_util.tree_map(torch.Tensor.double, tp)
    x, v = _state(2)
    for i in range(3):
        z0 = torch.tensor(np.concatenate([x[i], v[i]]), dtype=torch.float64)

        def f(z):
            X, V, _ = td.forward(tp64, z[None, :2], z[None, 2:])
            return torch.cat([X[0], V[0]])

        logabs = torch.linalg.slogdet(torch.autograd.functional.jacobian(f, z0))[1]
        ld = td.forward(tp64, z0[None, :2], z0[None, 2:])[2]
        np.testing.assert_allclose(float(ld[0]), float(logabs), rtol=0, atol=1e-8)


def test_default_device_is_cuda(monkeypatch):
    """Without a card, an entry point given no device raises rather than
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    td, tgt = build_dynamics(ScgConfig(T=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.init_params(torch.Generator(), eps=0.1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgt.sample(torch.Generator(), 4)


# -- eps_mat: the dense drift preconditioner ------------------------------------

# (hmc, W init: a scalar eps or the scale of chol(Sigma)). In HMC mode
# 0.5 chol(Sigma) is whitened leapfrog at step 0.5. The learned mode at
# 0.5 chol(Sigma) ("chol_half") is ill-conditioned in float32 and is held by
# its own test below; the other cases are held at 1e-5.
EPS_MAT_CASES = {
    "scalar": (False, None),
    "chol": (False, 0.1),
    "chol_half": (False, 0.5),
    "hmc_scalar": (True, None),
    "hmc_chol": (True, 0.5),
}
WELL_CONDITIONED = [c for c in EPS_MAT_CASES if c != "chol_half"]


def _eps_mat_pair(hmc, chol_scale):
    """(jax dyn, jax params, port dyn, port params, eps) with eps_mat, W
    from a scalar eps (0.1 I) or from ``chol_scale`` chol(Sigma); the nets
    lifted as in ``_pair``."""
    kw = dict(n_chains=N, T=4, eps_mat=True, hmc=hmc)
    jt, tt = jtargets.scg_gaussian(), targets.scg_gaussian()
    jd, _ = jax_build_dynamics(JaxScgConfig(**kw), jt)
    td, _ = build_dynamics(ScgConfig(**kw), tt)
    eps = 0.1 if chol_scale is None else (chol_scale * np.linalg.cholesky(jt.sigma)).astype(
        np.float32)
    jp = jd.init_params(jax.random.key(0), eps=eps)
    if not hmc:
        for net in ("xnet", "vnet"):
            jp[net] = jax.tree_util.tree_map(lambda a: a + 0.03, jp[net])
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jd, jp, td, tp, eps


def _target_state(seed=1):
    """(x, v): x drawn from the SCG target, so a chol(Sigma)-shaped W takes
    steps of its designed size, and v ~ N(0, I)."""
    x, v = _state(seed=seed)
    chol = np.linalg.cholesky(jtargets.scg_gaussian().sigma)
    return (x / 3.0 @ chol.T).astype(np.float32), v


@pytest.mark.parametrize("case", WELL_CONDITIONED)
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_eps_mat_trajectory_matches_jax(case, direction):
    """Trajectories and logdets of an eps_mat Dynamics against the JAX
    package's on converted params, at 1e-5."""
    jd, jp, td, tp, _ = _eps_mat_pair(*EPS_MAT_CASES[case])
    x, v = _target_state()
    Xr, Vr, ldr = getattr(jd, direction)(jp, jnp.asarray(x), jnp.asarray(v))
    Xt, Vt, ldt = getattr(td, direction)(tp, torch.tensor(x), torch.tensor(v))
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xr), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(Vt.numpy(), np.asarray(Vr), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldr), rtol=1e-5, atol=1e-5)
    if td.hmc:
        assert torch.all(ldt == 0.0)


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_eps_mat_chol_half_learned_matches_jax(direction, monkeypatch):
    """The learned mode at W = 0.5 chol(Sigma), the best recipe's init, with
    the lifted nets: its exp-gates run at eps = exp(mean log|diag W|) = 0.89
    and W's columns (norms ~5) carry the nets' O(1) translations, so a
    forward trajectory grows to |x| ~ 2e3 within its 4 substeps, and float32
    rounding alone moves each package's result by more than 1e-5 (asserted
    below for the port, against its own float64 run). So both packages run
    in float64 here and must agree to 1e-9. The JAX package's nets ask for a
    float32 result (``preferred_element_type``) whatever the input dtype:
    for this test its ``jnp.dot`` drops that request, and nothing else in
    it changes."""
    jd, jp, td, tp, _ = _eps_mat_pair(*EPS_MAT_CASES["chol_half"])
    x, v = _target_state()
    X32, V32, _ = getattr(td, direction)(tp, torch.tensor(x), torch.tensor(v))
    dot = jnp.dot
    monkeypatch.setattr(jnp, "dot", lambda a, b, preferred_element_type=None, **kw:
                        dot(a, b, **kw))
    jp64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), jp)
    tp64 = jax.tree_util.tree_map(torch.Tensor.double, tp)
    Xr, Vr, ldr = getattr(jd, direction)(jp64, jnp.asarray(x, jnp.float64),
                                         jnp.asarray(v, jnp.float64))
    Xt, Vt, ldt = getattr(td, direction)(tp64, torch.tensor(x).double(),
                                         torch.tensor(v).double())
    assert Xr.dtype == Vr.dtype == ldr.dtype == jnp.float64
    for got, want in ((Xt, Xr), (Vt, Vr), (ldt, ldr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-9)
    f32_err = max(float((X32.double() - Xt).abs().max()), float((V32.double() - Vt).abs().max()))
    assert f32_err > 1e-5


@pytest.mark.parametrize("case", list(EPS_MAT_CASES))
def test_eps_mat_init_inverse_and_logdet(case):
    """The port's own init gives JAX's W and alpha (W = eps I and log eps,
    or W = eps and mean log|diag W|); backward inverts forward with the
    logdets cancelling; and in float64 the logdet equals log|det J| of the
    (x, v) map, W being constant in the updated variable."""
    jd, jp, td, tp, eps = _eps_mat_pair(*EPS_MAT_CASES[case])
    own = td.init_params(torch.Generator().manual_seed(0), eps=eps, device="cpu")
    np.testing.assert_allclose(own["w"].numpy(), np.asarray(jp["w"]), rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(own["alpha"]), float(jp["alpha"]), rtol=1e-6)
    # chol_half's float32 trajectories are ill-conditioned (see above): its
    # round trip is held in float64
    dtype = torch.float64 if case == "chol_half" else torch.float32
    tp_rt = jax.tree_util.tree_map(lambda t: t.to(dtype), tp)
    x, v = (torch.tensor(a, dtype=dtype) for a in _target_state())
    X, V, ld = td.forward(tp_rt, x, v)
    x2, v2, ld_b = td.backward(tp_rt, X, V)
    torch.testing.assert_close(x2, x, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(v2, v, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ld + ld_b, torch.zeros_like(ld), rtol=0, atol=1e-5)
    tp64 = jax.tree_util.tree_map(torch.Tensor.double, tp)
    xs, vs = _target_state()
    for i in range(3):
        z0 = torch.tensor(np.concatenate([xs[i], vs[i]]), dtype=torch.float64)

        def f(z):
            Xz, Vz, _ = td.forward(tp64, z[None, :2], z[None, 2:])
            return torch.cat([Xz[0], Vz[0]])

        sign, logabs = torch.linalg.slogdet(torch.autograd.functional.jacobian(f, z0))
        assert sign != 0
        ld0 = td.forward(tp64, z0[None, :2], z0[None, 2:])[2]
        np.testing.assert_allclose(float(ld0[0]), float(logabs), rtol=0, atol=1e-8)


def test_eps_mat_hmc_is_preconditioned_leapfrog():
    """HMC mode with eps_mat is v -= grad W / 2; x += v W^T; v -= grad W / 2."""
    tgt = targets.scg_gaussian()
    dyn = dynamics.Dynamics(dim=2, energy=tgt.energy, grad_energy=tgt.grad_energy, T=6,
                            hmc=True, eps_mat=True)
    params = dyn.init_params(torch.Generator(), eps=0.1, device="cpu")
    w = torch.tensor([[0.12, 0.05], [-0.04, 0.09]])
    params["w"] = w
    x, v = map(torch.tensor, _state())
    X, V, ld = dyn.forward(params, x, v)
    xr, vr = x.clone(), v.clone()
    for _ in range(6):
        vr = vr - 0.5 * tgt.grad_energy(xr) @ w
        xr = xr + vr @ w.T
        vr = vr - 0.5 * tgt.grad_energy(xr) @ w
    torch.testing.assert_close(X, xr, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(V, vr, rtol=1e-5, atol=1e-5)
    assert torch.all(ld == 0.0)


def test_eps_mat_checks():
    """A zero diagonal is refused with the JAX package's message; eps_mat
    excludes eps_dim; params without "w" are refused; a frozen eps detaches
    W as it detaches alpha."""
    tgt = targets.scg_gaussian()
    dyn = dynamics.Dynamics(dim=2, energy=tgt.energy, T=3, hmc=True, eps_mat=True)
    with pytest.raises(ValueError, match=r"nonzero diagonal.*indices \[1\]"):
        dyn.init_params(torch.Generator(), eps=np.array([[0.1, 0.0], [0.3, 0.0]]), device="cpu")
    with pytest.raises(ValueError, match="scalar or \\(dim, dim\\)"):
        dyn.init_params(torch.Generator(), eps=np.ones(2, np.float32), device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        dynamics.Dynamics(dim=2, energy=tgt.energy, T=3, hmc=True, eps_mat=True, eps_dim=True)
    with pytest.raises(ValueError, match='missing "w"'):
        dyn.w({"alpha": torch.tensor(0.0)})
    frozen = dynamics.Dynamics(dim=2, energy=tgt.energy, T=3, hmc=True, eps_mat=True,
                               eps_trainable=False)
    p = frozen.init_params(torch.Generator(), eps=0.1, device="cpu")
    p["w"].requires_grad_(True)
    assert not frozen.w(p).requires_grad and dyn.w(p).requires_grad
