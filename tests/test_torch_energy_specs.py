"""The energy specs (rough well, GMM, funnel, phi^4) on the CPU: each spec's
plain energy and gradient against the JAX spec's closures, its hand-derived
gradient VJP against autograd in float64 and against ``jax.vjp`` of the JAX
closure, and the plain trajectory, chain and trajectory VJP built on it
against the JAX package's Pallas kernels in interpret mode and against
autograd."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from l2hmc_tpu import targets as jtargets
from l2hmc_tpu.ops import fused_dynamics as jfd
from l2hmc_tpu.train import ScgConfig as JaxScgConfig
from l2hmc_tpu.train import build_dynamics as jax_build_dynamics
from l2hmc_tpu_torch import targets
from l2hmc_tpu_torch.convert import params_from_jax
from l2hmc_tpu_torch.ops import fused_dynamics as fd
from l2hmc_tpu_torch.ops.philox import box_muller
from l2hmc_tpu_torch.train import ScgConfig, build_dynamics

N, T = 128, 3
TOL = 2e-4  # the JAX package's own fused-vs-XLA tolerance

# name -> (JAX target, port target, spec class, eps). The easy rough well:
# the hard one is float32-chaotic (tests/test_fused_dynamics.py:91-98). The
# funnel at a step its neck past the clip keeps stable.
CASES = {
    "rough_well_easy": (lambda: jtargets.RoughWell(dim=10, eps=0.1, easy=True),
                        lambda: targets.RoughWell(dim=10, eps=0.1, easy=True),
                        fd.RoughWellEnergy, 0.1),
    "ring": (lambda: jtargets.gen_ring(r=2.0, var=0.1, nb_mixtures=4),
             lambda: targets.gen_ring(r=2.0, var=0.1, nb_mixtures=4), fd.GmmEnergy, 0.1),
    "mog2": (lambda: jtargets.mog2(distance=4.0, var=0.1),
             lambda: targets.mog2(distance=4.0, var=0.1), fd.GmmEnergy, 0.1),
    "funnel": (lambda: jtargets.GaussianFunnel(dim=6), lambda: targets.GaussianFunnel(dim=6),
               fd.FunnelEnergy, 0.02),
    # the JAX test's lattice (tests/test_fused_dynamics.py:87)
    "phi4": (lambda: jtargets.Phi4Lattice(L=4, m2=-4.0, lam=1.0),
             lambda: targets.Phi4Lattice(L=4, m2=-4.0, lam=1.0), fd.Phi4Energy, 0.1),
}
# the funnel's first chains start past its clip (|v| > 8) on both sides
PAST_CLIP = (8.5, -8.5, 9.0, -9.0, 12.0, -12.0, 20.0, -20.0)


def _states(name, dim, n, seed=1):
    """(x, v) (n, dim) float32 from a numpy seed: x at the target's scale, the
    funnel's first chains past its clip, their necks at the clipped scale."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, dim))
    if name == "funnel":
        vcol = 2.0 * z[:, 0]
        vcol[:len(PAST_CLIP)] = PAST_CLIP
        x = np.concatenate([vcol[:, None], np.exp(np.clip(vcol, -8, 8) / 2)[:, None] * z[:, 1:]],
                           axis=1)
    elif name in ("ring", "mog2"):
        x = 2.0 * z
    else:
        x = z
    return x.astype(np.float32), rng.standard_normal((n, dim)).astype(np.float32)


def _setup(name):
    make_j, make_t, _, eps = CASES[name]
    jt, tt = make_j(), make_t()
    kw = dict(dim=tt.dim, n_chains=N, T=T)
    jd, _ = jax_build_dynamics(JaxScgConfig(**kw), jt)
    td, _ = build_dynamics(ScgConfig(**kw), tt)
    jp = jd.init_params(jax.random.key(0), eps=eps)
    for net in ("xnet", "vnet"):
        jp[net] = jax.tree_util.tree_map(lambda a: a + 0.03, jp[net])
    jp = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    tp = params_from_jax(jp, device="cpu")
    x, v = _states(name, tt.dim, N)
    return jt, tt, jd, td, jp, tp, x, v


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("name", list(CASES))
def test_spec_maps_and_packs(name):
    """``energy_spec_for_target`` gives the spec of the JAX package's mapping,
    with its constants as the kernels take them: kind and float count, in a
    block of D + D T + NC + 2 nets floats."""
    jt, tt, _, td, _, tp, _, _ = _setup(name)
    spec = fd.energy_spec_for_target(tt)
    assert type(spec) is CASES[name][2]
    assert type(jfd.energy_spec_for_target(jt)).__name__ == type(spec).__name__
    inp = fd.prepare(td, spec, tp, "cpu")
    D, H, H2, T_ = inp.dims
    nc = sum(c.numel() for c in spec.consts("cpu"))
    assert inp.energy_args == (spec.KIND, nc)
    assert nc == {"rough_well_easy": 4, "ring": 4 * (D + D * D + 1),
                  "mog2": 2 * (D + D * D + 1), "funnel": 3, "phi4": 3}[name]
    net = 2 * D * H + H * H2 + H2 + 3 * H2 * D + 5 * D + H * T_
    assert inp.block().numel() == D + D * T_ + nc + 2 * net
    for c, jc in zip(spec.consts("cpu"), jfd.energy_spec_for_target(jt).consts()):
        np.testing.assert_array_equal(c.numpy().reshape(-1), np.asarray(jc).reshape(-1))


@pytest.mark.parametrize("name", list(CASES))
def test_spec_closures_match_jax(name):
    """The plain energy and gradient on the (D, N) layout against the JAX
    spec's closures, 1e-5 (float32), the funnel's chains past the clip
    included."""
    jt, tt, *_, x, _ = _setup(name)
    spec, jspec = fd.energy_spec_for_target(tt), jfd.energy_spec_for_target(jt)
    energy, grad = spec.build(spec.consts("cpu"))
    jenergy, jgrad = jspec.build(jspec.consts())
    xt = x.T.copy()
    _close(energy(torch.tensor(xt)).numpy(), jenergy(jnp.asarray(xt)), 1e-5)
    _close(grad(torch.tensor(xt)).numpy(), jgrad(jnp.asarray(xt)), 1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_grad_vjp_matches_autograd_in_float64(name):
    """``build_grad_vjp`` (the Hessian-vector product the backward kernel
    uses) against autograd of ``build``'s gradient in float64, on constants
    made in float64: 1e-9."""
    _, tt, *_, x, _ = _setup(name)
    spec = fd.energy_spec_for_target(tt)
    c64 = spec.consts("cpu", torch.float64)
    _, grad = spec.build(c64)
    vjp = spec.build_grad_vjp(c64)
    xt = torch.tensor(x.T.copy(), dtype=torch.float64, requires_grad=True)
    d = torch.tensor(np.random.default_rng(4).standard_normal(xt.shape))
    (ref,) = torch.autograd.grad((grad(xt) * d).sum(), xt)
    torch.testing.assert_close(vjp(xt.detach(), d), ref, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("name", list(CASES))
def test_grad_vjp_matches_jax_vjp(name):
    """``build_grad_vjp`` against ``jax.vjp`` of the JAX spec's gradient
    closure in float32: rtol 1e-5 (and 1e-5 of the largest entry)."""
    jt, tt, *_, x, _ = _setup(name)
    spec, jspec = fd.energy_spec_for_target(tt), jfd.energy_spec_for_target(jt)
    _, jgrad = jspec.build(jspec.consts())
    xt = x.T.copy()
    d = np.random.default_rng(4).standard_normal(xt.shape).astype(np.float32)
    _, pullback = jax.vjp(jgrad, jnp.asarray(xt))
    (ref,) = pullback(jnp.asarray(d))
    got = spec.build_grad_vjp(spec.consts("cpu"))(torch.tensor(xt), torch.tensor(d)).numpy()
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_plain_trajectory_matches_jax_kernel(name, direction):
    """The plain trajectory on each spec against the JAX Pallas trajectory
    kernel in interpret mode, 2e-4."""
    jt, tt, jd, td, jp, tp, x, v = _setup(name)
    jfused = jfd.fused_for_target(jd, jt, tile=64, interpret=True)
    ref = getattr(jfused, direction)(jp, jnp.asarray(x), jnp.asarray(v))
    fd.reset_launch_counts()
    got = getattr(fd.fused_for_target(td, tt), direction)(tp, torch.tensor(x), torch.tensor(v))
    assert fd.LAUNCHES["trajectory"] == 0  # CPU tensors take the plain version
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        _close(g.numpy(), r)


def _zero_bit_draws(n, d):
    """The draws a Philox stream of zero words gives: v = sqrt(-2 ln 1e-7) in
    every dimension, direction forward, accept always — what the Pallas
    interpreter's zero PRNG bits give the JAX chain kernel."""
    zero = torch.zeros((d, n), dtype=torch.int64)
    u = torch.zeros(n)
    return lambda step: (box_muller(zero, zero), u, u)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_chain_matches_jax_kernel_on_zero_bits(name):
    """The plain chain on each spec, on the zero-bits schedule, against the
    JAX chain kernel under force_tpu_interpret_mode: acceptance exactly,
    states within 2e-4, the trace's end the state."""
    jt, tt, jd, td, jp, tp, x, _ = _setup(name)
    n_steps = 3
    sampler = jfd.fused_chain_sampler(jd, jt, tile=64)
    with pltpu.force_tpu_interpret_mode():
        x1, acc = sampler.run(jp, jnp.asarray(x), seed=7, n_mh_steps=n_steps)
    inp = fd.prepare(td, fd.energy_spec_for_target(tt), tp, "cpu")
    xo, acc_t, trace = fd.chain_plain(
        inp, torch.tensor(x).T.contiguous(), seed=7, n_mh_steps=n_steps,
        collect_trace=True, draws=_zero_bit_draws(N, tt.dim),
    )
    np.testing.assert_array_equal(acc_t[0].numpy(), np.asarray(acc))
    _close(xo.T.numpy(), x1)
    np.testing.assert_array_equal(trace[-1].numpy(), xo.numpy())


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "backward"])
def test_trajectory_vjp_plain_equals_autograd_in_float64(name, reverse):
    """``trajectory_vjp_plain`` on each spec (its gradient VJP at both
    gradient points of every substep) against autograd of
    ``trajectory_plain`` in float64: 1e-10 of each leaf's largest entry."""
    _, tt, _, td, _, tp, x, v = _setup(name)
    spec = fd.energy_spec_for_target(tt)
    inp = fd.prepare(td, spec, tp, "cpu")
    c64 = spec.consts("cpu", torch.float64)
    energy, grad = spec.build(c64)
    inp = dataclasses.replace(
        inp, eps=inp.eps.double(), masks=inp.masks.double(), consts=c64,
        xnet_w=[w.double() for w in inp.xnet_w], vnet_w=[w.double() for w in inp.vnet_w],
        energy=energy, grad_energy=grad, grad_vjp=spec.build_grad_vjp(c64))
    rng = np.random.default_rng(6)
    xs, vs = (torch.tensor(a.T.copy(), dtype=torch.float64) for a in (x, v))
    dX, dV = (torch.tensor(rng.standard_normal(xs.shape)) for _ in range(2))
    dld = torch.tensor(rng.standard_normal((1, N)))
    ws = [w.clone().requires_grad_(True) for w in [inp.eps, *inp.xnet_w, *inp.vnet_w]]
    xr, vr = xs.clone().requires_grad_(True), vs.clone().requires_grad_(True)
    k = dataclasses.replace(inp, eps=ws[0], xnet_w=ws[1:14], vnet_w=ws[14:])
    X, V, ld = fd.trajectory_plain(k, xr, vr, reverse)
    ref = torch.autograd.grad((X * dX).sum() + (V * dV).sum() + (ld * dld).sum(),
                              [xr, vr, *ws], allow_unused=True)
    gx, gv, deps, dx, dv = fd.trajectory_vjp_plain(inp, xs, vs, dX, dV, dld, reverse)
    for g, r in zip([dx, dv, deps, *gx, *gv], ref):
        r = torch.zeros_like(g) if r is None else r
        torch.testing.assert_close(g, r, rtol=0, atol=1e-10 * float(r.abs().max()) + 1e-300)


def test_unmapped_target_raises_jax_error():
    """A target with no spec raises JAX's ValueError, and the pure check the
    suite makes up front names the same reason."""
    class Opaque:
        dim = 2

    with pytest.raises(ValueError, match="no fused energy spec for target Opaque"):
        fd.energy_spec_for_target(Opaque())
    td, _ = build_dynamics(ScgConfig())
    assert fd.kernel_refusal(td, Opaque(), 10) == "no fused energy spec for target Opaque"
    assert fd.kernel_refusal(td, targets.scg_gaussian(), 10) is None
    assert "caps" in fd.kernel_refusal(td, targets.scg_gaussian(), 129)
