"""The training path's fused trajectory on the CPU: the hand-derived VJP
(``trajectory_vjp_plain``, the plain version of the backward kernel) against
the JAX package's backward Pallas kernel in interpret mode and against
``jax.grad`` of its XLA path, and the autograd Function around it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu import targets as jtargets
from l2hmc_tpu.ops import fused_dynamics as jfd
from l2hmc_tpu.train import ScgConfig as JaxScgConfig
from l2hmc_tpu.train import build_dynamics as jax_build_dynamics
from l2hmc_tpu_torch import targets
from l2hmc_tpu_torch.convert import params_from_jax
from l2hmc_tpu_torch.ops import fused_dynamics as fd
from l2hmc_tpu_torch.train import ScgConfig, build_dynamics
from l2hmc_tpu_torch.train.optim import tree_leaves, tree_unflatten

N, T = 128, 3  # the size tests/test_fused_dynamics.py runs its fused VJP at
# Per leaf, max |port - JAX| <= 1e-4 * max |JAX leaf|: float32 sums over 128
# chains and 3 substeps in another order (the JAX package's own fused-vs-XLA
# gradient tolerance is 2e-3 of the leaf).
REL = 1e-4

MODES = ["scg", "eps_dim", "input_scale", "hmc"]


def _setup(mode):
    """JAX and port dynamics, params (weights lifted by 0.03 so S/T/Q are
    not ~0), state and cotangents, all from numpy seeds."""
    dim = 8 if mode == "input_scale" else 2
    kw = dict(dim=dim, n_chains=N, T=T, hmc=mode == "hmc", eps_dim=mode == "eps_dim",
              net_input_whiten=mode == "input_scale")
    if dim == 2:
        jt, tt = jtargets.scg_gaussian(), targets.scg_gaussian()
    else:
        jt, tt = jtargets.ill_conditioned_gaussian(dim, 2.0), targets.ill_conditioned_gaussian(dim, 2.0)
    jd, _ = jax_build_dynamics(JaxScgConfig(**kw), jt)
    td, _ = build_dynamics(ScgConfig(**kw), tt)
    eps = np.array([0.05, 0.2], np.float32) if mode == "eps_dim" else 0.1
    jp = jd.init_params(jax.random.key(0), eps=eps)
    if mode != "hmc":
        for net in ("xnet", "vnet"):
            jp[net] = jax.tree_util.tree_map(lambda a: a + 0.03, jp[net])
    jp = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    tp = params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(5)
    scale = np.sqrt(np.diag(jt.sigma))
    arrs = dict(
        x=(rng.standard_normal((N, dim)) * scale).astype(np.float32),
        v=rng.standard_normal((N, dim)).astype(np.float32),
        dX=rng.standard_normal((N, dim)).astype(np.float32),
        dV=rng.standard_normal((N, dim)).astype(np.float32),
        dld=rng.standard_normal(N).astype(np.float32),
    )
    return jd, jt, jp, td, tt, tp, arrs


def _close(got, ref, what):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=REL * scale + 1e-30,
                               err_msg=what)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "backward"])
def test_vjp_plain_matches_jax_bwd_kernel(mode, reverse):
    """Kernel layout in and out: the same eps column, masks, energy
    constants, 13 + 13 weights, (D, N) state and cotangents go to the JAX
    backward Pallas kernel (interpret mode, two tiles of 64, so its
    cross-tile accumulation runs) and to ``trajectory_vjp_plain``; all 26
    weight cotangents, deps, dx and dv agree. In HMC mode the nets are zero
    stand-ins whose cotangents neither side uses (the JAX kernel
    differentiates them with relu'(0) = 1/2, the port skips them), so only
    deps, dx and dv are compared."""
    jd, jt, jp, td, tt, tp, a = _setup(mode)
    with jax.enable_x64(False):
        jfused = jfd.fused_for_target(jd, jt, tile=64, interpret=True)
        xw, vw = jfd._kernel_nets(jd, jp)
        eps = jfd._eps_col(jd.eps(jp), jd.dim)
        call = jfd.DifferentiableFusedDynamics(jfused)._get_bwd_callable(N, 64, reverse)
        out = call(eps, jnp.asarray(jd.masks.T, jnp.float32), jfused.spec.consts(), xw, vw,
                   *(jnp.asarray(a[k].T) for k in ("x", "v", "dX", "dV")),
                   jnp.asarray(a["dld"])[None, :])
        ref = [np.asarray(o) for o in out]

    inp = fd.prepare(td, fd.energy_spec_for_target(tt), tp, "cpu")
    fd.reset_launch_counts()
    gx, gv, deps, dx, dv = fd.trajectory_vjp(
        inp, *(torch.tensor(a[k].T.copy()) for k in ("x", "v", "dX", "dV")),
        torch.tensor(a["dld"])[None, :], reverse)
    assert fd.LAUNCHES["trajectory_bwd"] == 0  # CPU tensors take the plain version
    got = [*gx, *gv, deps, dx, dv]
    names = [f"xnet[{i}]" for i in range(13)] + [f"vnet[{i}]" for i in range(13)] + [
        "deps", "dx", "dv"]
    first = 26 if mode == "hmc" else 0
    for g, r, name in list(zip(got, ref, names))[first:]:
        assert tuple(g.shape) == r.shape, name
        _close(g.numpy(), r, name)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_fused_autograd_matches_jax_grad(mode, direction):
    """Through the params tree: the gradient of sum(X cX) + sum(V cV) +
    sum(ld cld) with respect to every params leaf (both nets' 13 + 13
    arrays, alpha), x and v, by autograd through ``DifferentiableFusedDynamics``
    on the CPU against ``jax.grad`` of the JAX package's XLA path."""
    jd, jt, jp, td, tt, tp, a = _setup(mode)
    with jax.enable_x64(False):
        def jloss(p, x, v):
            X, V, ld = getattr(jd, direction)(p, x, v)
            return (jnp.sum(X * a["dX"]) + jnp.sum(V * a["dV"]) + jnp.sum(ld * a["dld"]))

        jpf = jax.tree_util.tree_map(jnp.asarray, jp)
        gp, gx, gv = jax.grad(jloss, argnums=(0, 1, 2))(jpf, jnp.asarray(a["x"]),
                                                      jnp.asarray(a["v"]))
    dfd = fd.differentiable_fused(td, tt)
    leaves = [leaf.clone().requires_grad_(True) for leaf in tree_leaves(tp)]
    p = tree_unflatten(tp, leaves)
    x = torch.tensor(a["x"], requires_grad=True)
    v = torch.tensor(a["v"], requires_grad=True)
    X, V, ld = getattr(dfd, direction)(p, x, v)
    loss = (X * torch.tensor(a["dX"])).sum() + (V * torch.tensor(a["dV"])).sum() + (
        ld * torch.tensor(a["dld"])).sum()
    grads = torch.autograd.grad(loss, leaves + [x, v])
    ref = jax.tree_util.tree_leaves(gp) + [gx, gv]
    assert len(grads) == len(ref)
    for i, (g, r) in enumerate(zip(grads, ref)):
        assert tuple(g.shape) == np.shape(r), i
        _close(g.numpy(), r, f"leaf {i}")


def _double(inp: fd.KernelInputs, spec) -> fd.KernelInputs:
    consts = [c.double() for c in inp.consts]
    energy, grad_energy = spec.build(consts)
    return dataclasses.replace(
        inp, eps=inp.eps.double(), masks=inp.masks.double(), consts=consts,
        xnet_w=[w.double() for w in inp.xnet_w], vnet_w=[w.double() for w in inp.vnet_w],
        energy=energy, grad_energy=grad_energy, grad_vjp=spec.build_grad_vjp(consts))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "backward"])
def test_vjp_plain_equals_autograd_in_float64(mode, reverse):
    """The hand-derived VJP against autograd of ``trajectory_plain`` (its
    test oracle) in float64, where both are exact to rounding: 1e-10 of each
    leaf's largest entry."""
    _, _, _, td, tt, tp, a = _setup(mode)
    spec = fd.energy_spec_for_target(tt)
    inp = _double(fd.prepare(td, spec, tp, "cpu"), spec)
    x, v, dX, dV = (torch.tensor(a[k].T.copy(), dtype=torch.float64) for k in ("x", "v", "dX", "dV"))
    dld = torch.tensor(a["dld"], dtype=torch.float64)[None, :]
    ws = [w.clone().requires_grad_(True) for w in [inp.eps, *inp.xnet_w, *inp.vnet_w]]
    xr, vr = x.clone().requires_grad_(True), v.clone().requires_grad_(True)
    k = dataclasses.replace(inp, eps=ws[0], xnet_w=ws[1:14], vnet_w=ws[14:])
    X, V, ld = fd.trajectory_plain(k, xr, vr, reverse)
    ref = torch.autograd.grad((X * dX).sum() + (V * dV).sum() + (ld * dld).sum(),
                              [xr, vr, *ws], allow_unused=True)
    gx, gv, deps, dx, dv = fd.trajectory_vjp_plain(inp, x, v, dX, dV, dld, reverse)
    for g, r in zip([dx, dv, deps, *gx, *gv], ref):
        r = torch.zeros_like(g) if r is None else r
        scale = float(r.abs().max())
        torch.testing.assert_close(g, r, rtol=0, atol=1e-10 * scale + 1e-300)


def test_function_checks_and_hmc_surface():
    _, _, _, td, tt, tp, a = _setup("hmc")
    dfd = fd.differentiable_fused(td, tt)
    assert dfd.hmc and dfd.dynamics is td
    torch.testing.assert_close(dfd.eps(tp), td.eps(tp))
    inp = fd.prepare(td, fd.energy_spec_for_target(tt), tp, "cpu")
    x = torch.tensor(a["x"].T.copy())
    with pytest.raises(ValueError, match="dld"):
        fd.trajectory_vjp(inp, x, x, x, x, torch.zeros(N), False)
    # the sampling path's prep stays detached; the training path's keeps history
    tp = {**tp, "alpha": tp["alpha"].clone().requires_grad_(True)}
    assert not fd.prepare(td, fd.energy_spec_for_target(tt), tp, "cpu").eps.requires_grad
    assert fd.prepare(td, fd.energy_spec_for_target(tt), tp, "cpu",
                      differentiable=True).eps.requires_grad
