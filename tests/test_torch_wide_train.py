"""Fused training on the 10 x 10 phi^4 lattice (dim 100, past the lane
groups' 64: the trajectory kernels' site-parallel form on the card, their
plain versions here) against the JAX trainer's fused step on the same
draws."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from l2hmc_tpu import targets as jtargets
from l2hmc_tpu.mcmc import losses as jlosses
from l2hmc_tpu.ops import fused_dynamics as jfd
from l2hmc_tpu.train import ScgConfig as JaxScgConfig
from l2hmc_tpu.train import build_dynamics as jax_build_dynamics
from l2hmc_tpu.train import make_optimizer as jax_make_optimizer
from l2hmc_tpu_torch import targets
from l2hmc_tpu_torch.apps import phi4
from l2hmc_tpu_torch.convert import params_from_jax
from l2hmc_tpu_torch.ops import fused_dynamics as fd
from l2hmc_tpu_torch.train import (
    ScgConfig, StepDraws, TrainState, build_dynamics, make_optimizer, make_train_step,
)

N = 16  # chains, one JAX tile


def _setup():
    """JAX and port dynamics at L = 10 (hidden 8, T = 3), params from one JAX
    init with the parity cases' lift."""
    jt = jtargets.Phi4Lattice(L=10, m2=-1.0, lam=0.5)
    tt = targets.Phi4Lattice(L=10, m2=-1.0, lam=0.5)
    kw = dict(dim=tt.dim, n_chains=N, T=3, hidden=8)
    jd, _ = jax_build_dynamics(JaxScgConfig(**kw), jt)
    td, _ = build_dynamics(ScgConfig(**kw), tt)
    jp = jd.init_params(jax.random.key(0), eps=0.1)
    for net in ("xnet", "vnet"):
        jp[net] = jax.tree_util.tree_map(lambda a: a + phi4.PARITY_LIFT, jp[net])
    jp = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    return jt, tt, jd, td, jp, params_from_jax(jp, device="cpu")


STEPS = 3


def _jax_fused_steps(cfg, jd, jt, jp, x, draws):
    """STEPS steps of the JAX train step (train/scg.py make_train_step, the
    default loss: scg_joint_loss with the z burn-in term) with the dynamics
    the JAX trainer builds for ``fused_train`` (``differentiable_fused``,
    interpret mode on the CPU, one tile), on the given draws; the losses."""
    dyn = jfd.differentiable_fused(jd, jt, tile=N, interpret=True)
    opt, _ = jax_make_optimizer(cfg)
    ostate = opt.init(jp)

    def propose(p, x, v, u_dir, u_acc):
        fwd = (u_dir < 0.5).astype(x.dtype)[:, None]
        xf, vf, ljf = dyn.forward(p, x, v)
        xb, vb, ljb = dyn.backward(p, x, v)
        xp, vp = fwd * xf + (1 - fwd) * xb, fwd * vf + (1 - fwd) * vb
        lj = fwd[:, 0] * ljf + (1 - fwd[:, 0]) * ljb
        px = dyn.p_accept(p, x, v, xp, vp, lj)
        return xp, px, jnp.where((px - u_acc >= 0.0)[:, None], xp, x)

    losses = []
    for d in draws:
        def loss_fn(p):
            xp, px, x_next = propose(p, x, d["v_x"], d["dir_x"], d["acc_x"])
            zp, pz, _ = propose(p, d["z"], d["v_z"], d["dir_z"], d["acc_x"])
            return jlosses.scg_joint_loss(x, xp, px, d["z"], zp, pz, scale=cfg.scale), x_next

        (loss, x), grads = jax.value_and_grad(loss_fn, has_aux=True)(jp)
        updates, ostate = opt.update(grads, ostate, jp)
        jp = optax.apply_updates(jp, updates)
        losses.append(float(loss))
    return np.array(losses)


def test_fused_training_steps_match_jax_on_the_lattice():
    """Three training steps at L = 10 (dim 100, hidden 8, T = 3, 16 chains)
    through ``make_train_step`` on ``differentiable_fused`` against the JAX
    trainer's fused step on the same draws: the losses at the SCG training
    bar (rtol 2e-3, atol 1e-2; chip_smoke's phase 5b) at every step, the
    post-MH chains within 1e-4."""
    jt, tt, jd, td, jp, tp = _setup()
    kw = dict(dim=tt.dim, n_chains=N, T=3, hidden=8, seed=0)
    jcfg, cfg = JaxScgConfig(**kw), ScgConfig(**kw, fused_train=True)
    rng = np.random.default_rng(11)
    x = np.asarray(tt.sample(torch.Generator().manual_seed(2), N, device="cpu"))
    draws = []
    for _ in range(STEPS):
        d = {k: rng.standard_normal((N, tt.dim)).astype(np.float32) for k in ("v_x", "v_z")}
        d["z"] = np.asarray(tt.sample(torch.Generator().manual_seed(len(draws) + 5), N,
                                      device="cpu"))
        d.update({k: rng.uniform(size=N).astype(np.float32) for k in ("dir_x", "acc_x", "dir_z")})
        draws.append(d)
    with jax.enable_x64(False):
        jlosses_ = _jax_fused_steps(jcfg, jd, jt, jax.tree_util.tree_map(jnp.asarray, jp),
                                    jnp.asarray(x),
                                    [{k: jnp.asarray(v) for k, v in d.items()} for d in draws])
    opt, _ = make_optimizer(cfg)
    step = make_train_step(cfg, fd.differentiable_fused(td, tt), opt)
    state = TrainState(tp, opt.init(tp), torch.tensor(x), torch.Generator(), 0)
    got = []
    for d in draws:
        state, metrics = step(state, StepDraws(**{k: torch.tensor(v) for k, v in d.items()}))
        got.append(float(metrics["loss"]))
    np.testing.assert_allclose(got, jlosses_, rtol=2e-3, atol=1e-2)
    assert np.isfinite(got).all() and len(set(got)) == STEPS  # the params moved
