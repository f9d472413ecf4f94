"""The port's training half vs the JAX package (CPU): the hand-written Adam
against optax, one train step on injected draws against the JAX loss
composed from its parts, and the training loop's own contracts."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from l2hmc_tpu import targets as jtargets
from l2hmc_tpu.mcmc import losses as jlosses
from l2hmc_tpu.train import ScgConfig as JaxScgConfig
from l2hmc_tpu.train import build_dynamics as jax_build_dynamics
from l2hmc_tpu.train import make_optimizer as jax_make_optimizer
from l2hmc_tpu_torch import targets
from l2hmc_tpu_torch.convert import params_from_jax
from l2hmc_tpu_torch.ops import differentiable_fused
from l2hmc_tpu_torch.train import (
    ScgConfig,
    StepDraws,
    TrainState,
    build_dynamics,
    exponential_decay,
    make_optimizer,
    make_train_step,
    run_experiment,
    temperature_at,
    train,
)
from l2hmc_tpu_torch.train.optim import tree_leaves


def _adam_state(state):
    """optax's ScaleByAdamState inside the (apply_if_finite / chain) state."""
    if hasattr(state, "mu") and hasattr(state, "nu"):
        return state
    if hasattr(state, "inner_state"):
        return _adam_state(state.inner_state)
    if isinstance(state, tuple):
        for s in state:
            found = _adam_state(s)
            if found is not None:
                return found
    return None


def _flat(tree):
    return np.concatenate([np.asarray(a).reshape(-1) for a in jax.tree_util.tree_leaves(tree)])


# -- the optimizer vs optax -------------------------------------------------------


@pytest.mark.parametrize("grad_clip,skip", [(0.0, True), (0.5, True), (0.0, False)],
                         ids=["plain", "clip", "noskip"])
def test_optimizer_matches_optax(grad_clip, skip):
    """Eight steps on one gradient sequence, across two staircase boundaries
    (lr_decay_steps=3, rate 0.5), with a NaN gradient at step 4. Params,
    both moments and the count agree with optax to float32 rounding: rtol
    1e-6 and an absolute 1e-6 of the largest entry, a few ulps (XLA may fuse
    the moment updates into FMAs). With skipping the NaN step leaves params,
    moments and count unchanged, so the schedule does not advance; without
    it the NaN reaches the params in both."""
    cfg_kw = dict(learning_rate=0.1, lr_decay_steps=3, lr_decay_rate=0.5,
                  grad_clip=grad_clip, skip_nonfinite_updates=skip)
    rng = np.random.default_rng(0)
    p0 = {"alpha": np.float32(-2.3), "w": rng.standard_normal((3, 2)).astype(np.float32)}
    grads = [{"alpha": np.float32(rng.standard_normal()),
              "w": (rng.standard_normal((3, 2)) * (0.2 + k % 3)).astype(np.float32)}
             for k in range(8)]
    grads[4]["w"][1, 0] = np.nan

    def close(got, ref):
        ref = np.asarray(ref)
        scale = float(np.abs(ref[np.isfinite(ref)]).max())
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * scale)

    with jax.enable_x64(False):
        jopt, _ = jax_make_optimizer(JaxScgConfig(**cfg_kw))
        jp = jax.tree_util.tree_map(jnp.asarray, p0)
        jstate = jopt.init(jp)
        jhist = []
        for g in grads:
            u, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
            jp = optax.apply_updates(jp, u)
            jhist.append((_flat(jp), _adam_state(jstate)))

    opt, _ = make_optimizer(ScgConfig(**cfg_kw))
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    tstate = opt.init(tp)
    for k, g in enumerate(grads):
        before = tstate
        u, tstate = opt.update({kk: torch.tensor(v) for kk, v in g.items()}, tstate)
        tp = {kk: tp[kk] + u[kk] for kk in tp}
        jflat, jadam = jhist[k]
        got = torch.cat([tp[kk].reshape(-1) for kk in sorted(tp)]).numpy()
        close(got, jflat)
        close(tstate.mu.numpy(), _flat(jadam.mu))
        close(tstate.nu.numpy(), _flat(jadam.nu))
        assert int(tstate.count) == int(jadam.count)
        if k == 4 and skip:
            assert int(tstate.count) == int(before.count) == 4
            torch.testing.assert_close(tstate.mu, before.mu, rtol=0, atol=0)
            torch.testing.assert_close(tstate.nu, before.nu, rtol=0, atol=0)
            torch.testing.assert_close(u["w"], torch.zeros_like(u["w"]), rtol=0, atol=0)
    if skip:
        assert int(tstate.count) == 7 and np.isfinite(got).all()
    else:
        assert int(tstate.count) == 8 and np.isnan(got).any()


def test_schedule_matches_optax():
    with jax.enable_x64(False):
        js = optax.exponential_decay(1e-3, 1000, 0.96, staircase=True)
        ref = [float(js(jnp.asarray(c, jnp.int32))) for c in (0, 1, 999, 1000, 4999, 5000)]
    ts = exponential_decay(1e-3, 1000, 0.96)
    got = [float(ts(torch.tensor(c, dtype=torch.int32))) for c in (0, 1, 999, 1000, 4999, 5000)]
    np.testing.assert_allclose(got, ref, rtol=1e-6)


# -- one train step vs the JAX loss composed from its parts ----------------------

N = 64

STEP_CASES = {
    "default": dict(),
    "knobs": dict(z_burn_in_loss=False, whiten_loss=True, accept_penalty=0.5,
                  autocorr_penalty=0.3, alpha_reg=0.2, alpha_lr_scale=0.5, grad_clip=1.0),
    "per_dim": dict(per_dim_loss=True, whiten_full=True, eps_dim=True, eps_unfreeze_step=5),
    "hmc": dict(hmc=True, eps_dim=True),
    "frozen_eps": dict(eps_trainable=False),
    "fused": dict(fused_train=True),
}


def _jax_propose(jd, jp, x, v, u_dir, u_acc):
    if jd.hmc:
        xp, vp, lj = jd.forward(jp, x, v)
    else:
        fwd = (u_dir < 0.5).astype(x.dtype)
        xf, vf, ljf = jd.forward(jp, x, v)
        xb, vb, ljb = jd.backward(jp, x, v)
        m = fwd[:, None]
        xp, vp = m * xf + (1 - m) * xb, m * vf + (1 - m) * vb
        lj = fwd * ljf + (1 - fwd) * ljb
    px = jd.p_accept(jp, x, v, xp, vp, lj)
    x_next = jnp.where((px - u_acc >= 0.0)[:, None], xp, x)
    return xp, px, x_next


def _jax_step(cfg, jd, sigma, jp, x, d, alpha0):
    """The JAX train step (train/scg.py make_train_step, PT off, temperature
    1) with ``mcmc.propose`` composed from forward/backward/p_accept on the
    given draws, and the optax update."""
    sig = wmat = None
    if cfg.whiten_full:
        wmat = jnp.asarray(np.linalg.inv(np.linalg.cholesky(sigma)), jnp.float32)
    elif cfg.whiten_loss:
        sig = jnp.asarray(np.sqrt(np.diag(sigma)), jnp.float32)[None, :]

    def whiten(a):
        if wmat is not None:
            return a @ wmat.T
        return a / sig if sig is not None else a

    mixed = jlosses.loss_mixed_per_dim if cfg.per_dim_loss else jlosses.loss_mixed

    def loss_fn(params):
        xp, px, x_next = _jax_propose(jd, params, x, d["v_x"], d["dir_x"], d["acc_x"])
        if cfg.z_burn_in_loss:
            zp, pz, _ = _jax_propose(jd, params, d["z"], d["v_z"], d["dir_z"], d["acc_x"])
            z = d["z"]
            if cfg.per_dim_loss:
                loss = (mixed(whiten(x), whiten(xp), px, scale=cfg.scale)
                        + mixed(whiten(z), whiten(zp), pz, scale=cfg.scale))
            else:
                loss = jlosses.scg_joint_loss(whiten(x), whiten(xp), px, whiten(z),
                                              whiten(zp), pz, scale=cfg.scale)
        else:
            loss = mixed(whiten(x), whiten(xp), px, scale=cfg.scale)
        if cfg.accept_penalty > 0:
            loss = loss + cfg.accept_penalty * jnp.square(jnp.mean(px) - cfg.accept_target)
        if cfg.autocorr_penalty > 0:
            xw = whiten(x)
            p = px[:, None]
            xw_next = whiten(p * xp + (1.0 - p) * x)
            xc = xw - jnp.mean(xw, axis=0)
            nc = xw_next - jnp.mean(xw_next, axis=0)
            rho = jnp.mean(xc * nc, axis=0) / (
                jnp.std(xw, axis=0) * jnp.std(xw_next, axis=0) + 1e-6)
            loss = loss + cfg.autocorr_penalty * jnp.mean(jnp.square(rho))
        if cfg.alpha_reg > 0:
            loss = loss + cfg.alpha_reg * jnp.mean(jnp.square(params["alpha"] - alpha0))
        return loss, (x_next, px)

    (loss, (x_next, px)), grads = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    opt, _ = jax_make_optimizer(cfg)
    updates, ostate = opt.update(grads, opt.init(jp), jp)
    if cfg.alpha_lr_scale != 1.0 or cfg.eps_unfreeze_step > 0:
        ua = updates["alpha"] * cfg.alpha_lr_scale
        if cfg.eps_unfreeze_step > 0:
            ua = jnp.zeros_like(ua)  # step 0 < eps_unfreeze_step
        updates = {**updates, "alpha": ua}
    return loss, grads, optax.apply_updates(jp, updates), x_next, _adam_state(ostate)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_jax_on_same_draws(case):
    """One make_train_step on injected draws. Tolerances: the loss to 1e-4
    relative and the post-MH chains to 2e-5 (float32 trajectories of T=3
    substeps, summed in other orders); the first Adam moment (0.1 times the
    gradient after one step) per leaf to 1e-3 of the leaf's largest entry
    (reciprocal ESJD terms amplify the trajectories' rounding); the updated
    params to 1e-6 absolute where the gradient is above 1e-3 of its leaf's
    largest entry (one Adam step moves each such entry by lr times the sign
    of its gradient) and to 2 lr elsewhere."""
    kw = dict(n_chains=N, T=3, seed=0, **STEP_CASES[case])
    jax_kw = {k: v for k, v in kw.items() if k != "fused_train"}
    tgt_kw = {}
    if kw.get("whiten_loss") or kw.get("whiten_full"):
        # an anisotropic target, so whitening changes the loss
        tgt_kw = dict(dim=4)
    dim = tgt_kw.get("dim", 2)
    jt = jtargets.ill_conditioned_gaussian(dim, 2.0) if dim > 2 else jtargets.scg_gaussian()
    tt = targets.ill_conditioned_gaussian(dim, 2.0) if dim > 2 else targets.scg_gaussian()
    jcfg = JaxScgConfig(dim=dim, **jax_kw)
    cfg = ScgConfig(dim=dim, **kw)
    jd, _ = jax_build_dynamics(jcfg, jt)
    td, _ = build_dynamics(cfg, tt)
    eps = np.linspace(0.08, 0.12, dim).astype(np.float32) if cfg.eps_dim else 0.1
    jp = jd.init_params(jax.random.key(0), eps=eps)
    if not cfg.hmc:
        for net in ("xnet", "vnet"):
            jp[net] = jax.tree_util.tree_map(lambda a: a + 0.03, jp[net])
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((N, dim)) * np.sqrt(np.diag(jt.sigma))).astype(np.float32)
    d = {k: rng.standard_normal((N, dim)).astype(np.float32) for k in ("v_x", "z", "v_z")}
    d.update({k: rng.uniform(size=N).astype(np.float32) for k in ("dir_x", "acc_x", "dir_z")})
    alpha0 = np.log(np.float32(0.1))

    with jax.enable_x64(False):
        jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), jp)
        jloss, jgrads, jnew, jx_next, jadam = _jax_step(
            jcfg, jd, jt.sigma, jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in d.items()},
            alpha0)

    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    opt, _ = make_optimizer(cfg)
    step_dyn = differentiable_fused(td, tt) if cfg.fused_train else td
    sigmas = None
    if cfg.whiten_full:
        sigmas = np.linalg.inv(np.linalg.cholesky(tt.sigma)).astype(np.float32)
    elif cfg.whiten_loss:
        sigmas = np.sqrt(np.diag(tt.sigma))
    step = make_train_step(cfg, step_dyn, opt, sigmas, alpha0=alpha0)
    state = TrainState(tp, opt.init(tp), torch.tensor(x), torch.Generator(), 0)
    draws = StepDraws(**{k: torch.tensor(v) for k, v in d.items()})
    new, metrics = step(state, draws)

    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(new.x.numpy(), np.asarray(jx_next), rtol=0, atol=2e-5)
    jmu = jax.tree_util.tree_leaves(jadam.mu)
    offsets = np.cumsum([0] + [int(np.size(a)) for a in jmu])
    tmu = new.opt_state.mu.numpy()
    for i, (jm, jn, tn, t0) in enumerate(zip(
            jmu, jax.tree_util.tree_leaves(jnew), tree_leaves(new.params), tree_leaves(tp))):
        jm = np.asarray(jm).reshape(-1)
        scale = float(np.abs(jm).max())
        np.testing.assert_allclose(tmu[offsets[i]:offsets[i + 1]], jm, rtol=0,
                                   atol=1e-3 * scale + 1e-12)
        strong = np.abs(jm) > 1e-3 * scale
        got = tn.numpy().reshape(-1)
        ref = np.asarray(jn).reshape(-1)
        np.testing.assert_allclose(got[strong], ref[strong], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got, ref, rtol=0, atol=2 * cfg.learning_rate)
        if not strong.any():
            np.testing.assert_array_equal(got, t0.numpy().reshape(-1))
    assert new.step == 1 and int(new.opt_state.count) == 1
    if cfg.eps_unfreeze_step or not cfg.eps_trainable:
        torch.testing.assert_close(new.params["alpha"], tp["alpha"], rtol=0, atol=0)


# -- the training loop ---------------------------------------------------------------


def test_fused_train_matches_plain_training():
    """60 steps with fused_train=True reproduce the plain autograd path's
    loss and eps history (same seed and generator; the port's counterpart
    of the JAX package's fused-vs-XLA training test, same tolerances)."""
    hists = {}
    for fused in (False, True):
        cfg = ScgConfig(n_chains=64, T=4, n_steps=60, seed=3, fused_train=fused)
        _, hists[fused] = train(cfg, device="cpu")
    np.testing.assert_allclose(hists[True]["loss"], hists[False]["loss"], rtol=2e-3, atol=1e-2)
    np.testing.assert_allclose(hists[True]["eps"][-1], hists[False]["eps"][-1], rtol=1e-3)
    assert abs(float(hists[True]["eps"][-1]) - 0.1) > 1e-4  # eps trains


def test_train_resume_continuity():
    """train() from an explicit state continues where it stopped: 20 + 20
    steps equal 40 steps exactly, and the given state's generator is not
    advanced."""
    cfg = ScgConfig(n_steps=20, n_chains=16, T=3)
    state1, h1 = train(cfg, device="cpu")
    assert state1.step == 20 and int(state1.opt_state.count) == 20
    gen_before = state1.generator.get_state().clone()
    state2, h2 = train(cfg, state=state1, device="cpu")
    assert state2.step == 40
    torch.testing.assert_close(state1.generator.get_state(), gen_before, rtol=0, atol=0)
    _, h40 = train(ScgConfig(n_steps=40, n_chains=16, T=3), device="cpu")
    np.testing.assert_array_equal(np.concatenate([h1["loss"], h2["loss"]]), h40["loss"])


def test_log_every_chunks_and_select_best(capsys):
    cfg = ScgConfig(n_steps=20, n_chains=16, T=3, select_best=True)
    state, hist = train(cfg, log_every=5, device="cpu")
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("Step:")]
    assert len(lines) == 4 and lines[-1].startswith("Step: 20 / 20, Loss: ")
    assert lines[0].endswith("LR: 0.00100")
    assert hist["loss"].shape == (20,) and set(hist) == {"loss", "p_accept", "eps", "temperature"}
    chunk_means = hist["loss"].reshape(4, 5).mean(axis=1)
    assert state.step == 5 * (int(np.argmin(chunk_means)) + 1)


def test_run_experiment_small():
    out = run_experiment(ScgConfig(n_steps=30, n_chains=32, T=3), eval_steps=30, device="cpu")
    for k in ("ess_l2hmc", "ess_hmc", "ess_ratio", "final_loss", "final_accept", "train_time_s"):
        assert np.isfinite(out[k]), k
    assert 0.0 < out["final_accept"] <= 1.0
    assert out["history"]["loss"].shape == (30,)


def test_eps_sigma_init_and_unported_knobs():
    tgt = targets.ill_conditioned_gaussian(4)
    cfg = ScgConfig(dim=4, n_steps=1, n_chains=8, T=2, eps_dim=True, eps_sigma_init=0.1,
                    eps_trainable=False)
    state, _ = train(cfg, target=tgt, device="cpu")
    np.testing.assert_allclose(
        torch.exp(state.params["alpha"]).numpy(), 0.1 * np.sqrt(np.diag(tgt.sigma)), rtol=1e-6)
    assert temperature_at(cfg, 0) == 1.0
    ScgConfig(fused_train=True)  # ported now
    for knob in (dict(init_temperature=2.0), dict(pt_train_rungs=2), dict(eps_mat=True)):
        with pytest.raises(NotImplementedError):
            ScgConfig(**knob)
    if not torch.cuda.is_available():  # entry points run on cuda unless told otherwise
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train(ScgConfig(n_steps=1))
