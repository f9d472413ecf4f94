"""The port's training half vs the JAX package (CPU): the hand-written Adam
against optax, one train step on injected draws against the JAX loss
composed from its parts, and the training loop's own contracts."""

import gc
import weakref
from dataclasses import replace as dataclasses_replace

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
from l2hmc_tpu.train import temperature_at as jax_temperature_at
from l2hmc_tpu_torch import targets
from l2hmc_tpu_torch.apps import suite
from l2hmc_tpu_torch.convert import params_from_jax
from l2hmc_tpu_torch.ops import differentiable_fused, fused_chain_sampler, fused_for_target
from l2hmc_tpu_torch.train import (
    ScgConfig,
    StepDraws,
    TrainState,
    build_dynamics,
    draw_step,
    exponential_decay,
    init_state,
    make_optimizer,
    make_train_step,
    run_experiment,
    sample_chain,
    temperature_at,
    train,
)
from l2hmc_tpu_torch.mcmc import propose_draws
from l2hmc_tpu_torch.train import scg
from l2hmc_tpu_torch.train.optim import OPTIMIZERS, piecewise_constant_schedule, tree_leaves


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


@pytest.mark.parametrize("name", ["adam", "rmsprop", "sgd", "nesterov"])
@pytest.mark.parametrize("grad_clip", [0.0, 0.7], ids=["noclip", "clip"])
def test_vae_optimizers_match_optax(name, grad_clip):
    """The VAE apps' optimizer map against optax's (``l2hmc_tpu.apps.vae``'s
    ``OPTIMIZERS``, behind ``clip_by_global_norm`` where clipped) over seven
    steps on one gradient sequence with the piecewise-constant schedule
    dropping at step 4: params after every step to rtol 2e-6 and 2e-6 of the
    largest entry (float32, XLA may fuse the moment updates into FMAs). A
    NaN gradient reaches the params in both: none skips a step."""
    from l2hmc_tpu.apps.vae import OPTIMIZERS as JAX_OPTIMIZERS

    rng = np.random.default_rng(3)
    p0 = {"alpha": np.float32(-2.3), "w": rng.standard_normal((3, 2)).astype(np.float32)}
    grads = [{"alpha": np.float32(rng.standard_normal()),
              "w": (rng.standard_normal((3, 2)) * (0.2 + k % 3)).astype(np.float32)}
             for k in range(7)]
    with jax.enable_x64(False):
        jsched = optax.piecewise_constant_schedule(0.05, {4: 0.1})
        jopt = JAX_OPTIMIZERS[name](jsched)
        if grad_clip:
            jopt = optax.chain(optax.clip_by_global_norm(grad_clip), jopt)
        jp = jax.tree_util.tree_map(jnp.asarray, p0)
        jstate = jopt.init(jp)
        ref = []
        for g in grads:
            u, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
            jp = optax.apply_updates(jp, u)
            ref.append(_flat(jp))

    opt = OPTIMIZERS[name](piecewise_constant_schedule(0.05, {4: 0.1}), grad_clip)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    tstate = opt.init(tp)
    for k, g in enumerate(grads):
        u, tstate = opt.update({kk: torch.tensor(v) for kk, v in g.items()}, tstate)
        tp = {kk: tp[kk] + u[kk] for kk in tp}
        got = torch.cat([tp[kk].reshape(-1) for kk in sorted(tp)]).numpy()
        np.testing.assert_allclose(got, ref[k], rtol=2e-6, atol=2e-6 * np.abs(ref[k]).max())
        assert int(tstate.count) == k + 1
    # the drop showed: the last step is about a tenth of the first ones' size
    assert np.abs(ref[6] - ref[5]).max() < 0.3 * np.abs(ref[1] - ref[0]).max()
    nan = {"alpha": torch.tensor(np.float32("nan")), "w": torch.zeros(3, 2)}
    u, after = opt.update(nan, tstate)
    assert int(after.count) == 8 and bool(torch.isnan(u["alpha"]))


def test_piecewise_schedule_matches_optax():
    """Values on both sides of two boundaries, and a constant learning rate
    given as a number."""
    counts = (0, 1, 9, 10, 11, 29, 30, 1000)
    with jax.enable_x64(False):
        js = optax.piecewise_constant_schedule(1e-3, {10: 0.1, 30: 0.5})
        ref = [float(js(jnp.asarray(c, jnp.int32))) for c in counts]
    ts = piecewise_constant_schedule(1e-3, {10: 0.1, 30: 0.5})
    got = [float(ts(torch.tensor(c, dtype=torch.int32))) for c in counts]
    np.testing.assert_allclose(got, ref, rtol=1e-7)
    assert ref[3] == pytest.approx(1e-4) and ref[6] == pytest.approx(5e-5)
    assert float(piecewise_constant_schedule(0.3)(torch.tensor(7))) == pytest.approx(0.3)
    with pytest.raises(ValueError, match="non-negative"):
        piecewise_constant_schedule(1.0, {3: -0.1})
    opt = OPTIMIZERS["sgd"](0.5)
    u, _ = opt.update({"w": torch.ones(2)}, opt.init({"w": torch.zeros(2)}))
    torch.testing.assert_close(u["w"], torch.full((2,), -0.5))


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
    # bench's best recipe, and eps_mat under the step-size knobs: W frozen
    # before eps_unfreeze_step, scaled by alpha_lr_scale after it
    "best_recipe": dict(eps_mat=True, whiten_full=True, per_dim_loss=True,
                        z_burn_in_loss=False, autocorr_penalty=200.0),
    "eps_mat_frozen": dict(eps_mat=True, eps_chol_init=0.1, alpha_reg=0.2,
                           alpha_lr_scale=0.5, eps_unfreeze_step=5),
    "eps_mat_unfrozen": dict(eps_mat=True, eps_chol_init=0.1, alpha_lr_scale=0.5,
                             eps_unfreeze_step=5, at_step=5),
    # the suite's recipes: the ring annealed (at a step where the
    # temperature is 3.4), the funnel with its net-input features
    "annealed": dict(init_temperature=5.0, n_steps=10, at_step=3, target="ring"),
    "net_input": dict(net_input_target_fn=True, target="funnel"),
}
# the suite targets of STEP_CASES: (JAX, port)
STEP_TARGETS = {
    "ring": (lambda: jtargets.gen_ring(r=2.0, var=0.1, nb_mixtures=4),
             lambda: targets.gen_ring(r=2.0, var=0.1, nb_mixtures=4)),
    "funnel": (lambda: jtargets.GaussianFunnel(dim=4), lambda: targets.GaussianFunnel(dim=4)),
}


def _jax_propose(jd, jp, x, v, u_dir, u_acc, temperature=1.0):
    kt = dict(temperature=temperature)
    if jd.hmc:
        xp, vp, lj = jd.forward(jp, x, v, **kt)
    else:
        fwd = (u_dir < 0.5).astype(x.dtype)
        xf, vf, ljf = jd.forward(jp, x, v, **kt)
        xb, vb, ljb = jd.backward(jp, x, v, **kt)
        m = fwd[:, None]
        xp, vp = m * xf + (1 - m) * xb, m * vf + (1 - m) * vb
        lj = fwd * ljf + (1 - fwd) * ljb
    px = jd.p_accept(jp, x, v, xp, vp, lj, **kt)
    x_next = jnp.where((px - u_acc >= 0.0)[:, None], xp, x)
    return xp, px, x_next


def _jax_step(cfg, jd, sigma, jp, x, d, alpha0, step=0):
    """The JAX train step (train/scg.py make_train_step, PT off) at step
    ``step``, at its ``temperature_at``, with ``mcmc.propose`` composed from
    forward/backward/p_accept on the given draws, and the optax update."""
    temperature = jax_temperature_at(cfg, step)
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
        xp, px, x_next = _jax_propose(jd, params, x, d["v_x"], d["dir_x"], d["acc_x"],
                                      temperature)
        if cfg.z_burn_in_loss:
            zp, pz, _ = _jax_propose(jd, params, d["z"], d["v_z"], d["dir_z"], d["acc_x"],
                                     temperature)
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
        for leaf in ["alpha"] + (["w"] if "w" in updates else []):
            u = updates[leaf] * cfg.alpha_lr_scale
            if step < cfg.eps_unfreeze_step:
                u = jnp.zeros_like(u)
            updates = {**updates, leaf: u}
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
    at_step = kw.pop("at_step", 0)
    suite_target = kw.pop("target", None)
    jax_kw = {k: v for k, v in kw.items() if k != "fused_train"}
    tgt_kw = {}
    if kw.get("whiten_loss") or kw.get("whiten_full"):
        # an anisotropic target, so whitening changes the loss
        tgt_kw = dict(dim=4)
    dim = tgt_kw.get("dim", 2)
    jt = jtargets.ill_conditioned_gaussian(dim, 2.0) if dim > 2 else jtargets.scg_gaussian()
    tt = targets.ill_conditioned_gaussian(dim, 2.0) if dim > 2 else targets.scg_gaussian()
    if suite_target is not None:
        jt, tt = (make() for make in STEP_TARGETS[suite_target])
        dim = tt.dim
    sigma = getattr(jt, "sigma", None)
    scale = np.sqrt(np.diag(sigma)) if np.ndim(sigma) == 2 else 1.0
    jcfg = JaxScgConfig(dim=dim, **jax_kw)
    cfg = ScgConfig(dim=dim, **kw)
    jd, _ = jax_build_dynamics(jcfg, jt)
    td, _ = build_dynamics(cfg, tt)
    eps = np.linspace(0.08, 0.12, dim).astype(np.float32) if cfg.eps_dim else 0.1
    if cfg.eps_chol_init:
        eps = (cfg.eps_chol_init * np.linalg.cholesky(jt.sigma)).astype(np.float32)
    jp = jd.init_params(jax.random.key(0), eps=eps)
    if not cfg.hmc:
        for net in ("xnet", "vnet"):
            jp[net] = jax.tree_util.tree_map(lambda a: a + 0.03, jp[net])
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((N, dim)) * scale).astype(np.float32)
    d = {k: rng.standard_normal((N, dim)).astype(np.float32) for k in ("v_x", "z", "v_z")}
    d.update({k: rng.uniform(size=N).astype(np.float32) for k in ("dir_x", "acc_x", "dir_z")})
    alpha0 = np.log(np.float32(0.1))

    with jax.enable_x64(False):
        jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), jp)
        jloss, jgrads, jnew, jx_next, jadam = _jax_step(
            jcfg, jd, sigma, jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in d.items()},
            alpha0, at_step)

    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    opt, _ = make_optimizer(cfg)
    step_dyn = differentiable_fused(td, tt) if cfg.fused_train else td
    sigmas = None
    if cfg.whiten_full:
        sigmas = np.linalg.inv(np.linalg.cholesky(tt.sigma)).astype(np.float32)
    elif cfg.whiten_loss:
        sigmas = np.sqrt(np.diag(tt.sigma))
    step = make_train_step(cfg, step_dyn, opt, sigmas, alpha0=alpha0)
    step0 = torch.tensor(at_step, dtype=torch.int32) if at_step else 0
    state = TrainState(tp, opt.init(tp), torch.tensor(x), torch.Generator(), step0)
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
    assert new.step == at_step + 1 and int(new.opt_state.count) == 1
    step_leaves = ["alpha"] + (["w"] if cfg.eps_mat else [])
    for leaf in step_leaves:
        frozen = at_step < cfg.eps_unfreeze_step or not cfg.eps_trainable
        assert torch.equal(new.params[leaf], tp[leaf]) == frozen, leaf


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


def test_ring_training_routes_agree_over_their_free_steps():
    """On the suite's ring at 1024 chains and its recipe's eps, the fused
    step's route (the wrappers' plain versions on the CPU) and the module
    route agree to the SCG bar over ``suite.RING_FREE_STEPS`` free steps:
    the steps over which chip_smoke.py holds the ring's fused against plain
    training on the card. Later two plain routes part too, by the recipe's
    own dynamics."""
    case = suite.PARITY_CASES["ring"]
    tgt = case.target()
    hists = {}
    for fused in (False, True):
        cfg = ScgConfig(n_chains=1024, n_steps=suite.RING_FREE_STEPS, seed=0, dim=tgt.dim,
                        T=case.T, hidden=case.hidden, eps=0.2, fused_train=fused)
        _, hists[fused] = train(cfg, tgt, device="cpu")
    np.testing.assert_allclose(hists[True]["loss"], hists[False]["loss"], rtol=2e-3, atol=1e-2)


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
    ScgConfig(init_temperature=2.0, net_input_target_fn=True)  # ported now
    ScgConfig(dim=16, net_type="conv")  # ported now
    with pytest.raises(NotImplementedError):
        ScgConfig(pt_train_rungs=2)
    if not torch.cuda.is_available():  # entry points run on cuda unless told otherwise
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train(ScgConfig(n_steps=1))


def test_temperature_at_matches_jax_over_the_schedule():
    """The linear anneal against JAX's at every step of a schedule, from a
    Python int and from the device step counter (an int32 tensor): float32
    to 1e-6, 1.0 after ``anneal_frac`` of the steps."""
    for kw in (dict(init_temperature=5.0, n_steps=50), dict(init_temperature=3.0, n_steps=7,
                                                             anneal_frac=0.5)):
        cfg, jcfg = ScgConfig(**kw), JaxScgConfig(**kw)
        for step in range(cfg.n_steps + 2):
            ref = float(jax_temperature_at(jcfg, jnp.asarray(step, jnp.int32)))
            for s in (step, torch.tensor(step, dtype=torch.int32)):
                got = temperature_at(cfg, s)
                assert got.dtype == torch.float32 and got.shape == ()
                np.testing.assert_allclose(float(got), ref, rtol=1e-6)
        assert float(temperature_at(cfg, cfg.n_steps)) == 1.0


def test_suite_recipes_refusals():
    """JAX's errors: the fused training path takes neither annealing nor a
    net-input feature map, and ``net_input_target_fn`` needs a target that
    defines its transform."""
    funnel = targets.GaussianFunnel(dim=4)
    with pytest.raises(ValueError, match="cannot apply a nonlinear net_input_fn"):
        train(ScgConfig(dim=4, n_steps=1, net_input_target_fn=True, fused_train=True), funnel,
              device="cpu")
    with pytest.raises(ValueError, match="does not support temperature annealing"):
        train(ScgConfig(n_steps=1, init_temperature=5.0, fused_train=True), device="cpu")
    with pytest.raises(ValueError, match="net_input_transform"):
        build_dynamics(ScgConfig(net_input_target_fn=True))
    dyn, _ = build_dynamics(ScgConfig(dim=4, net_input_target_fn=True), funnel)
    assert dyn.net_input_fn is not None and not dyn.use_temperature
    assert build_dynamics(ScgConfig(init_temperature=5.0))[0].use_temperature
    assert build_dynamics(ScgConfig(init_temperature=5.0, hmc=True))[0].use_temperature


# -- eps_mat in training, and the route the captured step takes ---------------------


def test_eps_chol_init_and_fused_refusal():
    """eps_chol_init puts W = scale chol(Sigma) and alpha = mean log|diag W|
    (the frozen eps keeps them), and needs eps_mat; the fused paths refuse
    eps_mat with the JAX package's message."""
    cfg = ScgConfig(n_chains=16, T=2, n_steps=2, eps_mat=True, eps_chol_init=0.1,
                    eps_trainable=False, alpha_reg=0.5)
    state, hist = train(cfg, device="cpu")
    chol = np.linalg.cholesky(targets.scg_gaussian().sigma).astype(np.float32)
    np.testing.assert_allclose(state.params["w"].numpy(), 0.1 * chol, rtol=1e-6)
    np.testing.assert_allclose(float(state.params["alpha"]),
                               np.mean(np.log(np.abs(np.diag(0.1 * chol)))), rtol=1e-6)
    assert np.isfinite(hist["loss"]).all()
    with pytest.raises(ValueError, match="eps_chol_init requires eps_mat"):
        train(ScgConfig(n_steps=1, eps_chol_init=0.1), device="cpu")
    dyn, tgt = build_dynamics(ScgConfig(eps_mat=True))
    for fused in (fused_for_target, differentiable_fused, fused_chain_sampler):
        with pytest.raises(ValueError, match="do not support eps_mat"):
            fused(dyn, tgt)
    with pytest.raises(ValueError, match="do not support eps_mat"):
        train(ScgConfig(n_steps=1, eps_mat=True, fused_train=True), device="cpu")


ROUTE_CASES = {
    "reference": dict(),
    "fused": dict(fused_train=True),
    "best_recipe": STEP_CASES["best_recipe"],
    "hmc_knobs": dict(hmc=True, eps_mat=True, eps_unfreeze_step=3, alpha_lr_scale=0.5),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_draw_step_route_equals_generator_route(case):
    """What the captured step relies on: 5 steps fed ``draw_step``'s
    numbers equal the generator-driven eager steps bit for bit, both as a
    loop over ``make_train_step`` and as ``train``'s captured route (its
    step body run eagerly on the CPU, in chunks of 2), generator included."""
    cfg = ScgConfig(n_chains=32, T=3, n_steps=5, **ROUTE_CASES[case])
    ref, href = train(cfg, device="cpu", capture=False)
    got, hgot = train(cfg, device="cpu", capture=True, log_every=2)
    dyn, tgt = build_dynamics(cfg)
    opt, _ = make_optimizer(cfg)
    sigmas = (np.linalg.inv(np.linalg.cholesky(tgt.sigma)).astype(np.float32)
              if cfg.whiten_full else None)
    step = make_train_step(cfg, differentiable_fused(dyn, tgt) if cfg.fused_train else dyn, opt,
                           sigmas)
    state, h1 = train(dataclasses_replace(cfg, n_steps=1), device="cpu", capture=False)
    losses = [float(h1["loss"][0])]
    for _ in range(4):
        state, m = step(state, draw_step(state.generator, 32, 2, hmc=cfg.hmc,
                                         z_burn_in=cfg.z_burn_in_loss))
        losses.append(float(m["loss"]))
    np.testing.assert_array_equal(np.asarray(losses, np.float32), href["loss"])
    for k in href:
        np.testing.assert_array_equal(hgot[k], href[k], err_msg=k)
    for other in (got, state):
        for a, b in zip([*tree_leaves(other.params), *other.opt_state, other.x],
                        [*tree_leaves(ref.params), *ref.opt_state, ref.x]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert int(other.step) == 5
        assert torch.equal(other.generator.get_state(), ref.generator.get_state())


@pytest.mark.parametrize("collect", [True, False], ids=["trace", "p_accept"])
@pytest.mark.parametrize("hmc", [False, True], ids=["l2hmc", "hmc"])
def test_sample_chain_routes_agree(hmc, collect):
    """``sample_chain``'s captured route (its MH step body run eagerly on
    the CPU, draws made ahead in chunks) equals the eager route bit for bit,
    from a generator and from given draws."""
    dyn, tgt = build_dynamics(ScgConfig(T=3, hmc=hmc, eps_mat=True))
    params = dyn.init_params(torch.Generator().manual_seed(0), device="cpu")
    x0 = tgt.sample(torch.Generator().manual_seed(1), 16, device="cpu")
    runs = [sample_chain(dyn, params, x0, 7, torch.Generator().manual_seed(2), collect=collect,
                         capture=c) for c in (False, True)]
    g = torch.Generator().manual_seed(3)
    draws = (torch.randn((7, 16, 2), generator=g), torch.rand((7, 16), generator=g),
             torch.rand((7, 16), generator=g))
    runs += [sample_chain(dyn, params, x0, 7, None, collect=collect, draws=draws, capture=c)
             for c in (False, True)]
    for a, b in zip(runs[0], runs[1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(runs[2], runs[3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_replayed_steps_are_freed_by_reference_counts():
    """The captured routes' step objects (training and sampling) hold no
    reference cycle: with the cyclic collector off they are freed as soon as
    the last reference goes, so on the card a route's CUDA graph is
    destroyed when its call returns, never by the collector while a later
    call records its own graph."""
    cfg = ScgConfig(n_chains=16, T=3, n_steps=2)
    dyn, tgt = build_dynamics(cfg)
    opt, _ = make_optimizer(cfg)
    state = init_state(cfg, dyn, opt, device="cpu")
    x0 = tgt.sample(torch.Generator().manual_seed(1), 16, device="cpu")
    enabled = gc.isenabled()
    gc.disable()
    try:
        train_steps = scg._TrainSteps(make_train_step(cfg, dyn, opt), state, 2, dyn.hmc,
                                      cfg.z_burn_in_loss)
        train_steps.run(train_steps.draw(torch.Generator().manual_seed(2), 2))
        sample_steps = scg._SampleSteps(dyn, state.params, x0, 2, True)
        sample_steps.run(scg._pack_rows(
            [propose_draws(torch.Generator().manual_seed(3), 16, 2, hmc=False, accept=True)
             for _ in range(2)], "cpu"))
        refs = [weakref.ref(train_steps), weakref.ref(sample_steps)]
        del train_steps, sample_steps
        assert [r() for r in refs] == [None, None]
    finally:
        if enabled:
            gc.enable()
