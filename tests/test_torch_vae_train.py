"""VAE training in the port vs the JAX package (CPU, float32) at the small
size of the VAE tests (latent 8, hidden 32, nets 16/16, 3 leapfrogs): one
train step on injected draws against the JAX step composed from its parts
(encoder, decoder, ``Dynamics.forward/backward/p_accept``, optax), the
baseline VAE's step, the command line, and the training loop's contracts."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_vae_util import SMALL, build_pair

from l2hmc_tpu.apps import baseline_vae as jbase
from l2hmc_tpu.apps import vae as jvae
from l2hmc_tpu.apps import vae_main as jmain
from l2hmc_tpu.evals import normal_kl as jnormal_kl
from l2hmc_tpu_torch.apps import baseline_vae as tbase
from l2hmc_tpu_torch.apps import data as tdata
from l2hmc_tpu_torch.apps import vae as tvae
from l2hmc_tpu_torch.apps import vae_main as tmain
from l2hmc_tpu_torch.convert import adam_moment_leaves, params_from_jax
from l2hmc_tpu_torch.train.optim import tree_leaves

N, D, MH = 32, SMALL["latent_dim"], 2
BPE = 3  # batches per epoch: only shapes the learning-rate schedule


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These sizes are tiny: one intra-op thread is the fastest, and the
    test workers do not fight over cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

STEP_CASES = {
    "default": dict(),
    "faithful_energy": dict(faithful_loss_accum=True, energy_scale=0.01, stop_gradient=True),
    "composition": dict(random_lf_composition=3),
    "sampler_off_step": dict(update_sampler_every=2),
    "hmc": dict(hmc=True),
    "fused": dict(fused_train=True),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _draws(rng, composition: int):
    d = {
        "noise": rng.standard_normal((N, D)).astype(np.float32),
        "v": [rng.standard_normal((N, D)).astype(np.float32) for _ in range(MH)],
        "acc_u": [rng.uniform(size=N).astype(np.float32) for _ in range(MH)],
        "nb": None,
    }
    if composition:
        d["dir_u"] = [[rng.uniform(size=N).astype(np.float32) for _ in range(composition)]
                      for _ in range(MH)]
        d["nb"] = [2, 1]
    else:
        d["dir_u"] = [rng.uniform(size=N).astype(np.float32) for _ in range(MH)]
    return d


def _jax_one_op(dyn, smp, x, v, dir_u, aux):
    if dyn.hmc:
        return dyn.forward(smp, x, v, aux=aux)
    fwd = (dir_u < 0.5).astype(x.dtype)
    xf, vf, ljf = dyn.forward(smp, x, v, aux=aux)
    xb, vb, ljb = dyn.backward(smp, x, v, aux=aux)
    m = fwd[:, None]
    return m * xf + (1 - m) * xb, m * vf + (1 - m) * vb, fwd * ljf + (1 - fwd) * ljb


def _jax_losses(cfg, jm, params, batch, d):
    """``losses`` of the JAX train step (apps/vae.py make_train_step) with
    every draw given: the proposals are composed from the dynamics'
    forward/backward/p_accept as ``mcmc.propose`` and ``mcmc.chain_operator``
    (one momentum threaded through the composed ops) compose them."""
    sg = lambda t: jax.tree_util.tree_map(jax.lax.stop_gradient, t)  # noqa: E731
    dyn = jm.dynamics
    mu, log_sigma = jm.encoder.apply(params["enc"], batch)
    latent_q = mu + d["noise"] * jnp.exp(log_sigma)
    logits = jm.decoder.apply(sg(params["dec"]), latent_q)
    elbo = jnp.mean(jnormal_kl(mu, jnp.exp(log_sigma), 0.0, 1.0)
                    + jvae._bce_logits(logits, batch))

    smp = params["smp"]
    emb = jm.aux_encoder.apply(smp["aux_enc"], batch)
    aux = {"raw": batch, "emb": emb, "dec": sg(params["dec"])}
    init_x = jax.lax.stop_gradient(latent_q)
    sigma2 = jax.lax.stop_gradient(jnp.exp(2.0 * log_sigma))
    inverse_term = other_term = energy_loss = 0.0
    for t in range(cfg.mh_steps):
        if cfg.faithful_loss_accum:
            inverse_term = other_term = energy_loss = 0.0
        if cfg.stop_gradient:
            init_x = jax.lax.stop_gradient(init_x)
        v0 = d["v"][t]
        if cfg.random_lf_composition > 0:
            cx, cv, lj = init_x, v0, jnp.zeros((N,), jnp.float32)
            for i in range(d["nb"][t]):
                cx, cv, inc = _jax_one_op(dyn, smp, cx, cv, d["dir_u"][t][i], aux)
                lj = lj + inc
        else:
            cx, cv, lj = _jax_one_op(dyn, smp, init_x, v0, d["dir_u"][t], aux)
        px = dyn.p_accept(smp, init_x, v0, cx, cv, lj, aux=aux)
        mh_x = jnp.where((px - d["acc_u"][t] >= 0.0)[:, None], cx, init_x)
        v = jnp.sum(jnp.square(cx - init_x) / (sigma2 + 1e-4), axis=1) * px + 1e-4
        inverse_term += (1.0 / cfg.mh_steps) * jnp.mean(1.0 / v)
        other_term -= (1.0 / cfg.mh_steps) * jnp.mean(v)
        e_diff = jnp.square(dyn.energy(cx, aux=aux) - dyn.energy(init_x, aux=aux)) * px + 1e-4
        energy_loss += (1.0 / cfg.mh_steps) * (jnp.mean(1.0 / e_diff) - jnp.mean(e_diff))
        init_x = mh_x
    sampler_loss = inverse_term + other_term + cfg.energy_scale * energy_loss

    z_T = jax.lax.stop_gradient(init_x)
    logits_T = jm.decoder.apply(params["dec"], z_T)
    prior = 0.5 * cfg.latent_dim * jnp.log(2.0 * jnp.pi) + 0.5 * jnp.sum(jnp.square(z_T), axis=1)
    likelihood = jnp.mean(prior + jvae._bce_logits(logits_T, batch))
    return elbo + sampler_loss + likelihood, (elbo, sampler_loss, likelihood, init_x)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_jax_on_same_draws(case):
    """One ``make_train_step`` on injected draws against the JAX step.
    Tolerances: the three objectives to 2e-4 relative (float32 decoder sums
    over 784 pixels and trajectories of 3 leapfrog steps, in other orders;
    the sampler loss holds reciprocals of jump distances) and the refined
    latent to 5e-5; per group the first Adam moment (0.1 times the gradient
    after one step) per leaf to 2e-3 of the leaf's largest entry (the
    reciprocal terms and, on the fused path, the hand-written VJP amplify
    the rounding); the updated params to 1e-6 absolute where the gradient
    is above 2e-3 of its leaf's largest entry (one Adam step moves such an
    entry by lr times the sign of its gradient) and to 2 lr elsewhere. On
    the off-step of ``update_sampler_every`` and in HMC mode the sampler's
    params and optimizer state stay bit for bit."""
    kw = dict(mh_steps=MH, batch_size=N, **STEP_CASES[case])
    jax_kw = {k: v for k, v in kw.items() if k != "fused_train"}
    jm, jp, tm, tp = build_pair(**jax_kw)
    tm = tvae.VaeModel.build(tvae.VaeConfig(**{**SMALL, **kw}))
    cfg = tm.cfg
    rng = np.random.default_rng(21)
    batch = (rng.random((N, 784)) < 0.3).astype(np.float32)
    d = _draws(rng, cfg.random_lf_composition)
    step_index = 1 if cfg.update_sampler_every > 1 else 0

    with jax.enable_x64(False):
        jd = jax.tree_util.tree_map(jnp.asarray, {k: v for k, v in d.items() if k != "nb"})
        jd["nb"] = d["nb"]
        (_, (jelbo, jsl, jlik, jlatent)), jgrads = jax.value_and_grad(
            lambda p: _jax_losses(jm.cfg, jm, p, jnp.asarray(batch), jd), has_aux=True)(jp)
        opts = jvae.make_optimizers(jm.cfg, BPE)[:3]
        jnew, jmu = {}, {}
        for name, opt in zip(("enc", "dec", "smp"), opts):
            u, ostate = opt.update(jgrads[name], opt.init(jp[name]), jp[name])
            jnew[name] = optax.apply_updates(jp[name], u)
            jmu[name] = adam_moment_leaves(ostate)[0]
        if cfg.hmc or step_index % cfg.update_sampler_every:
            jnew["smp"], jmu["smp"] = jp["smp"], None

    step = tvae.make_train_step(tm, BPE)
    state = tvae.init_state(tm, BPE, device="cpu")._replace(params=tp, step=step_index)
    draws = tvae.VaeStepDraws(
        noise=torch.tensor(d["noise"]), v=[torch.tensor(a) for a in d["v"]],
        dir_u=[[torch.tensor(a) for a in u] if isinstance(u, list) else torch.tensor(u)
               for u in d["dir_u"]],
        acc_u=[torch.tensor(a) for a in d["acc_u"]], nb=d["nb"])
    latent_T = step.losses(tp, torch.tensor(batch), None, draws)[4]
    new, metrics = step(state, torch.tensor(batch), draws)

    for key, ref in (("elbo", jelbo), ("sampler_loss", jsl), ("log_prob", jlik)):
        np.testing.assert_allclose(float(metrics[key]), float(ref), rtol=2e-4)
    np.testing.assert_allclose(latent_T.detach().numpy(), np.asarray(jlatent), rtol=0, atol=5e-5)
    assert new.step == step_index + 1
    for name, ostate in (("enc", new.opt_enc), ("dec", new.opt_dec), ("smp", new.opt_smp)):
        t0, tn = tree_leaves(tp[name]), tree_leaves(new.params[name])
        if jmu[name] is None:  # the sampler was left alone
            assert int(ostate.count) == 0 and not bool(ostate.mu.any())
            for a, b in zip(tn, t0):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
            continue
        assert int(ostate.count) == 1
        offsets = np.cumsum([0] + [int(np.size(a)) for a in jmu[name]])
        tmu = ostate.mu.numpy()
        nonzero = 0
        for i, (m, jn, tn_i) in enumerate(zip(
                jmu[name], jax.tree_util.tree_leaves(jnew[name]), tn)):
            m = np.asarray(m).reshape(-1)
            scale = float(np.abs(m).max())
            nonzero += scale > 0
            np.testing.assert_allclose(tmu[offsets[i]:offsets[i + 1]], m, rtol=0,
                                       atol=2e-3 * scale + 1e-12)
            strong = np.abs(m) > 2e-3 * scale
            got, ref = tn_i.numpy().reshape(-1), np.asarray(jn).reshape(-1)
            np.testing.assert_allclose(got[strong], ref[strong], rtol=0, atol=1e-6)
            np.testing.assert_allclose(got, ref, rtol=0, atol=2 * cfg.learning_rate)
        assert nonzero == len(jmu[name])  # every leaf of the group gets a gradient


def test_lr_schedule_and_optimizers_follow_the_config():
    cfg = tvae.VaeConfig(**SMALL, lr_drop_epoch=2, optimizer="rmsprop", grad_clip=3.0)
    sched = tvae.make_lr_schedule(cfg, 5)
    got = [float(sched(torch.tensor(c))) for c in (0, 9, 10, 11)]
    np.testing.assert_allclose(got, [1e-3, 1e-3, 1e-4, 1e-4], rtol=1e-6)
    opt_enc, opt_dec, opt_smp, _ = tvae.make_optimizers(cfg, 5)
    assert type(opt_enc).__name__ == "RmsProp"
    assert opt_enc.grad_clip == 0.0 and opt_dec.grad_clip == 0.0 and opt_smp.grad_clip == 3.0


def test_train_runs_logs_and_checkpoints(tmp_path):
    """Two epochs of three batches on synthetic data: finite metrics, the
    generator advanced, metrics and checkpoint files written, and a second
    run from the same seed gives the same numbers."""
    cfg = tvae.VaeConfig(**SMALL, epochs=2, batch_size=16, mh_steps=2)
    ds = tdata.synthetic_mnist(n_train=48, n_test=16)
    _, state, last = tvae.train(cfg, ds, logdir=str(tmp_path), log_every=1, verbose=False,
                                device="cpu")
    assert state.step == 6 and int(state.opt_enc.count) == 6
    assert all(np.isfinite(v) for v in last.values())
    assert set(last) == {"elbo", "sampler_loss", "log_prob", "inverse_term", "other_term",
                         "energy_loss", "p_accept"}
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2, 3, 4, 5, 6]
    assert rows[-1]["elbo"] < rows[0]["elbo"]
    assert (tmp_path / "ckpt").exists() and (tmp_path / "ckpt.config.json").exists()
    _, state2, last2 = tvae.train(cfg, ds, log_every=1, verbose=False, device="cpu")
    assert last2 == last
    torch.testing.assert_close(state2.params["smp"]["alpha"], state.params["smp"]["alpha"],
                               rtol=0, atol=0)


def test_train_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tvae.train(tvae.VaeConfig(**SMALL, epochs=1), tdata.synthetic_mnist(32, 16))
    with pytest.raises(RuntimeError, match="CUDA"):
        tbase.train(tbase.BaselineVaeConfig(epochs=1), tdata.synthetic_mnist(32, 16))


# -- the baseline VAE ---------------------------------------------------------------


def test_baseline_config_has_every_field_with_the_same_default():
    jf = {f.name: f.default for f in dataclasses.fields(jbase.BaselineVaeConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tbase.BaselineVaeConfig)}
    assert jf == tf


@pytest.mark.parametrize("optimizer", ["adam", "nesterov"])
def test_baseline_step_matches_jax(optimizer):
    """One baseline step on the same noise: the ELBO to 1e-5 relative, the
    updated params to 1e-6 absolute where the gradient is above 1e-3 of its
    leaf's largest entry and to 2 lr elsewhere (Adam), or to 1e-6 of the
    leaf's largest update (Nesterov momentum, linear in the gradient)."""
    kw = dict(latent_dim=D, enc_hidden=32, batch_size=N, optimizer=optimizer)
    jcfg, tcfg = jbase.BaselineVaeConfig(**kw), tbase.BaselineVaeConfig(**kw)
    jenc, jdec = jbase.build(jcfg)
    tenc, tdec = tbase.build(tcfg)
    ke, kd = jax.random.split(jax.random.key(0))
    jp = {"enc": jenc.init(ke), "dec": jdec.init(kd)}
    tp = params_from_jax(_np(jp), device="cpu")
    rng = np.random.default_rng(5)
    batch = (rng.random((N, 784)) < 0.3).astype(np.float32)
    noise = rng.standard_normal((N, D)).astype(np.float32)

    with jax.enable_x64(False):
        def elbo_fn(p):
            mu, log_sigma = jenc.apply(p["enc"], jnp.asarray(batch))
            logits = jdec.apply(p["dec"], mu + jnp.asarray(noise) * jnp.exp(log_sigma))
            return jnp.mean(jnormal_kl(mu, jnp.exp(log_sigma), 0.0, 1.0)
                            + jvae._bce_logits(logits, jnp.asarray(batch)))

        jelbo, jg = jax.value_and_grad(elbo_fn)(jp)
        jopt = jvae.OPTIMIZERS[optimizer](jcfg.learning_rate)
        u, _ = jopt.update(jg, jopt.init(jp), jp)
        jnew = optax.apply_updates(jp, u)

    from l2hmc_tpu_torch.train.optim import OPTIMIZERS

    opt = OPTIMIZERS[optimizer](tcfg.learning_rate)
    step = tbase.make_train_step(tcfg, tenc, tdec, opt)
    state = tbase.BaselineState(tp, opt.init(tp), torch.Generator(), 0)
    new, metrics = step(state, torch.tensor(batch), torch.tensor(noise))
    np.testing.assert_allclose(float(metrics["elbo"]), float(jelbo), rtol=1e-5)
    assert new.step == 1
    for g, jn, j0, tn in zip(jax.tree_util.tree_leaves(jg), jax.tree_util.tree_leaves(jnew),
                             jax.tree_util.tree_leaves(jp), tree_leaves(new.params)):
        g, got, ref = np.asarray(g).reshape(-1), tn.numpy().reshape(-1), np.asarray(jn).reshape(-1)
        if optimizer == "adam":
            strong = np.abs(g) > 1e-3 * np.abs(g).max()
            np.testing.assert_allclose(got[strong], ref[strong], rtol=0, atol=1e-6)
            np.testing.assert_allclose(got, ref, rtol=0, atol=2 * tcfg.learning_rate)
        else:
            move = float(np.abs(ref - np.asarray(j0).reshape(-1)).max())
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * max(move, 1.0) + 1e-4 * move)


def test_baseline_train_and_samples(tmp_path):
    cfg = tbase.BaselineVaeConfig(epochs=2, batch_size=16, latent_dim=4, enc_hidden=32,
                                  eval_samples_every=1)
    ds = tdata.synthetic_mnist(n_train=48, n_test=16)
    (_, dec), state, last = tbase.train(cfg, ds, logdir=str(tmp_path), log_every=1,
                                        verbose=False, device="cpu")
    assert state.step == 6 and np.isfinite(last["elbo"])
    assert (tmp_path / "ckpt").exists()
    imgs = tbase.generate_samples(dec, state.params, torch.Generator().manual_seed(0), n=9)
    assert imgs.shape == (9, 784) and float(imgs.min()) >= 0.0 and float(imgs.max()) <= 1.0


# -- the command line ----------------------------------------------------------------


def test_parse_hparams_matches_jax():
    spec = "latent_dim=12,hmc=true,eps=0.2,optimizer=sgd,stop_gradient=0"
    got = tmain.parse_hparams(spec, tvae.VaeConfig)
    ref = jmain.parse_hparams(spec, jvae.VaeConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.latent_dim == 12 and got.hmc is True and got.stop_gradient is False
    assert tmain.parse_hparams("", tvae.VaeConfig) == tvae.VaeConfig()
    with pytest.raises(ValueError, match="unknown hparam"):
        tmain.parse_hparams("nope=1", tvae.VaeConfig)


def test_main_trains_then_restores_and_evaluates(tmp_path, monkeypatch):
    """``main`` on synthetic data on the CPU: two training steps with a
    checkpoint, then ``--restore`` of that checkpoint with a one-point AIS
    sweep and the sampler evaluation, as the command line chains them."""
    from l2hmc_tpu_torch.apps import eval_sampler

    ds = tdata.synthetic_mnist(n_train=32, n_test=16)
    monkeypatch.setattr(tdata, "get_data", lambda: ds)
    small_eval = dataclasses.replace(
        eval_sampler.EvalSamplerConfig(), n_chains=4, n_steps=6, burn_in=2,
        hmc_eps_grid=(0.1,), max_autocov_lag=3, datapoint_index=3)
    monkeypatch.setattr(eval_sampler, "EvalSamplerConfig", lambda **kw: dataclasses.replace(
        small_eval, **kw))
    hp = ("epochs=2,batch_size=32,latent_dim=4,leapfrogs=2,mh_steps=2,enc_hidden=32,"
          "sampler_size1=16,sampler_size2=16")
    last = tmain.main(["--hparams", hp, "--exp_id", "run", "--logdir_root", str(tmp_path),
                       "--device", "cpu"])
    assert np.isfinite(last["elbo"])
    results = json.load(open(tmp_path / "run" / "vae_results.json"))
    assert results["hparams"]["latent_dim"] == 4 and results["ais_log_likelihood"] == {}
    last = tmain.main(["--restore", str(tmp_path / "run" / "ckpt"), "--exp_id", "again",
                       "--logdir_root", str(tmp_path), "--device", "cpu",
                       "--anneal_steps", "4", "--max_eval_datapoints", "2"])
    assert last == {"restored_step": 2}
    results = json.load(open(tmp_path / "again" / "vae_results.json"))
    assert set(results["ais_log_likelihood"]) == {"train_as4", "test_as4"}
    assert all(np.isfinite(v) for v in results["ais_log_likelihood"].values())
