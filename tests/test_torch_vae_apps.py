"""``mcmc.chain_operator`` vs the JAX package on its own draws, and the two
VAE evaluation protocols (``apps.eval_sampler``, ``apps.eval_vae``) end to
end on the CPU at a small size."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_vae_util import SMALL, build_pair, inputs

from l2hmc_tpu import mcmc as jmcmc
from l2hmc_tpu.io import MetricsWriter as JaxMetricsWriter
from l2hmc_tpu_torch import mcmc
from l2hmc_tpu_torch.apps import data, eval_sampler, eval_vae
from l2hmc_tpu_torch.io import MetricsWriter
from l2hmc_tpu_torch.ops import fused_dynamics as fd

N, D = 32, SMALL["latent_dim"]


def _t(a):
    return torch.tensor(np.asarray(a))


def _chain_operator_draws(key, n, d, max_steps):
    """The draws ``l2hmc_tpu.mcmc.chain_operator`` makes from ``key``:
    (v0, per-op momenta, per-op direction uniforms, accept uniforms)."""
    k_v, k_scan, k_mh = jax.random.split(key, 3)
    v0 = jax.random.normal(k_v, (n, d), jnp.float32)
    op_v, op_dir = [], []
    for k in jax.random.split(k_scan, max_steps):
        kv, kdir, _ = jax.random.split(k, 3)
        op_v.append(_t(jax.random.normal(kv, (n, d), jnp.float32)))
        op_dir.append(_t(jax.random.uniform(kdir, (n,), jnp.float32)))
    return _t(v0), op_v, op_dir, _t(jax.random.uniform(k_mh, (n,), jnp.float32))


@pytest.mark.parametrize("faithful", [False, True], ids=["threaded", "faithful"])
@pytest.mark.parametrize("nb", [1, 3])
def test_chain_operator_matches_jax_on_its_draws(faithful, nb):
    """nb composed proposals under one terminal accept, both momentum
    readings, on the JAX run's own draws: proposal, acceptance probability
    and post-MH state to 3e-4 (up to three trajectories of float32)."""
    jm, jp, tm, tp = build_pair()
    x_raw, z0 = inputs(N, D)
    jemb = jm.aux_encoder.apply(jp["smp"]["aux_enc"], jnp.asarray(x_raw))
    jaux = {"raw": jnp.asarray(x_raw), "emb": jemb, "dec": jp["dec"]}
    taux = {"raw": _t(x_raw), "emb": _t(jemb), "dec": tp["dec"]}
    key = jax.random.key(11)
    ref = jmcmc.chain_operator(key, jm.dynamics, jp["smp"], jnp.asarray(z0), nb, max_steps=4,
                               aux=jaux, do_mh_step=True, faithful_momentum=faithful)
    v0, op_v, op_dir, u = _chain_operator_draws(key, N, D, 4)
    out = mcmc.chain_operator(None, tm.dynamics, tp["smp"], _t(z0), nb, max_steps=4,
                              init_v=v0, op_v=op_v, op_dir_u=op_dir, accept_u=u, aux=taux,
                              do_mh_step=True, faithful_momentum=faithful)
    tol = dict(rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(out.x_prop.numpy(), np.asarray(ref.x_prop), **tol)
    np.testing.assert_allclose(out.v_prop.numpy(), np.asarray(ref.v_prop), **tol)
    np.testing.assert_allclose(out.log_jac.numpy(), np.asarray(ref.log_jac), **tol)
    np.testing.assert_allclose(out.p_accept.numpy(), np.asarray(ref.p_accept),
                               rtol=5e-3, atol=3e-4)
    same = (out.p_accept - u >= 0).numpy() == (np.asarray(ref.p_accept) - u.numpy() >= 0)
    np.testing.assert_allclose(out.x_next.numpy()[same], np.asarray(ref.x_next)[same], **tol)
    assert same.mean() > 0.9


def test_chain_operator_stops_at_max_steps_and_draws_its_own():
    _, _, tm, tp = build_pair()
    x_raw, z0 = inputs(N, D)
    xr = _t(x_raw)
    aux = {"raw": xr, "emb": tm.aux_encoder.apply(tp["smp"]["aux_enc"], xr), "dec": tp["dec"]}
    g = torch.Generator().manual_seed(0)
    a = mcmc.chain_operator(g, tm.dynamics, tp["smp"], _t(z0), 9, max_steps=2, aux=aux)
    g = torch.Generator().manual_seed(0)
    b = mcmc.chain_operator(g, tm.dynamics, tp["smp"], _t(z0), 2, max_steps=2, aux=aux)
    torch.testing.assert_close(a.x_prop, b.x_prop, rtol=0, atol=0)
    assert a.x_next is None and torch.isfinite(a.p_accept).all()


SAMPLER_CFG = eval_sampler.EvalSamplerConfig(
    leapfrogs=SMALL["leapfrogs"], latent_dim=D, n_chains=16, n_steps=10, burn_in=4,
    max_composition=4, datapoint_index=3, hmc_eps_grid=(0.05, 0.1), max_autocov_lag=4)


@pytest.fixture(scope="module")
def dataset():
    return data.synthetic_mnist(n_train=8, n_test=8, seed=0)


@pytest.mark.parametrize("use_fused", ["auto", "always", "never"])
def test_eval_sampler_runs_on_cpu(dataset, use_fused):
    """Shapes and finite curves; on the CPU no kernel is launched, "auto"
    is the chain_operator loop (equal to "never") and "always" the sampler
    kernel's plain version, whose trace records the state after each step."""
    _, _, tm, tp = build_pair()
    fd.reset_launch_counts()
    out = eval_sampler.run(tm, tp, SAMPLER_CFG, dataset, seed=2, use_fused=use_fused,
                           device="cpu")
    assert not any(fd.LAUNCHES.values())
    assert out["data_source"] == "synthetic-blobs"
    assert out["trained"].shape == (4,) and np.isfinite(out["trained"]).all()
    assert set(out["hmc"]) == {0.05, 0.1}
    for c in out["hmc"].values():
        assert c.shape == (4,) and np.isfinite(c).all() and c[0] > 0
    trace = out["trace"]
    assert trace.shape == (10, 16, D) and torch.isfinite(trace).all()
    assert float((trace[-1] - trace[0]).abs().max()) > 0  # the chains moved
    if use_fused != "always":
        ref = eval_sampler.run(tm, tp, SAMPLER_CFG, dataset, seed=2, use_fused="never",
                               device="cpu")
        torch.testing.assert_close(trace, ref["trace"], rtol=0, atol=0)
        np.testing.assert_array_equal(out["trained"], ref["trained"])


def test_eval_sampler_trace_conventions(dataset):
    """The loop's row 0 is the encoder draw (state before step 0); the
    fused route's rows are states after each step."""
    _, _, tm, tp = build_pair()
    a = eval_sampler.run(tm, tp, SAMPLER_CFG, dataset, seed=2, use_fused="never",
                         device="cpu")["trace"]
    b = eval_sampler.run(tm, tp, SAMPLER_CFG, dataset, seed=2, use_fused="always",
                         device="cpu")["trace"]
    assert float((a[0] - b[0]).abs().max()) > 0
    x = data.binarize(np.random.default_rng(2), dataset.train)[SAMPLER_CFG.datapoint_index]
    with torch.no_grad():
        x0, emb, z0 = eval_sampler.protocol_inputs(tm, tp, SAMPLER_CFG, dataset, 2, "cpu")
    n = SAMPLER_CFG.n_chains
    np.testing.assert_array_equal(x0.numpy(), np.tile(x[None], (n, 1)))
    assert emb.shape == (n, SMALL["sampler_size1"]) and z0.shape == (n, D)
    torch.testing.assert_close(a[0], z0, rtol=0, atol=0)


def test_eval_entry_points_check_their_arguments(dataset):
    _, _, tm, tp = build_pair()
    with pytest.raises(ValueError, match="use_fused"):
        eval_sampler.run(tm, tp, SAMPLER_CFG, dataset, use_fused="sometimes", device="cpu")
    with pytest.raises(ValueError, match="use_fused"):
        eval_vae.run(tm, tp, eval_vae.EvalVaeConfig(latent_dim=D), dataset,
                     use_fused="sometimes", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_sampler.run(tm, tp, SAMPLER_CFG, dataset)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_vae.run(tm, tp, eval_vae.EvalVaeConfig(latent_dim=D), dataset)


@pytest.mark.parametrize("use_fused", ["auto", "always", "never"])
def test_eval_vae_runs_on_cpu(dataset, use_fused, tmp_path):
    """A finite estimate of the right order (minus a few hundred nats for
    784 pixels under an untrained decoder), written to <split>_ll.txt; no
    kernel is launched on the CPU; "auto" equals "never"."""
    _, _, tm, tp = build_pair()
    cfg = eval_vae.EvalVaeConfig(leapfrogs=3, anneal_steps=6, latent_dim=D, step_size=0.05,
                                 chains_per_datapoint=4, num_splits=3)
    fd.reset_launch_counts()
    est = eval_vae.run(tm, tp, cfg, dataset, seed=1, max_datapoints=5, logdir=str(tmp_path),
                       use_fused=use_fused, device="cpu")
    assert not any(fd.LAUNCHES.values())
    assert np.isfinite(est) and -2000 < est < -100
    assert float((tmp_path / "test_ll.txt").read_text().strip()) == est
    if use_fused == "auto":
        ref = eval_vae.run(tm, tp, cfg, dataset, seed=1, max_datapoints=5, use_fused="never",
                           device="cpu")
        assert est == ref


def test_eval_vae_routes_agree(dataset):
    """The kernel's plain version and the ais_estimate loop estimate the
    same log-likelihood: their own streams, 6 datapoints x 16 chains, so
    only to 3% (the estimate is about -600)."""
    _, _, tm, tp = build_pair()
    cfg = eval_vae.EvalVaeConfig(leapfrogs=3, anneal_steps=20, latent_dim=D, step_size=0.05,
                                 chains_per_datapoint=16, num_splits=6)
    a = eval_vae.run(tm, tp, cfg, dataset, seed=1, max_datapoints=6, use_fused="always",
                     device="cpu")
    b = eval_vae.run(tm, tp, cfg, dataset, seed=1, max_datapoints=6, use_fused="never",
                     device="cpu")
    assert abs(a - b) < 0.03 * abs(b)


def test_metrics_writer_writes_what_the_jax_packages_does(tmp_path):
    rows = [{"loss": 1.5, "p_accept": torch.tensor(0.25)}, {"loss": 2.0, "p_accept": 0.5}]
    for cls, sub in ((MetricsWriter, "t"), (JaxMetricsWriter, "j")):
        w = cls(str(tmp_path / sub))
        for i, r in enumerate(rows):
            w.write(i, {k: float(v) for k, v in r.items()})
        w.append_text("test_ll.txt", "-87.5\n")
        w.append_text("test_ll.txt", "-86.0")
    assert (tmp_path / "t" / "test_ll.txt").read_text() == (tmp_path / "j" / "test_ll.txt").read_text()
    t_lines = (tmp_path / "t" / "metrics.csv").read_text().splitlines()
    j_lines = (tmp_path / "j" / "metrics.csv").read_text().splitlines()
    assert t_lines[0] == j_lines[0] == "step,wall_time,loss,p_accept"
    assert [l.split(",")[2:] for l in t_lines] == [l.split(",")[2:] for l in j_lines]
    assert len((tmp_path / "t" / "metrics.jsonl").read_text().splitlines()) == 2
