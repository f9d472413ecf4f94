"""The port's SCG entry points on the CPU: the bench at smoke depth, the
command line's train -> checkpoint -> restore round trip, an eps_mat params
tree from the JAX package through the converter and a checkpoint, and the
profiler trace."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from l2hmc_tpu.train import ScgConfig as JaxScgConfig
from l2hmc_tpu.train import build_dynamics as jax_build_dynamics
from l2hmc_tpu.train import make_optimizer as jax_make_optimizer
from l2hmc_tpu_torch import bench
from l2hmc_tpu_torch.apps import scg as scg_app
from l2hmc_tpu_torch.convert import adam_moment_leaves, params_from_jax
from l2hmc_tpu_torch.io import restore_checkpoint, save_checkpoint
from l2hmc_tpu_torch.train import ScgConfig, TrainState, build_dynamics, init_state, make_optimizer
from l2hmc_tpu_torch.train.optim import tree_leaves
from l2hmc_tpu_torch.utils import profiling, steady_ms, trace, trace_summary

BENCH_KEYS = (
    "best_recipe_ratio_per_seed", "best_recipe_ess_l2hmc", "best_recipe_train_time_s",
    "reference_arch_ratio_median", "ess_ratio_per_seed", "median_seed", "ess_l2hmc",
    "ess_l2hmc_fused_trace", "ess_hmc", "final_accept", "final_loss", "train_time_s",
    "eval_time_s", "eval_time_s_plain_path", "fused_vs_plain_max_err",
    "leapfrog_steps_per_sec_8192chains_plain", "leapfrog_steps_per_sec_8192chains_fused",
    "hmc_mh_steps_per_sec_8192chains", "ess_per_sec_per_chip_l2hmc",
    "ess_per_sec_per_chip_hmc", "ess_per_sec_per_chip_ratio", "n_chips", "device",
    "smoke", "tripwire", "ess_gap_gate", "profile_trace", "profile",
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny sizes: one intra-op thread is the fastest, and the test workers
    do not fight over cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bench_smoke_prints_one_json_line(tmp_path, capsys):
    """``python -m l2hmc_tpu_torch.bench --smoke --device cpu``: one JSON
    line with the JAX bench's keys (two renamed), both arms per seed, the
    parity gate held, the tripwire and the ESS gap reported as not applied,
    and the profiler's trace written."""
    result = bench.main(["--smoke", "--device", "cpu", "--profile_dir", str(tmp_path)])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if not ln.startswith("#")]
    assert len(lines) == 1 and json.loads(lines[0]) == json.loads(json.dumps(result))
    extra = result["extra"]
    assert result["metric"] == "scg_ess_ratio" and np.isfinite(result["value"])
    assert set(BENCH_KEYS) <= set(extra)
    assert set(extra["ess_ratio_per_seed"]) == set(extra["best_recipe_ratio_per_seed"]) == {
        "0", "1", "2"}
    assert extra["smoke"] is True and extra["n_chips"] == 1 and extra["device"] == "cpu"
    assert extra["tripwire"].startswith("not applied")
    assert extra["ess_gap_gate"].startswith("not applied")
    assert extra["fused_vs_plain_max_err"] < bench.PARITY_TOL
    assert abs(result["value"] - sorted(extra["best_recipe_ratio_per_seed"].values())[1]) < 0.01
    for k in ("ess_l2hmc", "ess_l2hmc_fused_trace", "ess_hmc", "train_time_s",
              "leapfrog_steps_per_sec_8192chains_plain", "leapfrog_steps_per_sec_8192chains_fused",
              "hmc_mh_steps_per_sec_8192chains"):
        assert np.isfinite(extra[k]) and extra[k] > 0, k
    assert extra["profile_trace"] == os.path.join(str(tmp_path), "trace.json")
    assert os.path.getsize(extra["profile_trace"]) > 0


def test_scg_cli_round_trip(tmp_path, capsys):
    """Train + evaluate with a logdir, then ``--restore`` the checkpoint in
    a fresh call: the restored step and the same ESS numbers."""
    logdir = str(tmp_path / "run")
    out = scg_app.main(["--device", "cpu", "--n_steps", "30", "--n_chains", "32",
                        "--leapfrogs", "3", "--eval_steps", "30", "--log_every", "10",
                        "--logdir", logdir])
    assert out["checkpoint"] == f"{logdir}/ckpt"
    for name in ("ckpt", "ckpt.config.json", "metrics.csv", "summary.json"):
        assert os.path.exists(os.path.join(logdir, name)), name
    back = scg_app.main(["--device", "cpu", "--restore", f"{logdir}/ckpt",
                         "--eval_steps", "30"])
    assert back["restored_step"] == 30
    for k in ("ess_l2hmc", "ess_hmc", "ess_ratio"):
        assert back[k] == out[k], k
    assert capsys.readouterr().out.count("ESS L2HMC: ") == 2


def test_eps_mat_tree_through_converter_and_checkpoint(tmp_path):
    """A JAX eps_mat params tree and its optax state: the converter carries
    the "w" leaf, the Adam moments line up with the port's flat order, and
    a checkpoint of the state restores "w" into an eps_mat template."""
    jcfg = JaxScgConfig(n_chains=8, T=2, eps_mat=True)
    jd, _ = jax_build_dynamics(jcfg)
    jp = jd.init_params(jax.random.key(0), eps=0.1)
    jp["w"] = jp["w"] + 0.01 * jax.numpy.arange(4.0, dtype=jax.numpy.float32).reshape(2, 2)
    opt, _ = jax_make_optimizer(jcfg)
    grads = jax.tree_util.tree_map(lambda a: a + 1.0, jp)
    _, ostate = opt.update(grads, opt.init(jp), jp)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    np.testing.assert_array_equal(tp["w"].numpy(), np.asarray(jp["w"]))
    mu, nu = adam_moment_leaves(ostate)
    assert [m.shape for m in mu] == [tuple(t.shape) for t in tree_leaves(tp)]
    assert [n.shape for n in nu] == [m.shape for m in mu]

    cfg = ScgConfig(n_chains=8, T=2, eps_mat=True)
    dyn, _ = build_dynamics(cfg)
    topt, _ = make_optimizer(cfg)
    state = init_state(cfg, dyn, topt, device="cpu")
    state = state._replace(params=tp)
    save_checkpoint(str(tmp_path / "ckpt"), state, config=cfg)
    back = restore_checkpoint(str(tmp_path / "ckpt"), init_state(cfg, dyn, topt, device="cpu"))
    assert isinstance(back, TrainState)
    for a, b in zip(tree_leaves(back.params), tree_leaves(tp)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int(back.step) == 0


def test_trace_writes_a_chrome_trace_and_its_summary(tmp_path):
    """``trace`` writes a Chrome trace (with no replay in it on the CPU, so
    no summary); ``trace_summary`` reads a replay window off a trace: two
    replays from t=10, kernels over [10, 14], [12, 15] and [20, 30] us."""
    with trace(str(tmp_path / "t")):
        torch.ones(3).sum()
    with open(tmp_path / "t" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    assert trace_summary(str(tmp_path / "t" / "trace.json")) is None
    with trace(None):
        pass
    events = [{"name": "cudaGraphLaunch", "ts": 10}, {"name": "cudaGraphLaunch", "ts": 18},
              {"name": "early", "cat": "kernel", "ts": 1, "dur": 5},
              {"name": "a", "cat": "kernel", "ts": 10, "dur": 4},
              {"name": "b", "cat": "kernel", "ts": 12, "dur": 3},
              {"name": "a", "cat": "kernel", "ts": 20, "dur": 10}]
    with open(tmp_path / "s.json", "w") as f:
        json.dump({"traceEvents": events}, f)
    got = trace_summary(str(tmp_path / "s.json"))
    assert got["replays"] == 2 and got["kernels_per_replay"] == 1.5
    assert got["window_ms"] == pytest.approx(0.020) and got["busy_ms"] == pytest.approx(0.015)
    assert got["busy_share"] == pytest.approx(0.75)
    assert got["top_kernels"] == pytest.approx({"a": 14 / 17, "b": 3 / 17})


def test_steady_ms_cancels_each_runs_set_up(monkeypatch):
    """``steady_ms`` on a clock that a run of n steps advances by 0.5 s of
    set-up plus 2 ms a step: 2 ms a step, after one untimed short run."""
    clock = [0.0]
    calls = []

    def run(n):
        calls.append(n)
        clock[0] += 0.5 + 0.002 * n

    monkeypatch.setattr(profiling.time, "perf_counter", lambda: clock[0])
    assert steady_ms(run, 5, 25, "cpu") == pytest.approx(2.0)
    assert calls == [5, 5, 25]
