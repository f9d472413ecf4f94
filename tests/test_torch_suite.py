"""The distribution-suite runner on the CPU: its configuration tables and
precedence rules against the JAX runner's, and ``run_target`` / ``main`` at a
tiny size, with the JAX row's keys."""

import json

import pytest

from l2hmc_tpu.apps import suite as jsuite
from l2hmc_tpu_torch.apps import suite
from l2hmc_tpu_torch.ops import fused_dynamics as fd

# the keys of a JAX result row (l2hmc_tpu/apps/suite.py, run_target's return)
# off a TPU, where its fused cross-check does not run
JAX_ROW_KEYS = {
    "target", "dim", "n_chains", "ess_l2hmc", "ess_hmc", "ess_hmc_at_config_eps",
    "hmc_best_eps", "hmc_ess_by_eps", "ess_ratio", "ess_ratio_at_config_eps",
    "hmc_grid_fused", "final_accept", "n_train_seeds", "selected_seed", "train_time_s",
    "eval_time_s", "mh_steps_per_sec_eval",
}
TINY = dict(n_chains=16, n_steps=6, eval_steps=20, n_train_seeds=1, val_steps=10)


def test_tables_equal_jax():
    assert suite._GLOBAL_DEFAULTS == jsuite._GLOBAL_DEFAULTS
    assert suite._TARGET_OVERRIDES == jsuite._TARGET_OVERRIDES
    assert set(suite._target_registry()) == set(jsuite._target_registry())


@pytest.mark.parametrize("name", sorted(jsuite._target_registry()))
def test_effective_config_equals_jax(name):
    """Defaults, then the target's overrides (unless turned off), then the
    keyword arguments given, ``None`` meaning not given."""
    for apply in (True, False):
        assert (suite.effective_config(name, apply_overrides=apply)
                == jsuite.effective_config(name, apply_overrides=apply))
    kw = dict(n_chains=64, hidden=None, eps=0.3, init_temperature=2.0)
    got = suite.effective_config(name, **kw)
    assert got == jsuite.effective_config(name, **kw)
    assert got["n_chains"] == 64 and got["eps"] == 0.3
    assert got["hidden"] == jsuite._TARGET_OVERRIDES.get(name, {}).get("hidden", 10)
    with pytest.raises(TypeError, match="unknown hyperparameters"):
        suite.effective_config(name, not_a_knob=1)


@pytest.mark.parametrize("name", ["rough_well", "ring", "funnel"])
def test_run_target_smoke(name):
    """A tiny run of each kernel-spec'd row: finite ESS on both sides, the
    JAX row's keys, and the fused cross-check's reason recorded (off the
    card, or the funnel's net_input_fn)."""
    row = suite.run_target(name, device="cpu", verbose=False, **TINY)
    assert set(row) == JAX_ROW_KEYS | {"fused_cross_check"}
    assert row["target"] == name and row["n_chains"] == 16 and row["n_train_seeds"] == 1
    assert row["ess_l2hmc"] > 0 and row["ess_hmc"] > 0 and 0.0 <= row["final_accept"] <= 1.0
    assert len(row["hmc_ess_by_eps"]) == 8 and row["hmc_grid_fused"] is False
    reason = "net_input_fn" if name == "funnel" else "CUDA device"
    assert reason in row["fused_cross_check"]
    json.dumps(row)


def test_fused_hmc_runs_the_plain_chain_on_the_cpu(tmp_path, capsys, monkeypatch):
    """``--fused_hmc`` on the CPU runs the HMC grid through the chain
    kernel's plain version (no launch), so the row does not claim a
    kernel-run grid; ``main`` prints each row and writes them to ``--out``."""
    out = tmp_path / "suite.json"
    fd.reset_launch_counts()
    plain_calls = []
    chain_plain = fd.chain_plain
    monkeypatch.setattr(fd, "chain_plain",
                        lambda *a, **k: plain_calls.append(1) or chain_plain(*a, **k))
    rows = suite.main(["--targets", "rough_well", "--device", "cpu", "--n_chains", "16",
                       "--n_steps", "6", "--eval_steps", "20", "--leapfrogs", "2",
                       "--fused_hmc", "--out", str(out)])
    assert fd.LAUNCHES["chain"] == 0 and len(plain_calls) == 8
    (row,) = rows
    assert row["hmc_grid_fused"] is False and len(row["hmc_ess_by_eps"]) == 8
    assert json.loads(out.read_text())[0]["target"] == "rough_well"
    assert '"target": "rough_well"' in capsys.readouterr().out


def test_train_and_select_over_seeds():
    """With ``n_train_seeds`` > 1 each seed's sampler is scored on a
    validation chain and one of them is selected."""
    row = suite.run_target("ring", device="cpu", verbose=False,
                           **{**TINY, "n_train_seeds": 2, "leapfrogs": 2})
    assert row["n_train_seeds"] == 2 and row["selected_seed"] in (42, 1042)


def test_mog2_raises_naming_pt_train_rungs():
    with pytest.raises(NotImplementedError, match="pt_train_rungs"):
        suite.run_target("mog2", device="cpu", verbose=False, **TINY)


def test_kernel_refusals_of_the_suite_rows():
    """The pure check that decides each row's cross-check: scg's eps_mat
    and the funnel's net_input_fn are not supported; icg (hidden 100, on the
    chain kernel's site-parallel configuration), the rough well and the ring
    are served."""
    from l2hmc_tpu_torch.train import build_dynamics

    reasons = {}
    for name in ("icg", "scg", "funnel", "rough_well", "ring"):
        eff = suite.effective_config(name)
        target = suite._target_registry()[name]()
        cfg = suite.ScgConfig(dim=target.dim, T=eff["leapfrogs"], hmc=eff["hmc_mode"],
                              **{k: eff[k] for k in suite._SAME_NAME})
        reasons[name] = fd.kernel_refusal(build_dynamics(cfg, target)[0], target, eff["hidden"])
    assert reasons["icg"] is None
    assert "eps_mat" in reasons["scg"]
    assert "net_input_fn" in reasons["funnel"]
    assert reasons["rough_well"] is None and reasons["ring"] is None
