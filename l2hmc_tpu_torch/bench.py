"""The SCG headline protocol on one card (counterpart of the repository's
``bench.py``, whose protocol and JSON keys it keeps).

    python3 -m l2hmc_tpu_torch.bench                        # the protocol, on cuda
    python3 -m l2hmc_tpu_torch.bench --smoke --device cpu   # its control flow, tiny

Two arms, each trained and scored over seeds {0, 1, 2} at the notebook's
protocol (1024 chains, 5000 training steps, 2000 eval MH steps, ESS against
plain HMC at eps 0.15 with the same x0 and generator offsets +1, +2, +3):

  - the reference architecture (scalar eps, the notebook's joint loss),
    trained with ``fused_train=True``, so the trajectory kernel and its
    backward kernel carry it;
  - the best recipe, ``eps_mat + whiten_full + per_dim_loss +
    autocorr_penalty=200, z_burn_in_loss=False``, trained on the plain
    autograd path (``eps_mat`` has no kernel form).

Both are scored on the plain ``sample_chain``; training and both evaluation
chains replay captured steps on the card. The headline ``value`` is the best
recipe's median ratio, beside the reference architecture's. Before any
kernel number is reported the trajectory kernel must match
``Dynamics.forward`` within 5e-4 at 2048 chains; then the median seed's
sampler runs the chain kernel's one-launch traced eval, whose ESS must lie
within 0.30 of the plain ESS; and at the full protocol the reference
architecture's median must reach 40x (the repository's stored baseline is
46x). Throughput: chain-leapfrog-steps/s of the captured plain sampler and
of the chain kernel, and plain HMC MH steps/s, at 8192 chains.

There is one device: the sampler is launched on it directly (the JAX
package's chain mesh and sharded chain run are not ported). Prints one JSON
line; ``--smoke`` (60 steps, 64 chains, 80 eval steps, throughput at 256
chains) checks the control flow only, never gives reported numbers, and
reports without applying the 40x tripwire and the 0.30 ESS gap (80 steps of
64 chains give ESS estimates that spread wider than that).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

import numpy as np
import torch

from l2hmc_tpu_torch.config import resolve_device
from l2hmc_tpu_torch.dynamics import Dynamics
from l2hmc_tpu_torch.ops import fused_chain_sampler, fused_for_target
from l2hmc_tpu_torch.train import (
    ScgConfig,
    build_dynamics,
    evaluate_ess,
    hmc_sample_chain,
    sample_chain,
    train,
)
from l2hmc_tpu_torch.utils import Throughput, steady_ms, trace, trace_summary

BASELINE_ESS_RATIO = 46.0  # SCGExperiment.ipynb cell 21 stored output
PARITY_TOL = 5e-4  # the trajectory kernel against Dynamics.forward
PARITY_CHAINS = 2048  # the chains it is held on
ESS_GAP = 0.30  # the kernel's traced eval against the plain eval, relative
TRIPWIRE = 40.0  # the reference architecture's median at the full protocol
HMC_EPS = 0.15
N_CHIPS = 1
BEST_RECIPE = dict(eps_mat=True, whiten_full=True, per_dim_loss=True,
                   z_burn_in_loss=False, autocorr_penalty=200.0)


@dataclasses.dataclass(frozen=True)
class Depth:
    """How much of the protocol runs. ``tp_steps`` MH steps time each
    throughput; ``profile_steps`` steps of the reference arm are traced.
    ``smoke`` holds the parity gate only; ``tripwire`` holds the reference
    arm's median to 40x."""

    seeds: tuple = (0, 1, 2)
    n_steps: int = 5000
    n_chains: int = 1024
    eval_steps: int = 2000
    tp_chains: int = 8192
    tp_steps: int = 500
    profile_steps: int = 50
    smoke: bool = False
    tripwire: bool = True


FULL = Depth()
SMOKE = Depth(n_steps=60, n_chains=64, eval_steps=80, tp_chains=256, tp_steps=50,
              profile_steps=10, smoke=True, tripwire=False)


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them; on the CPU
    the word cpu."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[dev.index or 0]
    except (OSError, subprocess.SubprocessError) as e:
        return f"{torch.cuda.get_device_name(dev)} (nvidia-smi failed: {e})"


def parity_gate(dynamics, target, params, dev) -> float:
    """Max abs error of the trajectory kernel's forward trajectory against
    ``Dynamics.forward`` at ``PARITY_CHAINS`` chains; raises past
    ``PARITY_TOL``."""
    fused = fused_for_target(dynamics, target)
    x = target.sample(_gen(11), PARITY_CHAINS, device=dev)
    v = torch.randn(x.shape, generator=_gen(12)).to(dev)
    ref = dynamics.forward(params, x, v)
    got = fused.forward(params, x, v)
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    if not err < PARITY_TOL:
        raise RuntimeError(f"trajectory kernel diverges from Dynamics.forward: {err}")
    return err


def _train(cfg: ScgConfig, dev):
    _sync(dev)
    t0 = time.perf_counter()
    state, history = train(cfg, device=dev)
    _sync(dev)
    return state, history, time.perf_counter() - t0


def _plain_ess(dynamics, params, target, cfg, eval_steps, dev) -> float:
    x0 = target.sample(_gen(cfg.seed + 1), cfg.n_chains, device=dev)
    _, tr = sample_chain(dynamics, params, x0, eval_steps, _gen(cfg.seed + 2))
    return evaluate_ess(tr, target.sigma)


def _plain_rate(dynamics, params, x, steps: int, dev) -> float:
    """MH steps/s of the captured plain sampler on ``x`` at steady state:
    ``steps`` MH steps, the call's warm-up steps and recording cancelled
    (``utils.steady_ms``)."""
    short = max(steps // 10, 1)
    ms = steady_ms(lambda n: sample_chain(dynamics, params, x, n, _gen(3), collect=False),
                   short, short + steps, dev)
    return 1e3 / ms


def throughput(dynamics, target, params, dev, n_chains: int, steps: int):
    """(plain chain-leapfrog-steps/s, kernel chain-leapfrog-steps/s, kernel
    MH steps/s) at ``n_chains``: ``steps`` MH steps of the captured plain
    sampler at steady state, and one launch of the chain kernel for
    ``steps`` MH steps after a warm-up launch."""
    x = target.sample(_gen(1), n_chains, device=dev)
    lf = 2 * dynamics.T
    plain = _plain_rate(dynamics, params, x, steps, dev) * lf * n_chains

    sampler = fused_chain_sampler(dynamics, target)
    sampler.run(params, x, seed=0, n_mh_steps=steps)
    _sync(dev)
    tp = Throughput(n_chains=n_chains, leapfrogs_per_step=lf, device=dev)
    sampler.run(params, x, seed=1, n_mh_steps=steps)
    tp.tick(steps)
    return plain, tp.leapfrogs_per_sec, tp.steps_per_sec


def hmc_throughput(target, T: int, dev, n_chains: int, steps: int) -> float:
    """Plain-HMC MH steps/s at ``n_chains``: ``steps`` MH steps of the
    captured plain HMC sampler at steady state."""
    dyn = Dynamics(dim=target.dim, energy=target.energy, grad_energy=target.grad_energy,
                   T=T, hmc=True)
    params = dyn.init_params(_gen(0), eps=HMC_EPS, device=dev)
    return _plain_rate(dyn, params, target.sample(_gen(1), n_chains, device=dev), steps, dev)


def run(depth: Depth = FULL, device=None, profile_dir=None) -> dict:
    """The protocol at ``depth`` on ``device`` (``cuda`` unless told
    otherwise); returns the result that ``main`` prints."""
    dev = resolve_device(device)
    seeds = tuple(depth.seeds)
    dynamics, target = build_dynamics(ScgConfig(n_chains=depth.n_chains))

    def ref_cfg(seed, n_steps=depth.n_steps):
        return ScgConfig(n_chains=depth.n_chains, seed=seed, n_steps=n_steps, fused_train=True)

    # one training chunk of the reference arm traced; the runs below are not
    profiled = False
    trace_path = None if profile_dir is None else os.path.join(profile_dir, "trace.json")
    if profile_dir is not None:
        try:
            with trace(profile_dir):
                train(ref_cfg(1, depth.profile_steps), device=dev)
            profiled = True
        except Exception as e:  # the profiler must never sink the protocol
            print(f"# profiler trace skipped: {e!r}", flush=True)

    per_seed = []
    for s in seeds:
        cfg = ref_cfg(s)
        state, history, train_time = _train(cfg, dev)
        x0 = target.sample(_gen(s + 1), cfg.n_chains, device=dev)
        _, plain_trace = sample_chain(dynamics, state.params, x0, depth.eval_steps, _gen(s + 2))
        _, hmc_trace = hmc_sample_chain(target, HMC_EPS, cfg.T, x0, depth.eval_steps,
                                        _gen(s + 3))
        ess_l = evaluate_ess(plain_trace, target.sigma)
        ess_h = evaluate_ess(hmc_trace, target.sigma)
        per_seed.append(dict(seed=s, cfg=cfg, state=state, history=history,
                             train_time=train_time, ess_l2hmc=ess_l, ess_hmc=ess_h,
                             ratio=ess_l / max(ess_h, 1e-12)))
        print(f"# seed {s}: ESS ratio {per_seed[-1]['ratio']:.1f}x "
              f"(L2HMC {ess_l:.4f} / HMC {ess_h:.5f}), trained in {train_time:.1f} s",
              flush=True)
    med = sorted(per_seed, key=lambda r: r["ratio"])[len(per_seed) // 2]
    cfg, state, history = med["cfg"], med["state"], med["history"]

    best_seed = []
    for s, ref in zip(seeds, per_seed):
        bcfg = ScgConfig(n_chains=depth.n_chains, seed=s, n_steps=depth.n_steps, **BEST_RECIPE)
        bstate, _, btrain = _train(bcfg, dev)
        bdyn, _ = build_dynamics(bcfg)
        bess = _plain_ess(bdyn, bstate.params, target, bcfg, depth.eval_steps, dev)
        best_seed.append(dict(seed=s, ess_l2hmc=bess, train_time=btrain,
                              ratio=bess / max(ref["ess_hmc"], 1e-12)))
        print(f"# best-recipe seed {s}: ESS ratio {best_seed[-1]['ratio']:.1f}x "
              f"(L2HMC {bess:.4f}), trained in {btrain:.1f} s", flush=True)
    bmed = sorted(best_seed, key=lambda r: r["ratio"])[len(best_seed) // 2]

    parity_err = parity_gate(dynamics, target, state.params, dev)

    # the median seed's sampler through the chain kernel: one launch for the
    # whole traced eval (warmed up at the same length first)
    x0 = target.sample(_gen(cfg.seed + 1), cfg.n_chains, device=dev)
    sampler = fused_chain_sampler(dynamics, target)
    sampler.run(state.params, x0, seed=cfg.seed, n_mh_steps=depth.eval_steps,
                collect_trace=True)
    _sync(dev)
    t1 = time.perf_counter()
    _, _, fused_trace = sampler.run(state.params, x0, seed=cfg.seed + 2,
                                    n_mh_steps=depth.eval_steps, collect_trace=True)
    _sync(dev)
    eval_time = time.perf_counter() - t1

    # the plain eval path's time, one whole call as a user makes it (its
    # warm-up steps and recording included; its ESS came from the per-seed
    # loop)
    t2 = time.perf_counter()
    sample_chain(dynamics, state.params, x0, depth.eval_steps, _gen(cfg.seed + 2))
    _sync(dev)
    eval_time_plain = time.perf_counter() - t2

    ess_l2hmc, ess_hmc, ratio = med["ess_l2hmc"], med["ess_hmc"], med["ratio"]
    ess_fused = evaluate_ess(fused_trace, target.sigma)
    gap = abs(ess_fused - ess_l2hmc) / max(ess_l2hmc, 1e-12)
    if not depth.smoke and not gap < ESS_GAP:
        raise RuntimeError(f"fused-trace ESS {ess_fused} vs plain ESS {ess_l2hmc}: "
                           f"relative gap {gap:.2f} exceeds {ESS_GAP}")

    lf_plain, lf_fused, mh_sps_fused = throughput(dynamics, target, state.params, dev,
                                                  depth.tp_chains, depth.tp_steps)
    hmc_sps = hmc_throughput(target, cfg.T, dev, depth.tp_chains, depth.tp_steps)
    ess_sec_chip_l2hmc = ess_l2hmc * mh_sps_fused * depth.tp_chains / N_CHIPS
    ess_sec_chip_hmc = ess_hmc * hmc_sps * depth.tp_chains / N_CHIPS

    if depth.tripwire and ratio < TRIPWIRE:
        raise RuntimeError(
            f"reference-architecture ESS-ratio median {ratio:.1f}x fell below the "
            f"{TRIPWIRE:.0f}x tripwire (stored notebook baseline 46x); per seed: "
            + ", ".join(f"{r['seed']}: {r['ratio']:.2f}" for r in per_seed))

    return {
        "metric": "scg_ess_ratio",
        "value": round(bmed["ratio"], 3),
        "unit": "x (L2HMC ESS / HMC ESS per MH step, SCG 2-D; best framework recipe at the "
                "notebook protocol/budget, median of 3 seeds)",
        "vs_baseline": round(bmed["ratio"] / BASELINE_ESS_RATIO, 4),
        "extra": {
            "best_recipe": "eps_mat + whiten_full + per_dim_loss + autocorr_penalty=200",
            "best_recipe_ratio_per_seed": {str(r["seed"]): round(r["ratio"], 2)
                                           for r in best_seed},
            "best_recipe_ess_l2hmc": round(bmed["ess_l2hmc"], 6),
            "best_recipe_train_time_s": round(bmed["train_time"], 2),
            "reference_arch_ratio_median": round(ratio, 3),
            "ess_ratio_per_seed": {str(r["seed"]): round(r["ratio"], 2) for r in per_seed},
            "median_seed": cfg.seed,
            "ess_l2hmc": round(ess_l2hmc, 6),
            "ess_l2hmc_fused_trace": round(ess_fused, 6),
            "ess_fused_trace_rel_gap": round(gap, 4),
            "ess_hmc": round(ess_hmc, 6),
            "final_accept": round(float(history["p_accept"][-100:].mean()), 4),
            "final_loss": round(float(history["loss"][-1]), 1),
            "train_time_s": round(med["train_time"], 2),
            "eval_time_s": round(eval_time, 4),
            "eval_time_s_plain_path": round(eval_time_plain, 2),
            "fused_vs_plain_max_err": parity_err,
            "leapfrog_steps_per_sec_8192chains_plain": round(lf_plain),
            "leapfrog_steps_per_sec_8192chains_fused": round(lf_fused),
            "hmc_mh_steps_per_sec_8192chains": round(hmc_sps, 2),
            "throughput_n_chains": depth.tp_chains,
            "ess_per_sec_per_chip_l2hmc": round(ess_sec_chip_l2hmc),
            "ess_per_sec_per_chip_hmc": round(ess_sec_chip_hmc),
            "ess_per_sec_per_chip_ratio": round(
                ess_sec_chip_l2hmc / max(ess_sec_chip_hmc, 1e-12), 1),
            "n_chips": N_CHIPS,
            "fused_eval_n_devices": 1,
            "profile_trace": trace_path if profiled else None,
            "profile": trace_summary(trace_path) if profiled else None,
            "smoke": depth.smoke,
            "ess_gap_gate": (f"applied: {gap:.4f} < {ESS_GAP}" if not depth.smoke
                             else "not applied at smoke depth"),
            "tripwire": (f"applied: median {ratio:.3f} >= {TRIPWIRE:.0f}" if depth.tripwire
                         else "not applied at this depth"),
            "depth": dataclasses.asdict(depth),
            "device": card(dev),
        },
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--smoke", action="store_true",
                   help="the control flow at a tiny depth; never reported numbers")
    p.add_argument("--device", default="cuda")
    p.add_argument("--profile_dir",
                   default=os.path.join(os.path.dirname(os.path.dirname(
                       os.path.abspath(__file__))), "bench_artifacts", "torch_profile"),
                   help="where the traced training chunk goes")
    args = p.parse_args(argv)
    result = run(SMOKE if args.smoke else FULL, device=args.device,
                 profile_dir=args.profile_dir)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
