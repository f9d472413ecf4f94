#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``l2hmc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``l2hmc_tpu_torch/csrc`` (nvcc, sm_90a),
then:

  1. main path: the SCG evaluation protocol at the notebook's full width
     (D=2, S/T/Q hidden 10, T=10) through the port's entry points — the
     trajectory-kernel parity gate against ``Dynamics.forward/backward``
     (2048 chains), the fused 2000-step traced eval of the sampler and of
     the HMC baseline (eps 0.15) on 1024 chains, and the same eval through
     the plain ``sample_chain``; the two ESS must agree within 0.30
     relative. Launch counts are reset before and read after this phase;
  2. trajectory kernel vs its plain version on the same inputs: SCG at 2048
     and 200 chains, the 50-d ill-conditioned Gaussian (input_scale,
     eps_dim) and HMC mode, both directions, tolerance 5e-4; forward then
     backward must invert;
  3. chain kernel vs its plain version on the same Philox bits;
  4. throughput of the chain kernel at 8192 chains x 500 MH steps;
  5. kernel times, plain times and bounds.

Prints a ``kernels`` JSON line, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, without a CUDA device, without the port beside it, or when any
check fails. The full report is printed as a ``# report:`` JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# Published peaks of one H100 SXM at 700 W (NVIDIA data sheet): float32
# outside the tensor cores, and HBM3 bandwidth.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
TRAJ_TOL = 5e-4  # bench.py's compiled-parity gate
ESS_GAP = 0.30  # bench.py's fused-trace vs non-kernel ESS tolerance


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


class Failed(Exception):
    pass


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


# -- operation and byte counts (bounds) ------------------------------------------
#
# Operations counted per chain: a fused multiply-add is 2, every other
# arithmetic operation, comparison or transcendental function is 1, all at
# the float32 peak. (exp/tanh/log/cos run partly on the special-function
# units, which are slower; the bound is therefore optimistic.)


def _stq_ops(D, H, H2):
    return (4 * D * H + 2 * H  # embeds, time column, relu
            + 2 * H * H2 + 2 * H2  # hidden, bias, relu
            + 6 * H2 * D + 3 * D  # heads and their biases
            + 8 * D)  # exp(ls), exp(lq), 2 tanh, 2 scale products, 2 head sums


def _substep_ops(D, H, H2, hmc):
    nets = 0 if hmc else 4 * _stq_ops(D, H, H2)
    grads = 2 * (2 * D * D + D)
    updates = 4 * 12 * D  # four masked updates with their exp gates and logdet
    return nets + grads + updates


def _energy_ops(D):
    return 2 * D * D + 3 * D


def traj_bound(D, H, H2, T, N, hmc, block_floats):
    ops = N * T * _substep_ops(D, H, H2, hmc)
    nbytes = 4 * (2 * D * N + 2 * D * N + N + block_floats)
    return _bound(ops, nbytes)


def chain_bound(D, H, H2, T, N, K, hmc, block_floats, trace: bool):
    philox = (1 + (D + 1) // 2) * 10 * 8  # calls x rounds x integer ops
    per_step = (T * _substep_ops(D, H, H2, hmc) + 2 * _energy_ops(D) + 4 * D
                + philox + 6 * D + 8)
    ops = N * K * per_step
    nbytes = 4 * (D * N + D * N + N + block_floats + (K * D * N if trace else 0))
    return _bound(ops, nbytes)


def _bound(ops, nbytes):
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_BYTES
    if t_ops >= t_bytes:
        return 1e3 * t_ops, "operations"
    return 1e3 * t_bytes, "bytes"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from l2hmc_tpu_torch import targets
        from l2hmc_tpu_torch.ops import _cuda
        from l2hmc_tpu_torch.ops import fused_dynamics as fd
        from l2hmc_tpu_torch.train import (
            ScgConfig, build_dynamics, evaluate_ess, sample_chain,
        )
        from l2hmc_tpu_torch.utils import Throughput
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}", file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    report = {"torch": torch.__version__, "cuda": torch.version.cuda}
    smi = _nvidia_smi()
    print(f"# card: {smi}", flush=True)
    report["card"] = smi

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    def perturb(params):
        """Deterministic lift of every net weight by 0.03, so S/T/Q are
        O(0.1-1) (at init the 0.001 head factor makes them ~0)."""
        out = dict(params)
        for net in ("xnet", "vnet"):
            out[net] = _tree_map(lambda a: a + 0.03, params[net])
        return out

    def cuda_time(fn, reps):
        """Mean ms of ``fn()`` over ``reps`` runs by CUDA events, after one
        warm-up run."""
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    # -- setup: build ------------------------------------------------------------
    t0 = time.perf_counter()
    _cuda.library("trajectory")
    report["build_s"] = time.perf_counter() - t0
    print(f"# kernels built in {report['build_s']:.1f} s "
          f"(nvcc {_cuda.build_info.get('seconds', 0.0):.1f} s)", flush=True)
    ptxas = _cuda.build_info.get("ptxas", "")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            print(f"# ptxas: {line.strip()}")

    cfg = ScgConfig(n_chains=1024)
    dyn, target = build_dynamics(cfg)
    params = dyn.init_params(gen(cfg.seed), eps=cfg.eps, device=dev)
    eval_steps, hmc_eps = 2000, 0.15
    hmc_dyn, _ = build_dynamics(ScgConfig(hmc=True), target)
    hmc_params = hmc_dyn.init_params(gen(0), eps=hmc_eps, device=dev)

    # -- 1. main path --------------------------------------------------------------
    fd.reset_launch_counts()
    t_main = time.perf_counter()
    fused = fd.fused_for_target(dyn, target)
    xg = target.sample(gen(11), 2048, device=dev)
    vg = torch.randn(xg.shape, generator=gen(12)).to(dev)
    gate_err = 0.0
    for direction in ("forward", "backward"):
        ref = getattr(dyn, direction)(params, xg, vg)
        got = getattr(fused, direction)(params, xg, vg)
        gate_err = max(gate_err, *(float((a - b).abs().max()) for a, b in zip(got, ref)))
    _require(gate_err < TRAJ_TOL, f"parity gate: fused trajectory off by {gate_err}")

    x0 = target.sample(gen(cfg.seed + 1), cfg.n_chains, device=dev)
    sampler = fd.fused_chain_sampler(dyn, target)
    t = time.perf_counter()
    _, acc_fused, trace_fused = sampler.run(params, x0, seed=cfg.seed + 2,
                                            n_mh_steps=eval_steps, collect_trace=True)
    torch.cuda.synchronize()
    eval_fused_s = time.perf_counter() - t
    hmc_sampler = fd.fused_chain_sampler(hmc_dyn, target)
    _, acc_hmc, trace_hmc = hmc_sampler.run(hmc_params, x0, seed=cfg.seed + 3,
                                            n_mh_steps=eval_steps, collect_trace=True)
    t = time.perf_counter()
    _, trace_plain = sample_chain(dyn, params, x0, eval_steps, gen(cfg.seed + 2))
    torch.cuda.synchronize()
    eval_plain_s = time.perf_counter() - t
    launches = dict(fd.LAUNCHES)
    ess_fused = evaluate_ess(trace_fused, target.sigma)
    ess_hmc = evaluate_ess(trace_hmc, target.sigma)
    ess_plain = evaluate_ess(trace_plain, target.sigma)
    main_s = time.perf_counter() - t_main
    gap = abs(ess_fused - ess_plain) / max(ess_plain, 1e-12)
    report["main_path"] = {
        "parity_gate_max_abs_err": gate_err,
        "eval_steps": eval_steps, "n_chains": cfg.n_chains,
        "ess_l2hmc_fused_trace": ess_fused, "ess_l2hmc_plain_sample_chain": ess_plain,
        "ess_rel_gap": gap, "ess_hmc_fused_trace": ess_hmc,
        "ess_ratio_fused": ess_fused / max(ess_hmc, 1e-12),
        "accept_fused": float(acc_fused.mean()), "accept_hmc": float(acc_hmc.mean()),
        "eval_fused_s": eval_fused_s, "eval_plain_sample_chain_s": eval_plain_s,
        "wall_s": main_s, "launches": launches,
    }
    print("# main path: " + json.dumps(report["main_path"]), flush=True)
    _require(all(torch.isfinite(t).all() for t in (trace_fused, trace_hmc, trace_plain)),
             "non-finite trace")
    _require(trace_fused.shape == (eval_steps, cfg.n_chains, 2), "trace shape")
    _require(gap < ESS_GAP, f"fused-trace ESS {ess_fused} vs plain ESS {ess_plain}: gap {gap}")
    for name in ("trajectory", "chain"):
        _require(launches[name] > 0, f"kernel {name} not launched on the main path")

    # -- 2. trajectory kernel vs plain ----------------------------------------------
    icg = targets.ill_conditioned_gaussian(50)
    icg_cfg = ScgConfig(dim=50, eps_dim=True, net_input_whiten=True)
    icg_dyn, _ = build_dynamics(icg_cfg, icg)
    icg_eps = torch.as_tensor(0.1 * (icg.sigma.diagonal() ** 0.5), dtype=torch.float32)
    icg_params = perturb(icg_dyn.init_params(gen(5), eps=icg_eps, device=dev))
    scg_params = perturb(params)
    cases = [
        ("scg_n2048", dyn, target, scg_params, 2048),
        ("scg_n200", dyn, target, scg_params, 200),
        ("icg50_n1024", icg_dyn, icg, icg_params, 1024),
        ("hmc_n2048", hmc_dyn, target, hmc_params, 2048),
    ]
    traj = {}
    for name, d_, tg, p_, n in cases:
        inp = fd.prepare(d_, fd.energy_spec_for_target(tg), p_, dev)
        x = tg.sample(gen(21), n, device=dev).T.contiguous()
        v = torch.randn(x.shape, generator=gen(22)).to(dev)
        errs = {}
        for reverse in (False, True):
            k_out = fd.trajectory(inp, x, v, reverse)
            p_out = fd.trajectory_plain(inp, x, v, reverse)
            errs["backward" if reverse else "forward"] = max(
                float((a - b).abs().max()) for a, b in zip(k_out, p_out))
        X, V, ld = fd.trajectory(inp, x, v, False)
        x2, v2, ld2 = fd.trajectory(inp, X, V, True)
        inv = float(((x2 - x).abs() / (1 + x.abs())).max())
        inv_ld = float((ld + ld2).abs().max())
        traj[name] = {"max_abs_err": errs, "inverse_rel_err": inv, "inverse_logdet_err": inv_ld}
        _require(max(errs.values()) < TRAJ_TOL, f"trajectory {name}: {errs}")
        _require(inv < 1e-3 and inv_ld < 1e-3, f"trajectory {name} does not invert: {inv}, {inv_ld}")
    report["trajectory_vs_plain"] = traj
    print("# trajectory kernel vs plain: " + json.dumps(traj), flush=True)

    inp_scg = fd.prepare(dyn, fd.energy_spec_for_target(target), scg_params, dev)
    xs = target.sample(gen(31), 2048, device=dev).T.contiguous()
    vs = torch.randn(xs.shape, generator=gen(32)).to(dev)
    traj_ms = cuda_time(lambda: fd.trajectory(inp_scg, xs, vs, False), 50)
    traj_plain_ms = cuda_time(lambda: fd.trajectory_plain(inp_scg, xs, vs, False), 5)
    D, H, H2, T = inp_scg.dims
    traj_bound_ms, traj_bound_by = traj_bound(D, H, H2, T, 2048, False, inp_scg.block().numel())

    # -- 3. chain kernel vs plain on the same Philox bits ---------------------------
    # Tolerance: the kernel and its plain version draw identical bits, so an
    # accept decision can differ only where px - u is within the few-ulp gap
    # of the two float32 Hamiltonians (~1e-6), expected well under one flip in
    # 20480 decisions: at most 5 flips are allowed. On chains with no flip the
    # states may differ by the per-trajectory tolerance compounded over 20
    # trajectories: 20 x 5e-4 = 1e-2.
    chain_cmp = {}
    for name, d_, p_ in (("l2hmc", dyn, scg_params), ("hmc", hmc_dyn, hmc_params)):
        inp = fd.prepare(d_, fd.energy_spec_for_target(target), p_, dev)
        xc = target.sample(gen(41), 1024, device=dev).T.contiguous()
        _, _, tr_k = fd.chain(inp, xc, 9, 20, collect_trace=True)
        _, _, tr_p = fd.chain_plain(inp, xc, 9, 20, collect_trace=True)
        prev_k = torch.cat([xc[None], tr_k[:-1]])
        prev_p = torch.cat([xc[None], tr_p[:-1]])
        dec_k = (tr_k != prev_k).any(dim=1)  # (K, N) accepted
        dec_p = (tr_p != prev_p).any(dim=1)
        flipped = dec_k != dec_p
        clean = ~flipped.any(dim=0)
        dx = float((tr_k - tr_p).abs()[:, :, clean].max())
        chain_cmp[name] = {"decisions": int(dec_k.numel()), "flips": int(flipped.sum()),
                           "max_abs_dx_unflipped": dx,
                           "accept": float(dec_k.float().mean())}
        _require(int(flipped.sum()) <= 5 and dx < 1e-2, f"chain {name}: {chain_cmp[name]}")
    report["chain_vs_plain"] = chain_cmp
    print("# chain kernel vs plain: " + json.dumps(chain_cmp), flush=True)

    inp_eval = fd.prepare(dyn, fd.energy_spec_for_target(target), params, dev)
    x0t = x0.T.contiguous()
    chain_ms = cuda_time(lambda: fd.chain(inp_eval, x0t, 2, eval_steps, True), 3)
    t = time.perf_counter()
    fd.chain_plain(inp_eval, x0t, 2, eval_steps, collect_trace=True)
    torch.cuda.synchronize()
    chain_plain_ms = 1e3 * (time.perf_counter() - t)
    chain_bound_ms, chain_bound_by = chain_bound(
        D, H, H2, T, cfg.n_chains, eval_steps, False, inp_eval.block().numel(), True)

    # -- 4. throughput at 8192 chains ----------------------------------------------
    n_tp, k_tp = 8192, 500
    xt = target.sample(gen(51), n_tp, device=dev)
    sampler.run(params, xt, seed=1, n_mh_steps=10)  # warm-up
    torch.cuda.synchronize()
    tp = Throughput(n_chains=n_tp, leapfrogs_per_step=2 * dyn.T, device=dev)
    sampler.run(params, xt, seed=2, n_mh_steps=k_tp)
    tp.tick(k_tp)
    report["throughput"] = {
        "n_chains": n_tp, "mh_steps": k_tp, "seconds": tp.elapsed,
        "mh_steps_per_s": tp.steps_per_sec,
        "chain_leapfrog_steps_per_s": tp.leapfrogs_per_sec,
    }
    print("# throughput: " + json.dumps(report["throughput"]), flush=True)

    # -- 5. the kernels line -------------------------------------------------------
    src = "l2hmc_tpu_torch/csrc/"
    kernels = [
        {"name": "trajectory", "route": "cuda", "source": src + "trajectory.cu",
         "replaces": "l2hmc_tpu/ops/fused_dynamics.py:645",
         "launches": launches["trajectory"],
         "max_abs_err": max(max(c["max_abs_err"].values()) for c in traj.values()),
         "ms": traj_ms, "plain_ms": traj_plain_ms, "bound_ms": traj_bound_ms,
         "bound_by": traj_bound_by, "library_ms": None,
         "shape": "SCG D=2 H=10 T=10, 2048 chains, one direction"},
        {"name": "chain", "route": "cuda", "source": src + "chain.cu",
         "replaces": "l2hmc_tpu/ops/fused_dynamics.py:1103",
         "launches": launches["chain"],
         "max_abs_err": max(c["max_abs_dx_unflipped"] for c in chain_cmp.values()),
         "ms": chain_ms, "plain_ms": chain_plain_ms, "bound_ms": chain_bound_ms,
         "bound_by": chain_bound_by, "library_ms": None,
         "shape": "SCG D=2 H=10 T=10, 1024 chains x 2000 MH steps, traced"},
    ]
    report["kernels"] = kernels
    print("# report: " + json.dumps(report))
    print(json.dumps({"kernels": kernels}))
    print(_nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_tree_map(fn, v) for v in tree)
    return fn(tree)


if __name__ == "__main__":
    try:
        rc = main()
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        rc = 1
    sys.exit(rc)
