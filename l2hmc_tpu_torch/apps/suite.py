"""Distribution-suite benchmark runner (counterpart of
``l2hmc_tpu/apps/suite.py``; BASELINE.json configs[1-2]): train and evaluate
L2HMC against a tuned HMC grid on each analytic target — the 50-d
ill-conditioned Gaussian, the rough well, the GMM ring and the Gaussian
funnel.

Usage:
    python -m l2hmc_tpu_torch.apps.suite --targets rough_well ring \\
        --n_chains 2048 --seed 42 --out suite.json
    python -m l2hmc_tpu_torch.apps.suite --targets ring --device cpu \\
        --n_chains 32 --n_steps 10 --eval_steps 30 --fused_hmc

Everything runs on ``--device`` (default ``cuda``). Two differences from the
JAX runner, by design:
  - No fallback. Whether the chain kernel can serve a row (its fused
    cross-check) is decided up front by a pure check
    (``ops.fused_dynamics.kernel_refusal``: hidden widths past 128, a
    ``net_input_fn``, ``eps_mat``, a target with no energy spec); a row it
    cannot serve records the reason as ``fused_cross_check``. A row it can
    serve runs the kernel's traced eval, and any failure raises. Past
    hidden 64 (icg's recipe; any row at ``hidden=100``) the eval runs on the
    kernel's site-parallel configuration, which takes every energy spec.
  - The fused cross-check runs on a CUDA device, as the JAX one runs on a
    TPU only. ``--fused_hmc`` runs wherever it is asked: through the chain
    kernel on the card, through its plain version (``chain_plain``) on the
    CPU.

mog2's recipe trains parallel-tempered (``pt_train_rungs``), which is not
ported: it raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from l2hmc_tpu_torch import targets as targets_lib
from l2hmc_tpu_torch.config import resolve_device
from l2hmc_tpu_torch.dynamics import Dynamics
from l2hmc_tpu_torch.ops import fused_dynamics as fd
from l2hmc_tpu_torch.train import (
    ScgConfig,
    build_dynamics,
    evaluate_ess,
    hmc_sample_chain,
    sample_chain,
    train,
)
from l2hmc_tpu_torch.train.optim import tree_leaves, tree_unflatten
from l2hmc_tpu_torch.utils import trace as profiler_trace


def _target_registry() -> dict[str, Callable]:
    return {
        "scg": lambda: targets_lib.scg_gaussian(),
        # the paper's protocol: variances log-spaced over four decades
        "icg": lambda: targets_lib.ill_conditioned_gaussian(50, 4.0),
        "rough_well": lambda: targets_lib.RoughWell(dim=10, eps=0.1),
        "ring": lambda: targets_lib.gen_ring(r=2.0, var=0.1, nb_mixtures=4),
        "mog2": lambda: targets_lib.mog2(distance=4.0, var=0.1),
        "funnel": lambda: targets_lib.GaussianFunnel(dim=10),
    }


# Per-target hyperparameters, the JAX runner's table (its comments give the
# measurements behind each recipe).
_TARGET_OVERRIDES: dict[str, dict] = {
    "scg": {"eps_mat": True, "whiten_full": True, "per_dim_loss": True,
            "autocorr_penalty": 200.0, "z_burn_in_loss": False},
    "icg": {"hidden": 100, "eps": 0.1, "hmc_eps": 0.15, "n_steps": 10000,
            "init_temperature": 5.0, "whiten_loss": True,
            "z_burn_in_loss": False, "accept_penalty": 20.0,
            "eps_dim": True, "eps_sigma_init": 0.1, "eps_trainable": True,
            "eps_unfreeze_step": 5000,
            "n_train_seeds": 4, "val_steps": 800},
    # the margin grows with the training batch: n_chains is part of it
    "rough_well": {"eps": 0.05, "hmc_eps": 0.03, "leapfrogs": 5,
                   "hidden": 20, "n_chains": 2048},
    "ring": {"init_temperature": 5.0, "hmc_eps": 0.25, "eps": 0.2,
             "n_train_seeds": 4},
    "mog2": {"init_temperature": 1.0, "pt_train_rungs": 8,
             "pt_train_tmax": 50.0, "pt_loss_all_rungs": True,
             "hmc_eps": 0.25, "eps": 0.3,
             "hidden": 20, "n_steps": 8000, "n_train_seeds": 4},
    "funnel": {"eps": 0.1, "hmc_eps": 0.05, "hidden": 20, "grad_clip": 5.0,
               "accept_penalty": 20.0, "n_train_seeds": 4,
               "net_input_target_fn": True},
}


_GLOBAL_DEFAULTS: dict = {
    "n_chains": 512,
    "n_steps": 5000,
    "leapfrogs": 10,
    "eval_steps": 2000,
    "hmc_eps": 0.15,
    "hidden": 10,
    "eps": 0.1,
    "init_temperature": 1.0,
    "grad_clip": 0.0,
    "select_best": True,
    "eps_trainable": True,
    "eps_dim": False,
    "z_burn_in_loss": True,
    "whiten_loss": False,
    "net_input_whiten": False,
    "net_input_target_fn": False,
    "scale": 0.1,
    "eps_step": False,
    "eps_sigma_init": 0.0,
    "accept_penalty": 0.0,
    "accept_target": 0.65,
    "alpha_lr_scale": 1.0,
    "eps_unfreeze_step": 0,
    "alpha_reg": 0.0,
    "per_dim_loss": False,
    "eps_mat": False,
    "eps_chol_init": 0.0,
    "whiten_full": False,
    "autocorr_penalty": 0.0,
    "hmc_mode": False,
    "pt_train_rungs": 0,
    "pt_train_tmax": 10.0,
    "pt_loss_all_rungs": False,
    "learning_rate": 1e-3,
    "n_train_seeds": 1,
    "val_steps": 500,
}

# ScgConfig fields that take the effective config's value of the same name
_SAME_NAME = (
    "eps", "init_temperature", "grad_clip", "select_best", "eps_trainable", "eps_dim",
    "eps_step", "eps_sigma_init", "accept_penalty", "accept_target", "alpha_lr_scale",
    "eps_unfreeze_step", "alpha_reg", "per_dim_loss", "eps_mat", "eps_chol_init",
    "whiten_full", "autocorr_penalty", "pt_train_rungs", "pt_train_tmax",
    "pt_loss_all_rungs", "learning_rate", "z_burn_in_loss", "whiten_loss",
    "net_input_whiten", "net_input_target_fn", "scale", "n_chains", "n_steps", "hidden",
)

# the HMC baseline's grid, as multiples of the configured eps
_HMC_GRID = (0.25, 0.5, 0.75, 1.5, 2.0, 3.0, 4.0)


class ParityCase(NamedTuple):
    target: Callable
    hidden: int  # S/T/Q nets' hidden width
    T: int
    eps: float
    hmc: bool
    n_chains: int  # the chains of the suite row that runs the case
    # a step size per dimension, eps times the target's standard deviation
    # in it (eps_dim, as the recipe's eps_sigma_init sets it)
    eps_dim: bool = False
    lift: float = 0.03  # added to every initial net weight


# The cases on which the card tests and chip_smoke.py hold each energy spec's
# kernels to their plain versions, at the suite's shapes. The ring takes the
# SCG lane configurations (D = 2, hidden 10), the others WideLanes; mog2
# runs HMC mode (zero nets), as the suite's HMC grid does, at that grid's
# count. The easy rough well: the hard one is float32-chaotic (a 1e-6
# perturbation grows ~1e3x over 3 steps) and is held statistically, by the
# suite path's ESS gap. The funnel starts chains past its clip on both sides
# (FUNNEL_PAST_CLIP), at a step its neck there keeps stable. icg at its
# recipe's widths (D = 50, hidden 100, the chain kernel's site-parallel
# configuration; the trajectory kernels stop at hidden 64, so it is a case
# of the chain kernel alone, TRAJECTORY_CASES the others) with per-dimension
# step sizes 0.02 sigma_i (0.002-0.2) and the weights lifted by 0.001: the
# recipe starts training at 0.1 sigma_i, where an untrained net of 100 units
# over inputs up to 10 wide accepts 0-1% of proposals (64 chains, 5 steps, on
# the CPU; 0.02 sigma_i and 0.001: 34%).
PARITY_CASES: dict[str, ParityCase] = {
    "rough_well_easy": ParityCase(
        lambda: targets_lib.RoughWell(dim=10, eps=0.1, easy=True), 20, 5, 0.05, False, 2048),
    "ring": ParityCase(
        lambda: targets_lib.gen_ring(r=2.0, var=0.1, nb_mixtures=4), 10, 10, 0.1, False, 2048),
    "funnel": ParityCase(lambda: targets_lib.GaussianFunnel(dim=10), 20, 10, 0.02, False, 512),
    "mog2_hmc": ParityCase(
        lambda: targets_lib.mog2(distance=4.0, var=0.1), 10, 10, 0.25, True, 2048),
    "icg": ParityCase(lambda: targets_lib.ill_conditioned_gaussian(50, 4.0), 100, 10, 0.02,
                      False, 2048, eps_dim=True, lift=0.001),
}
TRAJECTORY_CASES = ("rough_well_easy", "ring", "funnel", "mog2_hmc")


def two_component_mixture(dim: int) -> targets_lib.GMM:
    """A two-component Gaussian mixture in ``dim`` dimensions with full,
    unequal covariances (0.5 I + 0.5 A_k A_k^T / dim, A_k from a fixed numpy
    seed), means at +-1.5 / sqrt(dim) along the diagonal (3 apart, so that
    chains between the modes weigh both) and weights 0.4 and 0.6."""
    rng = np.random.default_rng(80)
    mus = np.stack([np.full(dim, 1.5), np.full(dim, -1.5)]) / np.sqrt(dim)
    a = rng.standard_normal((2, dim, dim)) / np.sqrt(dim)
    sigmas = 0.5 * np.eye(dim) + 0.5 * a @ np.swapaxes(a, 1, 2)
    return targets_lib.GMM(mus, sigmas, np.array([0.4, 0.6]))


# The energy specs past 64 wide, on the site-parallel configuration of
# kernels 1-3: the suite rows at icg's recipe width (hidden 100; the ring at
# D = 2, whose first layer and heads take 2 of a block's 256 threads), the
# rough well and the funnel at D = 100 (hidden 20, their recipes' width) and
# a two-component mixture at D = 80. The easy rough well, as in
# PARITY_CASES; the weights lifted by PARITY_LIFT_WIDE, which keeps S, T and
# Q O(0.1-1) over inputs 80-100 wide (0.03 drives the trajectories far).
PARITY_LIFT_WIDE = 0.003
WIDE_CASES: dict[str, ParityCase] = {
    "rough_well_h100": ParityCase(
        lambda: targets_lib.RoughWell(dim=10, eps=0.1, easy=True), 100, 5, 0.05, False, 2048,
        lift=PARITY_LIFT_WIDE),
    "ring_h100": ParityCase(
        lambda: targets_lib.gen_ring(r=2.0, var=0.1, nb_mixtures=4), 100, 10, 0.1, False, 2048,
        lift=PARITY_LIFT_WIDE),
    "rough_well_D100": ParityCase(
        lambda: targets_lib.RoughWell(dim=100, eps=0.1, easy=True), 20, 5, 0.05, False, 2048,
        lift=PARITY_LIFT_WIDE),
    "funnel_D100": ParityCase(lambda: targets_lib.GaussianFunnel(dim=100), 20, 10, 0.02, False,
                              512, lift=PARITY_LIFT_WIDE),
    "mixture_D80": ParityCase(lambda: two_component_mixture(80), 20, 10, 0.05, False, 512,
                              lift=PARITY_LIFT_WIDE),
}
FUNNEL_PAST_CLIP = (8.5, -8.5, 9.0, -9.0, 12.0, -12.0, 20.0, -20.0)
# Fused and plain training on the ring, two free runs of 1024 chains from one
# seed at the recipe's eps (0.2), agree to the SCG bar (rtol 2e-3, atol
# 1e-2) over this many steps and then part by the recipe's own dynamics: an
# accept within rounding flips, and Adam's sign-like update turns gradient
# rounding into parameter gaps of ~lr. Two plain routes on the CPU part the
# same way.
RING_FREE_STEPS = 10


def parity_inputs(case: str, n: int, device, seed: int = 0):
    """The kernel inputs (``fd.KernelInputs``) and (D, n) start states of a
    parity case, from ``seed``: the nets' initial weights lifted (by the
    case's ``lift``) so that no output is zero, states drawn from the
    target, and the funnel's
    first chains set past its clip with necks at the clipped scale. The
    case is one of PARITY_CASES or WIDE_CASES."""
    c = PARITY_CASES[case] if case in PARITY_CASES else WIDE_CASES[case]
    tgt = c.target()
    dyn, _ = build_dynamics(ScgConfig(dim=tgt.dim, hidden=c.hidden, T=c.T, hmc=c.hmc,
                                      eps_dim=c.eps_dim), tgt)
    eps = (c.eps * np.sqrt(np.diag(np.asarray(tgt.sigma))).astype(np.float32) if c.eps_dim
           else c.eps)
    params = dyn.init_params(_gen(seed), eps=eps, device=device)
    if not c.hmc:
        for net in ("xnet", "vnet"):
            params[net] = tree_unflatten(params[net],
                                         [a + c.lift for a in tree_leaves(params[net])])
    x = tgt.sample(_gen(seed + 1), n, device="cpu")
    if isinstance(tgt, targets_lib.GaussianFunnel):
        v = torch.tensor(FUNNEL_PAST_CLIP[:n])
        x[:len(v), 0] = v
        x[:len(v), 1:] = torch.exp(torch.clamp(v, -tgt.clip, tgt.clip) / 2)[:, None] * (
            torch.randn((len(v), tgt.dim - 1), generator=_gen(seed + 2)))
    inp = fd.prepare(dyn, fd.energy_spec_for_target(tgt), params, device)
    return inp, x.T.contiguous().to(device)


def effective_config(name: str, *, apply_overrides: bool = True, **hparams) -> dict:
    """Resolve per-target hyperparameters. Precedence (lowest to highest):
    global defaults, then the per-target ``_TARGET_OVERRIDES`` (skipped when
    ``apply_overrides=False``), then the keyword arguments given (``None``
    means "not given")."""
    unknown = set(hparams) - set(_GLOBAL_DEFAULTS)
    if unknown:
        raise TypeError(f"unknown hyperparameters: {sorted(unknown)}")
    ov = _TARGET_OVERRIDES.get(name, {}) if apply_overrides else {}
    return {
        **_GLOBAL_DEFAULTS,
        **ov,
        **{k: v for k, v in hparams.items() if v is not None},
    }


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_target(
    name: str,
    *,
    seed: int = 42,
    apply_overrides: bool = True,
    verbose: bool = True,
    profile_dir: str | None = None,
    fused_hmc: bool = False,
    device=None,
    **hparams,
) -> dict:
    """Train L2HMC on one suite target and compare its ESS against the best
    of a grid of plain HMC step sizes, on ``device`` (``cuda`` unless the
    caller says otherwise). The ESS is normalised by the target's
    covariance where it has one (``sigma``), else by the covariance of 20000
    exact samples. With ``n_train_seeds > 1`` each seed's sampler is scored
    on a validation chain and the best one evaluated. The result has the
    JAX runner's keys, and ``fused_cross_check``."""
    dev = resolve_device(device)
    eff = effective_config(name, apply_overrides=apply_overrides, **hparams)
    if verbose:
        print(f"[suite:{name}] effective config: "
              + " ".join(f"{k}={eff[k]}" for k in sorted(eff)))
    leapfrogs, eval_steps = eff["leapfrogs"], eff["eval_steps"]
    n_chains, hmc_eps = eff["n_chains"], eff["hmc_eps"]

    target = _target_registry()[name]()
    dim = target.dim

    def make_cfg(s):
        return ScgConfig(dim=dim, T=leapfrogs, seed=s, hmc=eff["hmc_mode"],
                         **{k: eff[k] for k in _SAME_NAME})

    cfg = make_cfg(seed)
    dynamics, _ = build_dynamics(cfg, target)
    refusal = fd.kernel_refusal(dynamics, target, eff["hidden"])
    if refusal is None and dev.type != "cuda":
        refusal = "the fused cross-check runs on a CUDA device"

    sigma = getattr(target, "sigma", None)
    if sigma is not None and np.asarray(sigma).ndim == 2:
        cov = np.asarray(sigma)
    else:
        cov = np.cov(target.sample(_gen(7), 20000, device="cpu").numpy().T)

    n_train_seeds = int(eff["n_train_seeds"])
    sel_seed = seed
    t0 = time.perf_counter()
    with profiler_trace(profile_dir):  # a no-op when profile_dir is None
        if n_train_seeds <= 1:
            state, history = train(cfg, target, device=dev)
        else:
            # train-and-select across seeds, scored on a held-out chain
            best = None
            for i in range(n_train_seeds):
                s = seed + 1000 * i
                state_i, history_i = train(make_cfg(s), target, device=dev)
                xv = target.sample(_gen(seed + 5), n_chains, device=dev)
                _, vtrace = sample_chain(dynamics, state_i.params, xv, int(eff["val_steps"]),
                                         _gen(seed + 6))
                val_ess = evaluate_ess(vtrace, cov)
                if verbose:
                    print(f"[suite:{name}] seed {s}: val ESS {val_ess:.4g}")
                if best is None or val_ess > best[0]:
                    best = (val_ess, state_i, history_i, s)
            _, state, history, sel_seed = best
            if verbose:
                print(f"[suite:{name}] selected training seed {sel_seed}")
        _sync(dev)
    train_time = time.perf_counter() - t0

    x0 = target.sample(_gen(seed + 1), n_chains, device=dev)
    t1 = time.perf_counter()
    _, trace = sample_chain(dynamics, state.params, x0, eval_steps, _gen(seed + 2))
    _sync(dev)
    eval_time = time.perf_counter() - t1
    ess_l2hmc = evaluate_ess(trace, cov)
    del trace

    # the chain kernel's traced eval beside the scored plain one: its ESS
    # is a statistical cross-check, and its time the single-launch eval's
    fused_extra: dict = {"fused_cross_check": refusal or "ran"}
    if refusal is None:
        sampler = fd.fused_chain_sampler(dynamics, target)
        sampler.run(state.params, x0, seed=seed, n_mh_steps=eval_steps)  # warm-up
        _sync(dev)
        t2 = time.perf_counter()
        _, _, ftrace = sampler.run(state.params, x0, seed=seed + 9, n_mh_steps=eval_steps,
                                   collect_trace=True)
        _sync(dev)
        fused_extra["eval_time_s_fused"] = time.perf_counter() - t2
        fused_extra["fused_n_devices"] = 1
        ess_fused = evaluate_ess(ftrace, cov)
        fused_extra["ess_l2hmc_fused_trace"] = ess_fused
        fused_extra["fused_ess_rel_gap"] = abs(ess_fused - ess_l2hmc) / max(ess_l2hmc, 1e-12)
        del ftrace

    # best against best: the HMC baseline's step size tuned over a grid,
    # each scored by ESS; the ratio at the configured eps is kept beside it
    grid = sorted({hmc_eps} | {hmc_eps * f for f in _HMC_GRID})
    hmc_ess_by_eps = {}
    if fused_hmc:
        # the whole grid through the chain kernel in HMC mode (zero nets,
        # exact leapfrog); the step size is a kernel input
        hdyn = Dynamics(dim=dim, energy=target.energy, grad_energy=target.grad_energy,
                        T=leapfrogs, hmc=True)
        hsampler = fd.fused_chain_sampler(hdyn, target)
        for i, e in enumerate(grid):
            hparams_e = hdyn.init_params(_gen(seed + 4), eps=float(e), device=dev)
            _, _, htrace = hsampler.run(hparams_e, x0, seed=seed + 100 + i,
                                        n_mh_steps=eval_steps, collect_trace=True)
            hmc_ess_by_eps[round(float(e), 4)] = evaluate_ess(htrace, cov)
    else:
        for i, e in enumerate(grid):
            _, hmc_trace = hmc_sample_chain(target, float(e), leapfrogs, x0, eval_steps,
                                            _gen(seed + 3 + 100 * i))
            hmc_ess_by_eps[round(float(e), 4)] = evaluate_ess(hmc_trace, cov)
    best_eps, ess_hmc = max(hmc_ess_by_eps.items(), key=lambda kv: kv[1])
    ess_hmc_ref = hmc_ess_by_eps[round(float(hmc_eps), 4)]

    return {
        "target": name,
        "dim": dim,
        "n_chains": n_chains,
        "ess_l2hmc": ess_l2hmc,
        "ess_hmc": ess_hmc,
        "ess_hmc_at_config_eps": ess_hmc_ref,
        "hmc_best_eps": best_eps,
        "hmc_ess_by_eps": hmc_ess_by_eps,
        "ess_ratio": ess_l2hmc / max(ess_hmc, 1e-12),
        "ess_ratio_at_config_eps": ess_l2hmc / max(ess_hmc_ref, 1e-12),
        # as the JAX runner's: the grid went through the kernel
        "hmc_grid_fused": fused_hmc and dev.type == "cuda",
        "final_accept": float(np.mean(history["p_accept"][-100:])),
        "n_train_seeds": n_train_seeds,
        "selected_seed": sel_seed,
        "train_time_s": train_time,
        "eval_time_s": eval_time,
        "mh_steps_per_sec_eval": eval_steps / eval_time,
        **fused_extra,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--targets", nargs="*", default=["scg", "icg", "rough_well", "ring"],
                   choices=sorted(_target_registry()))
    # default None: only flags given override the per-target table
    p.add_argument("--n_chains", type=int, default=None)
    p.add_argument("--n_steps", type=int, default=None)
    p.add_argument("--leapfrogs", type=int, default=None)
    p.add_argument("--eval_steps", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of each target's training here")
    p.add_argument("--fused_hmc", action="store_true",
                   help="run the HMC baseline grid through the chain kernel "
                        "(zero nets, exact leapfrog)")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    results = []
    for name in args.targets:
        r = run_target(
            name, n_chains=args.n_chains, n_steps=args.n_steps, leapfrogs=args.leapfrogs,
            eval_steps=args.eval_steps, seed=args.seed, fused_hmc=args.fused_hmc,
            device=args.device,
            profile_dir=f"{args.profile_dir}/{name}" if args.profile_dir else None,
        )
        print(json.dumps(r), flush=True)
        results.append(r)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
