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
  5. training: (a) the backward-trajectory kernel vs its plain version
     (SCG at 2048 and 200 chains, the 50-d ill-conditioned Gaussian with
     eps_dim and input_scale, HMC mode; both directions; per leaf within
     1e-4 of the leaf's largest entry); (b) 20 training steps at 1024
     chains with fused_train=True vs False on one seed, loss histories
     within rtol 2e-3, atol 1e-2; (c) the training path: ``train`` with
     fused_train=True, 1024 chains, TRAIN_STEPS steps, then the 2000-step
     traced eval of the trained sampler and of HMC at eps 0.15 through the
     chain kernel; the ESS ratio must exceed 1.2, the final loss be finite
     and the final acceptance lie in (0.1, 1). Launch counts are reset
     before (c) and read after it;
  6. the VAE application at the full width of the reference model (latent
     50, decoder 50-1024-1024-784, aux encoder 784-512-512-200, S/T/Q nets
     200/200, 5 leapfrogs), weights seeded and lifted (``lift_vae_params``),
     data from ``apps.data.get_data()``: (a) the sampler kernel vs its plain
     version on the same Philox bits (203 and 256 chains, 3 recorded steps,
     single and composed ops, with trace); (b) the AIS kernel vs its plain
     version (1000 chains, 20 anneal steps, 10 leapfrogs); (c) the sampling
     path: ``apps.eval_sampler.run`` with the default protocol (200 chains,
     2000 recorded steps of 1-3 ops, the seven-eps HMC grid), its posterior
     moments held against a plain ``vae_chain_plain`` run with its own
     stream; (d) the AIS path: ``apps.eval_vae.run`` with the default
     protocol on 100 datapoints, held against the same entry point with
     ``use_fused="never"`` (the ``ais_estimate`` loop). Launch counts are
     reset before (c) and before (d) and read after each;
  7. kernel times, plain times and bounds.

Prints a ``kernels`` JSON line, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, without a CUDA device, without the port beside it, or when any
check fails. The full report is printed as a ``# report:`` JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

# Published peaks of one H100 SXM at 700 W (NVIDIA data sheet): float32
# outside the tensor cores, and HBM3 bandwidth.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
TRAJ_TOL = 5e-4  # bench.py's compiled-parity gate
ESS_GAP = 0.30  # bench.py's fused-trace vs non-kernel ESS tolerance
BWD_TOL = 1e-4  # per leaf, of the leaf's largest entry: sums over chains in another order
TRAIN_STEPS = 5000  # the notebook's training length (SCGExperiment.ipynb cell 12)
MIN_ESS_RATIO = 1.2  # the JAX package's short-run bar (tests/test_train_scg.py)
# VAE kernels against their plain versions on the same Philox bits. A flipped
# accept needs |px - u| inside the float32 gap of two Hamiltonians near 1e3
# (~1e-4), so at most VAE_FLIPS chains may differ in a decision; the others
# agree to VAE_CHAIN_TOL in state (sums of 1024 terms in another order,
# through up to 9 trajectories) and to VAE_AIS_TOL in log w (values near 1e3).
VAE_FLIPS = 2
VAE_CHAIN_TOL = 2e-3
VAE_AIS_TOL = 5e-3
# The fused trace's posterior moments per latent against a plain run with its
# own stream (two finite samples of one posterior): means within
# VAE_MEAN_TOL posterior standard deviations, variances within a factor
# 1 +- VAE_VAR_TOL.
VAE_PLAIN_STEPS, VAE_PLAIN_BURN_IN = 240, 80
VAE_MEAN_TOL = 0.1
VAE_VAR_TOL = 0.15
# eval_vae.run through the AIS kernel against the ais_estimate loop on the
# same datapoints and start states, each with its own momentum and accept
# stream: nats per datapoint on values near -700, whose spread over seeds is
# 0.04 on either route (8 seeds each, H100).
VAE_LL_TOL = 0.25


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


def traj_bwd_bound(D, H, H2, T, N, hmc, block_floats, n_grads):
    """The VJP of a trajectory: about three forward trajectories of
    operations (forward, and backward through each matrix product twice),
    plus the sum of n_grads cotangents over the N chains."""
    ops = 3 * N * T * _substep_ops(D, H, H2, hmc) + n_grads * N
    nbytes = 4 * (4 * D * N + N + block_floats + 2 * D * N + n_grads)
    return _bound(ops, nbytes)


def chain_bound(D, H, H2, T, N, K, hmc, block_floats, trace: bool):
    philox = (1 + (D + 1) // 2) * 10 * 8  # calls x rounds x integer ops
    per_step = (T * _substep_ops(D, H, H2, hmc) + 2 * _energy_ops(D) + 4 * D
                + philox + 6 * D + 8)
    ops = N * K * per_step
    nbytes = 4 * (D * N + D * N + N + block_floats + (K * D * N if trace else 0))
    return _bound(ops, nbytes)


def _decoder_grad_ops(D, E, P):
    """One energy-and-gradient sweep of the decoder posterior per chain: the
    three products forward and their transposes back, the two softplus
    layers with their sigmoids, the BCE terms and the prior."""
    return 4 * (D * E + E * E + E * P) + 2 * E * 10 + P * 14 + 4 * D


def vae_chain_bound(D, H, H2, T, E, P, N, K, total_ops, weight_floats, trace: bool):
    """The sampler kernel's least work: ``total_ops`` MH ops (this run's nb
    sequence summed), each T decoder sweeps (the gradient at the end of one
    leapfrog step is the first of the next, the energy comes with it) and
    4 T aux-conditioned net applications, plus the start state's sweep."""
    philox = (1 + (D + 1) // 2) * 10 * 8
    per_op = (T * (_decoder_grad_ops(D, E, P) + 4 * (_stq_ops(D, H, H2) + H) + 4 * 12 * D)
              + philox + 10 * D + 8)
    ops = N * (total_ops * per_op + _decoder_grad_ops(D, E, P))
    nbytes = 4 * (D * N + P * N + H * N + weight_floats + K + D * N + N
                  + (K * D * N if trace else 0))
    return _bound(ops, nbytes)


def vae_ais_bound(D, E, P, N, K, L, weight_floats):
    """The AIS kernel's least work: K anneal steps of L decoder sweeps, the
    leapfrog updates, the draws and the accept, plus the start state's
    sweep."""
    philox = (1 + (D + 1) // 2) * 10 * 8
    per_step = L * (_decoder_grad_ops(D, E, P) + 10 * D) + philox + 10 * D + 12
    ops = N * (K * per_step + _decoder_grad_ops(D, E, P))
    nbytes = 4 * (D * N + P * N + weight_floats + K + 2 * N)
    return _bound(ops, nbytes)


def _bound(ops, nbytes):
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_BYTES
    if t_ops >= t_bytes:
        return 1e3 * t_ops, "operations"
    return 1e3 * t_bytes, "bytes"


def _cuda_time(fn, reps):
    """Mean ms of ``fn()`` over ``reps`` runs by CUDA events, after one
    warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _gen(seed):
    import torch

    return torch.Generator().manual_seed(seed)


def lift_vae_params(params):
    """The seeded VAE weights, lifted so that the check is not hollow:
      - the decoder's last layer is initialised with factor 0.01 (logits
        ~0.2), so its weights are multiplied by 10: logits of standard
        deviation ~2 and a posterior well apart from the prior;
      - the aux embedding already drives S, T, Q to ~0.2 at init; the three
        heads' weights are multiplied by 0.3 (S, T, Q ~0.15), which keeps
        the untrained sampler's acceptance well inside (0, 1);
      - the encoder's log-sigma head is multiplied by 0.1: an untrained
        encoder starts some latent with a standard deviation above 10, far
        out where the untrained nets' unbounded T head has every proposal
        rejected, so the chains would not reach the posterior at this depth.
    """
    def scaled(lin, c):
        return {"w": lin["w"] * c, "b": lin["b"]}

    def heads(net):
        (s_lin, s_st), t_lin, (q_lin, q_st) = net[5]
        return (*net[:5], ((scaled(s_lin, 0.3), s_st), scaled(t_lin, 0.3),
                           (scaled(q_lin, 0.3), q_st)))

    smp = dict(params["smp"])
    smp["xnet"], smp["vnet"] = heads(smp["xnet"]), heads(smp["vnet"])
    dec = (*params["dec"][:4], scaled(params["dec"][4], 10.0))
    mu_lin, log_sigma_lin = params["enc"][4]
    enc = (*params["enc"][:4], (mu_lin, scaled(log_sigma_lin, 0.1)))
    return {**params, "enc": enc, "smp": smp, "dec": dec}


def vae_phases(dev, report, logdir):
    """Phase 6: the VAE kernels against their plain versions, the two VAE
    paths through their entry points, and the two kernels' rows of the
    ``kernels`` line."""
    import numpy as np
    import torch

    from l2hmc_tpu_torch.apps import data as data_lib
    from l2hmc_tpu_torch.apps import eval_sampler, eval_vae, vae
    from l2hmc_tpu_torch.ops import fused_dynamics as fd
    from l2hmc_tpu_torch.ops import fused_vae as fv

    t_phase = time.perf_counter()
    model = vae.VaeModel.build(vae.VaeConfig())
    params = lift_vae_params(model.init_params(_gen(0), device=dev))
    dataset = data_lib.get_data()
    dyn = model.dynamics
    D, T = dyn.dim, dyn.T
    x_test = data_lib.binarize(np.random.default_rng(0), dataset.test)
    dec = fv.decoder_arrays(params["dec"])
    E, P = dec[0].shape[0], dec[4].shape[0]
    dec_floats = sum(a.numel() for a in dec)

    def batch(n):
        """n test images (cycled), their embedding and a N(0, I) start."""
        x = torch.as_tensor(x_test[np.arange(n) % len(x_test)], device=dev)
        with torch.no_grad():
            emb = model.aux_encoder.apply(params["smp"]["aux_enc"], x)
        z = torch.randn((n, D), generator=_gen(n)).to(dev)
        return x.T.contiguous(), emb.T.contiguous(), z.T.contiguous()

    with torch.no_grad():
        xr, embT, zT = batch(256)
        inp = fv.prepare_vae(dyn, params["smp"], params["dec"], xr, embT)
        logits = model.decoder.apply(params["dec"], zT.T)
        stq = fd._apply_stq(inp.vnet_w, zT, inp.grad_energy(zT), 0, False, inp.emb)
    report["vae_weights"] = {
        "data_source": dataset.source, "logit_std": float(logits.std()),
        "vnet_S_T_Q_std": [float(a.std()) for a in stq],
        "energy_mean": float(inp.energy(zT).mean()),
    }
    print("# VAE weights: " + json.dumps(report["vae_weights"]), flush=True)
    H, H2 = inp.dims[1], inp.dims[2]
    net_floats = sum(w.numel() for w in [*inp.xnet_w, *inp.vnet_w]) + D + D * T

    # (a) sampler kernel vs plain on the same bits
    chain_cmp = {}
    for n in (203, 256):
        xr, embT, zT = batch(n)
        inp = fv.prepare_vae(dyn, params["smp"], params["dec"], xr, embT)
        for name, nb in (("single", None), ("composed", [2, 1, 3])):
            zk, acck, trk = fv.vae_chain(inp, xr, zT, seed=4, n_mh_steps=3,
                                         collect_trace=True, nb=nb)
            zp, accp, trp = fv.vae_chain_plain(inp, zT, seed=4, n_mh_steps=3,
                                               collect_trace=True, nb=nb)
            ops = 3 if nb is None else sum(nb)
            flipped = (acck - accp).abs()[0] * ops > 0.5
            dz = float((trk - trp).abs()[:, :, ~flipped].max())
            case = {"flips": int(flipped.sum()), "max_abs_dz_unflipped": dz,
                    "accept": float(acck.mean()),
                    "moved": float((zk - zT).abs().max())}
            chain_cmp[f"n{n}_{name}"] = case
            _require(bool(torch.isfinite(trk).all()), f"vae_chain {n} {name}: non-finite trace")
            _require(bool((trk[-1] == zk).all()), f"vae_chain {n} {name}: trace end != state")
            _require(case["flips"] <= VAE_FLIPS and dz < VAE_CHAIN_TOL,
                     f"vae_chain {n} {name}: {case}")
            _require(case["moved"] > 0.05, f"vae_chain {n} {name}: the chains did not move")
    report["vae_chain_vs_plain"] = chain_cmp
    print(f"# VAE sampler kernel vs plain ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(chain_cmp), flush=True)

    # (b) AIS kernel vs plain on the same bits
    t_phase = time.perf_counter()
    n_ais, k_ais, l_ais = 1000, 20, 10
    xr, _, zT = batch(n_ais)
    wk, acck = fv.vae_ais(dec, xr, zT, seed=6, anneal_steps=k_ais, step_size=0.05,
                          leapfrogs=l_ais)
    wp, accp = fv.vae_ais_plain(dec, xr, zT, seed=6, anneal_steps=k_ais, step_size=0.05,
                                leapfrogs=l_ais)
    clean = (wk - wp).abs()[0] < 0.05
    ais_cmp = {
        "chains": n_ais, "anneal_steps": k_ais, "leapfrogs": l_ais,
        "flipped_chains": int((~clean).sum()),
        "max_abs_dlogw_unflipped": float((wk - wp).abs()[:, clean].max()),
        "max_abs_daccept_unflipped": float((acck - accp).abs()[:, clean].max()),
        "logw_mean": float(wk.mean()), "accept": float(acck.mean()),
    }
    report["vae_ais_vs_plain"] = ais_cmp
    print(f"# AIS kernel vs plain ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(ais_cmp), flush=True)
    _require(bool(torch.isfinite(wk).all()), "vae_ais: non-finite log w")
    _require(ais_cmp["flipped_chains"] <= VAE_FLIPS
             and ais_cmp["max_abs_dlogw_unflipped"] < VAE_AIS_TOL
             and ais_cmp["max_abs_daccept_unflipped"] < VAE_AIS_TOL, f"vae_ais: {ais_cmp}")

    # (c) the sampling path
    fd.reset_launch_counts()
    t_phase = time.perf_counter()
    scfg = eval_sampler.EvalSamplerConfig()
    curves = eval_sampler.run(model, params, scfg, dataset, seed=0)
    torch.cuda.synchronize()
    sampling_s = time.perf_counter() - t_phase
    sampling_launches = dict(fd.LAUNCHES)
    trace = curves["trace"]
    post = trace[scfg.burn_in:]
    moved = float((trace[1:] != trace[:-1]).any(dim=2).float().mean())

    # the same posterior through the plain version, its own stream and depth
    t_plain = time.perf_counter()
    with torch.no_grad():
        x0, emb, z0 = eval_sampler.protocol_inputs(model, params, scfg, dataset, 0, dev)
        x0T, z0T = x0.T.contiguous(), z0.T.contiguous()
        inp = fv.prepare_vae(dyn, params["smp"], params["dec"], x0T, emb.T.contiguous())
        nb_plain = fv.composition_counts(_gen(7), VAE_PLAIN_STEPS, scfg.max_composition)
        _, acc_plain, trace_plain = fv.vae_chain_plain(
            inp, z0T, seed=99, n_mh_steps=VAE_PLAIN_STEPS, collect_trace=True, nb=nb_plain)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t_plain
    post_plain = trace_plain[VAE_PLAIN_BURN_IN:].permute(0, 2, 1)
    mu_f, mu_p = post.mean(dim=(0, 1)), post_plain.mean(dim=(0, 1))
    var_f, var_p = post.var(dim=(0, 1)), post_plain.var(dim=(0, 1))
    mean_gap = float(((mu_f - mu_p).abs() / var_p.sqrt()).max())
    var_gap = float((var_f / var_p - 1.0).abs().max())
    hmc_curves = curves["hmc"]
    report["vae_sampling_path"] = {
        "n_chains": scfg.n_chains, "n_steps": scfg.n_steps, "burn_in": scfg.burn_in,
        "max_composition": scfg.max_composition, "hmc_eps_grid": list(scfg.hmc_eps_grid),
        "data_source": curves["data_source"], "weights": "seeded, untrained, lifted",
        "moved_per_recorded_step": moved,
        "autocov_trained_lag_0_1_10_100": [float(curves["trained"][i]) for i in (0, 1, 10, 100)],
        "autocov_hmc_lag_10": {str(e): float(c[10]) for e, c in hmc_curves.items()},
        "posterior_mean_abs_max": float(mu_f.abs().max()),
        "posterior_var_min_max": [float(var_f.min()), float(var_f.max())],
        "start_var_max": float(z0.var(dim=0).max()),
        "between_chain_var_max": float(post.mean(dim=0).var(dim=0).max()),
        "plain_steps": VAE_PLAIN_STEPS, "plain_burn_in": VAE_PLAIN_BURN_IN,
        "plain_accept": float(acc_plain.mean()), "plain_s": plain_s,
        "mean_gap_in_sd": mean_gap, "var_rel_gap": var_gap,
        "wall_s": sampling_s, "launches": sampling_launches,
    }
    print(f"# VAE sampling path ({sampling_s:.1f} s, plain comparison {plain_s:.1f} s): "
          + json.dumps(report["vae_sampling_path"]), flush=True)
    _require(trace.shape == (scfg.n_steps, scfg.n_chains, D), "VAE trace shape")
    _require(bool(torch.isfinite(trace).all()), "non-finite VAE trace")
    _require(bool(np.isfinite(curves["trained"]).all())
             and all(bool(np.isfinite(c).all()) for c in hmc_curves.values()),
             "non-finite autocovariance curve")
    _require(len(hmc_curves) == len(scfg.hmc_eps_grid), "HMC grid incomplete")
    _require(sampling_launches["vae_chain"] > 0, "kernel vae_chain not launched on the sampling path")
    _require(0.0 < moved < 1.0, f"VAE sampler moved in a share {moved} of the recorded steps")
    _require(mean_gap < VAE_MEAN_TOL and var_gap < VAE_VAR_TOL,
             f"fused and plain posterior moments differ: mean {mean_gap} sd, var {var_gap}")

    # (d) the AIS path
    fd.reset_launch_counts()
    t_phase = time.perf_counter()
    acfg = eval_vae.EvalVaeConfig()
    n_data = 100
    ll_fused = eval_vae.run(model, params, acfg, dataset, seed=0, max_datapoints=n_data,
                            logdir=logdir)
    torch.cuda.synchronize()
    ais_s = time.perf_counter() - t_phase
    ais_launches = dict(fd.LAUNCHES)
    t_plain = time.perf_counter()
    ll_plain = eval_vae.run(model, params, acfg, dataset, seed=0, max_datapoints=n_data,
                            use_fused="never")
    torch.cuda.synchronize()
    ais_plain_s = time.perf_counter() - t_plain
    report["vae_ais_path"] = {
        "datapoints": n_data, "chains_per_datapoint": acfg.chains_per_datapoint,
        "anneal_steps": acfg.anneal_steps, "leapfrogs": acfg.leapfrogs,
        "step_size": acfg.step_size, "weights": "seeded, untrained, lifted",
        "log_likelihood_fused": ll_fused, "log_likelihood_ais_estimate": ll_plain,
        "wall_s": ais_s, "ais_estimate_s": ais_plain_s, "launches": ais_launches,
    }
    print(f"# VAE AIS path ({ais_s:.1f} s, ais_estimate {ais_plain_s:.1f} s): "
          + json.dumps(report["vae_ais_path"]), flush=True)
    _require(np.isfinite(ll_fused) and np.isfinite(ll_plain), "non-finite AIS estimate")
    with open(os.path.join(logdir, f"{acfg.split}_ll.txt")) as f:
        _require(float(f.read().split()[-1]) == ll_fused, "eval_vae did not record its estimate")
    _require(ais_launches["vae_ais"] > 0, "kernel vae_ais not launched on the AIS path")
    _require(abs(ll_fused - ll_plain) < VAE_LL_TOL,
             f"AIS kernel estimate {ll_fused} vs ais_estimate {ll_plain}")

    # times at the paths' shapes; the plain sampler over the first 20 steps
    t_phase = time.perf_counter()
    sampler = fv.FusedVaeSampler(dyn)
    nb_path = fv.composition_counts(_gen(1), scfg.n_steps, scfg.max_composition)

    def chain_run(steps):
        return fv.vae_chain(inp, x0T, z0T, seed=13, n_mh_steps=steps, collect_trace=True,
                            nb=nb_path[:steps])

    plain_steps = 20
    chain_k20_ms = _cuda_time(lambda: chain_run(plain_steps), 2)
    chain_ms = _cuda_time(lambda: chain_run(scfg.n_steps), 1)
    chain_plain_ms = _cuda_time(
        lambda: fv.vae_chain_plain(inp, z0T, seed=13, n_mh_steps=plain_steps,
                                   collect_trace=True, nb=nb_path[:plain_steps]), 1)
    _, acc_direct = sampler.run(params["smp"], params["dec"], x0, emb, z0, seed=13,
                                n_mh_steps=100, max_composition=scfg.max_composition,
                                comp_key=nb_path[:100])
    _require(0.0 < float(acc_direct.mean()) < 1.0,
             f"VAE sampler acceptance {float(acc_direct.mean())} over 100 recorded steps")
    chain_bound_ms, chain_bound_by = vae_chain_bound(
        D, H, H2, T, E, P, scfg.n_chains, scfg.n_steps, int(nb_path.sum()),
        dec_floats + net_floats, True)

    n_path = acfg.chains_per_datapoint * acfg.num_splits
    xr, _, zT = batch(n_path)

    def ais_run(fn):
        return fn(dec, xr, zT, seed=3, anneal_steps=acfg.anneal_steps,
                  step_size=acfg.step_size, leapfrogs=acfg.leapfrogs)

    ais_ms = _cuda_time(lambda: ais_run(fv.vae_ais), 2)
    ais_plain_ms = _cuda_time(lambda: ais_run(fv.vae_ais_plain), 1)
    ais_bound_ms, ais_bound_by = vae_ais_bound(
        D, E, P, n_path, acfg.anneal_steps, acfg.leapfrogs, dec_floats)

    # yardstick: one plain gradient (six torch.matmul) at the paths' chain counts
    grad_ms = {}
    for n, x_, z_ in ((scfg.n_chains, x0T, z0T), (n_path, xr, zT)):
        _, grad = fv._vae_decoder_closures(dec, x_)
        grad_ms[n] = _cuda_time(lambda: grad(z_), 50)
    sweeps_chain = int(nb_path.sum()) * T + 1
    sweeps_ais = (n_data // acfg.num_splits) * (acfg.anneal_steps * acfg.leapfrogs + 1)
    report["vae_times"] = {
        "vae_chain_ms": chain_ms, "vae_chain_ops": int(nb_path.sum()),
        "vae_chain_ms_per_op": chain_ms / int(nb_path.sum()),
        "vae_chain_accept_first_100_steps": float(acc_direct.mean()),
        "vae_ais_ms": ais_ms,
        "plain_grad_energy_ms": {str(n): t for n, t in grad_ms.items()},
        "decoder_sweeps_sampling_path": sweeps_chain,
        "plain_grads_sampling_path_ms": sweeps_chain * grad_ms[scfg.n_chains],
        "decoder_sweeps_ais_path": sweeps_ais,
        "plain_grads_ais_path_ms": sweeps_ais * grad_ms[n_path],
    }
    print(f"# VAE kernel times ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(report["vae_times"]), flush=True)

    src = "l2hmc_tpu_torch/csrc/"
    return [
        {"name": "vae_chain", "route": "cuda", "source": src + "vae_chain.cu",
         "replaces": "l2hmc_tpu/ops/fused_dynamics.py:1399",
         "launches": sampling_launches["vae_chain"],
         "max_abs_err": max(c["max_abs_dz_unflipped"] for c in chain_cmp.values()),
         "ms": chain_ms, "plain_ms": chain_plain_ms, "bound_ms": chain_bound_ms,
         "bound_by": chain_bound_by, "library_ms": None,
         "shape": (f"VAE latent {D}, decoder {E}, nets {H}/{H2}, T={T}, {scfg.n_chains} chains x "
                   f"{scfg.n_steps} recorded steps ({int(nb_path.sum())} MH ops), traced; "
                   f"plain_ms over the first {plain_steps} steps "
                   f"({int(nb_path[:plain_steps].sum())} ops; kernel over the same: "
                   f"{chain_k20_ms:.2f} ms)")},
        {"name": "vae_ais", "route": "cuda", "source": src + "vae_ais.cu",
         "replaces": "l2hmc_tpu/ops/fused_dynamics.py:2083",
         "launches": ais_launches["vae_ais"],
         "max_abs_err": ais_cmp["max_abs_dlogw_unflipped"],
         "ms": ais_ms, "plain_ms": ais_plain_ms, "bound_ms": ais_bound_ms,
         "bound_by": ais_bound_by, "library_ms": None,
         "shape": (f"VAE latent {D}, decoder {E}, {n_path} chains x {acfg.anneal_steps} "
                   f"anneal steps x {acfg.leapfrogs} leapfrogs (one AIS batch)")},
    ]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from l2hmc_tpu_torch import targets
        from l2hmc_tpu_torch.ops import _cuda
        from l2hmc_tpu_torch.ops import fused_dynamics as fd
        from l2hmc_tpu_torch.train import (
            ScgConfig, build_dynamics, evaluate_ess, sample_chain, train,
        )
        from l2hmc_tpu_torch.train.optim import tree_leaves
        from l2hmc_tpu_torch.utils import Throughput
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}", file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    report = {"torch": torch.__version__, "cuda": torch.version.cuda}
    smi = _nvidia_smi()
    print(f"# card: {smi}", flush=True)
    report["card"] = smi

    def perturb(params):
        """Deterministic lift of every net weight by 0.03, so S/T/Q are
        O(0.1-1) (at init the 0.001 head factor makes them ~0)."""
        out = dict(params)
        for net in ("xnet", "vnet"):
            out[net] = _tree_map(lambda a: a + 0.03, params[net])
        return out

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
    params = dyn.init_params(_gen(cfg.seed), eps=cfg.eps, device=dev)
    eval_steps, hmc_eps = 2000, 0.15
    hmc_dyn, _ = build_dynamics(ScgConfig(hmc=True), target)
    hmc_params = hmc_dyn.init_params(_gen(0), eps=hmc_eps, device=dev)

    # -- 1. main path --------------------------------------------------------------
    fd.reset_launch_counts()
    t_main = time.perf_counter()
    fused = fd.fused_for_target(dyn, target)
    xg = target.sample(_gen(11), 2048, device=dev)
    vg = torch.randn(xg.shape, generator=_gen(12)).to(dev)
    gate_err = 0.0
    for direction in ("forward", "backward"):
        ref = getattr(dyn, direction)(params, xg, vg)
        got = getattr(fused, direction)(params, xg, vg)
        gate_err = max(gate_err, *(float((a - b).abs().max()) for a, b in zip(got, ref)))
    _require(gate_err < TRAJ_TOL, f"parity gate: fused trajectory off by {gate_err}")

    x0 = target.sample(_gen(cfg.seed + 1), cfg.n_chains, device=dev)
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
    _, trace_plain = sample_chain(dyn, params, x0, eval_steps, _gen(cfg.seed + 2))
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
    t_phase = time.perf_counter()
    icg = targets.ill_conditioned_gaussian(50)
    icg_cfg = ScgConfig(dim=50, eps_dim=True, net_input_whiten=True)
    icg_dyn, _ = build_dynamics(icg_cfg, icg)
    icg_eps = torch.as_tensor(0.1 * (icg.sigma.diagonal() ** 0.5), dtype=torch.float32)
    icg_params = perturb(icg_dyn.init_params(_gen(5), eps=icg_eps, device=dev))
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
        x = tg.sample(_gen(21), n, device=dev).T.contiguous()
        v = torch.randn(x.shape, generator=_gen(22)).to(dev)
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
    print(f"# trajectory kernel vs plain ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(traj), flush=True)

    inp_scg = fd.prepare(dyn, fd.energy_spec_for_target(target), scg_params, dev)
    xs = target.sample(_gen(31), 2048, device=dev).T.contiguous()
    vs = torch.randn(xs.shape, generator=_gen(32)).to(dev)
    traj_ms = _cuda_time(lambda: fd.trajectory(inp_scg, xs, vs, False), 50)
    traj_plain_ms = _cuda_time(lambda: fd.trajectory_plain(inp_scg, xs, vs, False), 5)
    D, H, H2, T = inp_scg.dims
    traj_bound_ms, traj_bound_by = traj_bound(D, H, H2, T, 2048, False, inp_scg.block().numel())

    # -- 3. chain kernel vs plain on the same Philox bits ---------------------------
    # Tolerance: the kernel and its plain version draw identical bits, so an
    # accept decision can differ only where px - u is within the few-ulp gap
    # of the two float32 Hamiltonians (~1e-6), expected well under one flip in
    # 20480 decisions: at most 5 flips are allowed. On chains with no flip the
    # states may differ by the per-trajectory tolerance compounded over 20
    # trajectories: 20 x 5e-4 = 1e-2.
    t_phase = time.perf_counter()
    chain_cmp = {}
    for name, d_, p_ in (("l2hmc", dyn, scg_params), ("hmc", hmc_dyn, hmc_params)):
        inp = fd.prepare(d_, fd.energy_spec_for_target(target), p_, dev)
        xc = target.sample(_gen(41), 1024, device=dev).T.contiguous()
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

    # The plain chain is a yardstick of correctness, not of speed, and takes
    # tens of ms per MH step: it is timed over 100 MH steps, not 2000.
    inp_eval = fd.prepare(dyn, fd.energy_spec_for_target(target), params, dev)
    x0t = x0.T.contiguous()
    chain_ms = _cuda_time(lambda: fd.chain(inp_eval, x0t, 2, eval_steps, True), 3)
    plain_steps = 100
    chain_k100_ms = _cuda_time(lambda: fd.chain(inp_eval, x0t, 2, plain_steps, True), 3)
    t = time.perf_counter()
    fd.chain_plain(inp_eval, x0t, 2, plain_steps, collect_trace=True)
    torch.cuda.synchronize()
    chain_plain_ms = 1e3 * (time.perf_counter() - t)
    chain_bound_ms, chain_bound_by = chain_bound(
        D, H, H2, T, cfg.n_chains, eval_steps, False, inp_eval.block().numel(), True)
    print(f"# chain kernel vs plain ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(chain_cmp), flush=True)

    # -- 4. throughput at 8192 chains ----------------------------------------------
    t_phase = time.perf_counter()
    n_tp, k_tp = 8192, 500
    xt = target.sample(_gen(51), n_tp, device=dev)
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
    print(f"# throughput ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(report["throughput"]), flush=True)

    # -- 5. training -----------------------------------------------------------------
    # (a) backward-trajectory kernel vs its plain version, on phase 2's cases
    t_phase = time.perf_counter()
    bwd = {}
    for name, d_, tg, p_, n in cases:
        inp = fd.prepare(d_, fd.energy_spec_for_target(tg), p_, dev)
        g = _gen(61)
        x = tg.sample(_gen(21), n, device=dev).T.contiguous()
        v, dX, dV = (torch.randn(x.shape, generator=g).to(dev) for _ in range(3))
        dld = torch.randn((1, n), generator=g).to(dev)
        case = {}
        for reverse in (False, True):
            got = tree_leaves(fd.trajectory_vjp(inp, x, v, dX, dV, dld, reverse))
            ref = tree_leaves(fd.trajectory_vjp_plain(inp, x, v, dX, dV, dld, reverse))
            abs_err = [float((a - b).abs().max()) for a, b in zip(got, ref)]
            scale = [float(b.abs().max()) for b in ref]
            rel = max(e / s if s > 0 else (0.0 if e == 0 else float("inf"))
                      for e, s in zip(abs_err, scale))
            case["backward" if reverse else "forward"] = {"max_abs_err": max(abs_err),
                                                          "max_rel_err": rel}
            _require(rel <= BWD_TOL, f"trajectory_bwd {name} reverse={reverse}: rel err {rel}")
        bwd[name] = case
    report["trajectory_bwd_vs_plain"] = bwd
    print(f"# backward kernel vs plain ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(bwd), flush=True)

    n_tr = 1024  # the training batch
    xb = target.sample(_gen(71), n_tr, device=dev).T.contiguous()
    vb, dXb, dVb = (torch.randn(xb.shape, generator=_gen(72 + i)).to(dev) for i in range(3))
    dldb = torch.ones((1, n_tr), device=dev)
    traj_1024_ms = _cuda_time(lambda: fd.trajectory(inp_scg, xb, vb, False), 50)
    bwd_ms = _cuda_time(lambda: fd.trajectory_vjp(inp_scg, xb, vb, dXb, dVb, dldb, False), 20)
    bwd_plain_ms = _cuda_time(
        lambda: fd.trajectory_vjp_plain(inp_scg, xb, vb, dXb, dVb, dldb, False), 3)
    n_grads = sum(w.numel() for w in [*inp_scg.xnet_w, *inp_scg.vnet_w]) + D
    bwd_bound_ms, bwd_bound_by = traj_bwd_bound(
        D, H, H2, T, n_tr, False, inp_scg.block().numel(), n_grads)

    # (b) fused vs plain training on one seed
    t_phase = time.perf_counter()
    hists, step_ms = {}, {}
    for fused in (True, False):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, hists[fused] = train(ScgConfig(n_chains=n_tr, n_steps=20, seed=0, fused_train=fused))
        torch.cuda.synchronize()
        step_ms[fused] = 1e3 * (time.perf_counter() - t) / 20
    loss_gap = float(np.max(np.abs(hists[True]["loss"] - hists[False]["loss"])
                            / (1e-2 + 2e-3 * np.abs(hists[False]["loss"]))))
    report["train_fused_vs_plain"] = {
        "steps": 20, "n_chains": n_tr, "loss_fused": hists[True]["loss"].tolist(),
        "loss_plain": hists[False]["loss"].tolist(),
        "max_gap_over_tolerance": loss_gap,
        "ms_per_step_fused": step_ms[True], "ms_per_step_plain": step_ms[False],
    }
    print(f"# fused vs plain training ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(report["train_fused_vs_plain"]), flush=True)
    _require(loss_gap <= 1.0, f"fused and plain loss histories differ: {loss_gap} x tolerance")

    # (c) the training path: train, then evaluate through the chain kernel
    fd.reset_launch_counts()
    t_phase = time.perf_counter()
    state, hist = train(ScgConfig(n_chains=n_tr, n_steps=TRAIN_STEPS, seed=0, fused_train=True))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t_phase
    _, acc_tr, trace_tr = sampler.run(state.params, x0, seed=cfg.seed + 2,
                                      n_mh_steps=eval_steps, collect_trace=True)
    _, _, trace_h = hmc_sampler.run(hmc_params, x0, seed=cfg.seed + 3,
                                    n_mh_steps=eval_steps, collect_trace=True)
    train_launches = dict(fd.LAUNCHES)
    ess_tr = evaluate_ess(trace_tr, target.sigma)
    ess_h = evaluate_ess(trace_h, target.sigma)
    final_loss = float(hist["loss"][-1])
    final_accept = float(np.mean(hist["p_accept"][-100:]))
    report["training"] = {
        "n_chains": n_tr, "steps": TRAIN_STEPS, "train_s": train_s,
        "ms_per_step": 1e3 * train_s / TRAIN_STEPS,
        "trajectory_ms": traj_1024_ms, "trajectory_bwd_ms": bwd_ms,
        "kernel_ms_per_step": 4 * (traj_1024_ms + bwd_ms),
        "final_loss": final_loss, "final_accept": final_accept,
        "final_eps": float(hist["eps"][-1]),
        "eval_steps": eval_steps, "ess_trained": ess_tr, "ess_hmc": ess_h,
        "ess_ratio": ess_tr / max(ess_h, 1e-12),
        "eval_accept": float(acc_tr.mean()), "launches": train_launches,
        "wall_s": time.perf_counter() - t_phase,
    }
    print(f"# training path ({report['training']['wall_s']:.1f} s): "
          + json.dumps(report["training"]), flush=True)
    _require(bool(np.isfinite(hist["loss"]).all()), "non-finite training loss")
    _require(0.1 < final_accept < 1.0, f"final acceptance {final_accept}")
    _require(bool(torch.isfinite(trace_tr).all()), "non-finite trace of the trained sampler")
    _require(report["training"]["ess_ratio"] > MIN_ESS_RATIO,
             f"trained ESS ratio {report['training']['ess_ratio']} <= {MIN_ESS_RATIO}")
    for name in ("trajectory", "trajectory_bwd", "chain"):
        _require(train_launches[name] > 0, f"kernel {name} not launched on the training path")

    # -- 6. the VAE application ------------------------------------------------------
    with tempfile.TemporaryDirectory() as logdir:
        vae_rows = vae_phases(dev, report, logdir)

    # -- 7. the kernels line -------------------------------------------------------
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
         "shape": (f"SCG D=2 H=10 T=10, 1024 chains x 2000 MH steps, traced; plain_ms "
                   f"over {plain_steps} MH steps (kernel over {plain_steps}: "
                   f"{chain_k100_ms:.4f} ms)")},
        {"name": "trajectory_bwd", "route": "cuda", "source": src + "trajectory_bwd.cu",
         "replaces": "l2hmc_tpu/ops/fused_dynamics.py:801",
         "launches": train_launches["trajectory_bwd"],
         "max_abs_err": max(d["max_abs_err"] for c in bwd.values() for d in c.values()),
         "ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound_ms,
         "bound_by": bwd_bound_by, "library_ms": None,
         "shape": f"SCG D=2 H=10 T=10, {n_tr} chains, one direction (the training batch)"},
        *vae_rows,
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
