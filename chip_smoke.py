#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``l2hmc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``l2hmc_tpu_torch/csrc`` (nvcc, sm_90a)
in the background, one process a source: phases 13d and 11d's conv nets
(no kernel of the port) and then phases 6, 7 and 12 (the VAE kernels, whose
sources end first) run while the rest compiles; then phases 1-5, 9, 10, 11,
13, 14 and 15. A line ``# clock: ...`` marks each phase's start. The
phases:

  1. main path: the SCG evaluation protocol at the notebook's full width
     (D=2, S/T/Q hidden 10, T=10) through the port's entry points — the
     trajectory-kernel parity gate against ``Dynamics.forward/backward``
     (2048 chains), the fused 2000-step traced eval of the sampler and of
     the HMC baseline (eps 0.15) on 1024 chains, and the same eval through
     the plain ``sample_chain`` (its MH step captured as a CUDA graph and
     replayed); the two ESS must agree within 0.30 relative. Launch counts
     are reset before and read after this phase;
  2. trajectory kernel vs its plain version on the same inputs: SCG at 2048
     and 200 chains, the 50-d ill-conditioned Gaussian (input_scale,
     eps_dim) and HMC mode, both directions, tolerance 5e-4; forward then
     backward must invert; its launch timed alone at 1024, 2048 and 8192
     chains, through its wrapper, and through its wrapper in a captured
     graph;
  3. chain kernel vs its plain version on the same Philox bits: SCG
     learned and HMC at 1024 chains, the 50-d Gaussian and a ragged 203
     chains, 20 MH steps, each launch twice, bit for bit; its launch timed
     at 1024 chains x 2000 traced steps in both modes and at 8192 x 500,
     with its lanes a chain and ptxas's registers and spills;
  4. throughput of the chain kernel at 8192 chains x 500 MH steps;
  5. training: (a) the backward-trajectory kernel vs its plain version
     (SCG at 2048 and 200 chains, the 50-d ill-conditioned Gaussian with
     eps_dim and input_scale, HMC mode; both directions; per leaf within
     1e-4 of the leaf's largest entry; timed at 1024 and 8192 chains, and
     through its wrapper eager and captured);
     (b) 20 training steps at 1024
     chains with fused_train=True vs False on one seed, loss histories
     within rtol 2e-3, atol 1e-2; (c) the training path: ``train`` with
     fused_train=True, 1024 chains, TRAIN_STEPS captured steps, then the
     2000-step traced eval of the trained sampler and of HMC at eps 0.15
     through the chain kernel; the ESS ratio must exceed 1.2, the final loss
     be finite and the final acceptance lie in (0.1, 1). Launch counts are
     reset before (c) and read after it; (d) captured against eager: 20
     training steps of the reference architecture plain and fused and of
     the best recipe, and 50 MH steps of ``sample_chain`` (L2HMC and HMC),
     each route from the same seed, bit for bit, with ms per step each way;
  6. the VAE application at the full width of the reference model (latent
     50, decoder 50-1024-1024-784, aux encoder 784-512-512-200, S/T/Q nets
     200/200, 5 leapfrogs), weights seeded and lifted (``lift_vae_params``),
     data from ``apps.data.get_data()``: (a) the sampler kernel vs its plain
     version on the same Philox bits (9, 203 and 256 chains, 3 recorded
     steps, single and composed ops, with trace; each launch twice, bit for
     bit; its cluster configuration, the clusters the card holds at once and
     the L2 weight bytes of a protocol launch); (b) the AIS kernel vs its plain
     version (1000 and 203 chains, 20 anneal steps, 10 leapfrogs; each
     launch twice, bit for bit; its cluster configuration, the clusters
     the card holds at once and the L2 weight bytes of a protocol launch);
     (c) the sampling
     path: ``apps.eval_sampler.run`` with the default protocol cut to 600
     recorded steps of 1-3 ops and a burn-in of 300 (200 chains, the
     seven-eps plain HMC baseline grid; VAE_SAMPLING_CUT), its posterior
     moments held against a plain
     ``vae_chain_plain`` run with its own
     stream; (d) the AIS path: ``apps.eval_vae.run`` with the default
     protocol on 100 datapoints, held against the same entry point with
     ``use_fused="never"`` (the ``ais_estimate`` loop). Launch counts are
     reset before (c) and before (d) and read after each;
  7. VAE training at the same width (batch 512, 5 MH steps), weights
     seeded: (a) the training-trajectory kernel vs its plain version, both
     directions, 512 and 203 chains, on the lifted weights; (b) its VJP
     kernel vs its plain version on the same inputs, per leaf within
     VAE_BWD_TOL of the leaf's largest entry, with at most VAE_BWD_FLIPS
     chains set aside whose plain trajectory has a ReLU pre-activation
     within VAE_RELU_MARGIN of zero, and twice in a row bit for bit; both
     timed at the training batch, with the weight bytes each reads from the
     L2 and the share of its bound; (c) 20
     training steps with fused_train=True vs False on one seed, and the
     fused losses at each of the plain run's 20 states; (d) the
     training path: ``apps.vae.train`` with fused_train=True and a logdir on
     ``apps.data.get_data()`` for VAE_TRAIN_EPOCHS epochs, then
     ``apps.vae.restore`` of its checkpoint and ``apps.eval_vae.run`` on the
     restored state (100 datapoints). Launch counts are reset before (d)
     and read after the training and after the evaluation;
  8. kernel times, plain times and bounds (the ``kernels`` line, printed
     after phase 9);
  9. the bench protocol (``l2hmc_tpu_torch.bench.run``) cut to seed 0 and
     600 training steps per arm, with a 1000-step eval and the
     throughputs at 8192 chains: its parity gate (5e-4) and fused-trace ESS
     gap (0.30) held, both arms' ESS ratios above 1.2, its JSON printed as a
     ``# bench:`` line. Launch counts are reset before and read after it;
 10. the distribution suite (``apps.suite``) on its energy specs (rough
     well, GMM, funnel) and on the 50-d ill-conditioned Gaussian at its
     recipe's hidden 100 (icg, the chain kernel's site-parallel
     configuration; the trajectory kernels stop at hidden 64): (a) the trajectory and backward kernels vs their
     plain versions on each spec, both directions (the easy rough well at
     2048 and 203 chains, the ring at 1024 on the SCG lane configuration,
     the funnel with chains past its clip, mog2 in HMC mode; 5e-4, and 1e-4
     of each leaf's largest entry); (b) the chain kernel vs its plain
     version on the same Philox bits, the same cases and icg (2048 chains,
     eps_dim) at their suite rows' chain counts, 20 MH steps, twice bit for
     bit (phase 3's limits; icg's flips at PHI4_FLIPS); (c)
     the suite path: ``run_target`` on the rough well (its recipe: 2048
     chains, T=5, hidden 20, hard mode),
     the ring at 2048 chains, the funnel and icg at 2048 chains, cut to 100
     training steps (icg 20) and
     one training seed, with a 500-step eval, the fused cross-check
     (its ESS within 0.30 of the plain eval's) and the HMC grid through the
     chain kernel (icg's plain); (d) fused vs plain training on the ring, the easy rough
     well and the funnel (rtol 2e-3, atol 1e-2): the fused step's loss at
     each of a plain run's 20 states, and two free runs of 20 steps, held
     over their first steps (``SUITE_TRAIN``), the ring's beside the same
     two runs on the CPU through the plain versions. Launch counts are reset
     before (c) and read after (d), per kernel and spec; (e)
     captured vs eager, bit for bit: 10 steps of the annealed ring and of
     the funnel with its net-input features; (f) each spec's three kernels
     timed at its suite row's shapes, beside their plain versions and
     bounds, and the chain kernel on icg (row 3i: 2048 chains x 2000 traced
     steps, its L2 weight bytes reckoned);
 11. the phi^4 lattice (``apps.phi4``) on the ``Phi4`` spec: (a) the
     trajectory and backward kernels vs their plain versions at L = 8
     (D = 64, hidden 32, T = 10, 512 chains, both directions; phase 2's and
     5a's bars), both refusing L = 128 with their caps named, the chain
     kernel refusing L = 128 and hidden 129 with its caps named; (b) the
     chain kernel vs its plain version on the same Philox bits, 20 MH
     steps, twice bit for bit: the site-parallel configuration at L = 16
     (512 chains, learned and HMC), L = 32 (256), L = 64 (256; hidden 64,
     T = 24, the shipped 64 x 64 recipe's shape), L = 8 (512; the chain
     kernel runs the lattice there at every width)
     and a dense 128-d Gaussian (203), at PHI4_FLIPS and phase 3's 1e-2 on
     the other chains, each site launch's plan (a cluster of G CTAs a tile
     of 16 chains, ``csrc/l2hmc_site_cluster.cuh``) as the library reports
     it equal to the host's, and the card holding at least one of its
     clusters; (c) the app's
     path: ``apps.phi4.run`` at L = 16 (m^2 = -1, lam = 0.5, 512 chains,
     hidden 32, T = 10, 150 training steps, the 1000-step kernel eval, HMC,
     a parallel-tempered eval at 8 rungs cut to PHI4_PT_STEPS), its kernel
     eval's tunnelling rate and magnetization ESS held against a plain
     ``sample_chain`` eval of the same params from the same x0, each the
     mean over PHI4_SEEDS random streams (PHI4_GAP), the same at L = 64
     (A_control's shape of the JAX package's 64 x 64 record: 256 chains,
     hidden 32, T = 10, eps 0.03, training cut to 50 steps and the eval to
     600; PHI4_RUN_L64,
     PHI4_SEEDS_L64 streams), then at L = 8 and at L = 32 cut in training
     and eval; (d) captured training
     steps with conv nets at L = 16 against eager ones (cuDNN's TF32 off),
     and fused against plain training at L = 8: the fused step's loss at
     each of a plain run's 10 states on the same draws (phase 5b's bar),
     two free runs through ``train`` beside it (reported). Launch
     counts are reset before (c) and read after each of its runs, and reset
     before the fused training run of (d) and read after it; (e) the
     kernels at the app's shapes timed beside their plain versions and
     bounds, with the L2 weight bytes of a site-parallel launch reckoned:
     rows 3e-3g at L = 8, 16, 32, and 3h at L = 64 at the trained params of
     (c)'s L = 64 run and at the shipped recipe's shape (hidden 64, T = 24);
 12. bfloat16 operands (``compute_dtype="bfloat16"``) in the four VAE kernels
     at phases 6-7's width and weights, each bf16 instantiation against its
     plain version with the same operands and against the bf16-float32 gap
     of the plain versions (the bars at BF16_GAP_SHARE): (a) the training
     kernels at 512 and 203 chains, both directions, inverting, twice bit
     for bit; (b) the sampler at 9, 203 and 256 chains on the same Philox
     bits; (c) AIS at 1000 and 203 chains, 20 anneal steps; (d) bf16 fused
     training against its plain route (``vae_trajectory_plain`` under
     autograd) at the plain run's 20 states; (e) the bf16 path:
     ``apps.vae.train`` with ``fused_train=True,
     fused_compute_dtype="bfloat16"`` cut to BF16_TRAIN_EPOCHS, ``restore``, the
     restored model's posterior through the bf16 sampler and its
     log-likelihood through bf16 AIS beside float32 AIS; (f) each bf16
     launch timed at its protocol shape with its plain version, both bounds
     (the bf16 tensor-core peak and the float32 pipe), ptxas's registers and
     spills and the reckoned L2 weight bytes. Launch counts are reset before
     (e) and read after it;
 13. bfloat16 operands in kernels 1 and 3 (``compute_dtype="bfloat16"``),
     each bf16 instantiation against its plain bf16 version, held to shares
     of the plain bf16-float32 gap as phase 12: (a) the trajectory kernel on
     SCG at 2048 and 203 chains, the rough well (D = 10, H = 20, T = 5) and
     phi^4 at L = 8, both directions, inverting, twice bit for bit; (b) the
     chain kernel on the same Philox bits, 20 traced MH steps, twice bit for
     bit: SCG at 1024 and 203 chains, the rough well, phi^4 at L = 16 and
     L = 64 (dim 4096, hidden 32, T = 10; sites) and icg at hidden 100
     (sites, 128 hidden units); (c) the bf16 SCG path: ``train`` with
     ``ScgConfig(compute_dtype="bfloat16")`` at 1024 chains, the 1000-step
     traced eval through ``fused_chain_sampler(..., compute_dtype=
     "bfloat16")`` and HMC (ESS ratio, ESS gap to a plain bf16 eval), the
     bf16 parity gate against the bf16 nets, the bf16 sampler on the lattice
     at L = 16 and 64, fused bf16 training equal to fused float32 training;
     (d) the JAX package's bf16 conv recipe at L = 32 through
     ``apps.phi4.run``, cut in depth, with its peak memory; (e) the bf16
     rows 1-bf16, 3-bf16, 3f-bf16 and 3h-bf16 timed beside their float32
     rows, both bounds, ptxas. Launch counts are reset before (c) and read
     after it;
 14. kernels 1-2 on sites (past 64 wide, ``csrc/l2hmc_sites.cuh``): (a) the
     trajectory kernel vs its plain version at phi^4 L = 16 (1024 chains),
     32 (256), 64 (256, A_control's shape) and icg (hidden 100, 2048), both
     directions, twice bit for bit, inverting; (b) its backward kernel vs its
     plain version at the same cases (at L = 64 its intermediates in its
     global scratch), its scratch plan against the library's, and its
     second kernel, the fixed-order reduction of the factors, vs its plain
     version at the L = 16 path's shape (REDUCE_TOL), twice bit for bit;
     (c) fused vs plain training at L = 16 at the plain run's 20
     states (phase 5b's bar), a fused step recorded as a CUDA graph against
     the eager step and ``train``'s captured route against its eager one,
     bit for bit; (d) the path: ``train`` on the phi^4
     runner's L = 16 config with ``fused_train=True`` (1024 chains, cut to
     150 steps), the chain kernel's traced eval and plain HMC (tunnelling,
     ESS_m), ms per fused and plain step, short fused runs at L = 32 and 64
     and on icg, the trajectory kernel as the trajectory gate at L = 64 and in bf16
     at L = 16; (e) the bf16 site trajectory vs its plain bf16 version
     (phase 13's shares); (f) rows 1f-1i, 2f-2i, the reduction (2r) and
     1f-bf16 timed beside their plain versions, bounds and reckoned L2
     bytes, ptxas of all four kernels. Launch counts are reset before (d) and
     read after each of its runs;
 15. kernels 1-3 on sites for the rough well, the mixtures and the funnel
     (their prelude of per-chain block sums, ``csrc/l2hmc_sites.cuh``) at
     the path's five configurations (``apps.suite.WIDE_CASES``: the rough
     well and the ring at hidden 100, the rough well and the funnel at
     D = 100, a two-component mixture at D = 80): (a) rows 1 and 2 vs their
     plain versions, both directions, twice bit for bit (14a's bars; the
     VJP per leaf at 1e-4 with the chains near a ReLU kink set aside,
     WIDE_RELU_MARGIN); (b) row 3 vs its plain version on the same Philox
     bits (0.2% of the decisions, 1e-2); (c) fused vs plain training at the
     plain run's 20 states (5b's bar); (d) the path: ``run_target`` on the
     ring and the rough well at hidden 100 cut as 10c (the fused
     cross-check "ran", its ESS gap under 0.30), then ``train``
     with fused_train=True on each configuration and, at D = 80-100, the
     chain kernel's traced eval against a plain eval (ESS gap under 0.30);
     (e) the bf16 site trajectory on the rough well at D = 100 (13a's bars);
     (f) rows 1j-3j, 1k-3k and 1l-3l timed beside their plain versions and
     bounds, ptxas. Launch counts are reset before (d) and read after it.

Prints a ``kernels`` JSON line, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, without a CUDA device, without the port beside it, or when any
check fails. The full report is printed as a ``# report:`` JSON line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

# Published peaks of one H100 SXM at 700 W (NVIDIA data sheet): float32
# outside the tensor cores, bfloat16 on the tensor cores (dense), and HBM3
# bandwidth.
PEAK_F32_OPS = 67e12
PEAK_BF16_TC_OPS = 989e12
PEAK_BYTES = 3.35e12
TRAJ_TOL = 5e-4  # bench.py's compiled-parity gate
ESS_GAP = 0.30  # bench.py's fused-trace vs non-kernel ESS tolerance
BWD_TOL = 1e-4  # per leaf, of the leaf's largest entry: sums over chains in another order
TRAIN_STEPS = 5000  # the notebook's training length (SCGExperiment.ipynb cell 12)
MIN_ESS_RATIO = 1.2  # the JAX package's short-run bar (tests/test_train_scg.py)
# phase 9: the bench protocol cut to seed 0, 600 training steps per arm and
# a 1000-step eval (the full 8192-chain throughput); the 40x tripwire is the
# full protocol's and is not applied at this depth (at 400 steps the
# reference arm's ratio fell to 0.71, on an H100)
BENCH_CUT = dict(seeds=(0,), n_steps=600, eval_steps=1000, tripwire=False)
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
# 6c's sampling path cut to 0.3 of the protocol's recorded steps and burn-in
# (its plain seven-eps HMC grid is ~95% of the run), to keep the script near
# 1100 s with phase 13 (the autocovariance's 199 lags need more than the
# 150 steps after a burn-in at 0.15); (e) times the kernel's launch at the
# protocol's 2000 steps.
VAE_SAMPLING_CUT = dict(n_steps=600, burn_in=300)
VAE_MEAN_TOL = 0.1
VAE_VAR_TOL = 0.15
# eval_vae.run through the AIS kernel against the ais_estimate loop on the
# same datapoints and start states, each with its own momentum and accept
# stream: nats per datapoint on values near -700, whose spread over seeds is
# 0.04 on either route (8 seeds each, H100).
VAE_LL_TOL = 0.25
# The training-trajectory kernel against its plain version: bench.py's gate.
# Its VJP kernel: per leaf, of the leaf's largest entry, as BWD_TOL (sums over
# 512 chains and 1024 terms in another order, through 5 leapfrog steps). The
# nets are ReLU nets, so the VJP is discontinuous where a hidden
# pre-activation crosses zero: of a batch's 4 million gate decisions a few lie
# within float32 rounding of zero and come out differently in the kernel and
# in its plain version, and such a chain's cotangents differ by whole terms.
# Those chains are found by their own outputs (demb, dz, dv), may be at most
# VAE_BWD_FLIPS in a comparison (fewer than any ragged last block holds), must
# each have, in the plain trajectory, a pre-activation within VAE_RELU_MARGIN
# of its layer's largest (``relu_margins``), and are set aside by a second
# comparison with their cotangents zeroed, which must then hold VAE_BWD_TOL on
# every leaf.
VAE_BWD_TOL = 1e-4
VAE_BWD_FLIPS = 1
VAE_RELU_MARGIN = 1e-5
# Fused against plain VAE training over 20 steps on one seed, at the JAX
# package's bar for SCG training (rtol 2e-3, atol 1e-2), twice. From the same
# parameters: at each state of the plain run the fused losses on the same
# batch and draws, all three, all 20 steps. And as two free runs: ELBO and
# log-probability over all 20 steps, the sampler loss over the first
# VAE_SAMPLER_FREE_STEPS: it is a mean of jump distances over the encoder's
# variances and of their reciprocals, near -1e4 and carried by a few of the
# 512 chains, so the two runs' parameters, once apart by rounding, give
# sampler losses apart by more; the later gap is reported and not held.
VAE_SAMPLER_FREE_STEPS = 3
VAE_TRAIN_EPOCHS = 10  # 8 batches of 512 each on the 4096 synthetic images


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


def spec_ops(kind, D, nc):
    """(energy, gradient, gradient VJP) operations per chain of the energy
    spec ``kind`` with ``nc`` constants (``KernelInputs.energy_args``): the
    least each function needs, a transcendental function 1. The mixture is
    counted in one pass over its K components with a running maximum and a
    rescale; the kernel's second pass (it recomputes P_k (x - mu_k) to save
    registers) is its own choice, and not counted."""
    if kind == 0:  # Gauss: P (x - mu)
        return 2 * D * D + 3 * D, 2 * D * D + D, 2 * D * D + D
    if kind == 1:  # RoughWell: elementwise, one sin or cos an element
        return 7 * D, 4 * D, 6 * D
    if kind == 2:  # Gmm
        K = nc // (D + D * D + 1)
        comp = 2 * D * D + 3 * D + 2  # x - mu_k, P_k (x - mu_k), its log-weight
        lse = 7  # the running maximum, two shifts, two exps, the rescaled sum
        # the gradient rescales and adds one weighted D-vector a component;
        # the VJP forms P_k^T d, P_k^T (x - mu_k), p_k.d and q_k and rescales
        # and adds three
        return (K * (comp + lse) + 2,
                K * (comp + lse + 3 * D) + D,
                K * (comp + lse + 4 * D * D + 15 * D) + 8 * D)
    if kind == 3:  # Funnel: the neck's sum of squares, one clip and exp
        return 2 * D + 9, 3 * D + 8, 9 * D + 10
    if kind == 4:  # Phi4: a 5-point stencil a site
        # energy: two differences and their squares, the potential's x^2,
        # x^4 and FMA, the halves and the sums; gradient: the Laplacian's
        # five terms, m^2 x, 4 lam x^3; VJP: the diagonal's FMA and product,
        # the neighbours' sum of d and the difference
        return 14 * D, 11 * D, 8 * D
    raise ValueError(f"unknown energy spec kind {kind}")


def _ops_of(inp):
    kind, nc = inp.energy_args
    return spec_ops(kind, inp.dims[0], nc)


def _substep_ops(D, H, H2, hmc, ops):
    nets = 0 if hmc else 4 * _stq_ops(D, H, H2)
    grads = 2 * ops[1]
    updates = 4 * 12 * D  # four masked updates with their exp gates and logdet
    return nets + grads + updates


def _stq_weights(D, H, H2):
    """The S/T/Q net's products' weights: w1, w2, wh and the three heads."""
    return 2 * D * H + H * H2 + 3 * H2 * D


def _stq_products(D, H, H2):
    """The operations of one S/T/Q net application's matrix products (an
    FMA 2): the products that bfloat16 operands lower."""
    return 2 * _stq_weights(D, H, H2)


def traj_work(D, H, H2, T, N, hmc, block_floats, ops):
    """(operations, bytes) of one trajectory launch."""
    work = N * T * _substep_ops(D, H, H2, hmc, ops)
    nbytes = 4 * (2 * D * N + 2 * D * N + N + block_floats)
    return work, nbytes


def traj_bound(D, H, H2, T, N, hmc, block_floats, ops):
    return _bound(*traj_work(D, H, H2, T, N, hmc, block_floats, ops))


def traj_bwd_bound(D, H, H2, T, N, hmc, block_floats, n_grads, ops):
    """The VJP of a trajectory: about three forward trajectories of
    operations (forward, and backward through each matrix product twice),
    two gradient VJPs a substep, plus the sum of n_grads cotangents over
    the N chains."""
    work = N * T * (3 * _substep_ops(D, H, H2, hmc, ops) + 2 * ops[2]) + n_grads * N
    nbytes = 4 * (4 * D * N + N + block_floats + 2 * D * N + n_grads)
    return _bound(work, nbytes)


def chain_work(D, H, H2, T, N, K, hmc, block_floats, trace: bool, ops):
    """(operations, bytes) of one chain launch of K MH steps."""
    philox = (1 + (D + 1) // 2) * 10 * 8  # calls x rounds x integer ops
    per_step = (T * _substep_ops(D, H, H2, hmc, ops) + 2 * ops[0] + 4 * D
                + philox + 6 * D + 8)
    work = N * K * per_step
    nbytes = 4 * (D * N + D * N + N + block_floats + (K * D * N if trace else 0))
    return work, nbytes


def chain_bound(D, H, H2, T, N, K, hmc, block_floats, trace: bool, ops):
    return _bound(*chain_work(D, H, H2, T, N, K, hmc, block_floats, trace, ops))


def _decoder_grad_ops(D, E, P):
    """One energy-and-gradient sweep of the decoder posterior per chain: the
    three products forward and their transposes back, the two softplus
    layers with their sigmoids, the BCE terms and the prior."""
    return 4 * (D * E + E * E + E * P) + 2 * E * 10 + P * 14 + 4 * D


def _dec_products(D, E, P):
    """The operations of one decoder sweep's six matrix products (the
    three forward and their transposes), a multiply-add 2."""
    return 4 * (D * E + E * E + E * P)


def _net_products(D, H, H2):
    """The operations of one S/T/Q net application's matrix products."""
    return 4 * D * H + 2 * H * H2 + 6 * H2 * D


def vae_chain_work(D, H, H2, T, E, P, N, K, total_ops, weight_bytes, trace: bool):
    """The sampler kernel's least work as (operations, of them in matrix
    products, bytes): ``total_ops`` MH ops (this run's nb sequence summed),
    each T decoder sweeps (the gradient at the end of one leapfrog step is
    the first of the next, the energy comes with it) and 4 T aux-conditioned
    net applications, plus the start state's sweep."""
    philox = (1 + (D + 1) // 2) * 10 * 8
    per_op = (T * (_decoder_grad_ops(D, E, P) + 4 * (_stq_ops(D, H, H2) + H) + 4 * 12 * D)
              + philox + 10 * D + 8)
    ops = N * (total_ops * per_op + _decoder_grad_ops(D, E, P))
    products = N * (total_ops * T * (_dec_products(D, E, P) + 4 * _net_products(D, H, H2))
                    + _dec_products(D, E, P))
    nbytes = (4 * (D * N + P * N + H * N + K + D * N + N + (K * D * N if trace else 0))
              + weight_bytes)
    return ops, products, nbytes


def vae_chain_bound(D, H, H2, T, E, P, N, K, total_ops, weight_floats, trace: bool):
    ops, _, nbytes = vae_chain_work(D, H, H2, T, E, P, N, K, total_ops, 4 * weight_floats, trace)
    return _bound(ops, nbytes)


def vae_chain_l2_bytes(n, ct, ops, D, H, H2, T, E, P, item=4):
    """Weight bytes one sampler launch reads from the L2, reckoned for the
    report (weights of ``item`` bytes): every cluster of ct chains reads
    each weight once per product, T decoder sweeps (each matrix forward and
    transposed) and 4 T net applications per MH op, and the start state's
    sweep."""
    sweep = item * 2 * (D * E + E * E + E * P)
    net = item * (2 * D * H + H * H2 + 3 * H2 * D)
    return -(-n // ct) * (ops * (T * sweep + 4 * T * net) + sweep)


def vae_ais_work(D, E, P, N, K, L, weight_bytes):
    """The AIS kernel's least work as (operations, of them in matrix
    products, bytes): K anneal steps of L decoder sweeps, the leapfrog
    updates, the draws and the accept, plus the start state's sweep."""
    philox = (1 + (D + 1) // 2) * 10 * 8
    per_step = L * (_decoder_grad_ops(D, E, P) + 10 * D) + philox + 10 * D + 12
    ops = N * (K * per_step + _decoder_grad_ops(D, E, P))
    products = N * (K * L + 1) * _dec_products(D, E, P)
    nbytes = 4 * (D * N + P * N + K + 2 * N) + weight_bytes
    return ops, products, nbytes


def vae_ais_bound(D, E, P, N, K, L, weight_floats):
    ops, _, nbytes = vae_ais_work(D, E, P, N, K, L, 4 * weight_floats)
    return _bound(ops, nbytes)


def _bound(ops, nbytes):
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_BYTES
    if t_ops >= t_bytes:
        return 1e3 * t_ops, "operations"
    return 1e3 * t_bytes, "bytes"


def _bf16_bounds(ops, products, nbytes):
    """A bfloat16-operand kernel's two bounds, in ms: the least time the
    card could take (its matrix products at the bf16 tensor-core peak, its
    other operations at the float32 peak, each pipe alone, or its bytes,
    whichever is longest), with what bounds it; and the time of all its
    operations on the float32 pipe that the kernel, written for the CUDA
    cores, runs them on."""
    t_ops = max(products / PEAK_BF16_TC_OPS, (ops - products) / PEAK_F32_OPS)
    t_bytes = nbytes / PEAK_BYTES
    f32_pipe_ms = 1e3 * max(ops / PEAK_F32_OPS, t_bytes)
    if t_ops >= t_bytes:
        return 1e3 * t_ops, "operations", f32_pipe_ms
    return 1e3 * t_bytes, "bytes", f32_pipe_ms


def _cuda_time(fn, reps, warmup=True):
    """Mean ms of ``fn()`` over ``reps`` runs by CUDA events, after one
    warm-up run (without it where ``fn``'s kernel has run before)."""
    import torch

    if warmup:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _captured_ms(fn, calls, reps):
    """Mean ms of one ``fn()`` recorded ``calls`` times into a CUDA graph
    (``utils.capture``, as the captured steps record theirs), by CUDA events
    around ``reps`` replays: a wrapper's launch as a captured step replays
    it, with its host work gone."""
    from l2hmc_tpu_torch.utils import capture

    capture.run_on_side_stream(fn)
    graph = capture.Graph(lambda: [fn() for _ in range(calls)])
    return _cuda_time(graph.replay, reps) / calls


def _bwd_launch_ms(fd, cuda_lib, inp, x, v, dX, dV, dld, reps):
    """Mean ms of the backward kernel's launch (the VJP and the sum over
    chains; on sites its reduction) through its C entry point, by CUDA
    events, with the arguments ``fd.trajectory_vjp`` gives it made once: the
    device's time, apart from the wrapper's host work."""
    import torch

    block = fd._kernel_block(inp, x, "trajectory_bwd")
    D, H, H2, T = inp.dims
    N = x.shape[1]
    n_grads = sum(w.numel() for w in [*inp.xnet_w, *inp.vnet_w]) + D
    grads = torch.empty(n_grads, dtype=torch.float32, device=x.device)
    scratch = torch.empty(fd.bwd_scratch_floats(inp, N), dtype=torch.float32, device=x.device)
    dx, dv = torch.empty_like(x), torch.empty_like(v)
    name = fd._lib_name("trajectory_bwd", inp)  # the specs' library on sites
    entry = getattr(cuda_lib.library(name), f"l2hmc_{name}")
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        cuda_lib.check(entry(
            block.data_ptr(), D, H, H2, T, *inp.energy_args, 0, int(inp.hmc), x.data_ptr(),
            v.data_ptr(), dX.data_ptr(), dV.data_ptr(), dld.data_ptr(), dx.data_ptr(),
            dv.data_ptr(),
            grads.data_ptr(), scratch.data_ptr(), N, stream), name)

    return _cuda_time(launch, reps)


def _traj_launch_ms(fd, cuda_lib, inp, x, v, reps):
    """Mean ms of the trajectory kernel's launch through its C entry point,
    by CUDA events, with the arguments ``fd.trajectory`` gives it made once:
    the device's time, apart from the wrapper's host work."""
    import torch

    block = fd._kernel_block(inp, x, "trajectory")
    D, H, H2, T = inp.dims
    N = x.shape[1]
    xo, vo = torch.empty_like(x), torch.empty_like(v)
    ld = torch.empty((1, N), dtype=torch.float32, device=x.device)
    name = fd._lib_name("trajectory", inp)  # the bfloat16 library for inp.cd
    entry = getattr(cuda_lib.library(name), f"l2hmc_{name}")
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        cuda_lib.check(entry(
            block.data_ptr(), D, H, H2, T, *inp.energy_args, 0, int(inp.hmc), x.data_ptr(),
            v.data_ptr(), xo.data_ptr(), vo.data_ptr(), ld.data_ptr(), N, stream), name)

    return _cuda_time(launch, reps)


def _ptxas_of(log, entry):
    """ptxas's register and spill lines for the entry functions whose
    mangled names hold ``entry``, from the build's ``-Xptxas -v`` log."""
    lines, name = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else ""
        elif entry in name and ("registers" in line or "spill" in line):
            lines.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return lines


_T0 = time.perf_counter()


def _clock(label):
    """Prints the seconds since the script started, at a phase's start."""
    print(f"# clock: {label} at {time.perf_counter() - _T0:.1f} s", flush=True)


def _gen(seed):
    import torch

    return torch.Generator().manual_seed(seed)


def _over_tolerance(got, ref):
    """|got - ref| as a share of the SCG training bar (rtol 2e-3, atol 1e-2),
    elementwise."""
    import numpy as np

    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref) / (1e-2 + 2e-3 * np.abs(ref))


def _same_state_losses(cfg, dyn, tgt, dev):
    """The fused step's loss at each of the plain run's ``cfg.n_steps``
    states, on the same draws (``draw_step`` from ``cfg.seed + 100``), as
    [(fused, plain)]: both steps in one body that ``train``'s captured route
    runs (two eager warm-up steps, then a CUDA graph replayed for every
    other step), so the loop costs no host time a step. The captured route
    repeats the eager one bit for bit (phase 5d)."""
    from l2hmc_tpu_torch.ops import fused_dynamics as fd
    from l2hmc_tpu_torch.train import init_state, make_optimizer, make_train_step
    from l2hmc_tpu_torch.train.scg import _TrainSteps

    opt, _ = make_optimizer(cfg)
    plain_step = make_train_step(cfg, dyn, opt)
    fused_step = make_train_step(cfg, fd.differentiable_fused(dyn, tgt), opt)

    def both(state, draws):
        _, mf = fused_step(state, draws)
        new, mp = plain_step(state, draws)
        return new, {"loss": mp["loss"], "fused_loss": mf["loss"]}

    class SameStates(_TrainSteps):
        _METRICS = ("fused_loss", "loss")

    steps = SameStates(both, init_state(cfg, dyn, opt, device=dev), cfg.n_steps, dyn.hmc,
                       cfg.z_burn_in_loss)
    steps.run(steps.draw(_gen(cfg.seed + 100), cfg.n_steps))
    hist = steps.history(cfg.n_steps)
    return list(zip(hist["fused_loss"].tolist(), hist["loss"].tolist()))


def _site_plan_check(fd, inp, n, what):
    """The site-parallel chain launch's plan as the library takes it on this
    card, equal to the host mirror at the card's capacities (clusters of
    each size it holds at once, cudaOccupancyMaxActiveClusters), and how
    many of the plan's clusters the card holds at once, at least one; the
    summary."""
    D, H, H2, _ = inp.dims
    plan = fd.site_tile(D, H, H2, n, *inp.energy_args)
    capacity = fd.site_capacities(D, H, H2, *inp.energy_args)
    host = fd.site_geometry(D, H, H2, n, *inp.energy_args, capacity=capacity)
    _require(plan == host, f"{what}: site plan {plan} != the host's {host}")
    at_once = fd.site_clusters(D, H, H2, n, *inp.energy_args)
    _require(at_once >= 1, f"{what}: the card holds no cluster of {plan}")
    tiles = -(-n // plan.chains)
    return {"plan": plan._asdict(), "ctas": tiles * plan.G, "clusters_at_once": at_once,
            "waves": -(-tiles // at_once), "capacity": capacity}


def _chain_vs_plain(fd, inp, xc, what, max_flips):
    """The chain kernel against its plain version on the same Philox bits
    from the (D, N) state ``xc``, 20 traced MH steps, the kernel launched
    twice: at most ``max_flips`` accept decisions may differ (a decision
    flips only where px - u lies within the two versions' rounding of the
    Hamiltonians), the other chains' states agree within 1e-2 (20 x the
    trajectory gate), the second launch repeats the first bit for bit and
    the trace ends at the state. Returns the summary."""
    import torch

    xk, acck, tr_k = fd.chain(inp, xc, 9, 20, collect_trace=True)
    again = fd.chain(inp, xc, 9, 20, collect_trace=True)
    _, _, tr_p = fd.chain_plain(inp, xc, 9, 20, collect_trace=True)
    dec_k = (tr_k != torch.cat([xc[None], tr_k[:-1]])).any(dim=1)  # (K, N) accepted
    dec_p = (tr_p != torch.cat([xc[None], tr_p[:-1]])).any(dim=1)
    flipped = dec_k != dec_p
    clean = ~flipped.any(dim=0)
    dx = float((tr_k - tr_p).abs()[:, :, clean].max())
    repeats = all(bool((a == b).all()) for a, b in zip((xk, acck, tr_k), again))
    out = {"n_chains": xc.shape[1], "decisions": int(dec_k.numel()),
           "flips": int(flipped.sum()), "chains_flipped": int((~clean).sum()),
           "max_abs_dx_unflipped": dx, "accept": float(dec_k.float().mean()),
           "repeats_bit_for_bit": repeats}
    _require(repeats, f"{what}: two launches differ")
    _require(bool((tr_k[-1] == xk).all()), f"{what}: trace end != state")
    _require(bool(torch.isfinite(tr_k).all()), f"{what}: non-finite")
    _require(int(flipped.sum()) <= max_flips and dx < 1e-2, f"{what}: {out}")
    return out


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

    # (a) sampler kernel vs plain on the same bits, under one cluster's
    # chains, at a ragged count and at whole clusters; each launch twice
    chain_dims = (D, H, H2, T, E, P)
    chain_cmp = {}
    for n in (9, 203, 256):
        xr, embT, zT = batch(n)
        inp = fv.prepare_vae(dyn, params["smp"], params["dec"], xr, embT)
        for name, nb in (("single", None), ("composed", [2, 1, 3])):
            zk, acck, trk = fv.vae_chain(inp, xr, zT, seed=4, n_mh_steps=3,
                                         collect_trace=True, nb=nb)
            again = fv.vae_chain(inp, xr, zT, seed=4, n_mh_steps=3, collect_trace=True, nb=nb)
            zp, accp, trp = fv.vae_chain_plain(inp, zT, seed=4, n_mh_steps=3,
                                               collect_trace=True, nb=nb)
            ops = 3 if nb is None else sum(nb)
            flipped = (acck - accp).abs()[0] * ops > 0.5
            dz = float((trk - trp).abs()[:, :, ~flipped].max())
            case = {"ctas": fv.chain_sizes(chain_dims, n)["ctas"],
                    "flips": int(flipped.sum()), "max_abs_dz_unflipped": dz,
                    "repeats_bit_for_bit": all(bool(torch.equal(a, b))
                                               for a, b in zip((zk, acck, trk), again)),
                    "accept": float(acck.mean()),
                    "moved": float((zk - zT).abs().max())}
            chain_cmp[f"n{n}_{name}"] = case
            _require(bool(torch.isfinite(trk).all()), f"vae_chain {n} {name}: non-finite trace")
            _require(bool((trk[-1] == zk).all()), f"vae_chain {n} {name}: trace end != state")
            _require(case["repeats_bit_for_bit"], f"vae_chain {n} {name}: two launches differ")
            _require(case["flips"] <= VAE_FLIPS and dz < VAE_CHAIN_TOL,
                     f"vae_chain {n} {name}: {case}")
            _require(case["moved"] > 0.05, f"vae_chain {n} {name}: the chains did not move")
    report["vae_chain_vs_plain"] = chain_cmp
    print(f"# VAE sampler kernel vs plain ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(chain_cmp), flush=True)

    # (b) AIS kernel vs plain on the same bits, at the protocol's 1000 chains
    # and at a ragged count (not a multiple of a cluster's chains); each
    # launch twice, bit for bit
    t_phase = time.perf_counter()
    k_ais, l_ais = 20, 10
    acfg = eval_vae.EvalVaeConfig()
    ais_dims = (D, E, P)
    ais_cmp = {"chains_per_cta_and_ctas_per_cluster": list(fv.AIS_TILE),
               "clusters_at_once": fv.ais_max_clusters(ais_dims),
               "anneal_steps": k_ais, "leapfrogs": l_ais}
    for n_ais in (1000, 203):
        xr, _, zT = batch(n_ais)
        wk, acck = fv.vae_ais(dec, xr, zT, seed=6, anneal_steps=k_ais, step_size=0.05,
                              leapfrogs=l_ais)
        wk2, acck2 = fv.vae_ais(dec, xr, zT, seed=6, anneal_steps=k_ais, step_size=0.05,
                                leapfrogs=l_ais)
        wp, accp = fv.vae_ais_plain(dec, xr, zT, seed=6, anneal_steps=k_ais, step_size=0.05,
                                    leapfrogs=l_ais)
        clean = (wk - wp).abs()[0] < 0.05
        sizes = fv.ais_sizes(ais_dims, n_ais)
        case = {
            "ctas": sizes["ctas"], "smem_bytes_per_cta": sizes["smem_bytes"],
            "flipped_chains": int((~clean).sum()),
            "max_abs_dlogw_unflipped": float((wk - wp).abs()[:, clean].max()),
            "max_abs_daccept_unflipped": float((acck - accp).abs()[:, clean].max()),
            "repeats_bit_for_bit": bool(torch.equal(wk, wk2) and torch.equal(acck, acck2)),
            "logw_mean": float(wk.mean()), "accept": float(acck.mean()),
        }
        ais_cmp[f"n{n_ais}"] = case
        _require(bool(torch.isfinite(wk).all()), f"vae_ais {n_ais}: non-finite log w")
        _require(case["repeats_bit_for_bit"], f"vae_ais {n_ais}: two launches differ")
        _require(case["flipped_chains"] <= VAE_FLIPS
                 and case["max_abs_dlogw_unflipped"] < VAE_AIS_TOL
                 and case["max_abs_daccept_unflipped"] < VAE_AIS_TOL, f"vae_ais {n_ais}: {case}")
    n_path = acfg.chains_per_datapoint * acfg.num_splits
    ais_cmp["l2_weight_bytes_per_protocol_launch"] = fv.ais_l2_bytes(
        D, E, P, n_path, acfg.anneal_steps, acfg.leapfrogs)
    report["vae_ais_vs_plain"] = ais_cmp
    print(f"# AIS kernel vs plain ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(ais_cmp), flush=True)
    _require(ais_cmp["clusters_at_once"] * fv.AIS_TILE[1] >= ais_cmp["n1000"]["ctas"],
             f"vae_ais: {ais_cmp['n1000']['ctas']} CTAs do not fit one wave")

    # (c) the sampling path
    fd.reset_launch_counts()
    t_phase = time.perf_counter()
    scfg = eval_sampler.EvalSamplerConfig()
    run_cfg = dataclasses.replace(scfg, **VAE_SAMPLING_CUT)
    curves = eval_sampler.run(model, params, run_cfg, dataset, seed=0)
    torch.cuda.synchronize()
    sampling_s = time.perf_counter() - t_phase
    sampling_launches = dict(fd.LAUNCHES)
    trace = curves["trace"]
    post = trace[run_cfg.burn_in:]
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
        "n_chains": run_cfg.n_chains, "n_steps": run_cfg.n_steps, "burn_in": run_cfg.burn_in,
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
    _require(trace.shape == (run_cfg.n_steps, run_cfg.n_chains, D), "VAE trace shape")
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
    # one protocol launch (~5 s), its instantiation warmed up by the line above
    chain_ms = _cuda_time(lambda: chain_run(scfg.n_steps), 1, warmup=False)
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
    chain_plan = fv.chain_sizes(chain_dims, scfg.n_chains)
    chain_plan["clusters_at_once"] = fv.chain_max_clusters(chain_dims)
    chain_plan["l2_weight_bytes_per_protocol_launch"] = vae_chain_l2_bytes(
        scfg.n_chains, chain_plan["ct"], int(nb_path.sum()), *chain_dims)
    _require(chain_plan["clusters_at_once"] * chain_plan["g"] >= chain_plan["ctas"],
             f"vae_chain: {chain_plan['ctas']} CTAs do not fit one wave")

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
        "vae_chain_plan": chain_plan,
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
                   f"clusters of {chain_plan['g']} CTAs sharing {chain_plan['ct']} chains, "
                   f"{chain_plan['ctas']} CTAs, {chain_plan['clusters_at_once']} clusters at "
                   f"once; plain_ms over the first {plain_steps} steps "
                   f"({int(nb_path[:plain_steps].sum())} ops; kernel over the same: "
                   f"{chain_k20_ms:.2f} ms)")},
        {"name": "vae_ais", "route": "cuda", "source": src + "vae_ais.cu",
         "replaces": "l2hmc_tpu/ops/fused_dynamics.py:2083",
         "launches": ais_launches["vae_ais"],
         "max_abs_err": max(ais_cmp[k]["max_abs_dlogw_unflipped"] for k in ("n1000", "n203")),
         "ms": ais_ms, "plain_ms": ais_plain_ms, "bound_ms": ais_bound_ms,
         "bound_by": ais_bound_by, "library_ms": None,
         "shape": (f"VAE latent {D}, decoder {E}, {n_path} chains x {acfg.anneal_steps} "
                   f"anneal steps x {acfg.leapfrogs} leapfrogs (one AIS batch), clusters of "
                   f"{fv.AIS_TILE[1]} CTAs with {fv.AIS_TILE[0]} chains each")},
    ]


def vae_traj_work(D, H, H2, T, E, P, N, weight_bytes):
    """The training trajectory's least work as (operations, of them in
    matrix products, bytes): T + 1 decoder sweeps (the gradient at the end
    of a leapfrog step is the first of the next), 4 T net applications and
    the updates."""
    per_chain = ((T + 1) * _decoder_grad_ops(D, E, P)
                 + T * (4 * (_stq_ops(D, H, H2) + H) + 4 * 12 * D))
    products = N * ((T + 1) * _dec_products(D, E, P) + 4 * T * _net_products(D, H, H2))
    nbytes = 4 * (2 * D * N + P * N + H * N + 2 * D * N + N) + weight_bytes
    return N * per_chain, products, nbytes


def vae_traj_bound(D, H, H2, T, E, P, N, weight_floats):
    ops, _, nbytes = vae_traj_work(D, H, H2, T, E, P, N, 4 * weight_floats)
    return _bound(ops, nbytes)


def vae_traj_bwd_work(D, H, H2, T, E, P, N, weight_bytes, n_grads, blocks, hvps=None):
    """The VJP's least work as (operations, of them in matrix products,
    bytes), per chain: the trajectory again (the recompute: T + 1 decoder
    sweeps, 4 T net applications), one more sweep's worth per
    Hessian-vector product for the tangent that rides on the recomputed
    primal (six more products; ``hvps`` of them, T + 1 by default: one per
    point, its two gradient calls' cotangents added, which bfloat16
    operands forbid, 2 T then), and per net application the transposed
    products, the outer products of the weight cotangents (each as many
    multiply-adds as the net's own products) and the substep's elementwise
    VJP; plus the sum of the blocks' partial cotangents. The primal sweep
    and the nets' forward pass count once."""
    hvps = T + 1 if hvps is None else hvps
    net_products = _net_products(D, H, H2)
    recompute = ((T + 1) * _decoder_grad_ops(D, E, P)
                 + T * (4 * (_stq_ops(D, H, H2) + H) + 4 * 12 * D))
    back = (hvps * _decoder_grad_ops(D, E, P)
            + 4 * T * (2 * net_products + 40 * D))
    ops = N * (recompute + back) + n_grads * blocks
    products = N * ((T + 1 + hvps) * _dec_products(D, E, P) + 12 * T * net_products)
    nbytes = (4 * (4 * D * N + N + P * N + H * N + 2 * D * N + H * N + n_grads)
              + weight_bytes)
    return ops, products, nbytes


def vae_traj_bwd_bound(D, H, H2, T, E, P, N, weight_floats, n_grads, blocks):
    ops, _, nbytes = vae_traj_bwd_work(D, H, H2, T, E, P, N, 4 * weight_floats, n_grads,
                                       blocks)
    return _bound(ops, nbytes)


def _vjp_compare(fv, inp, xr, z, v, dZ, dV, dld, reverse):
    """The VJP kernel against its plain version: (mask of the chains set
    aside for a flipped ReLU gate, largest error of a leaf over the leaf's
    largest entry without them, largest absolute error, bit-for-bit
    repeat)."""
    import torch

    from l2hmc_tpu_torch.train.optim import tree_leaves

    def both(dZ_, dV_, dld_):
        got = fv.vae_trajectory_vjp(inp, xr, z, v, dZ_, dV_, dld_, reverse)
        ref = fv.vae_trajectory_vjp_plain(inp, z, v, dZ_, dV_, dld_, reverse)
        return got, ref

    got, ref = both(dZ, dV, dld)
    again = fv.vae_trajectory_vjp(inp, xr, z, v, dZ, dV, dld, reverse)
    repeats = all(bool((a == b).all())
                  for a, b in zip(tree_leaves(list(again)), tree_leaves(list(got))))
    flipped = torch.zeros(z.shape[1], dtype=torch.bool, device=z.device)
    for a, b in zip(got[3:], ref[3:]):  # demb, dz, dv: one column per chain
        flipped |= (a - b).abs().amax(dim=0) > VAE_BWD_TOL * b.abs().max()
    if bool(flipped.any()):
        keep = (~flipped).to(z.dtype)[None, :]
        got, ref = both(dZ * keep, dV * keep, dld * keep)
    rel, abs_err = 0.0, 0.0
    for a, b in zip(tree_leaves(list(got)), tree_leaves(list(ref))):
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        abs_err = max(abs_err, err)
        rel = max(rel, err / scale if scale > 0 else (0.0 if err == 0 else float("inf")))
    return flipped, rel, abs_err, repeats


def vae_train_phases(dev, report, logdir):
    """Phase 7: the VAE training kernels against their plain versions, fused
    against plain training, and the training path through its entry points;
    returns the two kernels' rows of the ``kernels`` line."""
    import numpy as np
    import torch

    from l2hmc_tpu_torch.apps import data as data_lib
    from l2hmc_tpu_torch.apps import eval_vae, vae
    from l2hmc_tpu_torch.ops import fused_dynamics as fd
    from l2hmc_tpu_torch.ops import fused_vae as fv
    from l2hmc_tpu_torch.train.optim import tree_leaves

    t_phase = time.perf_counter()
    cfg = vae.VaeConfig()
    model = vae.VaeModel.build(cfg)
    params = lift_vae_params(model.init_params(_gen(0), device=dev))
    dataset = data_lib.get_data()
    dyn = model.dynamics
    D, T = dyn.dim, dyn.T
    x_test = data_lib.binarize(np.random.default_rng(0), dataset.test)

    def inputs(n):
        x = torch.as_tensor(x_test[np.arange(n) % len(x_test)], device=dev)
        with torch.no_grad():
            emb = model.aux_encoder.apply(params["smp"]["aux_enc"], x)
        g = _gen(1000 + n)
        z, v, dZ, dV = (torch.randn((D, n), generator=g).to(dev) for _ in range(4))
        dld = torch.randn((1, n), generator=g).to(dev)
        xr = x.T.contiguous()
        inp = fv.prepare_vae(dyn, params["smp"], params["dec"], xr, emb.T.contiguous())
        return inp, xr, z, v, dZ, dV, dld

    # (a), (b) the two kernels vs plain
    traj_cmp, bwd_cmp = {}, {}
    for n in (cfg.batch_size, 203):
        inp, xr, z, v, dZ, dV, dld = inputs(n)
        for reverse in (False, True):
            name = f"n{n}_{'backward' if reverse else 'forward'}"
            got = fv.vae_trajectory(inp, xr, z, v, reverse)
            ref = fv.vae_trajectory_plain(inp, z, v, reverse)
            _require(all(bool(torch.isfinite(a).all()) for a in got),
                     f"vae_traj {name}: non-finite output")
            traj_cmp[name] = max(float((a - b).abs().max()) for a, b in zip(got, ref))
            _require(traj_cmp[name] < TRAJ_TOL, f"vae_traj {name}: off by {traj_cmp[name]}")
            flipped, rel, abs_err, repeats = _vjp_compare(
                fv, inp, xr, z, v, dZ, dV, dld, reverse)
            margins = fd.relu_margins(inp, z, v, reverse)
            flips = int(flipped.sum())
            margin = float(margins[flipped].max()) if flips else 0.0
            bwd_cmp[name] = {"flipped_relu_chains": flips, "their_relu_margin": margin,
                             "chains_within_margin": int((margins < VAE_RELU_MARGIN).sum()),
                             "smallest_relu_margin": float(margins.min()),
                             "max_rel_err": rel, "max_abs_err": abs_err,
                             "repeats_bit_for_bit": repeats}
            _require(repeats, f"vae_traj_bwd {name}: two launches differ")
            _require(flips <= VAE_BWD_FLIPS and margin < VAE_RELU_MARGIN
                     and rel <= VAE_BWD_TOL, f"vae_traj_bwd {name}: {bwd_cmp[name]}")
    report["vae_traj_vs_plain"] = traj_cmp
    report["vae_traj_bwd_vs_plain"] = bwd_cmp
    print(f"# VAE trajectory kernel vs plain ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(traj_cmp), flush=True)
    print("# VAE backward kernel vs plain: " + json.dumps(bwd_cmp), flush=True)

    # times at the training batch
    n_tr = cfg.batch_size
    inp, xr, z, v, dZ, dV, dld = inputs(n_tr)
    H, H2 = inp.dims[1], inp.dims[2]
    E, P = inp.consts[0].shape[0], inp.consts[4].shape[0]
    traj_ms = _cuda_time(lambda: fv.vae_trajectory(inp, xr, z, v, False), 10)
    bwd_ms = _cuda_time(lambda: fv.vae_trajectory_vjp(inp, xr, z, v, dZ, dV, dld, False), 10)
    dims = (D, H, H2, T, E, P)
    sizes = fv.kernel_sizes("vae_traj_bwd", dims, n_tr)
    config = (sizes["ct"], sizes["g"])
    clusters_at_once = [fv.max_clusters(dims, False), fv.max_clusters(dims, True)]
    traj_plain_ms = _cuda_time(lambda: fv.vae_trajectory_plain(inp, z, v, False), 3)
    bwd_plain_ms = _cuda_time(
        lambda: fv.vae_trajectory_vjp_plain(inp, z, v, dZ, dV, dld, False), 3)
    weight_floats = (sum(a.numel() for a in inp.consts)
                     + sum(w.numel() for w in [*inp.xnet_w, *inp.vnet_w]) + D + D * T)
    n_grads = sum(w.numel() for w in [*inp.xnet_w, *inp.vnet_w]) + D
    traj_bound_ms, traj_bound_by = vae_traj_bound(D, H, H2, T, E, P, n_tr, weight_floats)
    bwd_bound_ms, bwd_bound_by = vae_traj_bwd_bound(
        D, H, H2, T, E, P, n_tr, weight_floats, n_grads, -(-n_tr // config[0]))
    # weight bytes from the L2 per launch, reckoned from the shapes (the
    # backward kernel reads twice the forward's: the pass forward, then the
    # sweeps with a tangent and the nets' transposed products)
    dec_bytes, net_bytes = fv.weight_l2_bytes(config[0], n_tr, *dims)
    # for context only: the trajectory's 36 decoder products (T + 1
    # gradients of six) as float32 torch.matmul (cuBLAS, TF32 off) on the
    # same shapes; the port never calls this
    torch.backends.cuda.matmul.allow_tf32 = False
    A1, _, A2, _, A3, _ = inp.consts
    mats = [(A1, z), (A2, torch.randn((E, n_tr), generator=_gen(5)).to(dev)),
            (A3, torch.randn((E, n_tr), generator=_gen(6)).to(dev)),
            (A3.T, torch.randn((P, n_tr), generator=_gen(7)).to(dev)),
            (A2.T, torch.randn((E, n_tr), generator=_gen(8)).to(dev)),
            (A1.T, torch.randn((E, n_tr), generator=_gen(9)).to(dev))]

    def decoder_products():
        for _ in range(T + 1):
            for a_, b_ in mats:
                torch.matmul(a_, b_)

    cublas_ms = _cuda_time(decoder_products, 20)
    report["vae_traj_kernels_at_the_training_batch"] = {
        "chains": n_tr, "config_Ct_G": list(config), "ms_traj_bwd": [traj_ms, bwd_ms],
        "clusters_at_once_traj_bwd": clusters_at_once,
        "vae_traj_bwd_scratch_bytes_act_partial_bnd": [
            4 * sizes[k] for k in ("act", "partial", "bnd")],
        "vae_traj_weight_l2_bytes_decoder_nets": [dec_bytes, net_bytes],
        "vae_traj_bwd_weight_l2_bytes_decoder_nets": [2 * dec_bytes, 2 * net_bytes],
        "vae_traj_share_of_bound": traj_bound_ms / traj_ms,
        "vae_traj_bwd_share_of_bound": bwd_bound_ms / bwd_ms,
        "cublas_f32_36_decoder_products_ms_context_only": cublas_ms,
    }
    print("# VAE training kernels at the training batch: "
          + json.dumps(report["vae_traj_kernels_at_the_training_batch"]), flush=True)

    # (c) fused vs plain training on one seed, the same batches; beside the
    # plain run, the fused losses at each of its states with its draws
    t_phase = time.perf_counter()
    x_train = data_lib.binarize(np.random.default_rng(1), dataset.train)
    batches = [torch.as_tensor(x_train[(i * n_tr) % (len(x_train) - n_tr):][:n_tr], device=dev)
               for i in range(20)]
    hists, at_plain_states = {}, []
    fused_losses = vae.make_train_step(
        vae.VaeModel.build(vae.VaeConfig(fused_train=True)), 8).losses
    for fused in (True, False):
        m = vae.VaeModel.build(vae.VaeConfig(fused_train=fused))
        state = vae.init_state(m, 8, device=dev)
        step_fn = vae.make_train_step(m, 8)
        rows = []
        for b in batches:
            if not fused:
                draws = torch.Generator()
                draws.set_state(state.generator.get_state())
                with torch.no_grad():
                    at_plain_states.append(
                        [float(t) for t in fused_losses(state.params, b, draws)[:3]])
            state, metrics = step_fn(state, b)
            rows.append([float(metrics[k]) for k in ("elbo", "sampler_loss", "log_prob")])
        hists[fused] = np.asarray(rows)

    def where(gaps):
        """The loss and the step (1-based) of the largest entry of a
        (steps, 3) array of gaps."""
        step, col = np.unravel_index(int(np.argmax(gaps)), gaps.shape)
        return [("elbo", "sampler_loss", "log_prob")[col], int(step) + 1]

    same_params = _over_tolerance(np.asarray(at_plain_states), hists[False])
    same_params_gap = float(same_params.max())
    free = _over_tolerance(hists[True], hists[False])
    held = np.where(np.arange(len(free))[:, None] < VAE_SAMPLER_FREE_STEPS, free,
                    free * np.asarray([1.0, 0.0, 1.0]))
    gap = float(held.max())
    report["vae_train_fused_vs_plain"] = {
        "steps": len(batches), "batch": n_tr,
        "elbo_sampler_loss_log_prob_fused": hists[True].tolist(),
        "elbo_sampler_loss_log_prob_plain": hists[False].tolist(),
        "elbo_sampler_loss_log_prob_fused_at_plain_states": at_plain_states,
        "same_params_max_gap_over_tolerance": same_params_gap,
        "same_params_max_gap_at_loss_step": where(same_params),
        "same_params_gap_over_tolerance_by_step": same_params.tolist(),
        "max_gap_over_tolerance": gap,
        "max_gap_at_loss_step": where(held),
        "free_gap_over_tolerance_by_step": free.tolist(),
        "sampler_loss_free_steps_held": VAE_SAMPLER_FREE_STEPS,
    }
    print(f"# fused vs plain VAE training ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(report["vae_train_fused_vs_plain"]), flush=True)
    _require(bool(np.isfinite(hists[True]).all()), "non-finite fused VAE training history")
    _require(same_params_gap <= 1.0,
             f"fused and plain VAE losses from the same parameters differ: "
             f"{same_params_gap} x tolerance")
    _require(gap <= 1.0, f"fused and plain VAE histories differ: {gap} x tolerance")

    # (d) the training path: train -> checkpoint -> restore -> evaluate
    fd.reset_launch_counts()
    t_phase = time.perf_counter()
    tcfg = vae.VaeConfig(fused_train=True, epochs=VAE_TRAIN_EPOCHS,
                         eval_samples_every=VAE_TRAIN_EPOCHS - 1)
    _, state, last = vae.train(tcfg, logdir=logdir, log_every=4, verbose=False)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t_phase
    train_launches = dict(fd.LAUNCHES)
    steps = state.step
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    elbos = [row["elbo"] for row in logged]

    t_plain = time.perf_counter()
    _, plain_state, _ = vae.train(vae.VaeConfig(epochs=2), verbose=False)
    torch.cuda.synchronize()
    plain_step_ms = 1e3 * (time.perf_counter() - t_plain) / plain_state.step

    fd.reset_launch_counts()
    t_eval = time.perf_counter()
    ckpt = os.path.join(logdir, "ckpt")
    r_model, r_state = vae.restore(ckpt)
    same = all(bool((a == b).all()) for a, b in
               zip(tree_leaves(r_state.params), tree_leaves(state.params)))
    ll = eval_vae.run(r_model, r_state.params, eval_vae.EvalVaeConfig(), dataset, seed=0,
                      max_datapoints=100)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t_eval
    eval_launches = dict(fd.LAUNCHES)
    kernel_ms_per_step = 2 * cfg.mh_steps * (traj_ms + bwd_ms)
    report["vae_training_path"] = {
        "batch": n_tr, "mh_steps": cfg.mh_steps, "steps": steps, "epochs": VAE_TRAIN_EPOCHS,
        "data_source": dataset.source, "train_s": train_s,
        "ms_per_step_fused": 1e3 * train_s / steps, "ms_per_step_plain": plain_step_ms,
        "plain_steps": plain_state.step,
        "vae_traj_ms": traj_ms, "vae_traj_bwd_ms": bwd_ms,
        "kernel_ms_per_step": kernel_ms_per_step,
        "kernel_share_of_step": kernel_ms_per_step / (1e3 * train_s / steps),
        "elbo_first_last_logged": [elbos[0], elbos[-1]], "elbo_min_logged": min(elbos),
        "final": last, "launches": train_launches,
        "restored_step": r_state.step, "restored_params_equal": same,
        "log_likelihood_restored": ll, "eval_s": eval_s, "eval_launches": eval_launches,
    }
    print(f"# VAE training path ({train_s:.1f} s, restore and AIS {eval_s:.1f} s): "
          + json.dumps(report["vae_training_path"]), flush=True)
    _require(all(np.isfinite(list(row.values())).all() for row in logged),
             "non-finite VAE training metric")
    _require(elbos[-1] < elbos[0], f"ELBO did not fall: {elbos[0]} -> {elbos[-1]}")
    _require(0.0 < last["p_accept"] <= 1.0, f"sampler acceptance {last['p_accept']}")
    for name in ("vae_traj", "vae_traj_bwd"):
        _require(train_launches[name] == 2 * cfg.mh_steps * steps,
                 f"kernel {name}: {train_launches[name]} launches in {steps} steps")
    _require(os.path.exists(ckpt) and os.path.exists(ckpt + ".config.json"),
             "no checkpoint written")
    _require(r_state.step == steps and same, "restored state differs from the trained one")
    _require(np.isfinite(ll), "non-finite AIS estimate of the restored VAE")
    _require(eval_launches["vae_ais"] > 0, "kernel vae_ais not launched on the restored VAE")

    src = "l2hmc_tpu_torch/csrc/"
    shape = (f"VAE latent {D}, decoder {E}, nets {H}/{H2}, T={T}, {n_tr} chains, clusters of "
             f"{config[1]} CTAs sharing {config[0]} chains, one direction (the training batch)")
    return [
        {"name": "vae_traj", "route": "cuda", "source": src + "vae_traj.cu",
         "replaces": "l2hmc_tpu/ops/fused_dynamics.py:1622",
         "launches": train_launches["vae_traj"], "max_abs_err": max(traj_cmp.values()),
         "ms": traj_ms, "plain_ms": traj_plain_ms, "bound_ms": traj_bound_ms,
         "bound_by": traj_bound_by, "library_ms": None, "shape": shape},
        {"name": "vae_traj_bwd", "route": "cuda", "source": src + "vae_traj_bwd.cu",
         "replaces": "l2hmc_tpu/ops/fused_dynamics.py:1649",
         "launches": train_launches["vae_traj_bwd"],
         "max_abs_err": max(c["max_abs_err"] for c in bwd_cmp.values()),
         "ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound_ms,
         "bound_by": bwd_bound_by, "library_ms": None, "shape": shape},
    ]


# -- 12. bfloat16 operands in the VAE kernels ---------------------------------------
#
# The four VAE kernels' bfloat16 instantiations (compute_dtype="bfloat16")
# against their plain versions with the same operands (ops/operands.py),
# which round at the same sites: the two differ where float32 sums in
# another order put a value on the other side of a bfloat16 rounding
# boundary. At the card tests' small width that is rare (12a's small-width
# case; on an H100: the VJP within 0.034-0.047 of the bf16-float32 gap in
# RMS, the trajectory within 0.012). At the reference width (sums of 1024
# terms, ~3000 rounded values a chain and sweep) it happens a few times a
# sweep, and a flipped rounding (2^-8 of the value) moves that chain's
# later values, though less than lowering every operand does. So each
# comparison is held to a share of the gap between the plain bfloat16 and
# the plain float32 results on the same inputs (the bf16-float32 gap):
# BF16_GAP_SHARE on the trajectories in max-norm and RMS and on the
# sampler's chains in RMS over the chains that flipped in neither
# comparison. The VJP, whose Hessian terms carry every flip of the pass
# forward, is bounded by BF16_VJP_GAP_SHARE of each leaf's gap in RMS (on
# an H100 0.45-0.61 here, up to 0.92 on the card tests' inputs, where the
# plain VJP summed in float64 reads up to 0.79 and the float32 kernel 1.0:
# RMS does not tell them apart) and held by the shares of the bf16 signals
# it carries (``_vjp_shares``), which do: the whole bf16-float32 gap within
# BF16_SIGNAL_BAND of 1 (0.86-0.95; the float32 kernel 0.00), and the part
# that rounding the cotangents makes at least BF16_CT_SHARE (0.34-0.74 at
# the reference width, 0.97 at the small one; a VJP without that rounding
# reads 0). A sound VJP reads under 1 there because a flipped rounding
# upstream moves a cotangent by more than its own rounding error, which
# then no longer matches the plain version's: the plain VJP summed in
# float64, a sound one in another order, reads 0.91-0.98 and 0.53-0.88.
# AIS chains that part once stay apart (20 anneal steps of 10 leapfrogs
# carry a flipped rounding into another path, as far as bf16 from float32
# does): its log w
# is held at BF16_GAP_SHARE in median over 20 steps and in RMS over one. A
# flipped accept (|px - u| within the two versions' Hamiltonian gap, ~1e-2
# here against float32's ~1e-4) sends a chain elsewhere: at most
# BF16_FLIP_SHARE of the chains may flip (a tenth on an H100). The bf16
# trajectory inverts as its plain version does: most chains to float32
# rounding, but a state carried back with float32 rounding can put a value
# on the other side of a bf16 boundary (the JAX package's exact inverse at
# its test's widths, 1e-5, is no bound here): at most BF16_FLIP_SHARE of
# the chains miss by more than BF16_INVERSE_TOL, none by more than
# BF16_RESOLUTION (the JAX package's bf16 parity bar; 1-2% of the chains
# and 6.2e-3 at most on an H100, the plain version alike).
BF16_GAP_SHARE = 0.5
BF16_VJP_GAP_SHARE = 1.0
BF16_SIGNAL_BAND = 0.25
BF16_CT_SHARE = 0.25
BF16_FLIP_SHARE = 0.2
BF16_INVERSE_TOL = 1e-4
BF16_RESOLUTION = 2e-2
# (d): fused bf16 training against its plain route at the plain run's
# states, the ELBO and log-probability at phase 7c's bar. The sampler loss
# (a mean over 512 chains of jump distances over the encoder's variances
# and of their reciprocals, near -1e4 and carried by a few chains) moves
# with every accept that a bf16 rounding flips, a tenth of the chains as in
# (b): it is held at rtol BF16_SAMPLER_LOSS_RTOL (2.6e-3 at its worst step
# on an H100).
BF16_SAMPLER_LOSS_RTOL = 1e-2
# (e): the training path at 8 batches of 512 an epoch, cut to 6 epochs (48
# steps; phase 7d's 20 epochs, 160 steps) to keep the script near 1100 s
# with phase 13
BF16_TRAIN_EPOCHS = 6
# (e): the restored model's posterior through the bf16 sampler: the
# sampling protocol's 200 chains cut to this many recorded steps
BF16_SAMPLER_STEPS = 100


def _gap(a, b, mask=None):
    """max |a - b| over the columns (chains) of ``mask`` (all without)."""
    d = (a - b).abs()
    if mask is not None:
        d = d[..., mask]
    return float(d.max()) if d.numel() else 0.0


def _rms(a, b, mask=None):
    """The root-mean-square of a - b over the columns of ``mask``."""
    d = (a - b).double()
    if mask is not None:
        d = d[..., mask]
    return float(d.pow(2).mean().sqrt()) if d.numel() else 0.0


def _share(err, gap):
    return err / gap if gap > 0 else (0.0 if err == 0 else float("inf"))


def _plain_vae_dynamics(fv, dynamics, compute_dtype):
    """``DifferentiableFusedVae``'s surface with its trajectories through
    the kernels' plain version (``vae_trajectory_plain``, the operands
    lowered by ``ops.operands``) under autograd: the plain route of bf16
    training, on the same tensors as the fused one."""

    class PlainVaeTrajectories(fv.DifferentiableFusedVae):
        def _run(self, params, z, v, aux, reverse: bool):
            x_raw = aux["raw"].detach().T.contiguous()
            inp = fv.prepare_vae(self.dynamics, params, aux["dec"], x_raw,
                                 aux["emb"].T.contiguous(), differentiable=True,
                                 compute_dtype=self.compute_dtype)
            Z, V, ld = fv.vae_trajectory_plain(inp, z.T.contiguous(), v.T.contiguous(), reverse)
            return Z.T, V.T, ld[0]

    return PlainVaeTrajectories(dynamics, compute_dtype=compute_dtype)


def _inner(a, b):
    return float(a.double().flatten() @ b.double().flatten())


def _plain_vjp_unrounded_cotangents(fv, inp, *args):
    """A control: the plain VJP with the forward's operands lowered but its
    activation cotangents left in float32, as a VJP that rounds the one and
    not the other would compute them (``ops.operands.dot_ct`` without its
    rounding of the product)."""
    from l2hmc_tpu_torch.ops import fused_dynamics as fd
    from l2hmc_tpu_torch.ops import operands

    def unrounded(w, g, cd):
        return operands.lower(w, cd) @ g

    saved = fd.dot_ct, fv.dot_ct
    fd.dot_ct = fv.dot_ct = unrounded
    try:
        return fv.vae_trajectory_vjp_plain(inp, *args)
    finally:
        fd.dot_ct, fv.dot_ct = saved


def _plain_vjp_float64(fv, inp, xr, *args):
    """A sound VJP that sums in another order: the plain bf16 VJP in
    float64 (operands still lowered to bfloat16), returned in float32."""
    def f64(t):
        return t.double()

    dec, x64 = [f64(a) for a in inp.consts], f64(xr)
    energy, grad_energy = fv._vae_decoder_closures(dec, x64, inp.cd)
    inp64 = dataclasses.replace(
        inp, eps=f64(inp.eps), masks=f64(inp.masks), consts=dec, emb=f64(inp.emb),
        xnet_w=[f64(a) for a in inp.xnet_w], vnet_w=[f64(a) for a in inp.vnet_w],
        energy=energy, grad_energy=grad_energy, grad_vjp=fv.build_grad_vjp(dec, x64, inp.cd))
    out = fv.vae_trajectory_vjp_plain(inp64, *(f64(t) for t in args[:-1]), args[-1])
    return [t.float() for t in _leaves(out)]


def _leaves(vjp):
    from l2hmc_tpu_torch.train.optim import tree_leaves

    return tree_leaves(list(vjp))


def _vjp_shares(leaves, ref, ref32, noct):
    """Over the leaves of a VJP: the largest share of the bf16-float32 gap
    in RMS, and the shares of the two bf16 signals that the VJP carries,
    the whole plain bf16-float32 gap and the part of it that rounding the
    activation cotangents makes (plain bf16 against ``noct``): each the
    projection of the VJP's difference from the signal's base on the signal,
    pooled over the leaves with each leaf's bf16-float32 gap as its unit
    (1 where the VJP carries the signal whole, 0 where it does not; noise
    off the signal's direction does not count)."""
    rms = sig_num = ct_num = ct_den = 0.0
    n = 0
    for a, b, c, d in zip(leaves, ref, ref32, noct):
        g2 = _inner(b - c, b - c)
        if g2 == 0:
            continue
        n += 1
        rms = max(rms, _share(_rms(a, b), _rms(b, c)))
        sig_num += _inner(a - c, b - c) / g2
        ct_num += _inner(a - d, b - d) / g2
        ct_den += _inner(b - d, b - d) / g2
    return {"rms_share_of_bf16_f32_gap": rms, "signal_share": sig_num / max(n, 1),
            "ct_signal_share": ct_num / ct_den if ct_den > 0 else 1.0}


def _bf16_vjp_compare(fv, inp, inp32, xr, z, v, dZ, dV, dld, reverse):
    """The bf16 VJP kernel against its plain version and the plain float32
    VJP, over the leaves: the largest share of the bf16-float32 gap in RMS,
    in max-norm and in median, the shares of the bf16 signals it carries
    (``_vjp_shares``: the bar), the kernel's largest gap over the leaf's
    largest entry, the largest absolute gap, the gap to the float32 kernel
    and a bit-for-bit repeat; and the same shares for two controls, the
    float32 VJP kernel and the plain VJP without the cotangents' rounding,
    which a VJP kernel that ignored bf16 or rounded only its forward would
    read, and for a sound VJP in another order (``_plain_vjp_float64``)."""
    import torch

    args = (z, v, dZ, dV, dld, reverse)
    got = fv.vae_trajectory_vjp(inp, xr, *args)
    again = fv.vae_trajectory_vjp(inp, xr, *args)
    k32 = fv.vae_trajectory_vjp(inp32, xr, *args)
    ref, ref32 = (fv.vae_trajectory_vjp_plain(i, *args) for i in (inp, inp32))
    noct = _plain_vjp_unrounded_cotangents(fv, inp, *args)
    got, again, k32, ref, ref32, noct = (_leaves(t)
                                         for t in (got, again, k32, ref, ref32, noct))
    repeats = all(bool(torch.equal(a, b)) for a, b in zip(again, got))
    max_share = med_share = rel = abs_err = 0.0
    for a, b, c in zip(got, ref, ref32):
        err, scale = _gap(a, b), float(b.abs().max())
        abs_err = max(abs_err, err)
        max_share = max(max_share, _share(err, _gap(b, c)))
        med_share = max(med_share, _share(float((a - b).abs().median()),
                                          float((b - c).abs().median())))
        rel = max(rel, err / scale if scale > 0 else 0.0)
    return {**_vjp_shares(got, ref, ref32, noct), "max_share_of_bf16_f32_gap": max_share,
            "median_share_of_bf16_f32_gap": med_share, "max_rel_err": rel,
            "max_abs_err": abs_err, "repeats_bit_for_bit": repeats,
            "kernel_bf16_vs_f32": max(_gap(a, b) for a, b in zip(got, k32)),
            "control_f32_kernel": _vjp_shares(k32, ref, ref32, noct),
            "control_unrounded_cotangents": _vjp_shares(noct, ref, ref32, noct),
            "plain_float64": _vjp_shares(_plain_vjp_float64(fv, inp, xr, *args), ref, ref32,
                                         noct)}


def _vjp_bars_hold(case, rms_share):
    """The bf16 VJP's bars: apart from the float32 kernel, within
    ``rms_share`` of each leaf's bf16-float32 gap in RMS, and carrying the
    bf16 signals (the whole within BF16_SIGNAL_BAND of 1, the cotangents'
    rounding at least BF16_CT_SHARE); the two controls must miss them, or
    the bars could not tell them apart."""
    def carries(c):
        return (abs(c["signal_share"] - 1.0) <= BF16_SIGNAL_BAND
                and c["ct_signal_share"] >= BF16_CT_SHARE)

    return (case["kernel_bf16_vs_f32"] > 0 and case["rms_share_of_bf16_f32_gap"] <= rms_share
            and carries(case) and not carries(case["control_f32_kernel"])
            and not carries(case["control_unrounded_cotangents"]))


def _bf16_small_width(dev):
    """Phase 12a at the card tests' small width (latent 8, decoder 32, nets
    16/16, T = 3; 203 chains, lifted weights), where a flipped rounding is
    rare: the training kernels' shares of the bf16-float32 gap, the
    trajectory in max-norm and RMS, the VJP's leaves in RMS, each held at
    BF16_GAP_SHARE."""
    import torch

    from l2hmc_tpu_torch.apps import vae
    from l2hmc_tpu_torch.ops import fused_vae as fv

    cfg = vae.VaeConfig(latent_dim=8, leapfrogs=3, enc_hidden=32, sampler_size1=16,
                        sampler_size2=16)
    model = vae.VaeModel.build(cfg)
    params = lift_vae_params(model.init_params(_gen(0), device=dev))
    n, D = 203, cfg.latent_dim
    g = _gen(1000 + n)
    x = (torch.rand((n, 784), generator=g) < 0.3).float().to(dev)
    with torch.no_grad():
        emb = model.aux_encoder.apply(params["smp"]["aux_enc"], x)
    z, v, dZ, dV = (torch.randn((D, n), generator=g).to(dev) for _ in range(4))
    dld = torch.randn((1, n), generator=g).to(dev)
    xr, embT = x.T.contiguous(), emb.T.contiguous()
    inp, inp32 = (fv.prepare_vae(model.dynamics, params["smp"], params["dec"], xr, embT,
                                 compute_dtype=c) for c in ("bfloat16", None))
    out = {}
    for reverse in (False, True):
        got = fv.vae_trajectory(inp, xr, z, v, reverse)
        ref = fv.vae_trajectory_plain(inp, z, v, reverse)
        ref32 = fv.vae_trajectory_plain(inp32, z, v, reverse)
        case = {"traj_max_share": max(_share(_gap(a, b), _gap(b, c))
                                      for a, b, c in zip(got, ref, ref32)),
                "traj_rms_share": max(_share(_rms(a, b), _rms(b, c))
                                      for a, b, c in zip(got, ref, ref32)),
                **_bf16_vjp_compare(fv, inp, inp32, xr, z, v, dZ, dV, dld, reverse)}
        out["backward" if reverse else "forward"] = case
        _require(max(case["traj_max_share"], case["traj_rms_share"]) <= BF16_GAP_SHARE
                 and _vjp_bars_hold(case, BF16_GAP_SHARE) and case["repeats_bit_for_bit"],
                 f"bf16 training kernels, small width: {case}")
    return out


def _bf16_ais_log_likelihood(fv, params, x, k_chains, latent_dim, acfg, seed, dev):
    """``eval_vae.run``'s protocol (the seeded binarization ``x``, its start
    states and seeds from one generator, 50 datapoints an AIS batch) through
    ``FusedVaeAis(compute_dtype="bfloat16")``: the average of the
    per-datapoint logmeanexp of log w."""
    import math

    import torch

    gen = torch.Generator().manual_seed(seed)
    total = 0.0
    for i in range(0, x.shape[0], acfg.num_splits):
        batch = torch.as_tensor(x[i:i + acfg.num_splits], dtype=torch.float32, device=dev)
        tiled = torch.repeat_interleave(batch, k_chains, dim=0)
        z0 = torch.randn((tiled.shape[0], latent_dim), generator=gen).to(dev)
        s = int(torch.randint(0, 2**31 - 1, (), generator=gen))
        w, _ = fv.FusedVaeAis(latent_dim=latent_dim, compute_dtype="bfloat16").run(
            params["dec"], tiled, z0, seed=s, anneal_steps=acfg.anneal_steps,
            step_size=acfg.step_size, leapfrogs=acfg.leapfrogs)
        groups = w.reshape(batch.shape[0], k_chains)
        total += float(torch.sum(torch.logsumexp(groups, dim=1) - math.log(k_chains)))
    return total / x.shape[0]


def _weight_bytes(fv, inp):
    """Bytes of the weights a cluster kernel reads for ``inp``, as the
    wrapper hands them over (``fused_vae._weight_ptrs``: the products'
    matrices in ``inp.cd``, the rest float32)."""
    arrays = fv._weight_ptrs(inp, inp.eps.device)[1]
    return sum(a.numel() * a.element_size() for a in arrays)


def bf16_vae_phases(dev, report, logdir, cfg=None):
    """Phase 12: the four VAE kernels' bfloat16 instantiations against their
    plain versions, bf16 training against its plain route, the bf16 path
    through its entry points and the kernels' times; returns their rows of
    the ``kernels`` line. ``cfg`` is the model's ``VaeConfig`` (the
    reference model by default)."""
    import numpy as np
    import torch

    from l2hmc_tpu_torch.apps import data as data_lib
    from l2hmc_tpu_torch.apps import eval_sampler, eval_vae, vae
    from l2hmc_tpu_torch.ops import _cuda
    from l2hmc_tpu_torch.ops import fused_dynamics as fd
    from l2hmc_tpu_torch.ops import fused_vae as fv
    from l2hmc_tpu_torch.train.optim import tree_leaves

    BF = "bfloat16"
    t_phase = time.perf_counter()
    cfg = vae.VaeConfig() if cfg is None else cfg
    model = vae.VaeModel.build(cfg)
    params = lift_vae_params(model.init_params(_gen(0), device=dev))
    dataset = data_lib.get_data()
    dyn = model.dynamics
    D, T = dyn.dim, dyn.T
    x_test = data_lib.binarize(np.random.default_rng(0), dataset.test)
    dec = fv.decoder_arrays(params["dec"])
    E, P = dec[0].shape[0], dec[4].shape[0]

    def batch(n):
        """n test images (cycled), their embedding and a N(0, I) start."""
        x = torch.as_tensor(x_test[np.arange(n) % len(x_test)], device=dev)
        with torch.no_grad():
            emb = model.aux_encoder.apply(params["smp"]["aux_enc"], x)
        z = torch.randn((n, D), generator=_gen(n)).to(dev)
        return x.T.contiguous(), emb.T.contiguous(), z.T.contiguous()

    def inputs(n):
        """Phase 7's inputs at n chains, with bf16 and with float32
        operands."""
        xr, embT, _ = batch(n)
        g = _gen(1000 + n)
        z, v, dZ, dV = (torch.randn((D, n), generator=g).to(dev) for _ in range(4))
        dld = torch.randn((1, n), generator=g).to(dev)
        inp, inp32 = (fv.prepare_vae(dyn, params["smp"], params["dec"], xr, embT, compute_dtype=c)
                      for c in (BF, None))
        return inp, inp32, xr, z, v, dZ, dV, dld

    # (a) rows 4-5: the training kernels at the training batch and a ragged
    # count, both directions
    traj_cmp, bwd_cmp = {}, {}
    for n in (cfg.batch_size, 203):
        inp, inp32, xr, z, v, dZ, dV, dld = inputs(n)
        for reverse in (False, True):
            name = f"n{n}_{'backward' if reverse else 'forward'}"
            got = fv.vae_trajectory(inp, xr, z, v, reverse)
            again = fv.vae_trajectory(inp, xr, z, v, reverse)
            ref = fv.vae_trajectory_plain(inp, z, v, reverse)
            ref32 = fv.vae_trajectory_plain(inp32, z, v, reverse)
            k32 = fv.vae_trajectory(inp32, xr, z, v, reverse)
            inv = fv.vae_trajectory(inp, xr, got[0], got[1], not reverse)
            pinv = fv.vae_trajectory_plain(inp, ref[0], ref[1], not reverse)

            def chain_err(back):
                """Per chain, the largest miss of (z, v) after the inverse."""
                return torch.maximum((back[0] - z).abs().amax(0), (back[1] - v).abs().amax(0))

            k_inv, p_inv = chain_err(inv), chain_err(pinv)
            case = {
                "max_abs_err": max(_gap(a, b) for a, b in zip(got, ref)),
                "max_share_of_bf16_f32_gap": max(_share(_gap(a, b), _gap(b, c))
                                                 for a, b, c in zip(got, ref, ref32)),
                "rms_share_of_bf16_f32_gap": max(_share(_rms(a, b), _rms(b, c))
                                                 for a, b, c in zip(got, ref, ref32)),
                "plain_bf16_vs_f32": max(_gap(a, b) for a, b in zip(ref, ref32)),
                "kernel_bf16_vs_f32": max(_gap(a, b) for a, b in zip(got, k32)),
                "inverse_err": max(_gap(inv[0], z), _gap(inv[1], v), _gap(inv[2], -got[2])),
                "inverse_err_plain": max(_gap(pinv[0], z), _gap(pinv[1], v),
                                         _gap(pinv[2], -ref[2])),
                "inverse_chains_over_tol": int((k_inv > BF16_INVERSE_TOL).sum()),
                "inverse_chains_over_tol_plain": int((p_inv > BF16_INVERSE_TOL).sum()),
                "inverse_median": float(k_inv.median()),
                "repeats_bit_for_bit": all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
            }
            traj_cmp[name] = case
            _require(all(bool(torch.isfinite(a).all()) for a in got),
                     f"vae_traj bf16 {name}: non-finite output")
            _require(case["repeats_bit_for_bit"], f"vae_traj bf16 {name}: two launches differ")
            _require(case["max_share_of_bf16_f32_gap"] <= BF16_GAP_SHARE
                     and case["rms_share_of_bf16_f32_gap"] <= BF16_GAP_SHARE
                     and case["kernel_bf16_vs_f32"] > 0
                     and case["inverse_chains_over_tol"] <= BF16_FLIP_SHARE * n
                     and case["inverse_err"] <= BF16_RESOLUTION,
                     f"vae_traj bf16 {name}: {case}")
            bwd = _bf16_vjp_compare(fv, inp, inp32, xr, z, v, dZ, dV, dld, reverse)
            bwd_cmp[name] = bwd
            _require(bwd["repeats_bit_for_bit"], f"vae_traj_bwd bf16 {name}: two launches differ")
            _require(_vjp_bars_hold(bwd, BF16_VJP_GAP_SHARE), f"vae_traj_bwd bf16 {name}: {bwd}")
    small = _bf16_small_width(dev)
    report["bf16_vae_traj_vs_plain"] = traj_cmp
    report["bf16_vae_traj_bwd_vs_plain"] = bwd_cmp
    report["bf16_vae_training_kernels_small_width"] = small
    print(f"# bf16 VAE training kernels vs plain ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps({"vae_traj": traj_cmp, "vae_traj_bwd": bwd_cmp,
                        "small_width": small}), flush=True)

    # (b) row 6: the sampler on the same Philox bits, single and composed ops
    t_phase = time.perf_counter()
    chain_cmp = {}
    for n in (9, 203, 256):
        xr, embT, zT = batch(n)
        inp, inp32 = (fv.prepare_vae(dyn, params["smp"], params["dec"], xr, embT, compute_dtype=c)
                      for c in (BF, None))
        for name, nb in (("single", None), ("composed", [2, 1, 3])):
            kw = dict(seed=4, n_mh_steps=3, collect_trace=True, nb=nb)
            zk, acck, trk = fv.vae_chain(inp, xr, zT, **kw)
            again = fv.vae_chain(inp, xr, zT, **kw)
            z32, _, _ = fv.vae_chain(inp32, xr, zT, **kw)
            _, accp, trp = fv.vae_chain_plain(inp, zT, **kw)
            _, acc3, tr3 = fv.vae_chain_plain(inp32, zT, **kw)
            ops = 3 if nb is None else sum(nb)

            def moved_at(tr):
                """(K, N): the recorded steps at which a chain moved."""
                return (tr != torch.cat([zT[None], tr[:-1]])).any(dim=1)

            def flips(tr_a, acc_a, tr_b, acc_b):
                """Chains whose acceptance or a recorded step's move
                differs, or whose states part by 0.1 (ops that flipped
                apart within a step)."""
                return (((acc_a - acc_b).abs()[0] * ops > 0.5)
                        | (moved_at(tr_a) != moved_at(tr_b)).any(0)
                        | ((tr_a - tr_b).abs().amax(dim=(0, 1)) > 0.1))

            flipped, flip32 = flips(trk, acck, trp, accp), flips(trp, accp, tr3, acc3)
            clean = ~(flipped | flip32)
            case = {"flipped_chains": int(flipped.sum()), "bf16_f32_flipped_chains": int(flip32.sum()),
                    "max_abs_dz_unflipped": _gap(trk, trp, ~flipped),
                    "rms_share_of_bf16_f32_gap_unflipped": _share(_rms(trk, trp, clean),
                                                                  _rms(trp, tr3, clean)),
                    "max_share_of_bf16_f32_gap_unflipped": _share(_gap(trk, trp, clean),
                                                                  _gap(trp, tr3, clean)),
                    "kernel_bf16_vs_f32": _gap(zk, z32),
                    "repeats_bit_for_bit": all(bool(torch.equal(a, b))
                                               for a, b in zip((zk, acck, trk), again)),
                    "accept": float(acck.mean()), "moved": _gap(zk, zT)}
            chain_cmp[f"n{n}_{name}"] = case
            _require(bool(torch.isfinite(trk).all()) and bool(torch.equal(trk[-1], zk)),
                     f"vae_chain bf16 {n} {name}: non-finite trace or trace end != state")
            _require(case["repeats_bit_for_bit"], f"vae_chain bf16 {n} {name}: launches differ")
            _require(case["flipped_chains"] <= max(VAE_FLIPS, BF16_FLIP_SHARE * n)
                     and case["rms_share_of_bf16_f32_gap_unflipped"] <= BF16_GAP_SHARE
                     and case["kernel_bf16_vs_f32"] > 0 and case["moved"] > 0.05,
                     f"vae_chain bf16 {n} {name}: {case}")
    report["bf16_vae_chain_vs_plain"] = chain_cmp
    print(f"# bf16 VAE sampler kernel vs plain ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(chain_cmp), flush=True)

    # (c) row 7: AIS on the same bits, at the protocol's 1000 chains and a
    # ragged count
    t_phase = time.perf_counter()
    k_ais, l_ais = 20, 10
    ais_cmp = {"anneal_steps": k_ais, "leapfrogs": l_ais}
    for n in (1000, 203):
        xr, _, zT = batch(n)
        kw = dict(seed=6, anneal_steps=k_ais, step_size=0.05, leapfrogs=l_ais)
        wk, acck = fv.vae_ais(dec, xr, zT, **kw, compute_dtype=BF)
        wk2, acck2 = fv.vae_ais(dec, xr, zT, **kw, compute_dtype=BF)
        w32, _ = fv.vae_ais(dec, xr, zT, **kw)
        wp, accp = fv.vae_ais_plain(dec, xr, zT, **kw, compute_dtype=BF)
        w3, acc3 = fv.vae_ais_plain(dec, xr, zT, **kw)
        # one anneal step: the chains have not parted yet
        kw1 = dict(kw, anneal_steps=1)
        w1k, w1p, w13 = (fn(dec, xr, zT, **kw1, **c)[0] for fn, c in (
            (fv.vae_ais, {"compute_dtype": BF}), (fv.vae_ais_plain, {"compute_dtype": BF}),
            (fv.vae_ais_plain, {})))
        # a flipped accept moves a chain's log w by O(1)
        flipped, flip32 = ((wk - wp).abs()[0] >= 0.5), ((wp - w3).abs()[0] >= 0.5)
        clean = ~(flipped | flip32)
        case = {"flipped_chains": int(flipped.sum()), "bf16_f32_flipped_chains": int(flip32.sum()),
                "max_abs_dlogw_unflipped": _gap(wk, wp, ~flipped),
                "median_share_of_bf16_f32_gap": _share(float((wk - wp).abs().median()),
                                                       float((wp - w3).abs().median())),
                "rms_share_of_bf16_f32_gap_unflipped": _share(_rms(wk, wp, clean),
                                                              _rms(wp, w3, clean)),
                "rms_share_of_bf16_f32_gap_one_step": _share(_rms(w1k, w1p), _rms(w1p, w13)),
                "kernel_bf16_vs_f32_logw": _gap(wk, w32),
                "max_abs_daccept_unflipped": _gap(acck, accp, clean),
                "plain_bf16_vs_f32_accept": _gap(accp, acc3, clean),
                "repeats_bit_for_bit": bool(torch.equal(wk, wk2) and torch.equal(acck, acck2)),
                "logw_mean": float(wk.mean()), "accept": float(acck.mean())}
        ais_cmp[f"n{n}"] = case
        _require(bool(torch.isfinite(wk).all()), f"vae_ais bf16 {n}: non-finite log w")
        _require(case["repeats_bit_for_bit"], f"vae_ais bf16 {n}: two launches differ")
        _require(case["flipped_chains"] <= max(VAE_FLIPS, BF16_FLIP_SHARE * n)
                 and case["median_share_of_bf16_f32_gap"] <= BF16_GAP_SHARE
                 and case["rms_share_of_bf16_f32_gap_one_step"] <= BF16_GAP_SHARE
                 and case["kernel_bf16_vs_f32_logw"] > 0, f"vae_ais bf16 {n}: {case}")
    report["bf16_vae_ais_vs_plain"] = ais_cmp
    print(f"# bf16 AIS kernel vs plain ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(ais_cmp), flush=True)

    # (d) bf16 training, fused against its plain route on one seed: at each
    # of the plain run's 20 states the fused losses on the same batch and
    # draws, at phase 7c's bar
    t_phase = time.perf_counter()
    n_tr = cfg.batch_size
    x_train = data_lib.binarize(np.random.default_rng(1), dataset.train)
    batches = [torch.as_tensor(x_train[(i * n_tr) % (len(x_train) - n_tr):][:n_tr], device=dev)
               for i in range(20)]
    bf_cfg = dataclasses.replace(cfg, fused_train=True, fused_compute_dtype=BF)
    fused_losses = vae.make_train_step(vae.VaeModel.build(bf_cfg), 8).losses
    plain_model = vae.VaeModel.build(cfg)
    state = vae.init_state(plain_model, 8, device=dev)
    plain_step = vae.make_train_step(dataclasses.replace(
        plain_model, dynamics=_plain_vae_dynamics(fv, plain_model.dynamics, BF)), 8)
    rows, at_plain_states = [], []
    for b in batches:
        draws = torch.Generator()
        draws.set_state(state.generator.get_state())
        with torch.no_grad():
            at_plain_states.append([float(t) for t in fused_losses(state.params, b, draws)[:3]])
        state, metrics = plain_step(state, b)
        rows.append([float(metrics[k]) for k in ("elbo", "sampler_loss", "log_prob")])
    fused, plain = np.asarray(at_plain_states), np.asarray(rows)
    same_params = _over_tolerance(fused, plain)
    sampler_rel = np.abs(fused[:, 1] - plain[:, 1]) / (1e-2 + np.abs(plain[:, 1]))
    report["bf16_vae_train_fused_vs_plain"] = {
        "steps": len(batches), "batch": n_tr,
        "elbo_sampler_loss_log_prob_plain": rows,
        "elbo_sampler_loss_log_prob_fused_at_plain_states": at_plain_states,
        "same_params_elbo_log_prob_max_gap_over_tolerance": float(same_params[:, [0, 2]].max()),
        "same_params_sampler_loss_max_gap_over_tolerance": float(same_params[:, 1].max()),
        "same_params_sampler_loss_max_rel_gap": float(sampler_rel.max()),
        "same_params_sampler_loss_max_rel_gap_step": int(np.argmax(sampler_rel)) + 1}
    print(f"# bf16 fused vs plain VAE training ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(report["bf16_vae_train_fused_vs_plain"]), flush=True)
    _require(bool(np.isfinite(rows).all() and np.isfinite(at_plain_states).all()),
             "non-finite bf16 VAE training history")
    _require(float(same_params[:, [0, 2]].max()) <= 1.0
             and float(sampler_rel.max()) <= BF16_SAMPLER_LOSS_RTOL,
             "bf16 fused and plain VAE losses from the same parameters differ: "
             + json.dumps(report["bf16_vae_train_fused_vs_plain"]))

    # (e) the bf16 path: train -> checkpoint -> restore -> the restored
    # model's posterior through the bf16 sampler and its likelihood through
    # bf16 AIS, beside the float32 AIS of the same protocol
    fd.reset_launch_counts()
    t_phase = time.perf_counter()
    tcfg = dataclasses.replace(bf_cfg, epochs=BF16_TRAIN_EPOCHS,
                               eval_samples_every=BF16_TRAIN_EPOCHS - 1)
    _, state, last = vae.train(tcfg, logdir=logdir, log_every=4, verbose=False)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t_phase
    steps = state.step
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    elbos = [row["elbo"] for row in logged]
    t_eval = time.perf_counter()
    r_model, r_state = vae.restore(os.path.join(logdir, "ckpt"))
    same = all(bool(torch.equal(a, b)) for a, b in
               zip(tree_leaves(r_state.params), tree_leaves(state.params)))
    acfg = eval_vae.EvalVaeConfig()
    x_ll = data_lib.binarize(np.random.default_rng(0), dataset.test)[:100]
    ll_bf16 = _bf16_ais_log_likelihood(fv, r_state.params, x_ll, acfg.chains_per_datapoint,
                                       r_model.cfg.latent_dim, acfg, 0, dev)
    scfg = eval_sampler.EvalSamplerConfig()
    with torch.no_grad():
        x0, emb, z0 = eval_sampler.protocol_inputs(r_model, r_state.params, scfg, dataset, 0, dev)
    zs, acc_s = fv.FusedVaeSampler(r_model.dynamics, compute_dtype=BF).run(
        r_state.params["smp"], r_state.params["dec"], x0, emb, z0, seed=13,
        n_mh_steps=BF16_SAMPLER_STEPS, max_composition=scfg.max_composition, comp_key=_gen(1))
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t_eval
    launches = dict(fd.LAUNCHES)
    ll_f32 = eval_vae.run(r_model, r_state.params, acfg, dataset, seed=0, max_datapoints=100)
    f32_path = report.get("vae_training_path", {})
    report["bf16_vae_training_path"] = {
        "batch": n_tr, "mh_steps": cfg.mh_steps, "steps": steps, "epochs": BF16_TRAIN_EPOCHS,
        "data_source": dataset.source, "train_s": train_s,
        "ms_per_step_fused_bf16": 1e3 * train_s / steps,
        "ms_per_step_fused_f32_phase_7d": f32_path.get("ms_per_step_fused"),
        "elbo_first_last_logged": [elbos[0], elbos[-1]],
        "elbo_first_last_logged_f32_phase_7d": f32_path.get("elbo_first_last_logged"),
        "final": last, "final_f32_phase_7d": f32_path.get("final"),
        "restored_step": r_state.step, "restored_params_equal": same,
        "log_likelihood_restored_bf16_ais": ll_bf16,
        "log_likelihood_restored_f32_ais": ll_f32,
        "sampler_accept_bf16": float(acc_s.mean()), "sampler_steps": BF16_SAMPLER_STEPS,
        "eval_s": eval_s, "launches": launches,
    }
    print(f"# bf16 VAE training path ({train_s:.1f} s, restore, sampler and AIS "
          f"{eval_s:.1f} s): " + json.dumps(report["bf16_vae_training_path"]), flush=True)
    _require(all(np.isfinite(list(row.values())).all() for row in logged),
             "non-finite bf16 VAE training metric")
    _require(elbos[-1] < elbos[0], f"bf16 ELBO did not fall: {elbos[0]} -> {elbos[-1]}")
    _require(0.0 < last["p_accept"] <= 1.0, f"bf16 sampler acceptance {last['p_accept']}")
    _require(r_state.step == steps and same, "restored bf16 state differs from the trained one")
    _require(np.isfinite(ll_bf16) and bool(torch.isfinite(zs).all()),
             "non-finite bf16 evaluation of the restored VAE")
    for name in ("vae_traj", "vae_traj_bwd"):
        _require(launches[f"{name}:bf16"] == launches[name] == 2 * cfg.mh_steps * steps,
                 f"kernel {name}: {launches[f'{name}:bf16']} bf16 launches in {steps} steps")
    for name in ("vae_chain", "vae_ais"):
        _require(launches[f"{name}:bf16"] > 0, f"kernel {name} bf16 not launched on the path")

    # (f) each bf16 launch at its protocol shape, the plain bf16 versions,
    # ptxas's registers and spills, the reckoned L2 weight bytes, both bounds
    t_phase = time.perf_counter()
    inp, inp32, xr, z, v, dZ, dV, dld = inputs(n_tr)
    H, H2 = inp.dims[1], inp.dims[2]
    dims = (D, H, H2, T, E, P)
    traj_ms = _cuda_time(lambda: fv.vae_trajectory(inp, xr, z, v, False), 10)
    bwd_ms = _cuda_time(lambda: fv.vae_trajectory_vjp(inp, xr, z, v, dZ, dV, dld, False), 10)
    traj_plain_ms = _cuda_time(lambda: fv.vae_trajectory_plain(inp, z, v, False), 3)
    bwd_plain_ms = _cuda_time(
        lambda: fv.vae_trajectory_vjp_plain(inp, z, v, dZ, dV, dld, False), 3)
    with torch.no_grad():
        x0, emb, z0 = eval_sampler.protocol_inputs(model, params, scfg, dataset, 0, dev)
    x0T, z0T = x0.T.contiguous(), z0.T.contiguous()
    cinp = fv.prepare_vae(dyn, params["smp"], params["dec"], x0T, emb.T.contiguous(),
                          compute_dtype=BF)
    nb_path = fv.composition_counts(_gen(1), scfg.n_steps, scfg.max_composition)
    plain_steps = 20
    chain_ms = _cuda_time(lambda: fv.vae_chain(cinp, x0T, z0T, 13, scfg.n_steps, True, nb_path),
                          1, warmup=False)
    chain_plain_ms = _cuda_time(
        lambda: fv.vae_chain_plain(cinp, z0T, 13, plain_steps, True, nb_path[:plain_steps]), 1)
    n_ais = acfg.chains_per_datapoint * acfg.num_splits
    xa, _, za = batch(n_ais)
    akw = dict(seed=3, anneal_steps=acfg.anneal_steps, step_size=acfg.step_size,
               leapfrogs=acfg.leapfrogs, compute_dtype=BF)
    ais_ms = _cuda_time(lambda: fv.vae_ais(dec, xa, za, **akw), 2)
    ais_plain_ms = _cuda_time(lambda: fv.vae_ais_plain(dec, xa, za, **akw), 1)
    wb16, wb32 = _weight_bytes(fv, inp), _weight_bytes(fv, inp32)
    dec_bytes16 = 2 * (D * E + E * E + E * P) + 4 * (2 * E + P)
    n_grads = sum(w.numel() for w in [*inp.xnet_w, *inp.vnet_w]) + D
    ct = fv.CLUSTER[0]
    bounds = {
        "vae_traj": _bf16_bounds(*vae_traj_work(D, H, H2, T, E, P, n_tr, wb16)),
        "vae_traj_bwd": _bf16_bounds(*vae_traj_bwd_work(D, H, H2, T, E, P, n_tr, wb16,
                                                        n_grads, -(-n_tr // ct), 2 * T)),
        "vae_chain": _bf16_bounds(*vae_chain_work(D, H, H2, T, E, P, scfg.n_chains, scfg.n_steps,
                                                  int(nb_path.sum()), wb16, True)),
        "vae_ais": _bf16_bounds(*vae_ais_work(D, E, P, n_ais, acfg.anneal_steps,
                                              acfg.leapfrogs, dec_bytes16)),
    }
    dec_l2, net_l2 = fv.weight_l2_bytes(ct, n_tr, *dims, item=2)
    # the backward kernel: the pass forward's T + 1 sweeps, then a sweep
    # with a tangent per gradient call, 2 T (csrc/vae_traj_bwd.cu)
    l2 = {"vae_traj": [dec_l2, net_l2],
          "vae_traj_bwd": [dec_l2 * (3 * T + 1) // (T + 1), 2 * net_l2],
          "vae_chain": vae_chain_l2_bytes(scfg.n_chains, fv.CHAIN_CLUSTER[0],
                                          int(nb_path.sum()), *dims, item=2),
          "vae_ais": fv.ais_l2_bytes(D, E, P, n_ais, acfg.anneal_steps, acfg.leapfrogs, item=2)}
    ptxas = {name: [line for line in _ptxas_of(_cuda.build_info.get("ptxas", ""),
                                               f"{name}_kernel") if "bfloat16" in line]
             for name in bounds}
    ms = {"vae_traj": traj_ms, "vae_traj_bwd": bwd_ms, "vae_chain": chain_ms, "vae_ais": ais_ms}
    plain_ms = {"vae_traj": traj_plain_ms, "vae_traj_bwd": bwd_plain_ms,
                "vae_chain": chain_plain_ms, "vae_ais": ais_plain_ms}
    report["bf16_vae_kernel_times"] = {
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms_by": {k: list(b[:2]) for k, b in bounds.items()},
        "f32_pipe_bound_ms": {k: b[2] for k, b in bounds.items()},
        "share_of_bound": {k: bounds[k][0] / ms[k] for k in ms},
        "l2_weight_bytes_reckoned": l2, "weight_bytes_bf16_f32": [wb16, wb32],
        "ptxas": ptxas, "vae_chain_ops": int(nb_path.sum()),
    }
    print(f"# bf16 VAE kernel times ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(report["bf16_vae_kernel_times"]), flush=True)

    src = "l2hmc_tpu_torch/csrc/"
    replaces = {"vae_traj": 1622, "vae_traj_bwd": 1649, "vae_chain": 1399, "vae_ais": 2083}
    errs = {"vae_traj": max(c["max_abs_err"] for c in traj_cmp.values()),
            "vae_traj_bwd": max(c["max_abs_err"] for c in bwd_cmp.values()),
            "vae_chain": max(c["max_abs_dz_unflipped"] for c in chain_cmp.values()),
            "vae_ais": max(ais_cmp[k]["max_abs_dlogw_unflipped"] for k in ("n1000", "n203"))}
    shapes = {
        "vae_traj": f"{n_tr} chains, one direction (the training batch)",
        "vae_traj_bwd": f"{n_tr} chains, one direction (the training batch)",
        "vae_chain": (f"{scfg.n_chains} chains x {scfg.n_steps} recorded steps "
                      f"({int(nb_path.sum())} MH ops), traced; plain_ms over the first "
                      f"{plain_steps} steps"),
        "vae_ais": (f"{n_ais} chains x {acfg.anneal_steps} anneal steps x {acfg.leapfrogs} "
                    f"leapfrogs (one AIS batch)"),
    }
    return [{"name": f"{k}_bf16", "route": "cuda", "source": src + f"{k}.cu",
             "replaces": f"l2hmc_tpu/ops/fused_dynamics.py:{replaces[k]}",
             "launches": launches[f"{k}:bf16"], "max_abs_err": errs[k], "ms": ms[k],
             "plain_ms": plain_ms[k], "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
             "library_ms": None,
             "shape": (f"bfloat16 operands, float32 accumulation; VAE latent {D}, decoder {E}, "
                       f"nets {H}/{H2}, T={T}, {shapes[k]}; bound on the float32 pipe the "
                       f"kernel runs on: {bounds[k][2]:.4f} ms; L2 weight bytes reckoned: "
                       f"{l2[k]}")}
            for k in ms]


# -- 13. bfloat16 operands in kernels 1 and 3 -----------------------------------

# The trajectory and chain kernels' bfloat16 instantiations
# (csrc/trajectory_bf16.cu, csrc/chain_bf16.cu) against their plain versions
# with the same operands (``KernelInputs.cd``), which round at the same
# sites: the two differ where a float32 sum in another order rounds an
# activation to another bfloat16 value, a relative 2^-8 of a net output. As
# in phase 12, each comparison is held to a share of the plain bf16-float32
# gap on the same inputs: (a) the trajectory at BF16_GAP_SHARE in max-norm and
# RMS, inverting as 12a's; (b) the chain on the same Philox bits: at most
# BF16_FLIP_SHARE of the chains with a decision that differs (a bf16 rounding
# moves the Hamiltonians by ~1e-3, float32's sum order by ~1e-6: more flips
# than phase 3's at most 5), BF16_GAP_SHARE in RMS on the chains that flipped
# in neither comparison. (c) the bf16 SCG path at the notebook's width:
# ``train(ScgConfig(compute_dtype="bfloat16"))``, BF16_SCG_STEPS captured
# steps (the plain route: the JAX trainer hands the kernels no dtype, and
# fused bf16 training is fused float32 training, held bit for bit over
# BF16_FUSED_STEPS), the 1000-step traced eval through
# ``fused_chain_sampler(..., compute_dtype="bfloat16")`` and HMC at eps 0.15
# (ESS ratio above MIN_ESS_RATIO; the kernel's ESS within ESS_GAP of a plain
# bf16 ``sample_chain`` eval of the same params from the same x0), the parity
# gate of ``FusedDynamics(compute_dtype="bfloat16")`` against the plain bf16
# ``Dynamics`` (two rounding programs: the kernel folds the time embedding
# and the input scale in float32 before it rounds, the nets round the time
# features and the scaled input) at BF16_RESOLUTION, the JAX package's bar
# between the two, at its test's shape (tests/test_precision.py: T = 3, 64
# chains, the initial params; 6e-5 to 6e-4 over five seeds on the CPU, 2.9e-4
# on an H100), and at the trained sampler (2048 chains, T = 10, jumps up to
# ~170), where the two programs part by up to 0.17-0.24 and the float32
# kernel by 0.27-0.29 (the CPU; an H100): no absolute bar holds there, and
# the bf16 kernel must only lie nearer the bf16 nets than the float32 kernel
# does, in RMS (0.25-0.39 of its distance on the CPU, 0.53 on an H100; a
# kernel that did not round would read 1); and the bf16 sampler on the
# lattice through the
# same entry point at L = 16 and L = 64 (the site-parallel configuration),
# BF16_LATTICE_STEPS traced steps.
BF16_SCG_STEPS = 500
BF16_FUSED_STEPS = 20
BF16_LATTICE_STEPS = 200
# (d) the JAX package's bf16 protocol, the conv recipe of
# tools/phi4_conv64_chunked.py:40-48 (its record phi4_conv64_r5.json is an
# L = 32 run), through ``apps.phi4.run`` cut to BF16_CONV_STEPS training steps
# (the record: 4000) and a BF16_CONV_EVAL-step eval (1000); the conv nets run
# plain (the kernels take dense nets), so this drives the bf16 conv2d. On an
# H100 a plain bf16 conv step there takes 1.40 s over 500 steps (2.3-2.5 s
# over 10-30, cuDNN's first calls included) and 50 GB at peak (no
# checkpointing needed), so the cut is BF16_CONV_STEPS steps and a
# BF16_CONV_EVAL-step eval. The trained dynamics invert as the bf16 nets
# can: a state carried back with float32 rounding lands on the other side of
# a bfloat16 boundary in some of a chain's 32 x 1024 activations, so a third
# to a half of the chains miss by more than 1e-4 (84 and 114 of 256, 3.1e-4
# and 5.0e-4 at most, after 30 and 10 steps): held at BF16_RESOLUTION.
BF16_CONV = dict(L=32, m2=-1.0, lam=0.5, n_chains=256, leapfrogs=10, eps=0.1, hmc_eps=0.1,
                 net_type="conv", conv_channels=32, conv_depth=2, accept_penalty=20.0,
                 grad_clip=1.0, learning_rate=1e-4, init_temperature=4.0,
                 compute_dtype="bfloat16", remat=True)
BF16_CONV_STEPS = 5
BF16_CONV_EVAL = 20


def _bf16_traj_compare(fd, inp, inp32, x, v, what):
    """Kernel 1's bf16 instantiation against its plain bf16 version on (D, n)
    x, v, both directions, each launch twice; the bars of 12a."""
    import torch

    def miss(back):
        """Per chain, the largest miss of (x, v) after the inverse map."""
        return torch.maximum((back[0] - x).abs().amax(0), (back[1] - v).abs().amax(0))

    n = x.shape[1]
    out = {}
    for reverse in (False, True):
        got = fd.trajectory(inp, x, v, reverse)
        again = fd.trajectory(inp, x, v, reverse)
        ref = fd.trajectory_plain(inp, x, v, reverse)
        ref32 = fd.trajectory_plain(inp32, x, v, reverse)
        k32 = fd.trajectory(inp32, x, v, reverse)
        inv = fd.trajectory(inp, got[0], got[1], not reverse)
        pinv = fd.trajectory_plain(inp, ref[0], ref[1], not reverse)
        k_inv, p_inv = miss(inv), miss(pinv)
        case = {
            "max_abs_err": max(_gap(a, b) for a, b in zip(got, ref)),
            "max_share_of_bf16_f32_gap": max(_share(_gap(a, b), _gap(b, c))
                                             for a, b, c in zip(got, ref, ref32)),
            "rms_share_of_bf16_f32_gap": max(_share(_rms(a, b), _rms(b, c))
                                             for a, b, c in zip(got, ref, ref32)),
            "plain_bf16_vs_f32": max(_gap(a, b) for a, b in zip(ref, ref32)),
            "kernel_bf16_vs_f32": max(_gap(a, b) for a, b in zip(got, k32)),
            "inverse_err": max(_gap(inv[0], x), _gap(inv[1], v), _gap(inv[2], -got[2])),
            "inverse_err_plain": max(_gap(pinv[0], x), _gap(pinv[1], v), _gap(pinv[2], -ref[2])),
            "inverse_chains_over_tol": int((k_inv > BF16_INVERSE_TOL).sum()),
            "inverse_chains_over_tol_plain": int((p_inv > BF16_INVERSE_TOL).sum()),
            "repeats_bit_for_bit": all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
        }
        way = "backward" if reverse else "forward"
        out[way] = case
        _require(all(bool(torch.isfinite(a).all()) for a in got), f"{what} {way}: non-finite")
        _require(case["repeats_bit_for_bit"], f"{what} {way}: two launches differ")
        _require(case["max_share_of_bf16_f32_gap"] <= BF16_GAP_SHARE
                 and case["rms_share_of_bf16_f32_gap"] <= BF16_GAP_SHARE
                 and case["kernel_bf16_vs_f32"] > 0
                 and case["inverse_chains_over_tol"] <= BF16_FLIP_SHARE * n
                 and case["inverse_err"] <= BF16_RESOLUTION, f"{what} {way}: {case}")
    return out


def _bf16_chain_compare(fd, inp, inp32, xc, what):
    """Kernel 3's bf16 instantiation against its plain bf16 version on the
    same Philox bits from (D, n) xc, 20 traced MH steps, the kernel
    launched twice: at most BF16_FLIP_SHARE of the chains with a decision
    that differs, BF16_GAP_SHARE of the plain bf16-float32 gap in RMS on the
    chains that flipped in neither comparison."""
    import torch

    xk, acck, trk = fd.chain(inp, xc, 9, 20, collect_trace=True)
    again = fd.chain(inp, xc, 9, 20, collect_trace=True)
    xk32, _, _ = fd.chain(inp32, xc, 9, 20, collect_trace=True)
    _, _, trp = fd.chain_plain(inp, xc, 9, 20, collect_trace=True)
    _, _, tr3 = fd.chain_plain(inp32, xc, 9, 20, collect_trace=True)

    def moved(tr):
        return (tr != torch.cat([xc[None], tr[:-1]])).any(dim=1)  # (K, N) accepted

    flipped = (moved(trk) != moved(trp)).any(0)
    flip32 = (moved(trp) != moved(tr3)).any(0)
    clean = ~(flipped | flip32)
    n = xc.shape[1]
    case = {"n_chains": n, "flipped_chains": int(flipped.sum()),
            "bf16_f32_flipped_chains": int(flip32.sum()),
            "max_abs_dx_unflipped": _gap(trk, trp, ~flipped),
            "rms_share_of_bf16_f32_gap_unflipped": _share(_rms(trk, trp, clean),
                                                          _rms(trp, tr3, clean)),
            "max_share_of_bf16_f32_gap_unflipped": _share(_gap(trk, trp, clean),
                                                          _gap(trp, tr3, clean)),
            "kernel_bf16_vs_f32": _gap(xk, xk32), "accept": float(moved(trk).float().mean()),
            "repeats_bit_for_bit": all(bool(torch.equal(a, b))
                                       for a, b in zip((xk, acck, trk), again))}
    _require(bool(torch.isfinite(trk).all()) and bool(torch.equal(trk[-1], xk)),
             f"{what}: non-finite trace or trace end != state")
    _require(case["repeats_bit_for_bit"], f"{what}: two launches differ")
    _require(case["flipped_chains"] <= BF16_FLIP_SHARE * n
             and case["rms_share_of_bf16_f32_gap_unflipped"] <= BF16_GAP_SHARE
             and case["kernel_bf16_vs_f32"] > 0 and 0.0 < case["accept"] < 1.0,
             f"{what}: {case}")
    return case


# the lattice cases of (b), (c) and (e): L, hidden, T, eps, chains; L = 16 as
# the phi^4 app's defaults (PHI4_RUN), L = 64 at the JAX package's A_control
# shape (phi4_64_r3.json)
BF16_LATTICE = {"L16": (16, 32, 10, 0.1, 512), "L64": (64, 32, 10, 0.03, 256)}


def _phi4_case(dev, case, seed, compute_dtype=None):
    """(dynamics with ``compute_dtype`` nets, target, params with the nets'
    initial weights lifted by ``apps.phi4.PARITY_LIFT``, (n, D) hot-start
    states) of a BF16_LATTICE case."""
    from l2hmc_tpu_torch import targets
    from l2hmc_tpu_torch.apps import phi4
    from l2hmc_tpu_torch.train import ScgConfig, build_dynamics

    L, hidden, T, eps, n = BF16_LATTICE[case]
    tgt = targets.Phi4Lattice(L=L, m2=-1.0, lam=0.5)
    dyn, _ = build_dynamics(ScgConfig(dim=tgt.dim, hidden=hidden, T=T,
                                      compute_dtype=compute_dtype or "float32"), tgt)
    params = dyn.init_params(_gen(seed), eps=eps, device=dev)
    for net in ("xnet", "vnet"):
        params[net] = _tree_map(lambda a: a + phi4.PARITY_LIFT, params[net])
    return dyn, tgt, params, tgt.sample(_gen(seed + 1), n, device=dev)


def _phi4_inputs(fd, dev, case, seed):
    """Float32 kernel inputs and (D, n) states of a BF16_LATTICE case."""
    dyn, tgt, params, x = _phi4_case(dev, case, seed)
    return fd.prepare(dyn, fd.energy_spec_for_target(tgt), params, dev), x.T.contiguous()


def bf16_conv_phase(dev, report):
    """Phase 13d: the bf16 conv recipe at L = 32, cut in depth, with its
    peak memory. Its conv nets run plain (the kernels take dense nets), so
    it runs while the kernels build; phase 13 reports it."""
    import numpy as np
    import torch

    from l2hmc_tpu_torch import targets
    from l2hmc_tpu_torch.apps import phi4
    from l2hmc_tpu_torch.train import ScgConfig, build_dynamics

    BF = "bfloat16"
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    row, cstate = phi4.run(**BF16_CONV, n_steps=BF16_CONV_STEPS, eval_steps=BF16_CONV_EVAL,
                           device=dev, return_state=True)
    peak = torch.cuda.max_memory_allocated()
    tc = targets.Phi4Lattice(L=BF16_CONV["L"], m2=BF16_CONV["m2"], lam=BF16_CONV["lam"])
    dc, _ = build_dynamics(ScgConfig(dim=tc.dim, T=BF16_CONV["leapfrogs"], net_type="conv",
                                     conv_channels=BF16_CONV["conv_channels"],
                                     conv_depth=BF16_CONV["conv_depth"], compute_dtype=BF), tc)
    xc = tc.sample(_gen(7), BF16_CONV["n_chains"], device=dev)
    vc = torch.randn(xc.shape, generator=_gen(8)).to(dev)
    with torch.no_grad():
        X, V, ld = dc.forward(cstate.params, xc, vc)
        x2, v2, ld2 = dc.backward(cstate.params, X, V)
    miss = torch.maximum((x2 - xc).abs().amax(1), (v2 - vc).abs().amax(1))
    c = report["bf16_conv_recipe"] = {
        "row": row, "train_steps": BF16_CONV_STEPS,
        "ms_per_train_step": 1e3 * row["train_time_s"] / BF16_CONV_STEPS,
        "peak_memory_bytes": peak, "inverse_err": float(miss.max()),
        "inverse_chains_over_tol": int((miss > BF16_INVERSE_TOL).sum()),
        "inverse_logdet_err": float((ld + ld2).abs().max()),
        "wall_s": time.perf_counter() - t_phase}
    print(f"# bf16 conv recipe L=32 ({c['wall_s']:.1f} s): " + json.dumps(c), flush=True)
    _require(np.isfinite(row["final_loss"]) and 0.0 < row["final_accept"] < 1.0
             and all(np.isfinite(v) for k, v in row.items() if k.startswith(("tunn", "ess"))),
             f"bf16 conv recipe: {row}")
    _require(c["inverse_err"] <= BF16_RESOLUTION and c["inverse_logdet_err"] <= BF16_RESOLUTION,
             f"bf16 conv recipe inverse: {c}")


def bf16_scg_phases(dev, report):
    """Phase 13: kernels 1 and 3's bfloat16 instantiations against their
    plain versions (lane groups and sites), the bf16 SCG path, the bf16
    conv recipe through ``apps.phi4.run`` and the bf16 kernels' times beside
    their float32 rows; returns the bf16 rows of the ``kernels`` line."""
    import numpy as np
    import torch

    from l2hmc_tpu_torch.apps import phi4, suite
    from l2hmc_tpu_torch.ops import _cuda
    from l2hmc_tpu_torch.ops import fused_dynamics as fd
    from l2hmc_tpu_torch.train import (
        ScgConfig, build_dynamics, evaluate_ess, sample_chain, train,
    )
    from l2hmc_tpu_torch.train.optim import tree_leaves

    BF = "bfloat16"
    t_all = time.perf_counter()
    out = {}

    def bf16(inp):
        return dataclasses.replace(inp, cd=torch.bfloat16)

    dyn, target = build_dynamics(ScgConfig())
    params = dyn.init_params(_gen(0), eps=0.1, device=dev)
    lifted = dict(params, **{k: _tree_map(lambda a: a + 0.03, params[k])
                             for k in ("xnet", "vnet")})
    inp_scg = fd.prepare(dyn, fd.energy_spec_for_target(target), lifted, dev)

    # (a) kernel 1: SCG (ScgLanes) at 2048 and 203 chains, the rough well
    # (WideLanes, D = 10, H = 20, T = 5), phi^4 at L = 8 (WideLanes)
    t_phase = time.perf_counter()
    traj = {}
    for name, make in (
            ("scg_n2048", lambda: (inp_scg, target.sample(_gen(21), 2048, device=dev).T)),
            ("scg_n203", lambda: (inp_scg, target.sample(_gen(21), 203, device=dev).T)),
            ("rough_well_easy_n2048",
             lambda: suite.parity_inputs("rough_well_easy", 2048, dev, seed=20)),
            ("phi4_L8_n512", lambda: phi4.parity_inputs("phi4_L8", 512, dev, seed=20))):
        inp32, x = make()
        x = x.contiguous()
        v = torch.randn(x.shape, generator=_gen(22)).to(dev)
        traj[name] = _bf16_traj_compare(fd, bf16(inp32), inp32, x, v, f"trajectory bf16 {name}")
    out["trajectory_vs_plain"] = traj
    print(f"# bf16 trajectory kernel vs plain ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(traj), flush=True)

    # (b) kernel 3 on the same Philox bits: SCG at 1024 and 203 chains, the
    # rough well, phi^4 at L = 16 (sites, 64 hidden units) and L = 64 (dim
    # 4096, A_control's shape), icg at hidden 100 (sites, 128 hidden units)
    t_phase = time.perf_counter()
    chain_cmp = {}
    for name, make in (
            ("scg_n1024", lambda: (inp_scg, target.sample(_gen(41), 1024, device=dev).T)),
            ("scg_n203", lambda: (inp_scg, target.sample(_gen(41), 203, device=dev).T)),
            ("rough_well_easy_n2048",
             lambda: suite.parity_inputs("rough_well_easy", 2048, dev, seed=40)),
            ("phi4_L16_n512", lambda: _phi4_inputs(fd, dev, "L16", 40)),
            ("phi4_L64_n256", lambda: _phi4_inputs(fd, dev, "L64", 40)),
            ("icg_n2048", lambda: suite.parity_inputs("icg", 2048, dev, seed=40))):
        inp32, xc = make()
        xc = xc.contiguous()
        case = _bf16_chain_compare(fd, bf16(inp32), inp32, xc, f"chain bf16 {name}")
        D, H, H2, _ = inp32.dims
        case.update(dim=D, hidden=H, configuration="site-parallel" if fd.chain_on_sites(inp32)
                    else f"{_cuda.library('chain').l2hmc_chain_lanes(D, H, H2)} lanes")
        chain_cmp[name] = case
    out["chain_vs_plain"] = chain_cmp
    print(f"# bf16 chain kernel vs plain ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(chain_cmp), flush=True)

    # (c) the bf16 SCG path; the launch counts set to 0 just before it and
    # read just after
    t_phase = time.perf_counter()
    n_tr, eval_steps = 1024, 1000
    fd.reset_launch_counts()
    cfg = ScgConfig(n_chains=n_tr, n_steps=BF16_SCG_STEPS, seed=0, compute_dtype=BF)
    dynb, _ = build_dynamics(cfg, target)
    state, hist = train(cfg, target)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t_phase
    x0 = target.sample(_gen(1), n_tr, device=dev)
    sampler = fd.fused_chain_sampler(dynb, target, compute_dtype=BF)
    t = time.perf_counter()
    _, acc_k, trace_k = sampler.run(state.params, x0, seed=2, n_mh_steps=eval_steps,
                                    collect_trace=True)
    torch.cuda.synchronize()
    eval_k_s = time.perf_counter() - t
    hmc_dyn, _ = build_dynamics(ScgConfig(hmc=True), target)
    _, _, trace_h = fd.fused_chain_sampler(hmc_dyn, target).run(
        hmc_dyn.init_params(_gen(0), eps=0.15, device=dev), x0, seed=3, n_mh_steps=eval_steps,
        collect_trace=True)
    t = time.perf_counter()
    _, trace_p = sample_chain(dynb, state.params, x0, eval_steps, _gen(2))
    torch.cuda.synchronize()
    eval_p_s = time.perf_counter() - t
    ess_k, ess_h, ess_p = (evaluate_ess(tr, target.sigma) for tr in (trace_k, trace_h, trace_p))
    del trace_k, trace_h, trace_p
    # the parity gate: the bf16 kernel against the bf16 nets (two rounding
    # programs) at the JAX test's shape, and at the trained sampler beside
    # the float32 kernel's distance to them
    d3, _ = build_dynamics(ScgConfig(n_chains=64, T=3, compute_dtype=BF), target)
    p3 = d3.init_params(_gen(3), eps=0.1, device=dev)
    x3, v3 = (torch.randn((64, 2), generator=_gen(s)).to(dev) for s in (13, 14))
    gate = {"jax_test_shape_max_abs_err": max(
        float((a - b).abs().max()) for way in ("forward", "backward")
        for a, b in zip(getattr(fd.fused_for_target(d3, target, compute_dtype=BF), way)(
            p3, x3, v3), getattr(d3, way)(p3, x3, v3)))}
    xg = target.sample(_gen(11), 2048, device=dev)
    vg = torch.randn(xg.shape, generator=_gen(12)).to(dev)
    fb, f3 = (fd.fused_for_target(dynb, target, compute_dtype=c) for c in (BF, None))
    shares, errs, errs32 = [], [], []
    for way in ("forward", "backward"):
        ref = getattr(dynb, way)(state.params, xg, vg)
        for a, c, b in zip(getattr(fb, way)(state.params, xg, vg),
                           getattr(f3, way)(state.params, xg, vg), ref):
            shares.append(_share(_rms(a, b), _rms(c, b)))
            errs.append(_gap(a, b))
            errs32.append(_gap(c, b))
    gate.update(trained_max_abs_err=max(errs), trained_f32_kernel_max_abs_err=max(errs32),
                trained_rms_share_of_f32_kernel=max(shares))
    # the bf16 sampler on the lattice through the same entry point
    scg_chain_launches = fd.LAUNCHES["chain:bf16"]
    lattice = {}
    for label in BF16_LATTICE:
        dl, tl, pl, xl = _phi4_case(dev, label, 50, BF)
        before = fd.LAUNCHES["chain:sites"]
        _, acc_l, tr_l = fd.fused_chain_sampler(dl, tl, compute_dtype=BF).run(
            pl, xl, seed=5, n_mh_steps=BF16_LATTICE_STEPS, collect_trace=True)
        m = tr_l.mean(dim=2).cpu().numpy()
        lattice[label] = {"accept": float(acc_l.mean()), "tunneling_rate": phi4.tunneling_rate(m),
                          "site_launches": fd.LAUNCHES["chain:sites"] - before}
        _require(bool(torch.isfinite(tr_l).all()) and 0.0 < lattice[label]["accept"] < 1.0
                 and lattice[label]["site_launches"] == 1, f"bf16 lattice {label}: "
                 f"{lattice[label]}")
        del tr_l
    launches = dict(fd.LAUNCHES)
    # fused bf16 training is fused float32 training (the kernels get no
    # dtype from ScgConfig), bit for bit
    runs = [train(ScgConfig(n_chains=n_tr, n_steps=BF16_FUSED_STEPS, seed=0, fused_train=True,
                            compute_dtype=c), target) for c in (BF, "float32")]
    fused_same = all(np.array_equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1]) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(runs[0][0].params),
                                          tree_leaves(runs[1][0].params)))
    out["scg_path"] = {
        "n_chains": n_tr, "steps": BF16_SCG_STEPS, "train_s": train_s,
        "ms_per_step": 1e3 * train_s / BF16_SCG_STEPS, "final_loss": float(hist["loss"][-1]),
        "final_accept": float(np.mean(hist["p_accept"][-100:])),
        "eval_steps": eval_steps, "ess_kernel_bf16": ess_k, "ess_plain_bf16": ess_p,
        "ess_hmc": ess_h, "ess_ratio": ess_k / max(ess_h, 1e-12),
        "ess_rel_gap": abs(ess_k - ess_p) / max(ess_p, 1e-12),
        "eval_accept": float(acc_k.mean()), "eval_kernel_s": eval_k_s,
        "eval_plain_sample_chain_s": eval_p_s, "parity_gate_max_abs_err": gate,
        "lattice": lattice, "fused_bf16_equals_fused_f32": fused_same, "launches": launches,
        "wall_s": time.perf_counter() - t_phase}
    print(f"# bf16 SCG path ({out['scg_path']['wall_s']:.1f} s): "
          + json.dumps(out["scg_path"]), flush=True)
    _require(bool(np.isfinite(hist["loss"]).all()), "bf16 SCG training: non-finite loss")
    _require(out["scg_path"]["ess_ratio"] > MIN_ESS_RATIO, f"bf16 SCG ESS ratio: {out['scg_path']}")
    _require(out["scg_path"]["ess_rel_gap"] < ESS_GAP, f"bf16 SCG ESS gap: {out['scg_path']}")
    _require(gate["jax_test_shape_max_abs_err"] <= BF16_RESOLUTION
             and gate["trained_rms_share_of_f32_kernel"] < 1.0, f"bf16 parity gate: {gate}")
    _require(fused_same, "fused bf16 training differs from fused float32 training")
    for name in ("trajectory:bf16", "chain:bf16"):
        _require(launches[name] > 0, f"{name} not launched on the bf16 SCG path")

    # (d) the bf16 conv recipe ran beside the build (``bf16_conv_phase``)
    out["conv_recipe"] = report["bf16_conv_recipe"]

    # (e) each bf16 launch at its row's shape beside its float32 row, both
    # bounds, ptxas
    t_phase = time.perf_counter()
    x2048 = target.sample(_gen(31), 2048, device=dev).T.contiguous()
    v2048 = torch.randn(x2048.shape, generator=_gen(32)).to(dev)
    inp_eval = fd.prepare(dyn, fd.energy_spec_for_target(target), params, dev)
    x0t = target.sample(_gen(1), n_tr, device=dev).T.contiguous()
    times, bounds = {}, {}
    D, H, H2, T = inp_eval.dims
    ops = _ops_of(inp_eval)
    for label, cd in (("f32", None), ("bf16", torch.bfloat16)):
        ie = dataclasses.replace(inp_eval, cd=cd)
        times[f"1_{label}"] = _traj_launch_ms(fd, _cuda, ie, x2048, v2048, 200)
        times[f"3_{label}"] = _cuda_time(lambda: fd.chain(ie, x0t, 2, eval_steps, True), 5)
    work1, bytes1 = traj_work(D, H, H2, T, 2048, False, inp_eval.block().numel(), ops)
    work3, bytes3 = chain_work(D, H, H2, T, n_tr, eval_steps, False, inp_eval.block().numel(),
                               True, ops)
    # the products' weights as bfloat16 save 2 bytes each, both nets
    saved = 2 * 2 * _stq_weights(D, H, H2)
    bounds["1"] = _bf16_bounds(work1, 2048 * T * 4 * _stq_products(D, H, H2), bytes1 - saved)
    bounds["3"] = _bf16_bounds(work3, n_tr * eval_steps * T * 4 * _stq_products(D, H, H2),
                               bytes3 - saved)
    plain = {"1": _cuda_time(lambda: fd.trajectory_plain(bf16(inp_eval), x2048, v2048, False), 5),
             "3": _cuda_time(lambda: fd.chain_plain(bf16(inp_eval), x0t, 2, 20,
                                                    collect_trace=True), 1, warmup=False)}
    site_rows = {}
    for label, case in (("3f", "L16"), ("3h", "L64")):
        inp32, xc = _phi4_inputs(fd, dev, case, 32)
        Dc, Hc, H2c, Tc = inp32.dims
        n = xc.shape[1]
        for tag, ie in (("f32", inp32), ("bf16", bf16(inp32))):
            # the 1000-step launches at L = 64 run once, warmed up by (b)
            times[f"{label}_{tag}"] = _cuda_time(lambda: fd.chain(ie, xc, 2, 1000, True), 1,
                                                 warmup=Dc <= 1024)
        plain[label] = _cuda_time(lambda: fd.chain_plain(bf16(inp32), xc, 2, 20,
                                                         collect_trace=True), 1, warmup=False)
        w, nb = chain_work(Dc, Hc, H2c, Tc, n, 1000, False, inp32.block().numel(), True,
                           _ops_of(inp32))
        bounds[label] = _bf16_bounds(w, n * 1000 * Tc * 4 * _stq_products(Dc, Hc, H2c),
                                     nb - 2 * 2 * _stq_weights(Dc, Hc, H2c))
        plan = fd.site_tile(Dc, Hc, H2c, n, *inp32.energy_args)
        site_rows[label] = {"dim": Dc, "hidden": Hc, "T": Tc, "n_chains": n,
                            "plan": plan._asdict(),
                            "l2_weight_bytes_f32": phi4_l2_weight_bytes(Dc, Hc, H2c, Tc, n,
                                                                        1000, plan)}
    ptxas = _cuda.build_info.get("ptxas", "")
    ptx = {k: [l for l in _ptxas_of(ptxas, entry) if "bfloat16" in l]
           for k, entry in (("trajectory", "17trajectory_kernel"), ("chain", "12chain_kernel"),
                            ("site_chain", SITE_CHAIN_ENTRY))}
    out["kernel_times"] = {"ms": times, "bounds": bounds, "plain_ms": plain, "sites": site_rows,
                           "ptxas": ptx}
    print(f"# bf16 SCG kernel times ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(out["kernel_times"]), flush=True)

    src = "l2hmc_tpu_torch/csrc/"
    err1 = max(c["max_abs_err"] for t in traj.values() for c in t.values())
    err3 = max(c["max_abs_dx_unflipped"] for c in chain_cmp.values())
    rows = []
    for label, name, source, replaces, launches_n, err, shape in (
            ("1", "trajectory_bf16", "trajectory_bf16.cu", ":645", launches["trajectory:bf16"],
             err1, "SCG D=2 H=10 T=10, 2048 chains, one direction, the launch alone; plain_ms "
             "the plain bf16 version"),
            ("3", "chain_bf16", "chain_bf16.cu", ":1103", scg_chain_launches, err3,
             f"SCG D=2 H=10 T=10, {n_tr} chains x {eval_steps} MH steps, traced; plain_ms "
             "over 20 MH steps"),
            ("3f", "chain[phi4]_bf16", "chain_bf16.cu", ":1103",
             lattice["L16"]["site_launches"], err3,
             "phi4 L=16 D=256 H=32 T=10, 512 chains x 1000 MH steps, traced, site-parallel; "
             "plain_ms over 20 MH steps"),
            ("3h", "chain[phi4]_bf16", "chain_bf16.cu", ":1103",
             lattice["L64"]["site_launches"], err3,
             "phi4 L=64 D=4096 H=32 T=10 (A_control's shape), 256 chains x 1000 MH steps, "
             "traced, site-parallel; plain_ms over 20 MH steps")):
        b = bounds[label]
        rows.append({"name": name, "route": "cuda", "source": src + source,
                     "replaces": "l2hmc_tpu/ops/fused_dynamics.py" + replaces,
                     "launches": launches_n, "max_abs_err": err, "ms": times[f"{label}_bf16"],
                     "plain_ms": plain.get(label), "bound_ms": b[0], "bound_by": b[1],
                     "library_ms": None, "row": label + "-bf16",
                     "shape": (f"{shape}; float32 row in the same run: "
                               f"{times[label + '_f32']:.4f} ms; all operations on the f32 "
                               f"pipe: {b[2]:.4g} ms")})
    report["bf16_scg"] = out
    report["bf16_scg_wall_s"] = time.perf_counter() - t_all
    print(f"# bf16 SCG phase: {report['bf16_scg_wall_s']:.1f} s", flush=True)
    return rows


# -- 10. the distribution suite ---------------------------------------------------

# The kernels' parity cases are ``apps.suite.PARITY_CASES``; (a) runs each at
# these chain counts, (b) at its suite row's.
SUITE_TRAJ_CHAINS = {"rough_well_easy": (2048, 203), "ring": (1024,), "funnel": (1024,),
                     "mog2_hmc": (1024,)}
SPEC_OF_CASE = {"rough_well_easy": "rough_well", "ring": "gmm", "funnel": "funnel",
                "mog2_hmc": "gmm", "icg": "gauss"}
# The suite path cut in depth: 100 training steps and one training seed a
# row (the recipes: 5000 and up to 4), a 500-step eval (the recipes: 2000;
# the cross-checks' gaps 0.0-0.015 of the 0.30 bar there on an H100),
# the HMC grid's eight step sizes (through the chain kernel) and the widths
# and chain counts as the recipes have them. icg (2048 chains, the JAX
# record's) trains 20 steps, and its HMC grid runs plain: through the chain
# kernel it runs the 50-d Gaussian on WideLanes in HMC mode, where every lane
# of a warp repeats the chain's dense gradient (ROADMAP P7), ~22 s an eps at
# 2000 steps on an H100. The row shows the cross-check's path, not a ratio.
SUITE_CUT = dict(n_steps=100, n_train_seeds=1, fused_hmc=True, eval_steps=500)
SUITE_ROWS = (("rough_well", {}), ("ring", dict(n_chains=2048)), ("funnel", {}),
              ("icg", dict(n_chains=2048, n_steps=20, fused_hmc=False)))
# Fused against plain training on the suite's targets (no annealing, no
# net-input features: the fused path takes neither), 20 steps at 1024 chains,
# at phase 5b's bar, twice: the fused step's loss at each of the plain run's
# 20 states on the same draws, all 20 steps; and the two free runs of
# ``train``, the ring's over its first ``suite.RING_FREE_STEPS`` (they part
# later by the recipe's own dynamics, as two plain routes on the CPU do,
# which 10d runs beside them), the others' over all 20. (parity case, the
# config's changes): the ring at its recipe's eps.
SUITE_TRAIN = (("ring", dict(eps=0.2)), ("rough_well_easy", {}), ("funnel", {}))
# the times of each spec's kernels at its suite row's shapes: spec -> the
# parity case giving target, widths and chains
SUITE_TIMES = {"rough_well": "rough_well_easy", "gmm": "ring", "funnel": "funnel"}


# 10d's witness on the CPU: the ring's two free training runs through
# ``train`` (fused and plain) in a process of its own, started with phase 10
# so that it runs beside (a)-(c) on CPU_WITNESS_THREADS of the host's cores
CPU_WITNESS_THREADS = 4
_CPU_WITNESS = """
import dataclasses, json, sys
import torch
torch.set_num_threads(int(sys.argv[2]))
from l2hmc_tpu_torch.apps import suite
from l2hmc_tpu_torch.train import ScgConfig, train
cfg = ScgConfig(**json.loads(sys.argv[1]))
tgt = suite.PARITY_CASES["ring"].target()
print(json.dumps({str(f): train(dataclasses.replace(cfg, fused_train=f), tgt, device="cpu")[1][
    "loss"].tolist() for f in (True, False)}))
"""


def _start_cpu_witness(cfg_kwargs):
    """Starts the witness on the ring's ScgConfig(**cfg_kwargs); returns its
    process, whose output ``_cpu_witness_losses`` reads."""
    return subprocess.Popen(
        [sys.executable, "-c", _CPU_WITNESS, json.dumps(cfg_kwargs), str(CPU_WITNESS_THREADS)],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def _cpu_witness_losses(proc):
    """The witness's loss histories {fused: array}; fails if it did."""
    import numpy as np

    out, err = proc.communicate(timeout=600)
    _require(proc.returncode == 0, f"the CPU witness failed: {err[-2000:]}")
    return {k == "True": np.asarray(v) for k, v in json.loads(out.splitlines()[-1]).items()}


def _spec_vjp_compare(fd, inp, x, v, dX, dV, dld, reverse):
    """Kernel against plain VJP, per leaf of the leaf's largest entry, with
    the ReLU rule of phase 7b: at most one chain whose dx, dv differ by more
    than BWD_TOL may be set aside, if its plain trajectory has a hidden
    pre-activation within 1e-5 of its layer's largest (``relu_margins``)."""
    import torch
    from l2hmc_tpu_torch.train.optim import tree_leaves

    def both(keep=None):
        args = (dX, dV, dld) if keep is None else (dX * keep, dV * keep, dld * keep)
        return (tree_leaves(fd.trajectory_vjp(inp, x, v, *args, reverse)),
                tree_leaves(fd.trajectory_vjp_plain(inp, x, v, *args, reverse)))

    got, ref = both()
    n = x.shape[1]
    flipped = torch.zeros(n, dtype=torch.bool, device=x.device)
    for a, b in zip(got[-2:], ref[-2:]):
        flipped |= (a - b).abs().amax(dim=0) > BWD_TOL * b.abs().max()
    set_aside = int(flipped.sum())
    _require(set_aside <= 1, f"VJP: {set_aside} chains differ")
    if set_aside:
        margin = float(fd.relu_margins(inp, x, v, reverse)[flipped].max())
        _require(margin < 1e-5, f"VJP: a differing chain with relu margin {margin}")
        got, ref = both((~flipped).float()[None, :])
    abs_err = [float((a - b).abs().max()) for a, b in zip(got, ref)]
    scale = [float(b.abs().max()) for b in ref]
    rel = max(e / s if s > 0 else (0.0 if e == 0 else float("inf"))
              for e, s in zip(abs_err, scale))
    return {"max_abs_err": max(abs_err), "max_rel_err": rel, "set_aside": set_aside}


def suite_phases(dev, report):
    """Phase 10: the suite's energy specs through kernels 1-3 against their
    plain versions, the suite path, fused against plain training, captured
    against eager for the annealed and the net-input recipes, and the
    kernels' times at the suite's shapes. Returns the ``kernels`` rows of
    the three kernels for each of the suite's specs. The ring's CPU witness
    of (d) runs in its own process from the start."""
    from l2hmc_tpu_torch.apps import suite

    t_all = time.perf_counter()
    ring = suite.PARITY_CASES["ring"]
    ring_cfg = dict(n_chains=1024, n_steps=20, seed=0, dim=ring.target().dim, T=ring.T,
                    hidden=ring.hidden, **{"eps": ring.eps, **dict(SUITE_TRAIN)["ring"]})
    witness = _start_cpu_witness(ring_cfg)
    try:
        return _suite_phases(dev, report, witness, ring_cfg, t_all)
    finally:
        if witness.poll() is None:
            witness.kill()
            witness.wait()


def _suite_phases(dev, report, witness_proc, ring_cfg, t_all):
    import numpy as np
    import torch

    from l2hmc_tpu_torch import targets
    from l2hmc_tpu_torch.apps import suite
    from l2hmc_tpu_torch.ops import _cuda
    from l2hmc_tpu_torch.ops import fused_dynamics as fd
    from l2hmc_tpu_torch.train import ScgConfig, build_dynamics, train
    from l2hmc_tpu_torch.train.optim import tree_leaves

    # (a) the trajectory and backward kernels against their plain versions
    t_phase = time.perf_counter()
    traj, bwd = {}, {}
    for name, counts in SUITE_TRAJ_CHAINS.items():
        for n in counts:
            inp, x = suite.parity_inputs(name, n, dev, seed=20)
            g = _gen(61)
            v, dX, dV = (torch.randn(x.shape, generator=g).to(dev) for _ in range(3))
            dld = torch.randn((1, n), generator=g).to(dev)
            key = f"{name}_n{n}"
            traj[key], bwd[key] = {}, {}
            for reverse in (False, True):
                way = "backward" if reverse else "forward"
                k_out = fd.trajectory(inp, x, v, reverse)
                _require(all(bool(torch.isfinite(t).all()) for t in k_out),
                         f"suite trajectory {key}: non-finite")
                traj[key][way] = max(float((a - b).abs().max()) for a, b in
                                     zip(k_out, fd.trajectory_plain(inp, x, v, reverse)))
                bwd[key][way] = _spec_vjp_compare(fd, inp, x, v, dX, dV, dld, reverse)
                _require(traj[key][way] < TRAJ_TOL, f"suite trajectory {key}: {traj[key]}")
                _require(bwd[key][way]["max_rel_err"] <= BWD_TOL,
                         f"suite trajectory_bwd {key}: {bwd[key][way]}")
    report["suite_trajectory_vs_plain"] = traj
    report["suite_trajectory_bwd_vs_plain"] = bwd
    print(f"# suite trajectory and backward kernels vs plain ({time.perf_counter() - t_phase:.1f}"
          f" s): " + json.dumps({"trajectory": traj, "trajectory_bwd": bwd}), flush=True)

    # (b) the chain kernel against its plain version on the same Philox bits,
    # phase 3's limits, each launch twice
    t_phase = time.perf_counter()
    chain_cmp = {}
    for name, case in suite.PARITY_CASES.items():
        inp, xc = suite.parity_inputs(name, case.n_chains, dev, seed=40)
        # phase 3's 5 flips on the lane groups, the lattice's share on the
        # site-parallel configuration (icg at hidden 100)
        flips = PHI4_FLIPS * 20 * case.n_chains if fd.chain_on_sites(inp) else 5
        chain_cmp[name] = _chain_vs_plain(fd, inp, xc, f"suite chain {name}", flips)
    report["suite_chain_vs_plain"] = chain_cmp
    print(f"# suite chain kernel vs plain ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(chain_cmp), flush=True)

    # (c) the suite path: run_target on its rows, cut in depth; then (d)
    # fused against plain training; the launch counts of both together
    fd.reset_launch_counts()
    t_phase = time.perf_counter()
    rows = {}
    for name, kw in SUITE_ROWS:
        t = time.perf_counter()
        row = suite.run_target(name, device=dev, verbose=False, **{**SUITE_CUT, **kw})
        row["wall_s"] = time.perf_counter() - t
        rows[name] = row
        print(f"# suite row {name} ({row['wall_s']:.1f} s): ess_ratio {row['ess_ratio']:.4g}, "
              f"at config eps {row['ess_ratio_at_config_eps']:.4g}, ess_l2hmc "
              f"{row['ess_l2hmc']:.4g}, fused trace {row.get('ess_l2hmc_fused_trace')}, "
              f"gap {row.get('fused_ess_rel_gap')}, accept {row['final_accept']:.4g}, "
              f"cross-check: {row['fused_cross_check']}", flush=True)
        ess_vals = [row["ess_l2hmc"], row["ess_hmc"], *row["hmc_ess_by_eps"].values()]
        if row["fused_cross_check"] == "ran":
            ess_vals.append(row["ess_l2hmc_fused_trace"])
            _require(row["fused_ess_rel_gap"] < ESS_GAP,
                     f"suite {name}: fused-trace ESS gap {row['fused_ess_rel_gap']}")
        _require(all(np.isfinite(e) and e > 0 for e in ess_vals), f"suite {name}: ESS {ess_vals}")
        _require(0.0 < row["final_accept"] < 1.0, f"suite {name}: acceptance {row['final_accept']}")
        _require(row["hmc_grid_fused"] is (name != "icg"), f"suite {name}: HMC grid fused "
                                                            f"{row['hmc_grid_fused']}")
    _require(all(rows[r]["fused_cross_check"] == "ran" for r in ("rough_well", "ring", "icg")),
             "suite cross-check did not run")
    report["suite_rows"] = rows
    suite_s = time.perf_counter() - t_phase

    t_phase = time.perf_counter()

    fused_vs_plain = {}
    for name, kw in SUITE_TRAIN:
        case = suite.PARITY_CASES[name]
        tgt = case.target()
        cfg = ScgConfig(n_chains=1024, n_steps=20, seed=0, dim=tgt.dim, T=case.T,
                        hidden=case.hidden, **{"eps": case.eps, **kw})
        free_steps = suite.RING_FREE_STEPS if name == "ring" else cfg.n_steps
        # the fused step at each state of the plain run, on its draws
        dyn, _ = build_dynamics(cfg, tgt)
        same = _same_state_losses(cfg, dyn, tgt, dev)
        same_gap = float(_over_tolerance(*zip(*same)).max())
        # the two free runs through the entry point
        hists, step_ms = {}, {}
        for fused in (True, False):
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, hists[fused] = train(dataclasses.replace(cfg, fused_train=fused), tgt,
                                    device=dev)
            torch.cuda.synchronize()
            step_ms[fused] = 1e3 * (time.perf_counter() - t) / 20
        free = _over_tolerance(hists[True]["loss"], hists[False]["loss"])
        witness = {}
        if name == "ring":
            # the same two runs on the CPU, where the fused step takes the
            # wrappers' plain versions: two plain routes on the same draws
            _require(ScgConfig(**ring_cfg) == cfg, "the CPU witness's config is not the ring's")
            cpu = _cpu_witness_losses(witness_proc)
            gaps = _over_tolerance(cpu[True], cpu[False])
            witness = {"cpu_plain_routes_gap_by_step": gaps.tolist()}
            _require(float(gaps[:free_steps].max()) <= 1.0,
                     f"suite training on the CPU, two plain routes part: {gaps.tolist()}")
        fused_vs_plain[name] = {"same_states_max_gap_over_tolerance": same_gap,
                                "free_steps_held": free_steps,
                                "free_max_gap_over_tolerance": float(free[:free_steps].max()),
                                "free_max_gap_over_tolerance_all_20": float(free.max()),
                                "free_gap_by_step": free.tolist(),
                                "loss_fused_last": float(hists[True]["loss"][-1]),
                                "loss_plain_last": float(hists[False]["loss"][-1]),
                                "ms_per_step_fused": step_ms[True],
                                "ms_per_step_plain": step_ms[False], **witness}
        _require(same_gap <= 1.0, f"suite fused vs plain training {name} at the same states: "
                                  f"{same_gap} x tolerance")
        _require(float(free[:free_steps].max()) <= 1.0,
                 f"suite fused vs plain training {name}: {fused_vs_plain[name]}")
    launches = dict(fd.LAUNCHES)
    report["suite_fused_vs_plain_training"] = fused_vs_plain
    report["suite_path"] = {"wall_s": suite_s, "train_wall_s": time.perf_counter() - t_phase,
                            "launches": launches}
    print(f"# suite fused vs plain training ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(fused_vs_plain), flush=True)
    print(f"# suite path ({suite_s:.1f} s), launches: " + json.dumps(launches), flush=True)
    for kernel in ("trajectory", "trajectory_bwd", "chain"):
        for spec in SUITE_TIMES:
            _require(launches[f"{kernel}:{spec}"] > 0,
                     f"kernel {kernel} on the {spec} spec not launched on the suite path")
    # icg's cross-check, the suite path's only site-parallel launches
    _require(launches["chain:sites"] > 0, "icg's chain kernel not launched on the suite path")

    # (e) captured against eager, bit for bit: the annealed ring (the
    # temperature from the device step counter) and the funnel with its
    # net-input features
    t_phase = time.perf_counter()
    cap = {}
    for name, make, kw in (
            ("ring_annealed", lambda: targets.gen_ring(r=2.0, var=0.1, nb_mixtures=4),
             dict(init_temperature=5.0, eps=0.2)),
            ("funnel_net_input", lambda: targets.GaussianFunnel(dim=10),
             dict(net_input_target_fn=True, hidden=20, grad_clip=5.0))):
        tgt = make()
        cfg = ScgConfig(dim=tgt.dim, n_chains=1024, n_steps=10, **kw)
        (se, he), (sc, hc) = (train(cfg, tgt, device=dev, capture=c) for c in (False, True))
        same = all(np.array_equal(he[k], hc[k]) for k in he) and all(
            torch.equal(a, b) for a, b in zip(
                [*tree_leaves(se.params), *se.opt_state, se.x, se.step],
                [*tree_leaves(sc.params), *sc.opt_state, sc.x, sc.step]))
        cap[name] = {"bit_for_bit": same, "temperature_first_last": [
            float(hc["temperature"][0]), float(hc["temperature"][-1])]}
        _require(same, f"captured {name} training differs from eager")
    report["suite_captured_vs_eager"] = cap
    print(f"# suite captured vs eager ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(cap), flush=True)

    # (f) each spec's kernels at its suite row's shapes: the launches alone
    # (trajectory kernels through their C entry points), the plain versions,
    # the bounds
    t_phase = time.perf_counter()
    times, rows_out = {}, []
    src = "l2hmc_tpu_torch/csrc/"
    for spec, case in SUITE_TIMES.items():
        n = suite.PARITY_CASES[case].n_chains
        inp, x = suite.parity_inputs(case, n, dev, seed=32)
        g = _gen(34)
        v, dX, dV = (torch.randn(x.shape, generator=g).to(dev) for _ in range(3))
        dld = torch.ones((1, n), device=dev)
        D, H, H2, T = inp.dims
        ops = _ops_of(inp)
        blk = inp.block().numel()
        n_grads = sum(w.numel() for w in [*inp.xnet_w, *inp.vnet_w]) + D
        steps, plain_steps = 2000, 20
        t = {
            "trajectory": _traj_launch_ms(fd, _cuda, inp, x, v, 200),
            "trajectory_plain": _cuda_time(lambda: fd.trajectory_plain(inp, x, v, False), 5),
            "trajectory_bwd": _bwd_launch_ms(fd, _cuda, inp, x, v, dX, dV, dld, 100),
            "trajectory_bwd_plain": _cuda_time(
                lambda: fd.trajectory_vjp_plain(inp, x, v, dX, dV, dld, False), 3),
            "chain": _cuda_time(lambda: fd.chain(inp, x, 2, steps, True), 1),
            f"chain_{plain_steps}": _cuda_time(lambda: fd.chain(inp, x, 2, plain_steps, True), 5),
            f"chain_plain_{plain_steps}": _cuda_time(  # run at this shape in (b)
                lambda: fd.chain_plain(inp, x, 2, plain_steps, collect_trace=True), 1,
                warmup=False),
        }
        bounds = {
            "trajectory": traj_bound(D, H, H2, T, n, False, blk, ops),
            "trajectory_bwd": traj_bwd_bound(D, H, H2, T, n, False, blk, n_grads, ops),
            "chain": chain_bound(D, H, H2, T, n, steps, False, blk, True, ops),
        }
        times[spec] = {"case": case, "n_chains": n, "ms": t, "bound_ms": bounds}
        shape = f"{case} D={D} H={H} T={T}, {n} chains"
        errs = {
            "trajectory": max(e for k, c in traj.items() if SPEC_OF_CASE[k.rsplit('_n', 1)[0]]
                              == spec for e in c.values()),
            "trajectory_bwd": max(d["max_abs_err"] for k, c in bwd.items()
                                  if SPEC_OF_CASE[k.rsplit('_n', 1)[0]] == spec
                                  for d in c.values()),
            "chain": max(c["max_abs_dx_unflipped"] for k, c in chain_cmp.items()
                         if SPEC_OF_CASE[k] == spec),
        }
        for kernel, line, what in (
                ("trajectory", 645, "one direction, the launch alone"),
                ("trajectory_bwd", 801, "one direction, the launch alone"),
                ("chain", 1103, f"{steps} MH steps, traced; plain_ms over {plain_steps} MH "
                                f"steps (the kernel over {plain_steps}: "
                                f"{t[f'chain_{plain_steps}']:.4f} ms)")):
            plain = t[f"chain_plain_{plain_steps}"] if kernel == "chain" else t[f"{kernel}_plain"]
            rows_out.append({
                "name": f"{kernel}[{spec}]", "route": "cuda", "source": src + f"{kernel}.cu",
                "replaces": f"l2hmc_tpu/ops/fused_dynamics.py:{line}",
                "launches": launches[f"{kernel}:{spec}"], "max_abs_err": errs[kernel],
                "ms": t[kernel], "plain_ms": plain, "bound_ms": bounds[kernel][0],
                "bound_by": bounds[kernel][1], "library_ms": None,
                "shape": f"{shape}, {what}"})
    # row 3i: the chain kernel on icg at its recipe's widths (D = 50, hidden
    # 100: the site-parallel configuration), 2048 chains x 2000 traced steps
    inp, x = suite.parity_inputs("icg", suite.PARITY_CASES["icg"].n_chains, dev, seed=32)
    D, H, H2, T = inp.dims
    n = x.shape[1]
    t = {"chain": _cuda_time(lambda: fd.chain(inp, x, 2, steps, True), 1, warmup=False),
         f"chain_{plain_steps}": _cuda_time(lambda: fd.chain(inp, x, 2, plain_steps, True), 5),
         f"chain_plain_{plain_steps}": _cuda_time(
             lambda: fd.chain_plain(inp, x, 2, plain_steps, collect_trace=True), 1,
             warmup=False)}
    bound = chain_bound(D, H, H2, T, n, steps, False, inp.block().numel(), True, _ops_of(inp))
    plan = fd.site_tile(D, H, H2, n, *inp.energy_args)
    l2 = phi4_l2_weight_bytes(D, H, H2, T, n, steps, plan)
    times["icg"] = {"case": "icg", "n_chains": n, "ms": t, "bound_ms": {"chain": bound},
                    "plan": plan._asdict(),
                    "l2_weight_bytes": l2, "l2_weight_bytes_per_s": l2 / (t["chain"] * 1e-3)}
    rows_out.append({
        "name": "chain[gauss]", "route": "cuda", "source": src + "chain.cu",
        "replaces": "l2hmc_tpu/ops/fused_dynamics.py:1103",
        "launches": launches["chain:sites"],
        "max_abs_err": chain_cmp["icg"]["max_abs_dx_unflipped"],
        "ms": t["chain"], "plain_ms": t[f"chain_plain_{plain_steps}"], "bound_ms": bound[0],
        "bound_by": bound[1], "library_ms": None, "row": "3i",
        "shape": (f"icg D={D} H={H} T={T} eps_dim, {n} chains x {steps} MH steps, traced, "
                  f"site-parallel, {site_plan_text(plan, n)}, {l2:.4g} L2 weight bytes "
                  f"reckoned; plain_ms over {plain_steps} MH steps (the kernel over "
                  f"{plain_steps}: {t[f'chain_{plain_steps}']:.4f} ms)")})
    report["suite_kernel_times"] = times
    print(f"# suite kernel times ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(times), flush=True)
    report["suite_wall_s"] = time.perf_counter() - t_all
    print(f"# suite phase: {report['suite_wall_s']:.1f} s", flush=True)
    return rows_out


# -- 11. the phi^4 lattice ---------------------------------------------------------

# The parity cases are ``apps.phi4.PARITY_CASES``. (b)'s bars: the kernel and
# its plain version draw the same bits, so a
# decision differs only where px - u lies inside the float32 gap of two
# Hamiltonians of a few hundred (sums of 256-1024 terms in another order,
# ~1e-4): at most PHI4_FLIPS of the decisions may flip (20 of 10240 at 512
# chains x 20 steps), and the other chains agree to phase 3's 1e-2.
PHI4_FLIPS = 0.002
PHI4_CHAIN_CASES = ("phi4_L16", "phi4_L32", "phi4_L64", "gauss_D128", "phi4_L16_hmc", "phi4_L8")
# (c) the app's path at full width (L = 16, hidden 32, the JAX runner's
# defaults) cut in depth: 150 training steps (the protocol: 2000; phase 14
# trains this shape fused for 300), the 1000-step eval, the
# parallel-tempered evals cut to PHI4_PT_STEPS at 8
# rungs (the protocol's m^2 = -4 row: 24 rungs, 1000 steps). The kernel's
# eval and a plain sample_chain eval of the same params from the same x0
# are chains of one sampler on two random streams: their tunnelling rates
# and magnetization ESS, each the mean over PHI4_SEEDS streams (the run's
# and two more), must agree within PHI4_GAP relative (bench.py's ESS-gap
# bar) of the plain ones, the rate's floor 0.01 (a rate under 1% is noise
# at 512 chains x 1000 steps). One stream a route is too few: two single
# streams have given ESS_m 0.31 apart with their rates 0.006 apart (H100,
# L = 16 after 300 training steps); the estimator sums every lag's
# autocorrelation above 0.05, and its late lags average few products, so a
# 1000-step ESS_m moves by tens of percent between streams (the per-stream
# values are reported). The plain streams run as one batch of PHI4_SEEDS x
# 512 chains, a block of 512 a stream: the plain nets' small launches take
# about as long for one stream as for three.
PHI4_RUN = dict(L=16, m2=-1.0, lam=0.5, n_chains=512, hidden=32, leapfrogs=10, n_steps=150,
                eval_steps=1000, pt_rungs=8, pt_t_max=16.0)
PHI4_PT_STEPS = 50
PHI4_SEEDS = 3
PHI4_GAP = 0.30
# the other widths' runs of the app, cut in training and eval: L = 8 and
# L = 32 at the JAX package's 256 chains
# (phi4_results.json)
PHI4_RUNS_MORE = (dict(L=8, n_chains=512, n_steps=50, eval_steps=500),
                  dict(L=32, n_chains=256, n_steps=20, eval_steps=500))
# The 64 x 64 lattice at the JAX package's A_control shape (phi4_64_r3.json:
# 256 chains, hidden 32, T = 10, eps = hmc_eps = 0.03), training cut to 50
# steps (the protocol: 2000) and the eval to 600 (1000), its kernel eval held
# against a plain eval as L = 16's, each side the mean over PHI4_SEEDS_L64
# streams (gaps 0.034 and 0.041 of the 0.30 bar over three streams of 1000
# steps on an H100; a plain stream took 28-36 s).
PHI4_RUN_L64 = dict(L=64, m2=-1.0, lam=0.5, n_chains=256, hidden=32, leapfrogs=10,
                    n_steps=50, eval_steps=600, eps=0.03, hmc_eps=0.03)
PHI4_SEEDS_L64 = 2
# (e) times the shipped L = 64 recipe's shape (hidden 64, T = 24; 26 s at
# 1000 steps on an H100) over this many MH steps, for the script's clock
PHI4_RECIPE_STEPS = 100


def phi4_l2_weight_bytes(D, H, H2, T, N, K, plan):
    """Weight bytes one site-parallel chain launch reads from the L2,
    reckoned for the report, for its plan (``fd.site_tile``: a cluster of
    ``plan.G`` CTAs a tile of ``plan.chains`` chains, one load serving the
    tile's chains): each cluster reads a net's staged parts (the first
    layer's rows, or the heads' columns and per-site arrays: ``plan.staged``)
    of both nets once a launch, and the parts it streams once per tile in
    each of an MH step's 4 T net applications; every CTA reads the second
    layer, its biases and the time embedding (wh, bh, te) in each
    application. The energy spec's constants (a dense Gaussian's precision
    matrix) are not counted."""
    from l2hmc_tpu_torch.ops import fused_dynamics as fd

    tiles = -(-N // plan.chains)
    rows = 2 * D * H  # a net's first layer, over the cluster's ranges
    heads = 3 * H2 * D + 5 * D  # its heads and per-site arrays
    staged = ((rows if plan.staged & fd.STAGE_ROWS else 0)
              + (heads if plan.staged & fd.STAGE_HEADS else 0))
    streamed = rows + heads - staged
    shared = plan.G * (H * H2 + H2 + H)  # a net's, read by every CTA
    apps = K * 4 * T
    return tiles * (2 * staged + apps * (streamed + shared)) * 4


def site_plan_text(plan, n):
    """A site-parallel chain launch's plan as the rows' shapes name it."""
    tiles = -(-n // plan.chains)
    cluster = f"clusters of {plan.G} CTAs" if plan.G > 1 else "one CTA a tile"
    return (f"{plan.chains} chains a tile on {cluster} of {plan.threads} "
            f"threads ({tiles} x {plan.G} = {tiles * plan.G} CTAs, {plan.chunk} sites a CTA, "
            f"{plan.smem} bytes of shared memory a CTA, weights "
            f"{STAGED_TEXT[plan.staged]})")


# a site plan's staged parts (fd.STAGE_ROWS | fd.STAGE_HEADS) as the shapes name them
STAGED_TEXT = {0: "streamed from the L2", 1: "first layer staged, heads streamed",
               2: "heads staged, first layer streamed", 3: "staged"}


# the cluster chain kernel's entry functions in ptxas's report
SITE_CHAIN_ENTRY = "25site_cluster_chain_kernel"


def block_l2_weight_bytes(D, H, H2, T, N, K, chains_per_block):
    """Weight bytes one launch of a site-parallel trajectory kernel (a
    block a tile of ``chains_per_block`` chains) reads from the L2,
    reckoned for the report: each block reads, per trajectory, both nets'
    first-layer and head weights (one load serving the tile's chains), the
    second layer once per chain, and the biases and scales, in each of the
    4 T net applications."""
    per_app = 2 * D * H + 3 * H2 * D + chains_per_block * H * H2 + 5 * D + H2 + H
    return -(-N // chains_per_block) * K * 4 * T * per_app * 4


def phi4_conv_phase(dev, report):
    """Phase 11d's conv-net training at L = 16, captured against eager,
    cuDNN's TF32 off. It runs no kernel of the port (the kernels take dense
    nets), so it runs while the kernels build; phase 11 reports it."""
    import numpy as np
    import torch

    from l2hmc_tpu_torch import targets
    from l2hmc_tpu_torch.train import ScgConfig, build_dynamics, train
    from l2hmc_tpu_torch.train.optim import tree_leaves

    t_phase = time.perf_counter()
    _require(torch.backends.cudnn.allow_tf32 is False, "cuDNN TF32 is on")
    _require(torch.backends.cuda.matmul.allow_tf32 is False, "matmul TF32 is on")
    tgt = targets.Phi4Lattice(L=PHI4_RUN["L"], m2=PHI4_RUN["m2"], lam=PHI4_RUN["lam"])
    conv_cfg = ScgConfig(dim=tgt.dim, n_chains=128, n_steps=5, T=10, net_type="conv", eps=0.05,
                         seed=0)
    conv = {}
    for capture in (False, True):
        torch.cuda.synchronize()
        t = time.perf_counter()
        st, hist = train(conv_cfg, tgt, device=dev, capture=capture)
        torch.cuda.synchronize()
        conv[capture] = (st, hist, 1e3 * (time.perf_counter() - t) / conv_cfg.n_steps)

    conv_gap = float(_over_tolerance(conv[True][1]["loss"], conv[False][1]["loss"]).max())
    moved = any(bool((a != b).any()) for a, b in zip(
        tree_leaves(conv[True][0].params),
        tree_leaves(build_dynamics(conv_cfg, tgt)[0].init_params(_gen(0), eps=0.05, device=dev))))
    out = report["phi4_conv_training_L16"] = {
        "steps": conv_cfg.n_steps, "n_chains": conv_cfg.n_chains,
        "loss_captured": conv[True][1]["loss"].tolist(),
        "loss_eager": conv[False][1]["loss"].tolist(),
        "captured_vs_eager_gap_over_tolerance": conv_gap,
        "p_accept_last": float(conv[True][1]["p_accept"][-1]),
        "ms_per_step_eager": conv[False][2], "ms_per_step_captured_incl_recording": conv[True][2],
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "wall_s": time.perf_counter() - t_phase}
    print(f"# phi4 conv training L=16 ({out['wall_s']:.1f} s): " + json.dumps(out), flush=True)
    _require(bool(np.isfinite(conv[True][1]["loss"]).all()), "conv training: non-finite loss")
    _require(moved, "conv training: the params did not move")
    _require(conv_gap <= 1.0, f"conv training captured vs eager: {conv_gap} x tolerance")


def phi4_phases(dev, report):
    """Phase 11: the Phi4 spec through kernels 1-2 at L = 8, the chain
    kernel's site-parallel configuration at L = 8, 16 and 32, the phi^4 app's
    path, conv-net and fused training, and the kernels' times. Returns the
    ``kernels`` rows 1e, 2e, 3e, 3f and 3g."""
    import numpy as np
    import torch

    from l2hmc_tpu_torch import targets
    from l2hmc_tpu_torch.apps import phi4
    from l2hmc_tpu_torch.ops import _cuda
    from l2hmc_tpu_torch.ops import fused_dynamics as fd
    from l2hmc_tpu_torch.train import ScgConfig, build_dynamics, sample_chain, train

    t_all = time.perf_counter()
    out = {}

    # (a) kernels 1-2 on Phi4 at L = 8 (their lane groups) against their
    # plain versions; past 64 they run on sites (phase 14)
    t_phase = time.perf_counter()
    inp8, x8 = phi4.parity_inputs("phi4_L8", 512, dev, seed=20)
    g = _gen(61)
    v8, dX8, dV8 = (torch.randn(x8.shape, generator=g).to(dev) for _ in range(3))
    dld8 = torch.randn((1, 512), generator=g).to(dev)
    traj, bwd = {}, {}
    for reverse in (False, True):
        way = "backward" if reverse else "forward"
        k_out = fd.trajectory(inp8, x8, v8, reverse)
        again = fd.trajectory(inp8, x8, v8, reverse)
        _require(all(bool(torch.isfinite(t).all()) for t in k_out), "phi4 trajectory: non-finite")
        _require(all(bool((a == b).all()) for a, b in zip(k_out, again)),
                 "phi4 trajectory: two launches differ")
        traj[way] = max(float((a - b).abs().max())
                        for a, b in zip(k_out, fd.trajectory_plain(inp8, x8, v8, reverse)))
        bwd[way] = _spec_vjp_compare(fd, inp8, x8, v8, dX8, dV8, dld8, reverse)
        _require(traj[way] < TRAJ_TOL, f"phi4 trajectory {way}: {traj[way]}")
        _require(bwd[way]["max_rel_err"] <= BWD_TOL, f"phi4 trajectory_bwd {way}: {bwd[way]}")
    # past their caps (dim 4096, hidden 128) both refuse, naming the kernel
    # and its caps
    refusals = {}
    t128 = targets.Phi4Lattice(L=128)
    d128, _ = build_dynamics(ScgConfig(dim=t128.dim, hidden=32), t128)
    inp128 = fd.prepare(d128, fd.energy_spec_for_target(t128),
                        d128.init_params(_gen(0), device=dev), dev)
    x128 = t128.sample(_gen(1), 4, device=dev).T.contiguous()
    cap = "dim 16384, hidden 32 (caps dim 4096, hidden 128)"
    for kernel, call in (
            ("trajectory", lambda: fd.trajectory(inp128, x128, x128, False)),
            ("trajectory_bwd", lambda: fd.trajectory_vjp(
                inp128, x128, x128, x128, x128, torch.zeros((1, 4), device=dev), False))):
        try:
            call()
            refusals[kernel] = None
        except ValueError as e:
            refusals[kernel] = str(e)
        _require(refusals[kernel] == f"{kernel} kernel caps exceeded: {cap}",
                 f"{kernel} past its caps: {refusals[kernel]}")
    # the chain kernel past its caps: L = 128 (dim 16384), hidden 129 at L = 16
    for key, L, hidden in (("chain_L128", 128, 32), ("chain_hidden129", 16, 129)):
        tl = targets.Phi4Lattice(L=L)
        dl, _ = build_dynamics(ScgConfig(dim=tl.dim, hidden=hidden), tl)
        try:
            fd.fused_chain_sampler(dl, tl).run(
                dl.init_params(_gen(0), device=dev), tl.sample(_gen(1), 4, device=dev), seed=0,
                n_mh_steps=1)
            refusals[key] = None
        except ValueError as e:
            refusals[key] = str(e)
        _require(refusals[key] is not None and "chain kernel caps" in refusals[key]
                 and "caps dim 4096, hidden 128" in refusals[key]
                 and refusals[key] == fd.kernel_refusal(dl, tl, hidden),
                 f"chain kernel at L = {L}, hidden {hidden}: {refusals[key]}")
    out["kernels_1_2_vs_plain_L8"] = {"trajectory": traj, "trajectory_bwd": bwd,
                                      "refusals": refusals}
    print(f"# phi4 trajectory and backward kernels vs plain ({time.perf_counter() - t_phase:.1f}"
          " s): " + json.dumps(out["kernels_1_2_vs_plain_L8"]), flush=True)

    # (b) the chain kernel against its plain version on the same Philox bits
    t_phase = time.perf_counter()
    chain_cmp = {}
    for name in PHI4_CHAIN_CASES:
        n = phi4.PARITY_CASES[name].n_chains
        inp, xc = phi4.parity_inputs(name, n, dev, seed=40)
        D, H, H2, T = inp.dims
        chain_cmp[name] = _chain_vs_plain(fd, inp, xc, f"phi4 chain {name}",
                                          PHI4_FLIPS * 20 * n)
        chain_cmp[name].update(dim=D, configuration=(
            "site-parallel" if fd.chain_on_sites(inp) else
            f"{_cuda.library('chain').l2hmc_chain_lanes(D, H, H2)} lanes"))
        if fd.chain_on_sites(inp):
            chain_cmp[name].update(_site_plan_check(fd, inp, n, f"phi4 chain {name}"))
        _require(0.0 < chain_cmp[name]["accept"] < 1.0, f"phi4 chain {name}: hollow acceptance")
    ptx = _ptxas_of(_cuda.build_info.get("ptxas", ""), SITE_CHAIN_ENTRY)
    out["chain_vs_plain"] = chain_cmp
    out["site_chain_ptxas"] = ptx
    print(f"# phi4 chain kernel vs plain ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(chain_cmp), flush=True)
    print("# phi4 site-parallel chain kernel: " + json.dumps({"ptxas": ptx}), flush=True)

    # (c) the app's path through apps.phi4.run; launch counts per run
    def scores(trace):
        m = trace.mean(dim=2).cpu().numpy()
        return {"tunneling_rate": phi4.tunneling_rate(m), "ess_m": phi4.magnetization_ess(m)}

    def run_vs_plain(run_kw, n_streams, **extra):
        """apps.phi4.run, then its kernel eval on more streams and a plain
        sample_chain eval of the same params from the same x0 on as many
        (the run's streams are seed + 2): the means' gaps, held at
        PHI4_GAP."""
        fd.reset_launch_counts()
        t0 = time.perf_counter()
        row, state = phi4.run(**run_kw, **extra, device=dev, return_state=True)
        launches_run = dict(fd.LAUNCHES)
        row["wall_s"] = time.perf_counter() - t0
        L = run_kw["L"]
        _require(row["fused_eval"] == "ran",
                 f"phi4 run L={L}: kernel eval refused: {row['fused_eval']}")
        _require(launches_run["chain:phi4"] >= 1, f"chain kernel not launched at L={L}")
        tgt = targets.Phi4Lattice(L=L, m2=run_kw["m2"], lam=run_kw["lam"])
        dyn, _ = build_dynamics(ScgConfig(dim=tgt.dim, hidden=run_kw["hidden"],
                                          T=run_kw["leapfrogs"]), tgt)
        x0 = tgt.sample(_gen(1), run_kw["n_chains"], device=dev)  # run's seed + 1
        steps = run_kw["eval_steps"]
        kernel_runs = [{"tunneling_rate": row["tunneling_rate_l2hmc"],
                        "ess_m": row["ess_m_l2hmc"]}]
        sampler = fd.fused_chain_sampler(dyn, tgt)
        for i in range(1, n_streams):
            kernel_runs.append(scores(sampler.run(state.params, x0, seed=2 + 100 * i,
                                                  n_mh_steps=steps, collect_trace=True)[2]))
        # the plain streams in one batch: x0 once a stream along the chains,
        # each block of n_chains chains a stream of its own (its chains draw
        # their own numbers), scored apart
        n = run_kw["n_chains"]
        t = time.perf_counter()
        _, ptrace = sample_chain(dyn, state.params, x0.repeat(n_streams, 1), steps, _gen(2))
        torch.cuda.synchronize()
        plain_s = [time.perf_counter() - t]
        plain = [scores(ptrace[:, i * n:(i + 1) * n]) for i in range(n_streams)]
        del ptrace
        means = {route: {k: float(np.mean([r[k] for r in runs])) for k in runs[0]}
                 for route, runs in (("kernel", kernel_runs), ("plain", plain))}
        gaps = {"tunneling_rate": abs(means["kernel"]["tunneling_rate"]
                                      - means["plain"]["tunneling_rate"])
                / max(means["plain"]["tunneling_rate"], 0.01),
                "ess_m": abs(means["kernel"]["ess_m"] - means["plain"]["ess_m"])
                / max(means["plain"]["ess_m"], 1e-12)}
        # each side's own spread: the streams' standard deviation over their
        # mean
        spread = {route: {k: float(np.std([r[k] for r in runs]) / max(np.mean(
            [r[k] for r in runs]), 1e-12)) for k in runs[0]}
            for route, runs in (("kernel", kernel_runs), ("plain", plain))}
        res = {"row": row, "kernel_evals": kernel_runs, "plain_evals": plain,
               "plain_eval_s": plain_s, "means": means, "gap_over_plain": gaps,
               "stream_spread": spread, "launches": launches_run}
        print(f"# phi4 run L={L} ({row['wall_s']:.1f} s): " + json.dumps(res), flush=True)
        vals = [v for k, v in row.items() if k.startswith(("tunneling", "ess_m"))]
        _require(all(np.isfinite(v) for v in vals), f"phi4 run L={L}: {row}")
        _require(0.0 < row["final_accept"] < 1.0,
                 f"phi4 run L={L}: acceptance {row['final_accept']}")
        _require(max(gaps.values()) <= PHI4_GAP, f"phi4 L={L} kernel eval vs plain eval: {gaps}")
        return res, state

    out["run_L16"], _ = run_vs_plain(PHI4_RUN, PHI4_SEEDS, pt_eval_steps=PHI4_PT_STEPS)
    launches_run = out["run_L16"]["launches"]
    out["run_L64"], state64 = run_vs_plain(PHI4_RUN_L64, PHI4_SEEDS_L64)
    more = {}
    for kw in PHI4_RUNS_MORE:
        before = fd.LAUNCHES["chain:phi4"]
        t = time.perf_counter()
        r = phi4.run(device=dev, **kw)
        r["wall_s"] = time.perf_counter() - t
        r["launches_chain"] = fd.LAUNCHES["chain:phi4"] - before
        more[f"L{kw['L']}"] = r
        print(f"# phi4 run L={kw['L']} ({r['wall_s']:.1f} s): " + json.dumps(r), flush=True)
        _require(r["fused_eval"] == "ran" and r["launches_chain"] >= 1,
                 f"phi4 run L={kw['L']}: {r['fused_eval']}")
        _require(all(np.isfinite(v) for k, v in r.items() if k.startswith(("tunneling", "ess"))),
                 f"phi4 run L={kw['L']}: {r}")
    out["runs_more"] = more

    # (d) conv-net training at L = 16, captured against eager (no kernel: it
    # ran beside the build, ``phi4_conv_phase``); fused against plain
    # training at L = 8 (kernels 1-2 on Phi4)
    t_phase = time.perf_counter()
    out["conv_training_L16"] = report["phi4_conv_training_L16"]
    # fused against plain at L = 8, as 10d: the fused step's loss at each of
    # the plain run's 10 states on the same draws, held at phase 5b's bar;
    # the two free runs through ``train`` reported and not held: on an H100
    # they agree to 3.5e-5 relative over steps 1-5 and then part, 10.8x the
    # bar by step 17, the ring's way in 10d (losses near -2000, and Adam's
    # sign-like step turns rounding into parameter gaps)
    t8 = targets.Phi4Lattice(L=8, m2=-1.0, lam=0.5)
    fcfg = ScgConfig(dim=t8.dim, n_chains=512, n_steps=10, T=10, hidden=32, seed=0)
    dyn8, _ = build_dynamics(fcfg, t8)
    same = _same_state_losses(fcfg, dyn8, t8, dev)
    fused_gap = float(_over_tolerance(*zip(*same)).max())
    # the fused training path's own launches: the counts set to 0 just
    # before it and read just after
    hists = {}
    fd.reset_launch_counts()
    hists[True] = train(dataclasses.replace(fcfg, fused_train=True), t8, device=dev)[1]
    launches = dict(fd.LAUNCHES)
    hists[False] = train(dataclasses.replace(fcfg, fused_train=False), t8, device=dev)[1]
    out["fused_vs_plain_training_L8"] = {
        "same_states_max_gap_over_tolerance": fused_gap,
        "free_gap_by_step": _over_tolerance(hists[True]["loss"], hists[False]["loss"]).tolist(),
        "loss_fused": hists[True]["loss"].tolist(), "loss_plain": hists[False]["loss"].tolist()}
    out["fused_training_launches"] = launches
    print(f"# phi4 training ({time.perf_counter() - t_phase:.1f} s): " + json.dumps(
        {k: out[k] for k in ("conv_training_L16", "fused_vs_plain_training_L8")}), flush=True)
    print(f"# phi4 fused training launches (L = 8, {fcfg.n_steps} steps): " + json.dumps(launches),
          flush=True)
    _require(fused_gap <= 1.0, f"phi4 fused vs plain training at the same states: {fused_gap} "
                               "x tolerance")
    for kernel in ("trajectory", "trajectory_bwd"):
        _require(launches[f"{kernel}:phi4"] > 0,
                 f"kernel {kernel} on Phi4 not launched by fused training")

    # (e) the kernels at the app's shapes: launches alone, plain versions,
    # bounds; the site-parallel launches' L2 weight bytes
    t_phase = time.perf_counter()
    dld8 = torch.ones((1, 512), device=dev)
    D, H, H2, T = inp8.dims
    ops8 = _ops_of(inp8)
    blk8 = inp8.block().numel()
    n_grads = sum(w.numel() for w in [*inp8.xnet_w, *inp8.vnet_w]) + D
    times = {
        "trajectory": _traj_launch_ms(fd, _cuda, inp8, x8, v8, 200),
        "trajectory_plain": _cuda_time(lambda: fd.trajectory_plain(inp8, x8, v8, False), 5),
        "trajectory_bwd": _bwd_launch_ms(fd, _cuda, inp8, x8, v8, dX8, dV8, dld8, 100),
        "trajectory_bwd_plain": _cuda_time(
            lambda: fd.trajectory_vjp_plain(inp8, x8, v8, dX8, dV8, dld8, False), 3),
    }
    steps, plain_steps = 1000, 20  # the rows' launch: the app's eval
    # 3h at the L = 64 run's trained params (A_control's shape), and at the
    # shipped recipe's (the phi4_L64 parity case)
    t64 = targets.Phi4Lattice(L=64, m2=PHI4_RUN_L64["m2"], lam=PHI4_RUN_L64["lam"])
    dyn64, _ = build_dynamics(ScgConfig(dim=t64.dim, hidden=PHI4_RUN_L64["hidden"],
                                        T=PHI4_RUN_L64["leapfrogs"]), t64)

    def a_control_inputs():
        inp = fd.prepare(dyn64, fd.energy_spec_for_target(t64), state64.params, dev)
        return inp, t64.sample(_gen(33), PHI4_RUN_L64["n_chains"], device=dev).T.contiguous()

    chain_rows = {}
    for label, case, make in (
            ("3e", "phi4_L8", None), ("3f", "phi4_L16", None), ("3g", "phi4_L32", None),
            ("3h", "phi4_L64", a_control_inputs), ("3h_recipe", "phi4_L64", None)):
        inp, xc = (make() if make else
                   phi4.parity_inputs(case, phi4.PARITY_CASES[case].n_chains, dev, seed=32))
        Dc, Hc, H2c, Tc = inp.dims
        n = xc.shape[1]
        # the launches at L = 64 run once, their instantiations warmed up by
        # (b); the recipe's shape at PHI4_RECIPE_STEPS (the script's clock)
        wide = Dc > 1024
        k = PHI4_RECIPE_STEPS if label == "3h_recipe" else steps
        ms = _cuda_time(lambda: fd.chain(inp, xc, 2, k, True), 1, warmup=not wide)
        ms20 = _cuda_time(lambda: fd.chain(inp, xc, 2, plain_steps, True), 3)
        # the plain chain ran at this shape in (b)
        plain = (_cuda_time(lambda: fd.chain_plain(inp, xc, 2, plain_steps, collect_trace=True),
                            1, warmup=False) if label != "3h_recipe" else None)
        bound = chain_bound(Dc, Hc, H2c, Tc, n, k, False, inp.block().numel(), True,
                            _ops_of(inp))
        site = fd.chain_on_sites(inp)
        plan = fd.site_tile(Dc, Hc, H2c, n, *inp.energy_args) if site else None
        l2 = phi4_l2_weight_bytes(Dc, Hc, H2c, Tc, n, k, plan) if site else None
        chain_rows[label] = {"case": case, "dim": Dc, "hidden": Hc, "T": Tc, "n_chains": n,
                             "steps": k, "site": site,
                             "plan": plan._asdict() if site else None,
                             "plan_text": site_plan_text(plan, n) if site else None, "ms": ms,
                             f"ms_{plain_steps}": ms20, f"plain_ms_{plain_steps}": plain,
                             "bound_ms": bound, "l2_weight_bytes": l2,
                             "l2_weight_bytes_per_s": None if l2 is None else l2 / (ms * 1e-3)}
    bounds = {
        "trajectory": traj_bound(D, H, H2, T, 512, False, blk8, ops8),
        "trajectory_bwd": traj_bwd_bound(D, H, H2, T, 512, False, blk8, n_grads, ops8),
    }
    out["kernel_times"] = {"L8": {"ms": times, "bound_ms": bounds}, "chain": chain_rows}
    print(f"# phi4 kernel times ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(out["kernel_times"]), flush=True)

    src = "l2hmc_tpu_torch/csrc/"
    shape8 = f"phi4 L=8 D={D} H={H} T={T}, 512 chains, one direction, the launch alone"
    rows = [
        {"name": "trajectory[phi4]", "route": "cuda", "source": src + "trajectory.cu",
         "replaces": "l2hmc_tpu/ops/fused_dynamics.py:645",
         "launches": launches["trajectory:phi4"], "max_abs_err": max(traj.values()),
         "ms": times["trajectory"], "plain_ms": times["trajectory_plain"],
         "bound_ms": bounds["trajectory"][0], "bound_by": bounds["trajectory"][1],
         "library_ms": None, "shape": shape8, "row": "1e"},
        {"name": "trajectory_bwd[phi4]", "route": "cuda", "source": src + "trajectory_bwd.cu",
         "replaces": "l2hmc_tpu/ops/fused_dynamics.py:801",
         "launches": launches["trajectory_bwd:phi4"],
         "max_abs_err": max(d["max_abs_err"] for d in bwd.values()),
         "ms": times["trajectory_bwd"], "plain_ms": times["trajectory_bwd_plain"],
         "bound_ms": bounds["trajectory_bwd"][0], "bound_by": bounds["trajectory_bwd"][1],
         "library_ms": None, "shape": shape8, "row": "2e"},
    ]
    launch_of = {"3e": more["L8"]["launches_chain"], "3f": launches_run["chain:phi4"],
                 "3g": more["L32"]["launches_chain"],
                 "3h": out["run_L64"]["launches"]["chain:phi4"]}
    recipe = chain_rows["3h_recipe"]
    for label, c in chain_rows.items():
        if label not in launch_of:
            continue
        shape = (f"{c['case']} D={c['dim']} H={c['hidden']} T={c['T']}, {c['n_chains']} chains "
                 f"x {steps} MH steps, traced, "
                 + (f"site-parallel, {c['plan_text']}, {c['l2_weight_bytes']:.4g} L2 weight "
                    f"bytes reckoned"
                    if c["site"] else "32 lanes a chain (WideLanes)")
                 + f"; plain_ms over {plain_steps} MH steps (the kernel over {plain_steps}: "
                   f"{c[f'ms_{plain_steps}']:.4f} ms)")
        if label == "3h":
            shape += (f"; at the L = 64 run's trained params (A_control's shape); the shipped "
                      f"recipe's shape (H={recipe['hidden']} T={recipe['T']}), "
                      f"{recipe['steps']} MH steps: "
                      f"{recipe['ms']:.2f} ms, {recipe['l2_weight_bytes']:.4g} L2 weight bytes "
                      f"reckoned, bound {recipe['bound_ms'][0]:.4g} ms; the app's plain "
                      f"sample_chain eval of its {PHI4_SEEDS_L64} streams in one batch: "
                      f"{out['run_L64']['plain_eval_s'][0]:.2f} s")
        rows.append({"name": "chain[phi4]", "route": "cuda", "source": src + "chain.cu",
                     "replaces": "l2hmc_tpu/ops/fused_dynamics.py:1103",
                     "launches": launch_of[label],
                     "max_abs_err": chain_cmp[c["case"]]["max_abs_dx_unflipped"],
                     "ms": c["ms"], "plain_ms": c[f"plain_ms_{plain_steps}"],
                     "bound_ms": c["bound_ms"][0], "bound_by": c["bound_ms"][1],
                     "library_ms": None, "shape": shape, "row": label})
    report["phi4"] = out
    report["phi4_wall_s"] = time.perf_counter() - t_all
    print(f"# phi4 phase: {report['phi4_wall_s']:.1f} s", flush=True)
    return rows


# -- 14. kernels 1-2 on sites ----------------------------------------------------------

# The trajectory kernel and its backward kernel past 64 wide, on the
# site-parallel configuration (csrc/l2hmc_sites.cuh): (a) row 1 against its
# plain version, both directions, each launch twice bit for bit, at the
# lattice at L = 16 (1024 chains), 32 (256), 64 (256, A_control's shape:
# hidden 32, T = 10, eps 0.03) and icg (D = 50, hidden 100, eps_dim; 2048
# chains): X and V at phase 2's TRAJ_TOL, the log-det, a sum over D sites and
# 4 T net applications in another order than torch.sum, within TRAJ_TOL or
# WIDE_LD_REL of its largest magnitude, whichever is larger (at L = 64 the
# log-det reaches ~1.4e3, where float32 sums of 40,960 terms part by
# ~4e-4: 2.6e-7 of it on an H100); forward then reverse returns x within
# WIDE_INVERSE_TOL on at least WIDE_INVERSE_SHARE of the chains. (b) row 2
# against its plain version at the same cases (at L = 64 its intermediates
# in its global scratch), per leaf within BWD_TOL of its largest entry with
# at most one chain set aside by ``relu_margins`` (``_spec_vjp_compare``),
# twice bit for bit.
WIDE_CASES = (("phi4_L16", 1024), ("phi4_L32", 256), ("icg", 2048), ("phi4_L64", 256))
WIDE_LD_REL = 2e-6
WIDE_INVERSE_TOL = 1e-4
WIDE_INVERSE_SHARE = 0.8
# (c) fused against plain training at L = 16, 1024 chains, WIDE_SAME_STEPS
# steps: the fused step's loss at each of the plain run's states on the same
# draws at phase 5b's bar; one fused step recorded as a CUDA graph (as the
# captured route records it) against the eager step on the same state and
# draws, bit for bit, at the initial state and after the plain run; and
# ``train``'s captured route against its eager one over WIDE_CAPTURE_STEPS
# fused steps, bit for bit (5d's comparison).
WIDE_SAME_STEPS = 20
WIDE_CAPTURE_STEPS = 10
# (d) the path: ``train`` on the ScgConfig the phi^4 runner builds at L = 16
# (m^2 = -1, lam = 0.5, hidden 32, T = 10, eps 0.1, 1024 chains) with
# fused_train=True, cut to WIDE_TRAIN_STEPS of the protocol's 2000 steps;
# the chain kernel's traced eval and plain HMC (the app's baseline, eps 0.1)
# over WIDE_EVAL_STEPS; ms per fused and plain step at steady state
# (``steady_ms`` over WIDE_STEADY); short fused runs at L = 32 and 64 (256
# chains) and on icg (2048 chains); the trajectory kernel as the gate of the
# sampler's trajectory at L = 64 (``FusedDynamics`` against
# ``Dynamics.forward``/``backward``, A_control's shape) and, in bf16, at
# L = 16 on the trained params (nearer the bf16 nets than the float32
# kernel, in RMS, as 13c).
WIDE_APP = dict(L=16, m2=-1.0, lam=0.5, n_chains=1024, hidden=32, T=10, eps=0.1)
WIDE_TRAIN_STEPS = 150
WIDE_EVAL_STEPS = 500
WIDE_STEADY = (10, 40)
WIDE_SHORT_RUNS = (("L32", 20), ("icg", 10), ("L64", 4))


def wide_l2_bytes(D, H, H2, T, N, kernel):
    """Bytes a site-parallel launch of ``kernel`` reads and writes through
    the L2, reckoned for the report: the weights of its 4 T net applications
    a block (``block_l2_weight_bytes``, one trajectory), for the backward
    kernel three times (the forward sweep, each substep's recompute, its
    VJP), its factor writes (each application's a, b, dus, dut, duq, h,
    dz1, h2 and dz2 for the tile's 4 chains, once, 4 bytes each) and its
    compact rows' read-modify-writes (each application: the per-site
    arrays and eps, bh and te's column, 8 bytes each)."""
    w = block_l2_weight_bytes(D, H, H2, T, N, 1, 4)
    if kernel == "trajectory":
        return w
    apps = -(-N // 4) * T * 4
    factors = apps * 4 * (5 * D + 2 * H + 2 * H2) * 4
    rows = apps * (6 * D + H2 + H) * 8
    return 3 * w + factors + rows


# The site VJP's reduction (rows 2f-2l's second kernel, csrc/trajectory_bwd.cu:
# site_reduce_kernel, then site_reduce_sum_kernel over its partial rows)
# against its plain version (float32 matrix products, TF32 off) on seeded
# factors of the main path's shape (the fused L = 16 path's launches: 1024
# chains, K = 20,480 rows a net), per product within REDUCE_TOL of its
# largest entry (float32 sums over K in another order: measured ~2e-6 on
# seeded normal factors), twice bit for bit.
REDUCE_TOL = 1e-5


def reduce_bound(D, H, H2, K):
    """The reduction's bound: its twelve products over K factor rows a net
    (an FMA 2), or its bytes (the factors read once, the products written
    once)."""
    wc = 2 * _stq_weights(D, H, H2)
    return _bound(2 * K * wc, 4 * (2 * K * (5 * D + 2 * H + 2 * H2) + wc))


def _reduce_vs_plain(fd, dev, D, H, H2, K):
    """The reduction kernel against its plain version on seeded normal
    factors of K rows a net, each launch twice, with its time, the plain
    version's and the bound."""
    import torch

    g = torch.Generator(device=dev).manual_seed(71)
    flat = torch.randn(2 * K * fd._factor_row_floats(D, H, H2), generator=g, device=dev)
    got = fd.reduce_factors(flat, D, H, H2, K)
    again = fd.reduce_factors(flat, D, H, H2, K)
    ref = fd.reduce_factors_plain(flat, D, H, H2, K)
    rel = max(float((a - b).abs().max() / b.abs().max())
              for ga, gb in zip(fd.reduced_weights(got, D, H, H2),
                                fd.reduced_weights(ref, D, H, H2)) for a, b in zip(ga, gb))
    out = {"K": K, "splits": fd.reduce_splits(D, H, H2, K), "factor_bytes": 4 * flat.numel(),
           "max_abs_err": float((got - ref).abs().max()), "max_rel_err": rel,
           "repeats_bit_for_bit": bool(torch.equal(got, again)),
           "finite": bool(torch.isfinite(got).all()),
           "ms": _cuda_time(lambda: fd.reduce_factors(flat, D, H, H2, K), 20, warmup=False),
           "plain_ms": _cuda_time(lambda: fd.reduce_factors_plain(flat, D, H, H2, K), 5,
                                  warmup=False),
           "bound": reduce_bound(D, H, H2, K)}
    _require(out["finite"] and out["repeats_bit_for_bit"] and rel <= REDUCE_TOL,
             f"the site VJP's reduction against its plain version: {out}")
    return out


def _wide_inputs(fd, dev, name, n, seed):
    """Float32 kernel inputs and (D, n) states of a phase 14 case."""
    from l2hmc_tpu_torch.apps import phi4, suite

    if name == "icg":
        inp, x = suite.parity_inputs("icg", n, dev, seed=seed)
    elif name == "phi4_L64":
        inp, x = _phi4_inputs(fd, dev, "L64", seed)
    else:
        inp, x = phi4.parity_inputs(name, n, dev, seed=seed)
    return inp, x.contiguous()


def wide_traj_phases(dev, report):
    """Phase 14: kernels 1 and 2 on sites against their plain versions, fused
    against plain training at L = 16, the fused phi^4 training path, the bf16
    site trajectory, the new rows' times; returns rows 1f-1i, 2f-2i and
    1f-bf16 of the ``kernels`` line."""
    import numpy as np
    import torch

    from l2hmc_tpu_torch import targets
    from l2hmc_tpu_torch.apps import phi4, suite
    from l2hmc_tpu_torch.ops import _cuda
    from l2hmc_tpu_torch.ops import fused_dynamics as fd
    from l2hmc_tpu_torch.train import (
        ScgConfig, StepDraws, TrainState, build_dynamics, draw_step, hmc_sample_chain,
        init_state, make_optimizer, make_train_step, train,
    )
    from l2hmc_tpu_torch.train.optim import AdamState, tree_leaves, tree_unflatten
    from l2hmc_tpu_torch.utils import capture, steady_ms

    t_all = time.perf_counter()
    out = {}
    cases = WIDE_CASES

    # (a), (b) the two kernels against their plain versions
    t_phase = time.perf_counter()
    traj, bwd, inputs = {}, {}, {}
    for name, n in cases:
        inp, x = _wide_inputs(fd, dev, name, n, 20)
        D, H, H2, T = inp.dims
        g = _gen(61)
        v, dX, dV = (torch.randn(x.shape, generator=g).to(dev) for _ in range(3))
        dld = torch.randn((1, n), generator=g).to(dev)
        inputs[name] = (inp, x, v, dX, dV)
        geom = fd.trajectory_site_tile("trajectory", D, H, H2)
        _require(fd.trajectory_on_sites(inp)
                 and geom == fd.trajectory_site_geometry("trajectory", D, H, H2, n)[:3],
                 f"trajectory on sites {name}: geometry {geom}")
        case = {"dim": D, "hidden": H, "T": T, "n_chains": n,
                "chains_threads_smem_bytes_a_block": geom}
        for reverse in (False, True):
            way = "backward" if reverse else "forward"
            got = fd.trajectory(inp, x, v, reverse)
            again = fd.trajectory(inp, x, v, reverse)
            ref = fd.trajectory_plain(inp, x, v, reverse)
            back = fd.trajectory(inp, got[0], got[1], not reverse)
            miss = (back[0] - x).abs().amax(0)
            ld_bar = max(TRAJ_TOL, WIDE_LD_REL * float(ref[2].abs().max()))
            c = {"max_abs_err_x_v": max(float((a - b).abs().max()) for a, b in zip(got[:2], ref[:2])),
                 "max_abs_err_logdet": float((got[2] - ref[2]).abs().max()),
                 "logdet_bar": ld_bar, "logdet_scale": float(ref[2].abs().max()),
                 "inverse_share_within_tol": float((miss <= WIDE_INVERSE_TOL).float().mean()),
                 "inverse_max_miss": float(miss.max()),
                 "repeats_bit_for_bit": all(bool(torch.equal(a, b)) for a, b in zip(got, again))}
            case[way] = c
            _require(all(bool(torch.isfinite(a).all()) for a in got), f"trajectory {name} {way}")
            _require(c["repeats_bit_for_bit"], f"trajectory {name} {way}: two launches differ")
            _require(c["max_abs_err_x_v"] <= TRAJ_TOL and c["max_abs_err_logdet"] <= ld_bar
                     and c["inverse_share_within_tol"] >= WIDE_INVERSE_SHARE,
                     f"trajectory on sites {name} {way}: {c}")
        traj[name] = case
        bgeom = fd.trajectory_site_tile("trajectory_bwd", D, H, H2)
        plan = fd.site_bwd_plan(D, H, H2, T, n)
        _require(bgeom == fd.trajectory_site_geometry("trajectory_bwd", D, H, H2, n)[:3]
                 and plan == fd.site_bwd_plan_of_library(D, H, H2, T, n),
                 f"trajectory_bwd on sites {name}: geometry {bgeom}, plan {plan}")
        bcase = {"chains_threads_smem_bytes_a_block": bgeom,
                 "scratch_bytes": 4 * fd.bwd_scratch_floats(inp, n),
                 "factor_scratch_bytes": 4 * plan["fac"],
                 "plan": {k: plan[k] for k in ("blocks", "parts", "K", "splits")}}
        for reverse in (False, True):
            way = "backward" if reverse else "forward"
            c = _spec_vjp_compare(fd, inp, x, v, dX, dV, dld, reverse)
            a1 = tree_leaves(list(fd.trajectory_vjp(inp, x, v, dX, dV, dld, reverse)))
            a2 = tree_leaves(list(fd.trajectory_vjp(inp, x, v, dX, dV, dld, reverse)))
            c["repeats_bit_for_bit"] = all(bool(torch.equal(p, q)) for p, q in zip(a1, a2))
            bcase[way] = c
            _require(c["repeats_bit_for_bit"], f"trajectory_bwd {name} {way}: two launches differ")
            _require(c["max_rel_err"] <= BWD_TOL, f"trajectory_bwd on sites {name} {way}: {c}")
        bwd[name] = bcase
    out["trajectory_vs_plain"], out["trajectory_bwd_vs_plain"] = traj, bwd
    print(f"# sites: trajectory kernel vs plain ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(traj), flush=True)
    print("# sites: backward kernel vs plain: " + json.dumps(bwd), flush=True)
    # the backward kernel's reduction alone at the L = 16 path's factors
    t_phase = time.perf_counter()
    inp16 = inputs["phi4_L16"][0]
    D, H, H2, T = inp16.dims
    K16 = fd.site_bwd_plan(D, H, H2, T, dict(cases)["phi4_L16"])["K"]
    out["reduce_vs_plain"] = _reduce_vs_plain(fd, dev, D, H, H2, K16)
    print(f"# sites: the backward kernel's reduction vs plain "
          f"({time.perf_counter() - t_phase:.1f} s): " + json.dumps(out["reduce_vs_plain"]),
          flush=True)

    # (c) fused against plain training at L = 16 at the plain run's states;
    # one fused step recorded against the eager step
    t_phase = time.perf_counter()
    tgt = targets.Phi4Lattice(L=WIDE_APP["L"], m2=WIDE_APP["m2"], lam=WIDE_APP["lam"])
    cfg = ScgConfig(dim=tgt.dim, n_chains=WIDE_APP["n_chains"], T=WIDE_APP["T"],
                    hidden=WIDE_APP["hidden"], eps=WIDE_APP["eps"], n_steps=WIDE_TRAIN_STEPS,
                    seed=0)
    dyn, _ = build_dynamics(cfg, tgt)
    opt, _ = make_optimizer(cfg)
    plain_step = make_train_step(cfg, dyn, opt)
    fused_step = make_train_step(cfg, fd.differentiable_fused(dyn, tgt), opt)
    state = init_state(cfg, dyn, opt, device=dev)
    state = state._replace(step=torch.as_tensor(0, dtype=torch.int32, device=dev))
    gen = _gen(cfg.seed + 100)

    def draws():
        return StepDraws(*(None if a is None else a.to(dev) for a in draw_step(
            gen, cfg.n_chains, cfg.dim, z_burn_in=cfg.z_burn_in_loss)))

    def captured_vs_eager(st, d):
        """The fused step eager and recorded (two warm-up calls on a side
        stream, then the graph's replay) on static copies of ``st``: bit for
        bit in the loss and every state tensor."""
        def copy(s):
            return TrainState(tree_unflatten(s.params, [t.detach().clone()
                                                        for t in tree_leaves(s.params)]),
                              AdamState(*(t.clone() for t in s.opt_state)), s.x.clone(), None,
                              s.step.clone())

        eager, me = fused_step(copy(st), d)
        static, box = copy(st), {}

        def body():
            box["o"] = fused_step(static, d)

        for _ in range(capture.WARMUP_CALLS):
            capture.run_on_side_stream(body)
        capture.Graph(body).replay()
        torch.cuda.synchronize()
        rep, mr = box["o"]

        def tensors(s):
            return [*tree_leaves(s.params), *s.opt_state, s.x, s.step]

        return bool(torch.equal(me["loss"], mr["loss"])) and all(
            torch.equal(a, b) for a, b in zip(tensors(eager), tensors(rep)))

    bit_for_bit = [captured_vs_eager(state, draws())]
    same, ms = [], {"fused": [], "plain": []}
    for _ in range(WIDE_SAME_STEPS):
        d = draws()
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, mf = fused_step(state, d)
        torch.cuda.synchronize()
        ms["fused"].append(1e3 * (time.perf_counter() - t))
        t = time.perf_counter()
        state, mp = plain_step(state, d)
        torch.cuda.synchronize()
        ms["plain"].append(1e3 * (time.perf_counter() - t))
        same.append((float(mf["loss"]), float(mp["loss"])))
    bit_for_bit.append(captured_vs_eager(state, draws()))
    routes = [train(dataclasses.replace(cfg, n_steps=WIDE_CAPTURE_STEPS, fused_train=True), tgt,
                    device=dev, capture=c) for c in (False, True)]
    (se, he), (sc, hc) = routes
    route_same = all(np.array_equal(he[k], hc[k]) for k in he) and all(
        torch.equal(a, b) for a, b in zip([*tree_leaves(se.params), *se.opt_state, se.x, se.step],
                                          [*tree_leaves(sc.params), *sc.opt_state, sc.x, sc.step]))
    gap = float(_over_tolerance(*zip(*same)).max())
    out["fused_vs_plain_training_L16"] = {
        "steps": WIDE_SAME_STEPS, "n_chains": cfg.n_chains,
        "same_states_max_gap_over_tolerance": gap,
        "loss_fused": [a for a, _ in same], "loss_plain": [b for _, b in same],
        "eager_ms_per_step_median": {k: float(np.median(v)) for k, v in ms.items()},
        "captured_step_equals_eager": bit_for_bit,
        "captured_route_equals_eager": {"steps": WIDE_CAPTURE_STEPS, "bit_for_bit": route_same,
                                        "loss_eager": he["loss"].tolist(),
                                        "loss_captured": hc["loss"].tolist()}}
    print(f"# sites: fused vs plain training L=16 ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(out["fused_vs_plain_training_L16"]), flush=True)
    _require(gap <= 1.0, f"fused vs plain training at L = 16, same states: {gap} x tolerance")
    _require(all(bit_for_bit), f"captured fused step differs from eager: {bit_for_bit}")
    _require(route_same, "captured fused training at L = 16 differs from eager")

    # (d) the path; launch counts set to 0 just before it and read just after
    t_phase = time.perf_counter()
    fd.reset_launch_counts()
    fcfg = dataclasses.replace(cfg, fused_train=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    st, hist = train(fcfg, tgt, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    x0 = tgt.sample(_gen(1), cfg.n_chains, device=dev)
    sampler = fd.fused_chain_sampler(dyn, tgt)
    t = time.perf_counter()
    _, acc, trace = sampler.run(st.params, x0, seed=2, n_mh_steps=WIDE_EVAL_STEPS,
                                collect_trace=True)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t
    m = trace.mean(dim=2).cpu().numpy()
    del trace
    _, htrace = hmc_sample_chain(tgt, WIDE_APP["eps"], WIDE_APP["T"], x0, WIDE_EVAL_STEPS,
                                 _gen(3))
    mh = htrace.mean(dim=2).cpu().numpy()
    del htrace
    launches_train = dict(fd.LAUNCHES)
    short = {}
    for label, steps in WIDE_SHORT_RUNS:
        if label == "icg":
            ci = suite.PARITY_CASES["icg"]
            t_s = ci.target()
            scfg = ScgConfig(dim=t_s.dim, n_chains=ci.n_chains, T=ci.T, hidden=ci.hidden,
                             eps_dim=ci.eps_dim, n_steps=steps, seed=0, fused_train=True)
        else:  # L = 32 at its parity case's eps, L = 64 at A_control's
            L = int(label[1:])
            t_s = targets.Phi4Lattice(L=L, m2=WIDE_APP["m2"], lam=WIDE_APP["lam"])
            scfg = ScgConfig(dim=t_s.dim, n_chains=256, T=10, hidden=32,
                             eps=0.05 if L == 32 else 0.03, n_steps=steps, seed=0,
                             fused_train=True)
        before = dict(fd.LAUNCHES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, h_s = train(scfg, t_s, device=dev)
        torch.cuda.synchronize()
        short[label] = {"steps": steps, "n_chains": scfg.n_chains,
                        "ms_per_step_incl_capture": 1e3 * (time.perf_counter() - t) / steps,
                        "loss": h_s["loss"].tolist(),
                        "launches": {k: fd.LAUNCHES[k] - before[k]
                                     for k in ("trajectory:sites", "trajectory_bwd:sites",
                                               "trajectory_bwd_reduce")}}
        _require(bool(np.isfinite(h_s["loss"]).all())
                 and min(short[label]["launches"].values()) > 0, f"fused {label}: {short[label]}")
    # the trajectory kernel as the sampler's trajectory gate: at L = 64
    # (A_control's shape) in float32, at L = 16 in bf16 on the trained params
    t64 = targets.Phi4Lattice(L=64, m2=-1.0, lam=0.5)
    d64, _ = build_dynamics(ScgConfig(dim=t64.dim, hidden=32, T=10), t64)
    p64 = d64.init_params(_gen(4), eps=0.03, device=dev)
    p64 = dict(p64, **{k: _tree_map(lambda a: a + phi4.PARITY_LIFT, p64[k])
                       for k in ("xnet", "vnet")})
    x64 = t64.sample(_gen(5), 256, device=dev)
    v64 = torch.randn(x64.shape, generator=_gen(6)).to(dev)
    before = fd.LAUNCHES["trajectory:sites"]
    gate64 = max(float((a - b).abs().max() / max(1.0, float(b.abs().max())))
                 for way in ("forward", "backward")
                 for a, b in zip(getattr(fd.fused_for_target(d64, t64), way)(p64, x64, v64),
                                 getattr(d64, way)(p64, x64, v64)))
    gate64_launches = fd.LAUNCHES["trajectory:sites"] - before
    BF = "bfloat16"
    dynb, _ = build_dynamics(dataclasses.replace(cfg, compute_dtype=BF), tgt)
    xg = x0[:512]
    vg = torch.randn(xg.shape, generator=_gen(12)).to(dev)
    shares = []
    before = fd.LAUNCHES["trajectory:bf16"]
    for way in ("forward", "backward"):
        refb = getattr(dynb, way)(st.params, xg, vg)
        for a, c, b in zip(getattr(fd.fused_for_target(dynb, tgt, compute_dtype=BF), way)(
                st.params, xg, vg), getattr(fd.fused_for_target(dyn, tgt), way)(
                st.params, xg, vg), refb):
            shares.append(_share(_rms(a, b), _rms(c, b)))
    bf16_launches = fd.LAUNCHES["trajectory:bf16"] - before
    launches = dict(fd.LAUNCHES)
    steady = {}
    for fused in (True, False):
        steady["fused" if fused else "plain"] = steady_ms(
            lambda n, f=fused: train(dataclasses.replace(cfg, n_steps=n, fused_train=f), tgt,
                                     device=dev), *WIDE_STEADY)
    path = {
        "config": dict(WIDE_APP, steps=WIDE_TRAIN_STEPS, protocol_steps=2000),
        "train_s": train_s, "ms_per_step_incl_capture": 1e3 * train_s / WIDE_TRAIN_STEPS,
        "ms_per_step_steady": steady, "final_loss": float(hist["loss"][-1]),
        "final_accept": float(np.mean(hist["p_accept"][-100:])),
        "final_eps": float(hist["eps"][-1]), "eval_steps": WIDE_EVAL_STEPS,
        "eval_kernel_s": eval_s, "eval_accept": float(acc.mean()),
        "tunneling_rate_l2hmc": phi4.tunneling_rate(m), "tunneling_rate_hmc": phi4.tunneling_rate(mh),
        "ess_m_l2hmc": phi4.magnetization_ess(m), "ess_m_hmc": phi4.magnetization_ess(mh),
        "short_runs": short, "gate_L64_max_rel_err": gate64, "gate_L64_launches": gate64_launches,
        "bf16_gate_L16_rms_share_of_f32_kernel": max(shares), "bf16_gate_launches": bf16_launches,
        "launches_training": launches_train, "launches": launches,
        "wall_s": time.perf_counter() - t_phase}
    out["path"] = path
    print(f"# sites: phi4 fused training path L=16 ({path['wall_s']:.1f} s): " + json.dumps(path),
          flush=True)
    _require(bool(np.isfinite(hist["loss"]).all()) and 0.0 < path["final_accept"] < 1.0,
             f"fused phi4 training: {path['final_loss']}, {path['final_accept']}")
    _require(all(np.isfinite(path[k]) for k in ("tunneling_rate_l2hmc", "ess_m_l2hmc",
                                                 "tunneling_rate_hmc", "ess_m_hmc")),
             f"fused phi4 path scores: {path}")
    _require(gate64 <= TRAJ_TOL, f"trajectory gate at L = 64: {gate64}")
    _require(max(shares) < 1.0, f"bf16 trajectory gate at L = 16: {shares}")
    for k in ("trajectory:sites", "trajectory_bwd:sites", "trajectory_bwd_reduce"):
        _require(launches_train[k] > 0, f"{k} not launched by fused phi4 training")
    _require(gate64_launches > 0 and bf16_launches > 0,
             f"the trajectory gates launched {gate64_launches}, {bf16_launches} times")

    # (e) the bf16 site trajectory against its plain bf16 version (13a's bars)
    t_phase = time.perf_counter()
    inp16, x16, v16, _, _ = inputs["phi4_L16"]
    out["bf16_trajectory_vs_plain_L16"] = _bf16_traj_compare(
        fd, dataclasses.replace(inp16, cd=torch.bfloat16), inp16, x16, v16,
        "trajectory bf16 on sites L16")
    print(f"# sites: bf16 trajectory kernel vs plain L=16 ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(out["bf16_trajectory_vs_plain_L16"]), flush=True)

    # (f) each new row's launch alone at its shape, its plain version, bound,
    # reckoned L2 bytes, ptxas
    t_phase = time.perf_counter()
    times = {}
    for name, n in cases:
        inp, x, v, dX, dV = inputs[name]
        D, H, H2, T = inp.dims
        blk = inp.block().numel()
        ops = _ops_of(inp)
        dl1 = torch.ones((1, n), device=dev)
        r = {"ms": _traj_launch_ms(fd, _cuda, inp, x, v, 20 if D <= 1024 else 5),
             "plain_ms": _cuda_time(lambda: fd.trajectory_plain(inp, x, v, False), 2),
             "bound": traj_bound(D, H, H2, T, n, False, blk, ops),
             "l2_bytes": wide_l2_bytes(D, H, H2, T, n, "trajectory")}
        if name == "phi4_L16":
            ib = dataclasses.replace(inp, cd=torch.bfloat16)
            w1, b1 = traj_work(D, H, H2, T, n, False, blk, ops)
            r["bf16"] = {"ms": _traj_launch_ms(fd, _cuda, ib, x, v, 20),
                         "plain_ms": _cuda_time(lambda: fd.trajectory_plain(ib, x, v, False), 2),
                         "bound": _bf16_bounds(w1, n * T * 4 * _stq_products(D, H, H2),
                                               b1 - 2 * 2 * _stq_weights(D, H, H2))}
        n_grads = sum(w.numel() for w in [*inp.xnet_w, *inp.vnet_w]) + D
        r["bwd"] = {"ms": _bwd_launch_ms(fd, _cuda, inp, x, v, dX, dV, dl1, 3),
                    "plain_ms": _cuda_time(
                        lambda: fd.trajectory_vjp_plain(inp, x, v, dX, dV, dl1, False), 1),
                    "bound": traj_bwd_bound(D, H, H2, T, n, False, blk, n_grads, ops),
                    "l2_bytes": wide_l2_bytes(D, H, H2, T, n, "trajectory_bwd")}
        times[name] = r
    ptxas = _cuda.build_info.get("ptxas", "")
    ptx = {k: _ptxas_of(ptxas, entry) for k, entry in (
        ("trajectory", "16site_traj_kernel"), ("trajectory_bwd", "20site_traj_bwd_kernel"),
        ("trajectory_bwd_reduce", "18site_reduce_kernel"),
        ("trajectory_bwd_reduce_sum", "22site_reduce_sum_kernel"))}
    out["kernel_times"] = {"times": times, "ptxas": ptx}
    print(f"# sites: kernel times ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(out["kernel_times"]), flush=True)

    src = "l2hmc_tpu_torch/csrc/"
    rows = []
    launch_of = {"phi4_L16": {k: launches_train[k] for k in ("trajectory:sites",
                                                              "trajectory_bwd:sites")},
                 "phi4_L32": short["L32"]["launches"], "icg": short["icg"]["launches"],
                 "phi4_L64": {"trajectory:sites": gate64_launches
                              + short["L64"]["launches"]["trajectory:sites"],
                              "trajectory_bwd:sites":
                              short["L64"]["launches"]["trajectory_bwd:sites"]}}
    labels = {"phi4_L16": "f", "phi4_L32": "g", "icg": "h", "phi4_L64": "i"}
    for name, n in cases:
        inp = inputs[name][0]
        D, H, H2, T = inp.dims
        r = times[name]
        spec = "gauss" if name == "icg" else "phi4"
        shape = (f"{name} D={D} H={H} T={T}, {n} chains, one direction, the launch alone; "
                 f"site-parallel (4 chains a block of 256 threads)")
        traj_launches = launch_of[name]["trajectory:sites"]
        err = traj[name]
        rows.append({"name": f"trajectory[{spec}]", "route": "cuda", "source": src + "trajectory.cu",
                     "replaces": "l2hmc_tpu/ops/fused_dynamics.py:645", "launches": traj_launches,
                     "max_abs_err": max(max(err[w]["max_abs_err_x_v"], err[w]["max_abs_err_logdet"])
                                        for w in ("forward", "backward")),
                     "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                     "bound_by": r["bound"][1], "library_ms": None, "row": "1" + labels[name],
                     "shape": shape + f", {r['l2_bytes']:.4g} L2 weight bytes reckoned"})
        if "bwd" in r:
            b = r["bwd"]
            bl = launch_of[name]["trajectory_bwd:sites"]
            rows.append({"name": f"trajectory_bwd[{spec}]", "route": "cuda",
                         "source": src + "trajectory_bwd.cu",
                         "replaces": "l2hmc_tpu/ops/fused_dynamics.py:801", "launches": bl,
                         "max_abs_err": max(bwd[name][w]["max_abs_err"]
                                            for w in ("forward", "backward")),
                         "ms": b["ms"], "plain_ms": b["plain_ms"], "bound_ms": b["bound"][0],
                         "bound_by": b["bound"][1], "library_ms": None, "row": "2" + labels[name],
                         "shape": (shape + f"; scratch {bwd[name]['scratch_bytes']:.4g} bytes; "
                                   f"{b['l2_bytes']:.4g} L2 bytes reckoned (weights, factors and "
                                   "compact rows)")})
        if "bf16" in r:
            bb = r["bf16"]
            rows.append({"name": "trajectory[phi4]_bf16", "route": "cuda",
                         "source": src + "trajectory_bf16.cu",
                         "replaces": "l2hmc_tpu/ops/fused_dynamics.py:645",
                         "launches": bf16_launches,
                         "max_abs_err": max(c["max_abs_err"] for c in
                                            out["bf16_trajectory_vs_plain_L16"].values()),
                         "ms": bb["ms"], "plain_ms": bb["plain_ms"], "bound_ms": bb["bound"][0],
                         "bound_by": bb["bound"][1], "library_ms": None, "row": "1f-bf16",
                         "shape": (shape + f"; plain_ms the plain bf16 version; float32 row in "
                                   f"the same run: {r['ms']:.4f} ms; all operations on the f32 "
                                   f"pipe: {bb['bound'][2]:.4g} ms")})
    red = out["reduce_vs_plain"]
    rows.append({"name": "trajectory_bwd_reduce[sites]", "route": "cuda",
                 "source": src + "trajectory_bwd.cu",
                 "replaces": "l2hmc_tpu/ops/fused_dynamics.py:867",
                 "launches": launches_train["trajectory_bwd_reduce"],
                 "max_abs_err": red["max_abs_err"], "ms": red["ms"], "plain_ms": red["plain_ms"],
                 "bound_ms": red["bound"][0], "bound_by": red["bound"][1], "library_ms": None,
                 "row": "2r",
                 "shape": (f"the site VJP's twelve weight products over the factors of a phi4_L16 "
                           f"launch (1024 chains): K = {red['K']} rows a net in "
                           f"{red['splits']} fixed splits, {red['factor_bytes']:.4g} bytes of "
                           f"factors (seeded normals), float32 on the CUDA cores")})
    report["wide_traj"] = out
    report["wide_traj_wall_s"] = time.perf_counter() - t_all
    print(f"# sites phase: {report['wide_traj_wall_s']:.1f} s", flush=True)
    return rows


# -- 15. the rough well, the mixtures and the funnel on sites ---------------------------

# Kernels 1-3 past 64 wide on the specs whose sites need a per-chain prelude
# (the funnel, the mixtures) or only themselves (the rough well), on the
# site-parallel configuration (csrc/l2hmc_sites.cuh), at the path's five
# configurations, ``suite.WIDE_CASES`` at their chain counts: (a) rows 1 and
# 2 against their plain versions, both directions, each launch twice bit
# for bit (X, V and the log-det at TRAJ_TOL, the log-det's bar raised to
# WIDE_LD_REL of its largest magnitude as in 14a; the VJP per leaf at
# BWD_TOL with the chains near a ReLU kink set aside, below); (b) row 3
# against its plain version on the same Philox bits, 20 traced MH steps, at
# most PHI4_FLIPS of the decisions flipped and 1e-2 on the other chains,
# twice bit for bit; (c) fused against plain training from one state, the
# fused step's loss at each of the plain run's WIDE_SPEC_SAME_STEPS states
# on the same draws at phase 5b's bar (the ring without the recipe's anneal,
# which the fused path does not take).
WIDE_SPEC_CASES = ("rough_well_h100", "ring_h100", "rough_well_D100", "funnel_D100",
                   "mixture_D80")
# The VJP's ReLU rule at these widths: a chain's 4 T net applications take
# thousands of gate decisions (8000 at hidden 100, T = 10), and at 2048
# chains ~15% of the chains pass within 1e-5 of a kink somewhere and a few
# within the rounding by which two sums in another order differ, where the
# kernel and its plain version gate differently and the chain's cotangents
# differ by whole terms (at most one such chain, 14b's rule, held at the
# lattice and icg but not here). So the chains whose plain trajectory comes
# within WIDE_RELU_MARGIN of a kink are set aside beforehand, whatever the
# kernel gives them (at most a quarter of the chains): every chain whose dx
# or dv differs by more than BWD_TOL must be among them, and on the others
# every leaf holds BWD_TOL.
WIDE_RELU_MARGIN = 1e-5
WIDE_SPEC_SAME_STEPS = 20
# (d) the path, launch counts set to 0 before it and read after: the suite's
# ring and rough well at hidden 100 through ``run_target`` cut as phase 10c
# (SUITE_CUT: 100 training steps, one training seed, a 500-step eval, the
# HMC grid through the chain kernel): its fused cross-check "ran" and its
# ESS within ESS_GAP of the plain eval's; then ``train`` with
# fused_train=True on each configuration, WIDE_SPEC_TRAIN_STEPS steps at its
# case's chains and widths (the rough well at D = 100 in the suite's hard
# mode; the funnel and the mixture at D = 100 and 80; the ring and the rough
# well at hidden 100, the ring without its anneal, which the suite rows
# train plain), and where no suite row ran the chain kernel's cross-check
# (D = 80-100), its traced eval of the trained sampler against a plain eval
# (``sample_chain``) from the same start, WIDE_SPEC_EVAL_STEPS steps each on
# its own stream: ESS within ESS_GAP. The configurations' recipes: (target,
# ScgConfig fields).
WIDE_SPEC_ROWS = ("ring", "rough_well")
WIDE_SPEC_TRAIN_STEPS = 100
WIDE_SPEC_EVAL_STEPS = 1000
WIDE_SPEC_TRAIN = {
    "rough_well_h100": (lambda t: t.RoughWell(dim=10, eps=0.1),
                        dict(hidden=100, T=5, eps=0.05, n_chains=2048)),
    "ring_h100": (lambda t: t.gen_ring(r=2.0, var=0.1, nb_mixtures=4),
                  dict(hidden=100, T=10, eps=0.2, n_chains=2048)),
    "rough_well_D100": (lambda t: t.RoughWell(dim=100, eps=0.1),
                        dict(hidden=20, T=5, eps=0.05, n_chains=2048)),
    "funnel_D100": (lambda t: t.GaussianFunnel(dim=100),
                    dict(hidden=20, T=10, eps=0.1, n_chains=512, grad_clip=5.0,
                         accept_penalty=20.0)),
    "mixture_D80": (None, dict(hidden=20, T=10, eps=0.05, n_chains=512)),
}
# (e) the bf16 site trajectory on the rough well at D = 100 against its
# plain bf16 version (13a's bars); (f) rows 1j-3j (the rough well at
# D = 100), 1k-3k (the ring at hidden 100) and 1l-3l (the funnel at D = 100)
# at their cases' shapes, beside their plain versions and bounds.
WIDE_SPEC_ROWS_OF = {"rough_well_D100": ("j", "rough_well"), "ring_h100": ("k", "gmm"),
                     "funnel_D100": ("l", "funnel")}


def _site_vjp_compare(fd, inp, x, v, dX, dV, dld, reverse):
    """Kernel against plain VJP on sites with WIDE_RELU_MARGIN's set-aside;
    returns the summary, with the differing chains and their margins."""
    import torch
    from l2hmc_tpu_torch.train.optim import tree_leaves

    def both(keep=None):
        args = (dX, dV, dld) if keep is None else (dX * keep, dV * keep, dld * keep)
        return (tree_leaves(fd.trajectory_vjp(inp, x, v, *args, reverse)),
                tree_leaves(fd.trajectory_vjp_plain(inp, x, v, *args, reverse)))

    got, ref = both()
    n = x.shape[1]
    differ = torch.zeros(n, dtype=torch.bool, device=x.device)
    for a, b in zip(got[-2:], ref[-2:]):
        differ |= (a - b).abs().amax(dim=0) > BWD_TOL * b.abs().max()
    margin = fd.relu_margins(inp, x, v, reverse)
    aside = margin < WIDE_RELU_MARGIN
    idx = differ.nonzero().flatten().tolist()
    out = {"differing_chains": idx[:20], "their_margins": margin[differ].tolist()[:20],
           "set_aside": int(aside.sum())}
    _require(not bool((differ & ~aside).any()) and out["set_aside"] <= n // 4,
             f"VJP on sites: chains differ away from a ReLU kink: {out}")
    got, ref = both((~aside).float()[None, :])
    abs_err = [float((a - b).abs().max()) for a, b in zip(got, ref)]
    scale = [float(b.abs().max()) for b in ref]
    out["max_abs_err"] = max(abs_err)
    out["max_rel_err"] = max(e / s if s > 0 else (0.0 if e == 0 else float("inf"))
                             for e, s in zip(abs_err, scale))
    return out


def wide_spec_phases(dev, report):
    """Phase 15: kernels 1-3 on sites on the rough well, the mixtures and the
    funnel against their plain versions, fused against plain training, the
    path (the suite's rows at hidden 100 and fused training with the chain
    kernel's eval on each configuration), the bf16 site trajectory, and
    rows 1j-3l; returns those rows of the ``kernels`` line."""
    import numpy as np
    import torch

    from l2hmc_tpu_torch import targets
    from l2hmc_tpu_torch.apps import suite
    from l2hmc_tpu_torch.ops import _cuda
    from l2hmc_tpu_torch.ops import fused_dynamics as fd
    from l2hmc_tpu_torch.train import (
        ScgConfig, build_dynamics, evaluate_ess, sample_chain, train,
    )
    from l2hmc_tpu_torch.train.optim import tree_leaves

    t_all = time.perf_counter()
    out = {}

    def target_of(name):
        make = WIDE_SPEC_TRAIN[name][0]
        return suite.two_component_mixture(80) if make is None else make(targets)

    # (a), (b) the three kernels against their plain versions
    t_phase = time.perf_counter()
    traj, bwd, chain_cmp, inputs = {}, {}, {}, {}
    for name in WIDE_SPEC_CASES:
        n = suite.WIDE_CASES[name].n_chains
        inp, x = suite.parity_inputs(name, n, dev, seed=20)
        x = x.contiguous()
        D, H, H2, T = inp.dims
        g = _gen(61)
        v, dX, dV = (torch.randn(x.shape, generator=g).to(dev) for _ in range(3))
        dld = torch.randn((1, n), generator=g).to(dev)
        inputs[name] = (inp, x, v, dX, dV)
        kind, nc = inp.energy_args
        geom = {k: fd.trajectory_site_tile(k, D, H, H2, kind, nc)
                for k in ("trajectory", "trajectory_bwd")}
        _require(fd.trajectory_on_sites(inp) and fd.chain_on_sites(inp)
                 and all(geom[k] == fd.trajectory_site_geometry(k, D, H, H2, n, kind, nc)[:3]
                         for k in ("trajectory", "trajectory_bwd")),
                 f"{name}: site geometry {geom}")
        case = {"dim": D, "hidden": H, "T": T, "n_chains": n,
                "chains_threads_smem_bytes_a_block": geom,
                "chain": _site_plan_check(fd, inp, n, f"chain on sites {name}"),
                "prelude_floats_a_chain": fd.site_prelude_floats(kind, nc, D)}
        bcase = {"scratch_bytes": 4 * fd.bwd_scratch_floats(inp, n)}
        for reverse in (False, True):
            way = "backward" if reverse else "forward"
            got = fd.trajectory(inp, x, v, reverse)
            again = fd.trajectory(inp, x, v, reverse)
            ref = fd.trajectory_plain(inp, x, v, reverse)
            ld_bar = max(TRAJ_TOL, WIDE_LD_REL * float(ref[2].abs().max()))
            c = {"max_abs_err_x_v": max(float((a - b).abs().max())
                                        for a, b in zip(got[:2], ref[:2])),
                 "max_abs_err_logdet": float((got[2] - ref[2]).abs().max()),
                 "logdet_bar": ld_bar,
                 "repeats_bit_for_bit": all(bool(torch.equal(a, b)) for a, b in zip(got, again))}
            case[way] = c
            _require(all(bool(torch.isfinite(a).all()) for a in got), f"trajectory {name} {way}")
            _require(c["repeats_bit_for_bit"], f"trajectory {name} {way}: two launches differ")
            _require(c["max_abs_err_x_v"] <= TRAJ_TOL and c["max_abs_err_logdet"] <= ld_bar,
                     f"trajectory on sites {name} {way}: {c}")
            b = _site_vjp_compare(fd, inp, x, v, dX, dV, dld, reverse)
            a1 = tree_leaves(list(fd.trajectory_vjp(inp, x, v, dX, dV, dld, reverse)))
            a2 = tree_leaves(list(fd.trajectory_vjp(inp, x, v, dX, dV, dld, reverse)))
            b["repeats_bit_for_bit"] = all(bool(torch.equal(p, q)) for p, q in zip(a1, a2))
            bcase[way] = b
            _require(b["repeats_bit_for_bit"], f"trajectory_bwd {name} {way}: two launches differ")
            _require(b["max_rel_err"] <= BWD_TOL, f"trajectory_bwd on sites {name} {way}: {b}")
        traj[name], bwd[name] = case, bcase
        chain_cmp[name] = _chain_vs_plain(fd, inp, x, f"chain on sites {name}",
                                          PHI4_FLIPS * 20 * n)
    out["trajectory_vs_plain"], out["trajectory_bwd_vs_plain"] = traj, bwd
    out["chain_vs_plain"] = chain_cmp
    print(f"# spec sites: kernels vs plain ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(out), flush=True)

    # (c) fused against plain training at the plain run's states
    t_phase = time.perf_counter()
    same_gap = {}
    for name in WIDE_SPEC_CASES:
        tgt = target_of(name)
        kw = WIDE_SPEC_TRAIN[name][1]
        cfg = ScgConfig(dim=tgt.dim, n_steps=WIDE_SPEC_SAME_STEPS, seed=0, **kw)
        dyn, _ = build_dynamics(cfg, tgt)
        same = _same_state_losses(cfg, dyn, tgt, dev)
        same_gap[name] = {"max_gap_over_tolerance": float(_over_tolerance(*zip(*same)).max()),
                          "loss_first_last": [same[0][1], same[-1][1]]}
        _require(np.isfinite(same).all() and same_gap[name]["max_gap_over_tolerance"] <= 1.0,
                 f"fused vs plain training {name} at the same states: {same_gap[name]}")
    out["fused_vs_plain_training"] = same_gap
    print(f"# spec sites: fused vs plain training ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(same_gap), flush=True)

    # (d) the path; launch counts set to 0 just before it and read just after
    t_phase = time.perf_counter()
    fd.reset_launch_counts()
    rows, runs, launch_of, row_chain = {}, {}, {}, {}
    for name in WIDE_SPEC_ROWS:
        t = time.perf_counter()
        before = fd.LAUNCHES["chain:sites"]
        row = suite.run_target(name, device=dev, verbose=False, hidden=100, **SUITE_CUT)
        row_chain[f"{name}_h100"] = fd.LAUNCHES["chain:sites"] - before
        rows[name] = {k: row[k] for k in ("ess_ratio", "ess_l2hmc", "ess_hmc",
                                          "ess_l2hmc_fused_trace", "fused_ess_rel_gap",
                                          "final_accept", "fused_cross_check", "hmc_grid_fused")
                      if k in row}
        rows[name]["wall_s"] = time.perf_counter() - t
        _require(row["fused_cross_check"] == "ran" and row["fused_ess_rel_gap"] < ESS_GAP,
                 f"suite {name} at hidden 100: {rows[name]}")
        _require(0.0 < row["final_accept"] < 1.0 and np.isfinite(row["ess_l2hmc"]),
                 f"suite {name} at hidden 100: {rows[name]}")
    launches_rows = dict(fd.LAUNCHES)
    for name in WIDE_SPEC_CASES:
        tgt = target_of(name)
        cfg = ScgConfig(dim=tgt.dim, n_steps=WIDE_SPEC_TRAIN_STEPS, seed=0, fused_train=True,
                        **WIDE_SPEC_TRAIN[name][1])
        before = dict(fd.LAUNCHES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        st, hist = train(cfg, tgt, device=dev)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        runs[name] = {"config": {"dim": tgt.dim, **WIDE_SPEC_TRAIN[name][1]},
                      "steps": WIDE_SPEC_TRAIN_STEPS, "train_s": train_s,
                      "ms_per_step_incl_capture": 1e3 * train_s / WIDE_SPEC_TRAIN_STEPS,
                      "final_loss": float(hist["loss"][-1]),
                      "final_accept": float(np.mean(hist["p_accept"][-20:]))}
        _require(bool(np.isfinite(hist["loss"]).all()), f"fused training on sites {name}")
        if name in ("rough_well_D100", "funnel_D100", "mixture_D80"):
            dyn, _ = build_dynamics(cfg, tgt)
            x0 = tgt.sample(_gen(1), cfg.n_chains, device=dev)
            t = time.perf_counter()
            _, acc, trace = fd.fused_chain_sampler(dyn, tgt).run(
                st.params, x0, seed=2, n_mh_steps=WIDE_SPEC_EVAL_STEPS, collect_trace=True)
            torch.cuda.synchronize()
            eval_kernel_s = time.perf_counter() - t
            cov = np.cov(tgt.sample(_gen(7), 20000, device="cpu").numpy().T)
            ess_k = evaluate_ess(trace, cov)
            finite = bool(torch.isfinite(trace).all())
            del trace
            t = time.perf_counter()
            _, ptrace = sample_chain(dyn, st.params, x0, WIDE_SPEC_EVAL_STEPS, _gen(3))
            torch.cuda.synchronize()
            eval_plain_s = time.perf_counter() - t
            ess_p = evaluate_ess(ptrace, cov)
            del ptrace
            gap = abs(ess_k - ess_p) / max(ess_p, 1e-12)
            runs[name].update({"eval_steps": WIDE_SPEC_EVAL_STEPS, "eval_kernel_s": eval_kernel_s,
                               "eval_plain_s": eval_plain_s, "eval_accept": float(acc.mean()),
                               "ess_kernel_trace": ess_k, "ess_plain": ess_p,
                               "ess_rel_gap": gap})
            _require(finite and gap < ESS_GAP, f"eval on sites {name}: {runs[name]}")
        launch_of[name] = {k: fd.LAUNCHES[k] - before[k]
                           for k in ("trajectory:sites", "trajectory_bwd:sites",
                                     "trajectory_bwd_reduce", "chain:sites")}
        runs[name]["launches"] = launch_of[name]
        print(f"# spec sites: path {name}: " + json.dumps(runs[name]), flush=True)
    # the chain kernel's launches on the ring's and the rough well's
    # configurations at hidden 100: their suite rows' cross-checks and grids
    launch_of = {k: dict(v, **{"chain:sites": row_chain.get(k, v["chain:sites"])})
                 for k, v in launch_of.items()}
    for name in WIDE_SPEC_CASES:
        _require(min(launch_of[name].values()) > 0, f"{name}: {launch_of[name]}")
    launches = dict(fd.LAUNCHES)
    out["path"] = {"suite_rows_hidden100": rows, "fused_training_runs": runs,
                   "launches_suite_rows": launches_rows, "launches": launches,
                   "wall_s": time.perf_counter() - t_phase}
    print(f"# spec sites: path ({out['path']['wall_s']:.1f} s): "
          + json.dumps({"suite_rows_hidden100": rows, "launches": launches}), flush=True)
    for k in ("trajectory", "trajectory_bwd", "chain"):
        for spec in ("rough_well", "gmm", "funnel"):
            _require(launches[f"{k}:{spec}"] > 0, f"{k}:{spec} not launched on the path")
    _require(launches_rows["chain:sites"] > 0, "the suite rows' cross-checks launched no "
                                               "chain kernel on sites")

    # (e) the bf16 site trajectory against its plain bf16 version (13a's bars)
    t_phase = time.perf_counter()
    inp, x, v, _, _ = inputs["rough_well_D100"]
    out["bf16_trajectory_vs_plain_rough_well_D100"] = _bf16_traj_compare(
        fd, dataclasses.replace(inp, cd=torch.bfloat16), inp, x, v,
        "trajectory bf16 on sites rough_well_D100")
    print(f"# spec sites: bf16 trajectory kernel vs plain ({time.perf_counter() - t_phase:.1f}"
          " s): " + json.dumps(out["bf16_trajectory_vs_plain_rough_well_D100"]), flush=True)

    # (f) rows 1j-3l: each launch alone at its case's shape, its plain
    # version, the bounds
    t_phase = time.perf_counter()
    times, rows_out = {}, []
    src = "l2hmc_tpu_torch/csrc/"
    steps, plain_steps = 2000, 20
    for name, (label, spec) in WIDE_SPEC_ROWS_OF.items():
        inp, x, v, dX, dV = inputs[name]
        D, H, H2, T = inp.dims
        n = x.shape[1]
        blk = inp.block().numel()
        ops = _ops_of(inp)
        dl1 = torch.ones((1, n), device=dev)
        n_grads = sum(w.numel() for w in [*inp.xnet_w, *inp.vnet_w]) + D
        t = {"trajectory": _traj_launch_ms(fd, _cuda, inp, x, v, 20),
             "trajectory_plain": _cuda_time(lambda: fd.trajectory_plain(inp, x, v, False), 3),
             "trajectory_bwd": _bwd_launch_ms(fd, _cuda, inp, x, v, dX, dV, dl1, 5),
             "trajectory_bwd_plain": _cuda_time(
                 lambda: fd.trajectory_vjp_plain(inp, x, v, dX, dV, dl1, False), 1),
             # its instantiation warmed up by (b) and (d)
             "chain": _cuda_time(lambda: fd.chain(inp, x, 2, steps, True), 1, warmup=False),
             f"chain_{plain_steps}": _cuda_time(lambda: fd.chain(inp, x, 2, plain_steps, True), 3),
             f"chain_plain_{plain_steps}": _cuda_time(  # run at this shape in (b)
                 lambda: fd.chain_plain(inp, x, 2, plain_steps, collect_trace=True), 1,
                 warmup=False)}
        bounds = {"trajectory": traj_bound(D, H, H2, T, n, False, blk, ops),
                  "trajectory_bwd": traj_bwd_bound(D, H, H2, T, n, False, blk, n_grads, ops),
                  "chain": chain_bound(D, H, H2, T, n, steps, False, blk, True, ops)}
        times[name] = {"ms": t, "bound_ms": bounds}
        shape = (f"{name} D={D} H={H} T={T}, {n} chains, site-parallel (4 chains a block of "
                 f"256 threads, {traj[name]['prelude_floats_a_chain']} prelude floats a chain)")
        plan = fd.site_tile(D, H, H2, n, *inp.energy_args)
        l2 = phi4_l2_weight_bytes(D, H, H2, T, n, steps, plan)
        times[name]["chain_plan"] = plan._asdict()
        times[name]["chain_l2_weight_bytes"] = l2
        chain_shape = (f"{name} D={D} H={H} T={T}, {n} chains, site-parallel, "
                       f"{site_plan_text(plan, n)}, {l2:.4g} L2 weight bytes reckoned")
        errs = {"trajectory": max(max(traj[name][w]["max_abs_err_x_v"],
                                      traj[name][w]["max_abs_err_logdet"])
                                  for w in ("forward", "backward")),
                "trajectory_bwd": max(bwd[name][w]["max_abs_err"]
                                      for w in ("forward", "backward")),
                "chain": chain_cmp[name]["max_abs_dx_unflipped"]}
        for num, kernel, line, what in (
                (1, "trajectory", 645, "one direction, the launch alone"),
                (2, "trajectory_bwd", 801, "one direction, the launch alone"),
                (3, "chain", 1103, f"{steps} MH steps, traced; plain_ms over {plain_steps} MH "
                                   f"steps (the kernel over {plain_steps}: "
                                   f"{t[f'chain_{plain_steps}']:.4f} ms)")):
            plain = t[f"chain_plain_{plain_steps}"] if kernel == "chain" else t[f"{kernel}_plain"]
            rows_out.append({
                "name": f"{kernel}[{spec}]", "route": "cuda",
                "source": src + f"{fd._lib_name(kernel, inp)}.cu",
                "replaces": f"l2hmc_tpu/ops/fused_dynamics.py:{line}",
                "launches": launch_of[name][f"{kernel}:sites"], "max_abs_err": errs[kernel],
                "ms": t[kernel], "plain_ms": plain, "bound_ms": bounds[kernel][0],
                "bound_by": bounds[kernel][1], "library_ms": None, "row": f"{num}{label}",
                "shape": f"{chain_shape if kernel == 'chain' else shape}, {what}"})
    ptxas = _cuda.build_info.get("ptxas", "")
    ptx = {k: _ptxas_of(ptxas, entry) for k, entry in (
        ("trajectory", "16site_traj_kernel"), ("trajectory_bwd", "20site_traj_bwd_kernel"),
        ("chain", SITE_CHAIN_ENTRY))}
    out["kernel_times"] = {"times": times, "ptxas": ptx}
    print(f"# spec sites: kernel times ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(out["kernel_times"]), flush=True)
    report["wide_specs"] = out
    report["wide_specs_wall_s"] = time.perf_counter() - t_all
    print(f"# spec sites phase: {report['wide_specs_wall_s']:.1f} s", flush=True)
    return rows_out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from l2hmc_tpu_torch import bench, targets
        from l2hmc_tpu_torch.ops import _cuda
        from l2hmc_tpu_torch.ops import fused_dynamics as fd
        from l2hmc_tpu_torch.train import (
            ScgConfig, build_dynamics, evaluate_ess, sample_chain, train,
        )
        from l2hmc_tpu_torch.train.optim import tree_leaves
        from l2hmc_tpu_torch.utils import Throughput, steady_ms
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

    # -- setup: the build, in the background ------------------------------------
    # One nvcc process a source. The conv-net phases (13d, 11d) need none,
    # and the VAE application's four sources end first, so phases 6, 7 and
    # 12 run while the L2HMC kernels' sources (the backward kernel's the
    # longest) still compile, each phase's first launch waiting for its own
    # library only.
    t0 = time.perf_counter()
    _cuda.start_build()

    # -- 13d and 11d's conv nets, which run no kernel of the port ------------------
    _clock("phases 13d, 11d")
    bf16_conv_phase(dev, report)
    phi4_conv_phase(dev, report)

    _clock("phase 6")
    # -- 6. the VAE application ------------------------------------------------------
    with tempfile.TemporaryDirectory() as logdir:
        vae_rows = vae_phases(dev, report, logdir)

    _clock("phase 7")
    # -- 7. VAE training -------------------------------------------------------------
    with tempfile.TemporaryDirectory() as logdir:
        vae_rows += vae_train_phases(dev, report, logdir)

    _clock("phase 12")
    # -- 12. bfloat16 operands in the VAE kernels -------------------------------------
    with tempfile.TemporaryDirectory() as logdir:
        vae_rows += bf16_vae_phases(dev, report, logdir)

    _cuda.wait_build()
    report["build_s"] = _cuda.build_info.get("seconds", 0.0)
    report["build_s_by_source"] = _cuda.build_info.get("seconds_by_source", {})
    report["build_and_vae_phases_s"] = time.perf_counter() - t0
    print(f"# kernels built in {report['build_s']:.1f} s beside the VAE phases "
          f"({report['build_and_vae_phases_s']:.1f} s with them); each source ending at "
          + json.dumps({k: round(v, 1) for k, v in report["build_s_by_source"].items()}),
          flush=True)
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

    _clock("phase 1")
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

    _clock("phase 2")
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
    # the trajectory kernel's own time (its launch through the C entry point
    # on buffers made once) at the training batch, the row's 2048 chains and
    # 8192, and the wrapper's, whose host work it waits for at this size
    traj_launch_ms = {}
    for n in (1024, 2048, 8192):
        xn = target.sample(_gen(33), n, device=dev).T.contiguous()
        vn = torch.randn(xn.shape, generator=_gen(34)).to(dev)
        traj_launch_ms[n] = _traj_launch_ms(fd, _cuda, inp_scg, xn, vn, 200)
    traj_ms = traj_launch_ms[2048]
    traj_wrapper_ms = _cuda_time(lambda: fd.trajectory(inp_scg, xs, vs, False), 50)
    # the wrapper's launch as a captured training step replays it, at the
    # training batch: the host work is gone from the replay
    x1024 = target.sample(_gen(33), 1024, device=dev).T.contiguous()
    v1024 = torch.randn(x1024.shape, generator=_gen(34)).to(dev)
    traj_captured_ms = _captured_ms(lambda: fd.trajectory(inp_scg, x1024, v1024, False), 50, 20)
    traj_plain_ms = _cuda_time(lambda: fd.trajectory_plain(inp_scg, xs, vs, False), 5)
    report["trajectory_times"] = {
        "launch_ms": {str(n): t for n, t in traj_launch_ms.items()},
        "wrapper_ms_2048": traj_wrapper_ms, "plain_ms_2048": traj_plain_ms,
        "captured_wrapper_ms_1024": traj_captured_ms,
    }
    print("# trajectory kernel times: " + json.dumps(report["trajectory_times"]), flush=True)
    D, H, H2, T = inp_scg.dims
    scg_ops = _ops_of(inp_scg)
    traj_bound_ms, traj_bound_by = traj_bound(D, H, H2, T, 2048, False, inp_scg.block().numel(),
                                              scg_ops)

    _clock("phase 3")
    # -- 3. chain kernel vs plain on the same Philox bits ---------------------------
    # Tolerance: the kernel and its plain version draw identical bits, so an
    # accept decision can differ only where px - u is within the few-ulp gap
    # of the two float32 Hamiltonians (~1e-6), expected well under one flip in
    # 20480 decisions: at most 5 flips are allowed. On chains with no flip the
    # states may differ by the per-trajectory tolerance compounded over 20
    # trajectories: 20 x 5e-4 = 1e-2. Cases: SCG learned and HMC at 1024
    # chains, the 50-d Gaussian of phase 2 (the wide instantiation) and a
    # ragged 203 chains; each launch twice, bit for bit.
    t_phase = time.perf_counter()
    chain_cmp = {}
    for name, d_, tg, p_, n in (("l2hmc", dyn, target, scg_params, 1024),
                                ("hmc", hmc_dyn, target, hmc_params, 1024),
                                ("icg50", icg_dyn, icg, icg_params, 1024),
                                ("l2hmc_n203", dyn, target, scg_params, 203)):
        inp = fd.prepare(d_, fd.energy_spec_for_target(tg), p_, dev)
        xc = tg.sample(_gen(41), n, device=dev).T.contiguous()
        chain_cmp[name] = _chain_vs_plain(fd, inp, xc, f"chain {name}", 5)
    report["chain_vs_plain"] = chain_cmp
    print(f"# chain kernel vs plain ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(chain_cmp), flush=True)

    # The plain chain is a yardstick of correctness, not of speed, and takes
    # tens of ms per MH step: it is timed over 100 MH steps, not 2000. The
    # kernel: the protocol's launch (1024 chains x 2000 traced steps) in
    # L2HMC and in HMC mode, and the throughput phase's (8192 x 500).
    inp_eval = fd.prepare(dyn, fd.energy_spec_for_target(target), params, dev)
    inp_hmc = fd.prepare(hmc_dyn, fd.energy_spec_for_target(target), hmc_params, dev)
    x0t = x0.T.contiguous()
    x8192 = target.sample(_gen(51), 8192, device=dev).T.contiguous()
    chain_ms = _cuda_time(lambda: fd.chain(inp_eval, x0t, 2, eval_steps, True), 5)
    chain_hmc_ms = _cuda_time(lambda: fd.chain(inp_hmc, x0t, 3, eval_steps, True), 5)
    chain_8192_ms = _cuda_time(lambda: fd.chain(inp_eval, x8192, 2, 500, False), 5)
    plain_steps = 100
    chain_k100_ms = _cuda_time(lambda: fd.chain(inp_eval, x0t, 2, plain_steps, True), 5)
    t = time.perf_counter()
    fd.chain_plain(inp_eval, x0t, 2, plain_steps, collect_trace=True)
    torch.cuda.synchronize()
    chain_plain_ms = 1e3 * (time.perf_counter() - t)
    chain_bound_ms, chain_bound_by = chain_bound(
        D, H, H2, T, cfg.n_chains, eval_steps, False, inp_eval.block().numel(), True, scg_ops)
    report["chain_times"] = {
        "lanes_per_chain": {"scg": _cuda.library("chain").l2hmc_chain_lanes(D, H, H2),
                            "icg50": _cuda.library("chain").l2hmc_chain_lanes(50, 10, 10)},
        "ms_1024x2000_traced": chain_ms, "ms_1024x2000_traced_hmc": chain_hmc_ms,
        "ms_8192x500": chain_8192_ms, "ms_1024x100_traced": chain_k100_ms,
        "plain_ms_1024x100_traced": chain_plain_ms,
        "bound_ms_1024x2000_traced": chain_bound_ms,
        "ptxas": _ptxas_of(_cuda.build_info.get("ptxas", ""), "12chain_kernel"),
    }
    print("# chain kernel times: " + json.dumps(report["chain_times"]), flush=True)

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

    _clock("phase 5")
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
    traj_1024_ms = traj_launch_ms[1024]
    # the backward kernel's own time (its launch and the sum over chains,
    # through the C entry point on buffers made once), and the wrapper's,
    # whose host work (checks, packing the parameter block, allocation) it
    # waits for at this size; at 8192 chains beside the training batch's 1024
    xw = target.sample(_gen(75), 8192, device=dev).T.contiguous()
    vw, dXw, dVw = (torch.randn(xw.shape, generator=_gen(76 + i)).to(dev) for i in range(3))
    dldw = torch.ones((1, 8192), device=dev)
    bwd_ms = _bwd_launch_ms(fd, _cuda, inp_scg, xb, vb, dXb, dVb, dldb, 200)
    bwd_8192_ms = _bwd_launch_ms(fd, _cuda, inp_scg, xw, vw, dXw, dVw, dldw, 50)
    bwd_wrapper_ms = _cuda_time(
        lambda: fd.trajectory_vjp(inp_scg, xb, vb, dXb, dVb, dldb, False), 20)
    bwd_captured_ms = _captured_ms(
        lambda: fd.trajectory_vjp(inp_scg, xb, vb, dXb, dVb, dldb, False), 50, 20)
    bwd_plain_ms = _cuda_time(
        lambda: fd.trajectory_vjp_plain(inp_scg, xb, vb, dXb, dVb, dldb, False), 3)
    n_grads = sum(w.numel() for w in [*inp_scg.xnet_w, *inp_scg.vnet_w]) + D
    bwd_bound_ms, bwd_bound_by = traj_bwd_bound(
        D, H, H2, T, n_tr, False, inp_scg.block().numel(), n_grads, scg_ops)

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

    # (c) the training path: train (captured steps), then evaluate through
    # the chain kernel
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
        "trajectory_bwd_ms_8192_chains": bwd_8192_ms,
        "trajectory_bwd_wrapper_ms": bwd_wrapper_ms,
        "trajectory_captured_ms": traj_captured_ms,
        "trajectory_bwd_captured_ms": bwd_captured_ms,
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

    # (d) captured against eager: the card tests' comparison. 20 steps from
    # one seed each way, bit for bit, for the three step kinds the bench
    # trains (the reference architecture plain and fused, the best recipe)
    # and 50 MH steps of sample_chain; ms per step each way, the captured
    # one at steady state (a 50- less a 10-step run, so the capture cancels;
    # sampling 150 less 25)
    t_phase = time.perf_counter()
    cap = {}
    for name, kw in (("reference_plain", {}), ("reference_fused", dict(fused_train=True)),
                     ("best_recipe", bench.BEST_RECIPE)):
        runs = {}
        for capture in (False, True):
            torch.cuda.synchronize()
            t = time.perf_counter()
            runs[capture] = train(ScgConfig(n_chains=n_tr, n_steps=20, **kw), capture=capture)
            torch.cuda.synchronize()
            if not capture:
                eager_ms = 1e3 * (time.perf_counter() - t) / 20
        (se, he), (sc, hc) = runs[False], runs[True]
        same = all(np.array_equal(he[k], hc[k]) for k in he) and all(
            torch.equal(a, b) for a, b in zip(
                [*tree_leaves(se.params), *se.opt_state, se.x, se.step],
                [*tree_leaves(sc.params), *sc.opt_state, sc.x, sc.step]))
        cap[name] = {"bit_for_bit": same, "ms_per_step_eager": eager_ms,
                     "ms_per_step_captured": steady_ms(
                         lambda n, kw=kw: train(ScgConfig(n_chains=n_tr, n_steps=n, **kw)),
                         10, 50)}
        _require(same, f"captured {name} training differs from eager")
    for name, d_, p_ in (("sample_chain", dyn, params), ("sample_chain_hmc", hmc_dyn, hmc_params)):
        runs = [sample_chain(d_, p_, x0, 50, _gen(cfg.seed + 2), capture=c) for c in (False, True)]
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        torch.cuda.synchronize()
        t = time.perf_counter()
        sample_chain(d_, p_, x0, 50, _gen(cfg.seed + 2), capture=False)
        torch.cuda.synchronize()
        cap[name] = {"bit_for_bit": same,
                     "ms_per_step_eager": 1e3 * (time.perf_counter() - t) / 50,
                     "ms_per_step_captured": steady_ms(
                         lambda n, d_=d_, p_=p_: sample_chain(d_, p_, x0, n, _gen(cfg.seed + 2)),
                         25, 150)}
        _require(same, f"captured {name} differs from eager")
    report["captured_vs_eager"] = cap
    print(f"# captured vs eager ({time.perf_counter() - t_phase:.1f} s): "
          + json.dumps(cap), flush=True)

    _clock("phase 9")
    # -- 9. the bench protocol at a cut depth ---------------------------------------
    # l2hmc_tpu_torch.bench on seed 0 only, BENCH_CUT's training steps and
    # eval, the throughput at 8192 chains: its parity gate and
    # ESS gap held inside it, both arms' ratios above MIN_ESS_RATIO here
    fd.reset_launch_counts()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as profile_dir:
        result = bench.run(bench.Depth(**BENCH_CUT), device=dev, profile_dir=profile_dir)
    bench_launches = dict(fd.LAUNCHES)
    extra = result["extra"]
    report["bench"] = {"result": result, "launches": bench_launches,
                       "wall_s": time.perf_counter() - t_phase}
    print("# bench: " + json.dumps(result), flush=True)
    print(f"# bench phase ({report['bench']['wall_s']:.1f} s), launches: "
          + json.dumps(bench_launches), flush=True)
    _require(extra["fused_vs_plain_max_err"] < TRAJ_TOL, "bench parity gate")
    _require(extra["ess_fused_trace_rel_gap"] < ESS_GAP, "bench ESS gap")
    for arm, ratio in (("reference", extra["reference_arch_ratio_median"]),
                       ("best recipe", result["value"])):
        _require(ratio > MIN_ESS_RATIO, f"bench {arm} ESS ratio {ratio} <= {MIN_ESS_RATIO}")
    for name in ("trajectory", "trajectory_bwd", "chain"):
        _require(bench_launches[name] > 0, f"kernel {name} not launched on the bench path")

    _clock("phase 10")
    # -- 10. the distribution suite ----------------------------------------------
    suite_rows = suite_phases(dev, report)

    _clock("phase 11")
    # -- 11. the phi^4 lattice --------------------------------------------------
    phi4_rows = phi4_phases(dev, report)

    _clock("phase 13")
    # -- 13. bfloat16 operands in kernels 1 and 3 ----------------------------------
    bf16_scg_rows = bf16_scg_phases(dev, report)

    _clock("phase 14")
    # -- 14. kernels 1-2 on sites ----------------------------------------------------
    wide_rows = wide_traj_phases(dev, report)

    _clock("phase 15")
    # -- 15. the rough well, the mixtures and the funnel on sites ---------------------
    spec_site_rows = wide_spec_phases(dev, report)

    _clock("the kernels line")
    # -- 8. the kernels line -------------------------------------------------------
    src = "l2hmc_tpu_torch/csrc/"
    kernels = [
        {"name": "trajectory", "route": "cuda", "source": src + "trajectory.cu",
         "replaces": "l2hmc_tpu/ops/fused_dynamics.py:645",
         "launches": launches["trajectory"],
         "max_abs_err": max(max(c["max_abs_err"].values()) for c in traj.values()),
         "ms": traj_ms, "plain_ms": traj_plain_ms, "bound_ms": traj_bound_ms,
         "bound_by": traj_bound_by, "library_ms": None,
         "shape": (f"SCG D=2 H=10 T=10, 2048 chains, one direction, the launch alone; "
                   f"1024 chains: {traj_launch_ms[1024]:.4f} ms; 8192 chains: "
                   f"{traj_launch_ms[8192]:.4f} ms; through the wrapper: "
                   f"{traj_wrapper_ms:.4f} ms; through the wrapper in a captured graph "
                   f"at 1024 chains: {traj_captured_ms:.4f} ms")},
        {"name": "chain", "route": "cuda", "source": src + "chain.cu",
         "replaces": "l2hmc_tpu/ops/fused_dynamics.py:1103",
         "launches": launches["chain"],
         "max_abs_err": max(c["max_abs_dx_unflipped"] for c in chain_cmp.values()),
         "ms": chain_ms, "plain_ms": chain_plain_ms, "bound_ms": chain_bound_ms,
         "bound_by": chain_bound_by, "library_ms": None,
         "shape": (f"SCG D=2 H=10 T=10, 1024 chains x 2000 MH steps, traced, "
                   f"{report['chain_times']['lanes_per_chain']['scg']} lanes a chain; "
                   f"HMC mode: {chain_hmc_ms:.4f} ms; 8192 chains x 500 steps: "
                   f"{chain_8192_ms:.4f} ms; plain_ms over {plain_steps} MH steps "
                   f"(kernel over {plain_steps}: {chain_k100_ms:.4f} ms)")},
        {"name": "trajectory_bwd", "route": "cuda", "source": src + "trajectory_bwd.cu",
         "replaces": "l2hmc_tpu/ops/fused_dynamics.py:801",
         "launches": train_launches["trajectory_bwd"],
         "max_abs_err": max(d["max_abs_err"] for c in bwd.values() for d in c.values()),
         "ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound_ms,
         "bound_by": bwd_bound_by, "library_ms": None,
         "shape": (f"SCG D=2 H=10 T=10, {n_tr} chains, one direction (the training batch), "
                   f"the launch alone; 8192 chains: {bwd_8192_ms:.4f} ms; through the "
                   f"wrapper: {bwd_wrapper_ms:.4f} ms; through the wrapper in a captured "
                   f"graph: {bwd_captured_ms:.4f} ms")},
        *vae_rows,
        *suite_rows,
        *phi4_rows,
        *bf16_scg_rows,
        *wide_rows,
        *spec_site_rows,
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
