"""phi^4 lattice experiment: train L2HMC to hop between the broken-phase
modes (counterpart of ``l2hmc_tpu/apps/phi4.py``; BASELINE.json configs[4]).

The figure of merit is the tunnelling rate of the global magnetization:
plain HMC at reasonable step sizes stays in one well, the trained sampler
learns large collective moves. Reported: tunnels per step and the ESS of the
magnetization series, L2HMC against HMC, and with ``pt_rungs`` > 1 the same
for parallel-tempered chains of both, with each rung's acceptance and each
adjacent pair's swap rate (``pt_rung_accept_*``, ``pt_swap_rate_*``).

Usage:
    python -m l2hmc_tpu_torch.apps.phi4 --L 16 --n_chains 512 --n_steps 2000
    python -m l2hmc_tpu_torch.apps.phi4 --device cpu --L 4 --n_chains 16 \\
        --n_steps 30 --leapfrogs 3 --hidden 8 --eval_steps 30
    # the JAX package's bf16 conv recipe (phi4_conv64_r5.json, an L = 32 run)
    python -m l2hmc_tpu_torch.apps.phi4 --L 32 --net_type conv --conv_channels 32 \\
        --conv_depth 2 --n_chains 256 --leapfrogs 10 --eps 0.1 --accept_penalty 20 \\
        --grad_clip 1 --learning_rate 1e-4 --init_temperature 4 \\
        --compute_dtype bfloat16 --remat --n_steps 4000 --eval_steps 1000

Everything runs on ``--device`` (default ``cuda``). On the card a dense
net's eval is one traced launch of the chain kernel
(``ops.fused_chain_sampler``; every lattice up to 64 x 64 on its
site-parallel configuration). Whether the kernel serves the run is decided up front by
the pure check ``ops.fused_dynamics.kernel_refusal`` (a conv net, a state
past 4096 wide, a hidden width past 128); a run it refuses evaluates through
the plain ``sample_chain``, and the result records the reason as
``fused_eval``. There is no fallback after a failure: a kernel launch that
fails raises.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from l2hmc_tpu_torch import targets as targets_lib
from l2hmc_tpu_torch.config import resolve_device
from l2hmc_tpu_torch.dynamics import Dynamics
from l2hmc_tpu_torch.evals import acl_spectrum, ess
from l2hmc_tpu_torch.mcmc.tempering import geometric_temps, pt_hmc_sample_chain, pt_sample_chain
from l2hmc_tpu_torch.ops import fused_dynamics as fd
from l2hmc_tpu_torch.targets.lattice import Phi4Lattice
from l2hmc_tpu_torch.train import ScgConfig, build_dynamics, hmc_sample_chain, sample_chain, train
from l2hmc_tpu_torch.train.optim import tree_leaves, tree_unflatten


class ParityCase(NamedTuple):
    target: Callable
    hidden: int  # S/T/Q nets' hidden width
    T: int
    eps: float
    hmc: bool
    n_chains: int  # the chains the protocol runs at this width


# The cases on which the card tests and chip_smoke.py hold the kernels to
# their plain versions at the lattice's widths: L = 8 (D = 64) on the lane
# groups of kernels 1-2, L = 8, 16, 32 and 64 (D = 64, 256, 1024, 4096) and
# a dense 128-d Gaussian on the chain kernel's site-parallel configuration,
# HMC mode at L = 16. The app's m^2 = -1, lam = 0.5 and hidden 32; eps as the
# app's at L = 16, halved at L = 32 (the stability bound tightens with the
# lattice). L = 64 at the kernel shape of the JAX package's shipped 64 x 64
# recipe (phi4_64_r3.json, L_T24: hidden 64, T = 24, eps 0.03, 256 chains),
# the widest hidden layer and longest trajectory a recorded protocol runs.
PARITY_CASES: dict[str, ParityCase] = {
    "phi4_L8": ParityCase(lambda: Phi4Lattice(L=8, m2=-1.0, lam=0.5), 32, 10, 0.1, False, 512),
    "phi4_L16": ParityCase(lambda: Phi4Lattice(L=16, m2=-1.0, lam=0.5), 32, 10, 0.1, False,
                           512),
    "phi4_L32": ParityCase(lambda: Phi4Lattice(L=32, m2=-1.0, lam=0.5), 32, 10, 0.05, False,
                           256),
    "phi4_L64": ParityCase(lambda: Phi4Lattice(L=64, m2=-1.0, lam=0.5), 64, 24, 0.03, False,
                           256),
    "phi4_L16_hmc": ParityCase(lambda: Phi4Lattice(L=16, m2=-1.0, lam=0.5), 32, 10, 0.1, True,
                               512),
    "gauss_D128": ParityCase(lambda: targets_lib.random_tilted_gaussian(0, 128, -1.0, 1.0), 32,
                             10, 0.05, False, 203),
}
# The nets' initial weights are lifted by this much in the parity cases, so
# that S, T and Q are O(0.4-1) and not ~0 (the heads' 0.001 init factor):
# at these widths the first layer sums 64-1024 sites, and the SCG cases'
# 0.03 drives the trajectories past float32's range.
PARITY_LIFT = 0.003


def parity_inputs(case: str, n: int, device, seed: int = 0):
    """The kernel inputs (``fd.KernelInputs``) and (D, n) start states of a
    parity case, from ``seed``: the nets' initial weights lifted by
    PARITY_LIFT, the states the target's hot start."""
    c = PARITY_CASES[case]
    tgt = c.target()
    dyn, _ = build_dynamics(ScgConfig(dim=tgt.dim, hidden=c.hidden, T=c.T, hmc=c.hmc), tgt)
    params = dyn.init_params(_gen(seed), eps=c.eps, device=device)
    if not c.hmc:
        for net in ("xnet", "vnet"):
            params[net] = tree_unflatten(params[net], [a + PARITY_LIFT
                                                       for a in tree_leaves(params[net])])
    x = tgt.sample(_gen(seed + 1), n, device="cpu")
    inp = fd.prepare(dyn, fd.energy_spec_for_target(tgt), params, device)
    return inp, x.T.contiguous().to(device)


def tunneling_rate(m_trace: np.ndarray) -> float:
    """Mean sign flips of the magnetization per chain per step."""
    signs = np.sign(m_trace)
    flips = (signs[1:] * signs[:-1]) < 0
    return float(flips.mean())


def magnetization_ess(m_trace: np.ndarray) -> float:
    """ESS of the centered magnetization series, (T, N)."""
    centered = m_trace - m_trace.mean()
    spectrum = acl_spectrum(torch.as_tensor(centered[:, :, None]),
                            scale=max(float(centered.std()), 1e-9))
    return float(ess(spectrum))


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _magnetization(trace: torch.Tensor) -> np.ndarray:
    """(T, N, D) trace -> (T, N) magnetization on the host."""
    return torch.mean(trace, dim=2).cpu().numpy()


def run(
    L: int = 16,
    m2: float = -1.0,
    lam: float = 0.5,
    n_chains: int = 512,
    n_steps: int = 2000,
    leapfrogs: int = 10,
    hidden: int = 32,
    eval_steps: int = 1000,
    eps: float = 0.1,
    hmc_eps: float = 0.1,
    init_temperature: float = 1.0,
    pt_rungs: int = 0,
    pt_t_max: float = 16.0,
    seed: int = 0,
    log_every: int = 0,
    net_type: str = "dense",
    conv_channels: int = 32,
    conv_depth: int = 2,
    remat: bool = False,
    compute_dtype: str = "float32",
    accept_penalty: float = 0.0,
    accept_target: float = 0.65,
    grad_clip: float = 0.0,
    z_burn_in_loss: bool = True,
    scale: float = 0.1,
    learning_rate: float = 1e-3,
    *,
    pt_eval_steps: Optional[int] = None,
    device=None,
    return_state: bool = False,
):
    """Train and evaluate on the phi^4 lattice on ``device`` (``cuda``
    unless the caller says otherwise); the JAX runner's arguments, and
    ``pt_eval_steps`` (the parallel-tempered evals' length, ``eval_steps``
    when None). With ``pt_rungs > 1`` the evaluation also runs
    parallel-tempered chains (a geometric ladder to ``pt_t_max``, the chain
    budget shared by the rungs) for the trained sampler, rebuilt with
    ``use_temperature``, and for the HMC baseline. Returns the JAX runner's
    keys with ``fused_eval`` ("ran" or the refusal), and with
    ``return_state`` also the final ``TrainState``. ``compute_dtype``
    "bfloat16" lowers the plain S/T/Q nets' products (training and the plain
    evals); the kernel eval is built with no operand dtype, as the JAX
    runner builds it (``fused_chain_sampler(dynamics, target)``), so it
    runs float32 operands."""
    dev = resolve_device(device)
    target = Phi4Lattice(L=L, m2=m2, lam=lam)
    cfg = ScgConfig(
        dim=target.dim, n_chains=n_chains, T=leapfrogs, hidden=hidden, eps=eps,
        n_steps=n_steps, seed=seed, init_temperature=init_temperature, net_type=net_type,
        conv_channels=conv_channels, conv_depth=conv_depth, remat=remat,
        compute_dtype=compute_dtype, accept_penalty=accept_penalty,
        accept_target=accept_target, grad_clip=grad_clip, z_burn_in_loss=z_burn_in_loss,
        scale=scale, learning_rate=learning_rate,
    )
    dynamics, _ = build_dynamics(cfg, target)
    refusal = fd.kernel_refusal(dynamics, target, hidden, net_type=net_type)
    if refusal is None and dev.type != "cuda":
        refusal = "the fused eval runs on a CUDA device"

    t0 = time.perf_counter()
    state, history = train(cfg, target=target, log_every=log_every, device=dev)
    _sync(dev)
    train_time = time.perf_counter() - t0

    x0 = target.sample(_gen(seed + 1), n_chains, device=dev)
    result_fused = {}
    if refusal is None:
        # the trained sampler's eval in one traced launch, timed after a
        # warm-up launch of the same length
        sampler = fd.fused_chain_sampler(dynamics, target)
        sampler.run(state.params, x0, seed=seed, n_mh_steps=eval_steps, collect_trace=True)
        _sync(dev)
        t1 = time.perf_counter()
        _, _, trace = sampler.run(state.params, x0, seed=seed + 2, n_mh_steps=eval_steps,
                                  collect_trace=True)
        _sync(dev)
        result_fused["eval_time_s_fused"] = time.perf_counter() - t1
    else:
        _, trace = sample_chain(dynamics, state.params, x0, eval_steps, _gen(seed + 2))
    m_l2hmc = _magnetization(trace)
    del trace
    _, hmc_trace = hmc_sample_chain(target, hmc_eps, leapfrogs, x0, eval_steps, _gen(seed + 3))
    m_hmc = _magnetization(hmc_trace)
    del hmc_trace

    result = {
        "L": L,
        "m2": m2,
        "lam": lam,
        "n_chains": n_chains,
        "tunneling_rate_l2hmc": tunneling_rate(m_l2hmc),
        "tunneling_rate_hmc": tunneling_rate(m_hmc),
        "ess_m_l2hmc": magnetization_ess(m_l2hmc),
        "ess_m_hmc": magnetization_ess(m_hmc),
        "susceptibility_l2hmc": float(target.susceptibility(torch.as_tensor(m_l2hmc))),
        "final_accept": float(np.mean(history["p_accept"][-100:])),
        "final_loss": float(history["loss"][-1]),
        "train_time_s": train_time,
        "fused_eval": refusal or "ran",
        **result_fused,
    }

    if pt_rungs > 1:
        steps = eval_steps if pt_eval_steps is None else pt_eval_steps
        temps = geometric_temps(pt_t_max, pt_rungs, device=dev)
        # the rungs share the chain budget, so PT costs the same device work
        n_rep = max(n_chains // pt_rungs, 1)
        x0_pt = x0[None, :n_rep].repeat(pt_rungs, 1, 1)
        if dynamics.use_temperature:
            pt_dyn = dynamics
        else:
            # the trained sampler with the temperature plumbing on
            pt_dyn = Dynamics(dim=dynamics.dim, energy=dynamics.energy,
                              grad_energy=dynamics.grad_energy, T=dynamics.T,
                              xnet=dynamics.xnet, vnet=dynamics.vnet,
                              mask_seed=dynamics.mask_seed, use_temperature=True)
        t2 = time.perf_counter()
        st, st_hmc = {}, {}
        _, pt_trace = pt_sample_chain(pt_dyn, state.params, x0_pt, temps, steps,
                                      _gen(seed + 4), stats=st)
        _, pt_hmc_trace = pt_hmc_sample_chain(target, hmc_eps, leapfrogs, x0_pt, temps, steps,
                                              _gen(seed + 5), stats=st_hmc)
        _sync(dev)
        m_pt, m_pt_hmc = _magnetization(pt_trace), _magnetization(pt_hmc_trace)
        result.update(
            pt_rungs=pt_rungs,
            pt_t_max=pt_t_max,
            tunneling_rate_pt_l2hmc=tunneling_rate(m_pt),
            tunneling_rate_pt_hmc=tunneling_rate(m_pt_hmc),
            ess_m_pt_l2hmc=magnetization_ess(m_pt),
            ess_m_pt_hmc=magnetization_ess(m_pt_hmc),
            pt_eval_steps=steps,
            pt_eval_time_s=time.perf_counter() - t2,
            pt_rung_accept_l2hmc=st["rung_accept"].tolist(),
            pt_rung_accept_hmc=st_hmc["rung_accept"].tolist(),
            pt_swap_rate_l2hmc=st["swap_rate"].tolist(),
            pt_swap_rate_hmc=st_hmc["swap_rate"].tolist(),
        )
    if return_state:
        return result, state
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--L", type=int, default=16)
    p.add_argument("--m2", type=float, default=-1.0)
    p.add_argument("--lam", type=float, default=0.5)
    p.add_argument("--init_temperature", type=float, default=1.0)
    p.add_argument("--n_chains", type=int, default=512)
    p.add_argument("--n_steps", type=int, default=2000)
    p.add_argument("--leapfrogs", type=int, default=10)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--eval_steps", type=int, default=1000)
    p.add_argument("--eps", type=float, default=0.1,
                   help="initial leapfrog step size (shrink for large L: "
                        "the stability bound tightens with lattice size)")
    p.add_argument("--hmc_eps", type=float, default=0.1)
    p.add_argument("--pt_rungs", type=int, default=0,
                   help="parallel-tempering rungs for the eval (0 = off)")
    p.add_argument("--pt_t_max", type=float, default=16.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--net_type", type=str, default="dense", choices=["dense", "conv"],
                   help="S/T/Q architecture: reference dense MLP or the "
                        "lattice-equivariant circular-padded CNN")
    p.add_argument("--conv_channels", type=int, default=32)
    p.add_argument("--conv_depth", type=int, default=2)
    p.add_argument("--remat", action="store_true",
                   help="accepted for the JAX runner's command line; changes no number")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="S/T/Q net operand dtype (config.Precision; the plain nets' "
                        "products, not the kernel eval's, as in the JAX runner)")
    p.add_argument("--accept_penalty", type=float, default=0.0)
    p.add_argument("--grad_clip", type=float, default=0.0)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--scale", type=float, default=0.1)
    p.add_argument("--no_z_burn_in_loss", dest="z_burn_in_loss", action="store_false")
    p.add_argument("--device", type=str, default="cuda")
    args = vars(p.parse_args(argv))
    device = args.pop("device")
    r = run(**args, device=device)
    print(json.dumps(r))
    return r


if __name__ == "__main__":
    main()
