"""The SCG experiment's sampling and evaluation half
(counterpart of ``l2hmc_tpu/train/scg.py``).

A sampler given its parameters runs the notebook's evaluation protocol
(SCGExperiment.ipynb cells 14-21): 2000 MH steps, ESS from the full-lag
autocovariance spectrum, plain HMC at eps 0.15 as the baseline. Training
(``train``, the optimizer) is not ported yet.

Randomness comes from ``torch.Generator``s seeded from ``ScgConfig.seed``.
The generators live on the CPU, so a seed gives the same chains on every
device; the streams differ from the JAX package's threefry streams.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from l2hmc_tpu_torch import mcmc, nets, targets
from l2hmc_tpu_torch.config import resolve_device
from l2hmc_tpu_torch.dynamics import Dynamics
from l2hmc_tpu_torch.evals import acl_spectrum, ess


@dataclasses.dataclass(frozen=True)
class ScgConfig:
    """Hyperparameters of the notebook experiment; the fields and defaults of
    the JAX package's ``ScgConfig`` (see its comments for each knob).

    Sampling reads dim, n_chains, T, eps, hidden, hmc, seed, mask_seed,
    eps_trainable, eps_dim and net_input_whiten. The training knobs are kept
    so configs carry over and are read by no code yet. A knob that changes
    the sampler and is not ported raises when set (``_UNPORTED``).
    """

    dim: int = 2
    n_chains: int = 200
    T: int = 10
    eps: float = 0.1
    hidden: int = 10
    net_type: str = "dense"
    conv_channels: int = 32
    conv_depth: int = 2
    hmc: bool = False
    scale: float = 0.1
    learning_rate: float = 1e-3
    lr_decay_rate: float = 0.96
    lr_decay_steps: int = 1000
    n_steps: int = 5000
    seed: int = 0
    mask_seed: int = 0
    eps_trainable: bool = True
    eps_dim: bool = False
    eps_step: bool = False
    eps_mat: bool = False
    eps_chol_init: float = 0.0
    eps_sigma_init: float = 0.0
    accept_penalty: float = 0.0
    accept_target: float = 0.65
    autocorr_penalty: float = 0.0
    alpha_lr_scale: float = 1.0
    eps_unfreeze_step: int = 0
    alpha_reg: float = 0.0
    per_dim_loss: bool = False
    z_burn_in_loss: bool = True
    whiten_loss: bool = False
    whiten_full: bool = False
    net_input_whiten: bool = False
    net_input_target_fn: bool = False
    remat: bool = False
    grad_clip: float = 0.0
    init_temperature: float = 1.0
    anneal_frac: float = 0.8
    pt_train_rungs: int = 0
    pt_train_tmax: float = 10.0
    pt_swap_every: int = 1
    pt_loss_all_rungs: bool = False
    skip_nonfinite_updates: bool = True
    select_best: bool = False
    fused_train: bool = False
    fused_tile: int = 1024
    compute_dtype: str = "float32"

    def __post_init__(self):
        for name, ok in _UNPORTED.items():
            if not ok(getattr(self, name)):
                raise NotImplementedError(
                    f"ScgConfig.{name}={getattr(self, name)!r} is not ported yet"
                )


# sampler-changing knobs the port cannot honour yet: name -> accepted values
_UNPORTED = {
    "net_type": lambda v: v == "dense",
    "eps_step": lambda v: not v,
    "eps_mat": lambda v: not v,
    "eps_chol_init": lambda v: v == 0.0,
    "net_input_target_fn": lambda v: not v,
    "init_temperature": lambda v: v <= 1.0,
    "pt_train_rungs": lambda v: v <= 1,
    "fused_train": lambda v: not v,
    "compute_dtype": lambda v: v == "float32",
}


def build_dynamics(config: ScgConfig, target=None) -> tuple[Dynamics, Any]:
    """Dynamics + target for the SCG experiment (notebook cells 3, 5)."""
    target = targets.scg_gaussian() if target is None else target
    common = dict(
        dim=config.dim,
        energy=target.energy,
        grad_energy=target.grad_energy,
        T=config.T,
        mask_seed=config.mask_seed,
        eps_trainable=config.eps_trainable,
        eps_dim=config.eps_dim,
    )
    if config.hmc:
        return Dynamics(hmc=True, **common), target
    xnet = nets.scg_net_factory(config.dim, factor=2.0, hidden=config.hidden)
    vnet = nets.scg_net_factory(config.dim, factor=1.0, hidden=config.hidden)
    input_scale = None
    if config.net_input_whiten:
        sig = np.asarray(getattr(target, "sigma", None))
        if sig.ndim != 2:
            raise ValueError("net_input_whiten needs a target with a covariance .sigma")
        input_scale = tuple(np.sqrt(np.diag(sig)).tolist())
    return Dynamics(xnet=xnet, vnet=vnet, input_scale=input_scale, **common), target


def sample_chain(
    dynamics: Dynamics,
    params,
    x0: torch.Tensor,
    n_steps: int,
    generator: Optional[torch.Generator],
    *,
    collect: bool = True,
    draws=None,
):
    """Run the sampler for ``n_steps`` MH steps on x0's device; returns
    (x_final, trace) with trace the (n_steps, N, D) post-MH states (or the
    (n_steps, N) acceptance probabilities when ``collect`` is False).

    ``draws`` optionally gives every random number instead of
    ``generator``: (momenta (K, N, D), direction uniforms (K, N), accept
    uniforms (K, N)); HMC mode reads no direction uniforms."""
    x = x0
    trace = []
    with torch.no_grad():
        for k in range(n_steps):
            kw = {}
            if draws is not None:
                v, u_dir, u_acc = draws
                kw = dict(init_v=v[k], dir_u=u_dir[k], accept_u=u_acc[k])
            out = mcmc.propose(generator, dynamics, params, x, do_mh_step=True, **kw)
            x = out.x_next
            trace.append(x if collect else out.p_accept)
    return x, torch.stack(trace)


def hmc_sample_chain(
    target, eps: float, T: int, x0: torch.Tensor, n_steps: int,
    generator: torch.Generator,
):
    """Plain-HMC baseline chain (reference utils/notebook_utils.py:25-39)."""
    dyn = Dynamics(dim=x0.shape[1], energy=target.energy,
                   grad_energy=target.grad_energy, T=T, hmc=True)
    params = dyn.init_params(generator, eps=eps, device=x0.device)
    return sample_chain(dyn, params, x0, n_steps, generator)


def evaluate_ess(trace: torch.Tensor, cov: np.ndarray, max_lag: int | None = None) -> float:
    """ESS from a (T, N, D) trace with the notebook's normalization
    (scale = sqrt(trace(cov))), over the full n-1 lag spectrum by default."""
    scale = float(np.sqrt(np.trace(cov)))
    spectrum = acl_spectrum(trace, scale=scale, max_lag=max_lag)
    return float(ess(spectrum))


def evaluate_trained(
    config: ScgConfig,
    params,
    *,
    target=None,
    eval_steps: int = 2000,
    hmc_eps: float = 0.15,
    device=None,
) -> dict:
    """Notebook eval protocol (cells 14-21) on given sampler params, on
    ``device`` (``cuda`` unless the caller says otherwise)."""
    dev = resolve_device(device)
    dynamics, target = build_dynamics(config, target)

    def gen(offset):
        return torch.Generator().manual_seed(config.seed + offset)

    x0 = target.sample(gen(1), config.n_chains, device=dev)
    t1 = time.perf_counter()
    _, l2hmc_trace = sample_chain(dynamics, params, x0, eval_steps, gen(2))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    eval_time = time.perf_counter() - t1

    _, hmc_trace = hmc_sample_chain(target, hmc_eps, config.T, x0, eval_steps, gen(3))

    ess_l2hmc = evaluate_ess(l2hmc_trace, target.sigma)
    ess_hmc = evaluate_ess(hmc_trace, target.sigma)
    return {
        "ess_l2hmc": ess_l2hmc,
        "ess_hmc": ess_hmc,
        "ess_ratio": ess_l2hmc / max(ess_hmc, 1e-12),
        "eval_time_s": eval_time,
    }
