"""The SCG experiment: train L2HMC on the strongly-correlated Gaussian, then
evaluate it (counterpart of ``l2hmc_tpu/train/scg.py``).

Training (SCGExperiment.ipynb cells 9-12): the joint loss over the target
chains x and fresh z ~ N(0, I) burn-in chains at scale 0.1, Adam at lr 1e-3
with staircase decay 0.96 per 1000 steps (``train/optim.py``), non-finite
updates skipped. ``fused_train`` runs the trajectories through the fused
CUDA kernels (``ops.differentiable_fused``), else through ``Dynamics`` with
plain autograd. The steps run as a Python loop in chunks of ``log_every``
(or 250) steps; the chain state and the optimizer state stay on the device,
and the metrics come to the host once per chunk.

Evaluation (cells 14-21): 2000 MH steps, ESS from the full-lag
autocovariance spectrum, plain HMC at eps 0.15 as the baseline.

Randomness comes from ``torch.Generator``s seeded from ``ScgConfig.seed``.
The generators live on the CPU, so a seed gives the same chains on every
device; the streams differ from the JAX package's threefry streams.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from l2hmc_tpu_torch import mcmc, nets, targets
from l2hmc_tpu_torch.config import resolve_device
from l2hmc_tpu_torch.dynamics import Dynamics
from l2hmc_tpu_torch.evals import acl_spectrum, ess
from l2hmc_tpu_torch.mcmc.sampler import normal_like
from l2hmc_tpu_torch.ops import differentiable_fused
from l2hmc_tpu_torch.train.optim import (
    Adam,
    AdamState,
    apply_updates,
    exponential_decay,
    tree_leaves,
    tree_unflatten,
)


@dataclasses.dataclass(frozen=True)
class ScgConfig:
    """Hyperparameters of the notebook experiment; the fields and defaults of
    the JAX package's ``ScgConfig`` (see its comments for each knob).

    Every field is read, except ``fused_tile`` (the CUDA kernels run a lane
    group per chain and need no tile) and ``remat`` (a memory knob of the
    JAX package that changes no number; autograd here keeps the
    trajectories' activations). A knob that is not ported raises when set
    (``_UNPORTED``).
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


# -- training (notebook cells 9-12) --------------------------------------------


class TrainState(NamedTuple):
    params: Any
    opt_state: AdamState
    x: torch.Tensor  # chain state (n_chains, dim)
    generator: torch.Generator  # CPU; a train step advances it in place
    step: int


class StepDraws(NamedTuple):
    """Every random number of one train step, in the order a step draws them
    from its generator: the x-proposal's momentum, direction and accept
    uniforms, then the burn-in chains z, then the z-proposal's momentum and
    direction uniforms. HMC mode reads no direction uniforms, and without
    ``z_burn_in_loss`` no z draws are made."""

    v_x: torch.Tensor  # (n, d)
    dir_x: torch.Tensor  # (n,)
    acc_x: torch.Tensor  # (n,)
    z: torch.Tensor  # (n, d)
    v_z: torch.Tensor  # (n, d)
    dir_z: torch.Tensor  # (n,)


def temperature_at(config: ScgConfig, step) -> float:
    """The training temperature: 1.0 (annealing, ``init_temperature > 1``,
    is not ported and raises in ``ScgConfig``)."""
    return 1.0


def make_optimizer(config: ScgConfig):
    """(Adam with the staircase schedule, the schedule): grad_clip and
    skip_nonfinite_updates as the config says."""
    schedule = exponential_decay(
        config.learning_rate, config.lr_decay_steps, config.lr_decay_rate)
    opt = Adam(schedule, grad_clip=config.grad_clip,
               skip_nonfinite=config.skip_nonfinite_updates)
    return opt, schedule


def init_state(
    config: ScgConfig, dynamics: Dynamics, optimizer: Adam, eps_init=None, device=None,
) -> TrainState:
    """Params, then chains from N(0, I) (cell 12), both drawn from one CPU
    generator seeded with ``config.seed``; training goes on drawing from it."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(config.seed)
    params = dynamics.init_params(
        gen, eps=config.eps if eps_init is None else eps_init, device=dev
    )
    x = torch.randn((config.n_chains, config.dim), generator=gen).to(dev)
    return TrainState(params, optimizer.init(params), x, gen, 0)


def make_train_step(
    config: ScgConfig, dynamics, optimizer: Adam, loss_sigmas=None, *, alpha0=None,
):
    """One training step ``step(state, draws=None) -> (state, metrics)``:
    the joint loss on the (x, z) proposals, its gradient by autograd, the
    Adam update, and the chains advanced by the x-proposal's MH output.
    ``dynamics`` is a ``Dynamics`` or a ``DifferentiableFusedDynamics``.
    ``draws`` (a ``StepDraws``) replaces the generator's numbers.
    ``loss_sigmas`` whitens the jump distance: a (dim,) vector divides, a
    (dim, dim) matrix W maps a -> a W^T. ``alpha0`` is the log-eps centre of
    ``alpha_reg`` (log ``config.eps`` when not given)."""
    sig = wmat = None
    if loss_sigmas is not None:
        arr = torch.as_tensor(np.asarray(loss_sigmas, np.float32))
        if arr.ndim == 2:
            wmat = arr
        else:
            sig = arr[None, :]
    if config.alpha_reg > 0 and alpha0 is None:
        alpha0 = float(np.log(np.float32(config.eps)))

    def whiten(a):
        if wmat is not None:
            return a @ wmat.to(a.device).T
        return a / sig.to(a.device) if sig is not None else a

    mixed = mcmc.loss_mixed_per_dim if config.per_dim_loss else mcmc.loss_mixed

    def loss_fn(params, x, gen, draws):
        kx = {} if draws is None else dict(
            init_v=draws.v_x, dir_u=draws.dir_x, accept_u=draws.acc_x)
        out_x = mcmc.propose(gen, dynamics, params, x, do_mh_step=True, **kx)
        if config.z_burn_in_loss:
            z = normal_like(gen, x) if draws is None else draws.z
            kz = {} if draws is None else dict(init_v=draws.v_z, dir_u=draws.dir_z)
            out_z = mcmc.propose(gen, dynamics, params, z, **kz)
            if config.per_dim_loss:
                loss = (mixed(whiten(x), whiten(out_x.x_prop), out_x.p_accept,
                              scale=config.scale)
                        + mixed(whiten(z), whiten(out_z.x_prop), out_z.p_accept,
                                scale=config.scale))
            else:
                loss = mcmc.scg_joint_loss(
                    whiten(x), whiten(out_x.x_prop), out_x.p_accept,
                    whiten(z), whiten(out_z.x_prop), out_z.p_accept,
                    scale=config.scale,
                )
        else:
            loss = mixed(whiten(x), whiten(out_x.x_prop), out_x.p_accept,
                         scale=config.scale)
        if config.accept_penalty > 0:
            loss = loss + config.accept_penalty * torch.square(
                torch.mean(out_x.p_accept) - config.accept_target)
        if config.autocorr_penalty > 0:
            xw = whiten(x)
            p = out_x.p_accept[:, None]
            xw_next = whiten(p * out_x.x_prop + (1.0 - p) * x)
            xc = xw - torch.mean(xw, dim=0)
            nc = xw_next - torch.mean(xw_next, dim=0)
            rho = torch.mean(xc * nc, dim=0) / (
                torch.std(xw, dim=0, correction=0) * torch.std(xw_next, dim=0, correction=0)
                + 1e-6)
            loss = loss + config.autocorr_penalty * torch.mean(torch.square(rho))
        if config.alpha_reg > 0:
            a0 = torch.as_tensor(alpha0, dtype=torch.float32, device=x.device)
            loss = loss + config.alpha_reg * torch.mean(torch.square(params["alpha"] - a0))
        return loss, out_x

    def train_step(state: TrainState, draws: Optional[StepDraws] = None):
        leaves = [leaf.detach().requires_grad_(True) for leaf in tree_leaves(state.params)]
        params = tree_unflatten(state.params, leaves)
        loss, out_x = loss_fn(params, state.x, state.generator, draws)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not reach (alpha with eps_trainable=False)
        # gets zeros, as stop_gradient gives in JAX
        grads = [torch.zeros_like(l) if g is None else g for g, l in zip(grads, leaves)]
        updates, opt_state = optimizer.update(tree_unflatten(state.params, grads),
                                              state.opt_state)
        if config.alpha_lr_scale != 1.0 or config.eps_unfreeze_step > 0:
            ua = updates["alpha"] * config.alpha_lr_scale
            if state.step < config.eps_unfreeze_step:
                ua = torch.zeros_like(ua)
            updates = {**updates, "alpha": ua}
        new_params = apply_updates(state.params, updates)
        metrics = {
            "loss": loss.detach(),
            "p_accept": torch.mean(out_x.p_accept.detach()),
            # mean over dims when eps_dim (keeps the metric a scalar)
            "eps": torch.mean(dynamics.eps(new_params)),
            "temperature": temperature_at(config, state.step),
        }
        new_state = TrainState(new_params, opt_state, out_x.x_next.detach(),
                               state.generator, state.step + 1)
        return new_state, metrics

    return train_step


def _copy_generator(gen: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


def train(
    config: ScgConfig,
    target=None,
    *,
    log_every: int = 0,
    state: Optional[TrainState] = None,
    device=None,
) -> tuple[TrainState, dict]:
    """Train for ``config.n_steps`` steps on ``device`` (``cuda`` unless the
    caller says otherwise), or on from ``state`` (whose generator is copied,
    not advanced). Returns (final state, history: a (n_steps,) array per
    metric). With ``log_every > 0`` prints progress like the notebook (cell
    12). With ``select_best`` the returned state is the end of the chunk
    with the lowest mean loss."""
    dynamics, target = build_dynamics(config, target)
    optimizer, schedule = make_optimizer(config)
    if config.n_chains < 1:
        raise ValueError(f"n_chains must be >= 1, got {config.n_chains}")
    sigma = getattr(target, "sigma", None)
    has_cov = sigma is not None and np.asarray(sigma).ndim == 2
    eps_init = None
    if config.eps_sigma_init > 0:
        if not config.eps_dim:
            raise ValueError("eps_sigma_init requires eps_dim")
        if not has_cov:
            raise ValueError("eps_sigma_init requires a target with a known covariance")
        eps_init = config.eps_sigma_init * np.sqrt(np.diag(np.asarray(sigma))).astype(np.float32)
    if state is None:
        state = init_state(config, dynamics, optimizer, eps_init=eps_init, device=device)
    else:
        state = state._replace(generator=_copy_generator(state.generator))
    step_dynamics = differentiable_fused(dynamics, target) if config.fused_train else dynamics
    loss_sigmas = None
    if config.whiten_loss or config.whiten_full:
        if not has_cov:
            raise ValueError("whiten_loss requires a target with a known covariance")
        cov = np.asarray(sigma)
        loss_sigmas = (np.linalg.inv(np.linalg.cholesky(cov)).astype(np.float32)
                       if config.whiten_full else np.sqrt(np.diag(cov)))
    alpha0 = None
    if config.alpha_reg > 0:
        e0 = config.eps if eps_init is None else eps_init
        alpha0 = np.log(np.asarray(e0, np.float32))
    step_fn = make_train_step(config, step_dynamics, optimizer, loss_sigmas, alpha0=alpha0)

    # chunks of log_every (or 250) steps: the metrics come to the host once
    # per chunk, and select_best picks among chunk ends
    chunk = min(log_every if log_every and log_every > 0 else 250, config.n_steps)
    history = []
    done = 0
    best_loss, best_state = float("inf"), None
    while done < config.n_steps:
        n = min(chunk, config.n_steps - done)
        metrics = []
        for _ in range(n):
            state, m = step_fn(state)
            metrics.append(m)
        history.append({
            k: torch.stack([torch.as_tensor(m[k]) for m in metrics]).cpu().numpy()
            for k in metrics[0]
        })
        if config.select_best:
            chunk_loss = float(np.mean(history[-1]["loss"]))
            if chunk_loss < best_loss:
                best_loss = chunk_loss
                best_state = state._replace(generator=_copy_generator(state.generator))
        done += n
        if log_every:
            print(
                f"Step: {done} / {config.n_steps}, "
                f"Loss: {float(history[-1]['loss'][-1]):.2e}, "
                f"Acceptance: {float(history[-1]['p_accept'][-1]):.2f}, "
                f"LR: {float(schedule(done)):.5f}"
            )
    merged = {k: np.concatenate([h[k] for h in history]) for k in history[0]}
    if config.select_best and best_state is not None:
        # the snapshot's optimizer state and step are those of that chunk's
        # end: meant for evaluation, not for resuming to the full budget
        state = best_state
    return state, merged


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


def run_experiment(
    config: ScgConfig = ScgConfig(),
    *,
    eval_steps: int = 2000,
    hmc_eps: float = 0.15,
    log_every: int = 0,
    return_state: bool = False,
    device=None,
):
    """The notebook end to end on ``device`` (``cuda`` unless the caller
    says otherwise): train, then the L2HMC vs HMC ESS evaluation (cells
    12-21). Returns the metrics dict with the ESS ratio, final loss and
    acceptance, training time and history; with ``return_state`` also the
    final ``TrainState``."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    state, history = train(config, log_every=log_every, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_time = time.perf_counter() - t0
    metrics = evaluate_trained(config, state.params, eval_steps=eval_steps,
                               hmc_eps=hmc_eps, device=dev)
    metrics.update(
        final_loss=float(history["loss"][-1]),
        final_accept=float(history["p_accept"][-100:].mean()),
        train_time_s=train_time,
        history=history,
    )
    if return_state:
        return metrics, state
    return metrics
