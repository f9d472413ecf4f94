"""The SCG experiment: train L2HMC on the strongly-correlated Gaussian, then
evaluate it (counterpart of ``l2hmc_tpu/train/scg.py``).

Training (SCGExperiment.ipynb cells 9-12): the joint loss over the target
chains x and fresh z ~ N(0, I) burn-in chains at scale 0.1, Adam at lr 1e-3
with staircase decay 0.96 per 1000 steps (``train/optim.py``), non-finite
updates skipped. ``fused_train`` runs the trajectories through the fused
CUDA kernels (``ops.differentiable_fused``), else through ``Dynamics`` with
plain autograd. The steps run in chunks of ``log_every`` (or 250) steps; the
chain state and the optimizer state stay on the device, and the metrics come
to the host once per chunk.

Evaluation (cells 14-21): 2000 MH steps, ESS from the full-lag
autocovariance spectrum, plain HMC at eps 0.15 as the baseline.

Randomness comes from ``torch.Generator``s seeded from ``ScgConfig.seed``.
The generators live on the CPU, so a seed gives the same chains on every
device; the streams differ from the JAX package's threefry streams.

Captured steps (the counterpart of the JAX package's jitted scans): on a CUDA
device ``train`` records one training step and ``sample_chain`` one MH step
as a CUDA graph (``utils.capture``) and replays it for every step. The
draws still come from the CPU generator in the eager order (``draw_step``,
``mcmc.propose_draws``), a chunk at a time, made by the host while the card
runs the previous chunk; they reach the graph through static device buffers
and the ``draws=`` injection, so the captured route gives the generator-driven
eager route's numbers. ``capture=False`` runs the eager route on any device.
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
from l2hmc_tpu_torch.mcmc.sampler import normal_like, propose_draws
from l2hmc_tpu_torch.ops import differentiable_fused
from l2hmc_tpu_torch.train.optim import (
    Adam,
    AdamState,
    apply_updates,
    exponential_decay,
    tree_leaves,
    tree_unflatten,
)
from l2hmc_tpu_torch.utils.capture import WARMUP_CALLS, Graph, run_on_side_stream


@dataclasses.dataclass(frozen=True)
class ScgConfig:
    """Hyperparameters of the notebook experiment; the fields and defaults of
    the JAX package's ``ScgConfig`` (see its comments for each knob).

    Every field is read, except ``fused_tile`` (the CUDA kernels run a lane
    group per chain and need no tile) and ``remat`` (a memory knob of the
    JAX package that changes no number; autograd here keeps the
    trajectories' activations: the bf16 conv recipe that sets it, L = 32
    at 256 chains, peaks at 50 GB of an H100's 80). A knob that is not
    ported raises when set (``_UNPORTED``).

    ``compute_dtype`` ("float32" or "bfloat16", ``config.Precision``) is the
    operand dtype of the plain S/T/Q nets' products (``nets.core.linear``,
    ``nets.lattice.conv2d``). As in the JAX package it reaches the nets and
    no kernel: ``fused_train=True`` builds ``differentiable_fused(dynamics,
    target)`` with no dtype, whose trajectories read the params and not the
    nets, so fused bfloat16 training is fused float32 training, bit for
    bit; the plain evals of the trained sampler run the bfloat16 nets.
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
                    f"ScgConfig.{name}={getattr(self, name)!r} is not ported yet "
                    f"(ROADMAP {_QUEUED[name]})"
                )


# sampler-changing knobs the port cannot honour yet: name -> accepted values
_UNPORTED = {
    "eps_step": lambda v: not v,
    "pt_train_rungs": lambda v: v <= 1,
}
# where each stands in ROADMAP's queues
_QUEUED = {"eps_step": "A7", "pt_train_rungs": "A1"}


def build_dynamics(config: ScgConfig, target=None) -> tuple[Dynamics, Any]:
    """Dynamics + target for the SCG experiment (notebook cells 3, 5):
    dense S/T/Q nets, or with ``net_type="conv"`` the lattice conv nets of a
    square ``dim``. ``init_temperature > 1`` turns on ``use_temperature``;
    ``net_input_target_fn`` takes the target's ``net_input_transform()`` as
    the nets' input features."""
    target = targets.scg_gaussian() if target is None else target
    common = dict(
        dim=config.dim,
        energy=target.energy,
        grad_energy=target.grad_energy,
        T=config.T,
        mask_seed=config.mask_seed,
        eps_trainable=config.eps_trainable,
        eps_dim=config.eps_dim,
        eps_mat=config.eps_mat,
        use_temperature=config.init_temperature > 1.0 or config.pt_train_rungs > 1,
    )
    if config.hmc:
        return Dynamics(hmc=True, **common), target
    if config.net_type == "conv":
        L = int(round(np.sqrt(config.dim)))
        if L * L != config.dim:
            raise ValueError(f"net_type='conv' needs a square lattice dim, got {config.dim}")
        xnet, vnet = (nets.lattice_net_factory(L, factor=f, channels=config.conv_channels,
                                               depth=config.conv_depth,
                                               compute_dtype=config.compute_dtype)
                      for f in (2.0, 1.0))
    elif config.net_type == "dense":
        xnet, vnet = (nets.scg_net_factory(config.dim, factor=f, hidden=config.hidden,
                                           compute_dtype=config.compute_dtype)
                      for f in (2.0, 1.0))
    else:
        raise ValueError(f"unknown net_type: {config.net_type!r}")
    input_scale = None
    if config.net_input_whiten:
        sig = np.asarray(getattr(target, "sigma", None))
        if sig.ndim != 2:
            raise ValueError("net_input_whiten needs a target with a covariance .sigma")
        input_scale = tuple(np.sqrt(np.diag(sig)).tolist())
    net_input_fn = None
    if config.net_input_target_fn:
        if not hasattr(target, "net_input_transform"):
            raise ValueError(
                "net_input_target_fn needs a target that defines "
                f"net_input_transform(); {type(target).__name__} does not"
            )
        net_input_fn = target.net_input_transform()
    return Dynamics(xnet=xnet, vnet=vnet, input_scale=input_scale,
                    net_input_fn=net_input_fn, **common), target


# -- training (notebook cells 9-12) --------------------------------------------


class TrainState(NamedTuple):
    params: Any
    opt_state: AdamState
    x: torch.Tensor  # chain state (n_chains, dim)
    generator: torch.Generator  # CPU; a train step advances it in place
    step: Any  # () int32 tensor on the device (a Python int is read too)


class StepDraws(NamedTuple):
    """Every random number of one train step, in the order a step draws them
    from its generator: the x-proposal's momentum, direction and accept
    uniforms, then the burn-in chains z, then the z-proposal's momentum and
    direction uniforms. HMC mode reads no direction uniforms, and without
    ``z_burn_in_loss`` no z draws are made (``draw_step`` leaves those None)."""

    v_x: torch.Tensor  # (n, d)
    dir_x: Optional[torch.Tensor]  # (n,)
    acc_x: torch.Tensor  # (n,)
    z: Optional[torch.Tensor]  # (n, d)
    v_z: Optional[torch.Tensor]  # (n, d)
    dir_z: Optional[torch.Tensor]  # (n,)


def draw_step(generator: torch.Generator, n: int, dim: int, *, hmc: bool = False,
              z_burn_in: bool = True) -> StepDraws:
    """The random numbers of one train step from ``generator``, in the order
    the generator-driven step draws them (``mcmc.propose_draws`` twice, the
    burn-in chains between), so a step given them equals the step that
    draws them itself bit for bit."""
    v_x, dir_x, acc_x = propose_draws(generator, n, dim, hmc=hmc, accept=True)
    z = v_z = dir_z = None
    if z_burn_in:
        z = torch.randn((n, dim), generator=generator, dtype=torch.float32,
                        device=generator.device)
        v_z, dir_z, _ = propose_draws(generator, n, dim, hmc=hmc, accept=False)
    return StepDraws(v_x, dir_x, acc_x, z, v_z, dir_z)


def temperature_at(config: ScgConfig, step) -> torch.Tensor:
    """The training temperature: a linear anneal from ``init_temperature`` to
    1 over ``anneal_frac`` of the steps (1.0 throughout without annealing),
    as a float32 tensor on the step counter's device (the CPU for a Python
    int). Computed from the counter on its device, so a captured step
    replays the schedule with no host branch."""
    device = getattr(step, "device", None)
    if config.init_temperature <= 1.0:
        return torch.ones((), dtype=torch.float32, device=device)
    anneal_steps = max(int(config.n_steps * config.anneal_frac), 1)
    step = torch.as_tensor(step, dtype=torch.int32, device=device)
    frac = torch.clamp(1.0 - step / anneal_steps, 0.0, 1.0)
    return 1.0 + (config.init_temperature - 1.0) * frac.to(torch.float32)


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
    generator seeded with ``config.seed``; training goes on drawing from it.
    The step counter starts as a device tensor, as the captured step needs."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(config.seed)
    params = dynamics.init_params(
        gen, eps=config.eps if eps_init is None else eps_init, device=dev
    )
    x = torch.randn((config.n_chains, config.dim), generator=gen).to(dev)
    step = torch.zeros((), dtype=torch.int32, device=dev)
    return TrainState(params, optimizer.init(params), x, gen, step)


def _per_device(value):
    """``value`` as a float32 tensor on any device, copied there once: a
    captured step copies nothing from the host."""
    host = torch.as_tensor(np.asarray(value, np.float32))
    cache = {}

    def on(device):
        t = cache.get(device)
        if t is None:
            t = cache[device] = host.to(device)
        return t

    return on


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
    ``alpha_reg`` (log ``config.eps`` when not given).

    With a device tensor for ``state.step`` and ``draws`` on the device the
    step makes no host copy, synchronisation or host branch on a tensor, so
    ``train`` can record it as a CUDA graph."""
    sig = wmat = None
    if loss_sigmas is not None:
        arr = np.asarray(loss_sigmas, np.float32)
        if arr.ndim == 2:
            wmat = _per_device(arr)
        else:
            sig = _per_device(arr[None, :])
    if config.alpha_reg > 0 and alpha0 is None:
        alpha0 = float(np.log(np.float32(config.eps)))
    a0 = _per_device(alpha0) if config.alpha_reg > 0 else None

    def whiten(a):
        if wmat is not None:
            return a @ wmat(a.device).T
        return a / sig(a.device) if sig is not None else a

    mixed = mcmc.loss_mixed_per_dim if config.per_dim_loss else mcmc.loss_mixed
    anneal = config.init_temperature > 1.0

    def loss_fn(params, x, gen, draws, temperature):
        kt = {"temperature": temperature} if anneal else {}
        kx = {} if draws is None else dict(
            init_v=draws.v_x, dir_u=draws.dir_x, accept_u=draws.acc_x)
        out_x = mcmc.propose(gen, dynamics, params, x, do_mh_step=True, **kx, **kt)
        if config.z_burn_in_loss:
            z = normal_like(gen, x) if draws is None else draws.z
            kz = {} if draws is None else dict(init_v=draws.v_z, dir_u=draws.dir_z)
            out_z = mcmc.propose(gen, dynamics, params, z, **kz, **kt)
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
            loss = loss + config.alpha_reg * torch.mean(
                torch.square(params["alpha"] - a0(x.device)))
        return loss, out_x

    def train_step(state: TrainState, draws: Optional[StepDraws] = None):
        leaves = [leaf.detach().requires_grad_(True) for leaf in tree_leaves(state.params)]
        params = tree_unflatten(state.params, leaves)
        temperature = temperature_at(config, state.step)
        loss, out_x = loss_fn(params, state.x, state.generator, draws, temperature)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not reach (alpha with eps_trainable=False)
        # gets zeros, as stop_gradient gives in JAX
        grads = [torch.zeros_like(l) if g is None else g for g, l in zip(grads, leaves)]
        updates, opt_state = optimizer.update(tree_unflatten(state.params, grads),
                                              state.opt_state)
        if config.alpha_lr_scale != 1.0 or config.eps_unfreeze_step > 0:
            # the dense W (eps_mat) is step-size state like alpha: the
            # freeze and scale knobs govern both leaves alike
            scaled = {}
            for leaf in ("alpha", "w") if "w" in updates else ("alpha",):
                u = updates[leaf] * config.alpha_lr_scale
                if config.eps_unfreeze_step > 0:
                    live = torch.as_tensor(state.step, device=u.device) >= config.eps_unfreeze_step
                    u = torch.where(live, u, torch.zeros_like(u))
                scaled[leaf] = u
            updates = {**updates, **scaled}
        new_params = apply_updates(state.params, updates)
        metrics = {
            "loss": loss.detach(),
            "p_accept": torch.mean(out_x.p_accept.detach()),
            # mean over dims when eps_dim (keeps the metric a scalar)
            "eps": torch.mean(dynamics.eps(new_params)),
            "temperature": temperature,
        }
        new_state = TrainState(new_params, opt_state, out_x.x_next.detach(),
                               state.generator, state.step + 1)
        return new_state, metrics

    return train_step


def _copy_generator(gen: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


def _pack_rows(rows: list, device) -> torch.Tensor:
    """Per-step lists of draws (None where a step draws nothing) -> one
    (steps, floats) float32 tensor, pinned when it is bound for a card."""
    flat = torch.stack([torch.cat([a.reshape(-1) for a in r if a is not None]) for r in rows])
    return flat.pin_memory() if torch.device(device).type == "cuda" else flat


def _unpack_row(row: torch.Tensor, shapes: list) -> list:
    """A packed row back into its draws, None where ``shapes`` has None."""
    out, at = [], 0
    for shape in shapes:
        if shape is None:
            out.append(None)
            continue
        size = int(np.prod(shape))
        out.append(row[at:at + size].view(shape))
        at += size
    return out


def _state_tensors(state: TrainState) -> list:
    return [*tree_leaves(state.params), *state.opt_state, state.x, state.step]


class _ReplayedSteps:
    """A captured route's common part: a static device buffer for a chunk of
    steps' packed draws (a row each, laid out as ``shapes``), a device
    counter ``i``, and the subclass's step body ``_body``, which reads row
    ``i`` (``_row``) and advances ``i``.

    ``step`` runs the body once. On a CUDA device its first
    ``WARMUP_CALLS`` calls run eagerly on a side stream, the next one
    records the body as a CUDA graph, and every call from then on replays
    it: one launch for the whole step. A capture that fails raises; nothing
    falls back to eager on the card. On the CPU every call runs the body
    eagerly."""

    def __init__(self, shapes: list, chunk: int, device):
        self.shapes = shapes
        size = sum(int(np.prod(sh)) for sh in shapes if sh is not None)
        self.draws = torch.zeros((chunk, size), dtype=torch.float32, device=device)
        self.i = torch.zeros((1,), dtype=torch.int64, device=device)
        self.cuda = torch.device(device).type == "cuda"
        self.graph = None
        self.warm_calls = 0

    def _body(self) -> None:
        raise NotImplementedError

    def _row(self) -> list:
        return _unpack_row(self.draws.index_select(0, self.i)[0], self.shapes)

    def step(self) -> None:
        if not self.cuda:
            self._body()
            return
        if self.graph is None:
            if self.warm_calls < WARMUP_CALLS:
                run_on_side_stream(self._body)
                self.warm_calls += 1
                return
            self.graph = Graph(self._body)
        self.graph.replay()

    def run(self, draws: torch.Tensor) -> None:
        """Enqueues one chunk: its draws to the card, then a step per row."""
        self.draws[: len(draws)].copy_(draws, non_blocking=True)
        self.i.zero_()
        for _ in range(len(draws)):
            self.step()


class _TrainSteps(_ReplayedSteps):
    """The captured training route: the state, a chunk's draws and its
    metrics in static device buffers; the step body runs ``step_fn`` on row
    ``i``'s draws, writes the new state over the old and the metrics into
    row ``i``."""

    _METRICS = ("loss", "p_accept", "eps", "temperature")

    def __init__(self, step_fn, state: TrainState, chunk: int, hmc: bool, z_burn_in: bool):
        dev = state.x.device
        n, dim = state.x.shape
        self.hmc, self.z_burn_in, self.n, self.dim = hmc, z_burn_in, n, dim
        u = None if hmc else (n,)
        z = (n, dim) if z_burn_in else None
        # StepDraws' fields: v_x, dir_x, acc_x, z, v_z, dir_z
        super().__init__([(n, dim), u, (n,), z, z, u if z_burn_in else None], chunk, dev)
        self.static = state._replace(
            params=tree_unflatten(state.params, [t.detach().clone() for t in
                                                 tree_leaves(state.params)]),
            opt_state=AdamState(*(t.clone() for t in state.opt_state)),
            x=state.x.detach().clone(),
            step=torch.as_tensor(state.step, dtype=torch.int32, device=dev).clone(),
            generator=None,
        )
        self.metrics = torch.zeros((chunk, len(self._METRICS)), dtype=torch.float32, device=dev)
        self.step_fn = step_fn

    def _body(self) -> None:
        new, m = self.step_fn(self.static, StepDraws(*self._row()))
        for dst, src in zip(_state_tensors(self.static), _state_tensors(new)):
            dst.copy_(src)
        vals = torch.stack([m[k].reshape(()).to(torch.float32) for k in self._METRICS])
        self.metrics.index_copy_(0, self.i, vals[None])
        self.i += 1

    def draw(self, generator: torch.Generator, steps: int) -> torch.Tensor:
        """``steps`` steps' draws from ``generator``, packed on the host."""
        return _pack_rows([draw_step(generator, self.n, self.dim, hmc=self.hmc,
                                     z_burn_in=self.z_burn_in) for _ in range(steps)],
                          self.draws.device)

    def history(self, steps: int) -> dict:
        m = self.metrics[:steps].cpu().numpy()
        return {k: m[:, j].copy() for j, k in enumerate(self._METRICS)}

    def state(self, generator: torch.Generator) -> TrainState:
        """A copy of the state after the steps run so far."""
        s = self.static
        return TrainState(
            tree_unflatten(s.params, [t.clone() for t in tree_leaves(s.params)]),
            AdamState(*(t.clone() for t in s.opt_state)), s.x.clone(), generator,
            s.step.clone(),
        )


def train(
    config: ScgConfig,
    target=None,
    *,
    log_every: int = 0,
    state: Optional[TrainState] = None,
    device=None,
    capture: Optional[bool] = None,
) -> tuple[TrainState, dict]:
    """Train for ``config.n_steps`` steps on ``device`` (``cuda`` unless the
    caller says otherwise), or on from ``state`` (whose generator is copied,
    not advanced). Returns (final state, history: a (n_steps,) array per
    metric). With ``log_every > 0`` prints progress like the notebook (cell
    12). With ``select_best`` the returned state is the end of the chunk
    with the lowest mean loss.

    ``capture`` (default: on a CUDA device) runs the captured route: one
    step recorded as a CUDA graph and replayed, its draws made ahead by
    ``draw_step``; a capture that fails raises. On the CPU the same route
    runs its step body eagerly. ``capture=False`` runs the eager route,
    which draws from the generator inside each step. Both give the same
    numbers."""
    dynamics, target = build_dynamics(config, target)
    optimizer, schedule = make_optimizer(config)
    if config.n_chains < 1:
        raise ValueError(f"n_chains must be >= 1, got {config.n_chains}")
    if config.fused_train and config.net_input_target_fn:
        raise ValueError(
            "fused_train cannot apply a nonlinear net_input_fn "
            "(fused kernels fold only the linear input_scale)"
        )
    if config.fused_train and config.init_temperature > 1.0:
        raise ValueError("fused_train does not support temperature annealing")
    if config.fused_train and config.net_type != "dense" and not config.hmc:
        raise ValueError("fused_train needs dense S/T/Q nets (the kernels take no conv nets)")
    sigma = getattr(target, "sigma", None)
    has_cov = sigma is not None and np.asarray(sigma).ndim == 2
    eps_init = None
    if config.eps_sigma_init > 0:
        if not config.eps_dim:
            raise ValueError("eps_sigma_init requires eps_dim")
        if not has_cov:
            raise ValueError("eps_sigma_init requires a target with a known covariance")
        eps_init = config.eps_sigma_init * np.sqrt(np.diag(np.asarray(sigma))).astype(np.float32)
    if config.eps_chol_init > 0:
        if not config.eps_mat:
            raise ValueError("eps_chol_init requires eps_mat")
        if not has_cov:
            raise ValueError("eps_chol_init requires a target with a known covariance")
        eps_init = (config.eps_chol_init * np.linalg.cholesky(np.asarray(sigma))).astype(np.float32)
    if state is None:
        state = init_state(config, dynamics, optimizer, eps_init=eps_init, device=device)
    else:
        state = state._replace(generator=_copy_generator(state.generator))
    # no operand dtype for the kernels, as the JAX trainer passes none
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
        e0 = np.asarray(config.eps if eps_init is None else eps_init, np.float32)
        if config.eps_mat and e0.ndim == 2:
            # the gate scalar init_params gives a (dim, dim) init
            alpha0 = np.mean(np.log(np.abs(np.diag(e0))))
        elif config.eps_mat and e0.ndim != 0:
            raise ValueError("alpha_reg with eps_mat requires a scalar or (dim, dim) eps "
                             f"init, got shape {e0.shape}")
        else:
            alpha0 = np.log(e0)
    step_fn = make_train_step(config, step_dynamics, optimizer, loss_sigmas, alpha0=alpha0)

    # chunks of log_every (or 250) steps: the metrics come to the host once
    # per chunk, and select_best picks among chunk ends
    chunk = min(log_every if log_every and log_every > 0 else 250, config.n_steps)
    if capture is None:
        capture = state.x.device.type == "cuda"
    steps = (_TrainSteps(step_fn, state, chunk, dynamics.hmc, config.z_burn_in_loss)
             if capture else None)
    gen = state.generator
    pending = steps.draw(gen, chunk) if steps is not None else None
    history = []
    done = 0
    best_loss, best_state = float("inf"), None
    while done < config.n_steps:
        n = min(chunk, config.n_steps - done)
        if steps is None:
            metrics = []
            for _ in range(n):
                state, m = step_fn(state)
                metrics.append(m)
            history.append({
                k: torch.stack([torch.as_tensor(m[k]) for m in metrics]).cpu().numpy()
                for k in metrics[0]
            })
        else:
            steps.run(pending[:n])
            at_end = _copy_generator(gen)
            later = min(chunk, config.n_steps - done - n)
            # the next chunk's draws are made while the card runs this one
            pending = steps.draw(gen, later) if later > 0 else None
            history.append(steps.history(n))
            state = steps.state(at_end)
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


class _SampleSteps(_ReplayedSteps):
    """The captured sampling route: the chain state, a chunk's draws and its
    outputs in static device buffers; the step body runs one MH step on row
    ``i``'s draws and writes its output into row ``i``."""

    def __init__(self, dynamics, params, x0: torch.Tensor, chunk: int, collect: bool):
        n, dim = x0.shape
        super().__init__([(n, dim), None if dynamics.hmc else (n,), (n,)], chunk, x0.device)
        self.x = x0.detach().clone()
        self.out = torch.zeros((chunk, *((n, dim) if collect else (n,))), dtype=x0.dtype,
                               device=x0.device)
        self.dynamics, self.params, self.collect = dynamics, params, collect

    def _body(self) -> None:
        v, u_dir, u_acc = self._row()
        out = mcmc.propose(None, self.dynamics, self.params, self.x, init_v=v, dir_u=u_dir,
                           accept_u=u_acc, do_mh_step=True)
        self.x.copy_(out.x_next)
        self.out.index_copy_(0, self.i, (out.x_next if self.collect else out.p_accept)[None])
        self.i += 1


_SAMPLE_CHUNK = 250


def sample_chain(
    dynamics: Dynamics,
    params,
    x0: torch.Tensor,
    n_steps: int,
    generator: Optional[torch.Generator],
    *,
    collect: bool = True,
    draws=None,
    capture: Optional[bool] = None,
):
    """Run the sampler for ``n_steps`` MH steps on x0's device; returns
    (x_final, trace) with trace the (n_steps, N, D) post-MH states (or the
    (n_steps, N) acceptance probabilities when ``collect`` is False).

    ``draws`` optionally gives every random number instead of
    ``generator``: (momenta (K, N, D), direction uniforms (K, N), accept
    uniforms (K, N)); HMC mode reads no direction uniforms.

    ``capture`` (default: on a CUDA device) records one MH step as a CUDA
    graph and replays it, the draws made ahead a chunk at a time in the
    eager order (``mcmc.propose_draws``); a capture that fails raises. On
    the CPU the same route runs its step body eagerly. ``capture=False``
    runs the eager route. Both give the same chains."""
    if capture is None:
        capture = x0.device.type == "cuda"
    with torch.no_grad():
        if not capture:
            x = x0
            trace = []
            for k in range(n_steps):
                kw = {}
                if draws is not None:
                    v, u_dir, u_acc = draws
                    kw = dict(init_v=v[k], dir_u=u_dir[k], accept_u=u_acc[k])
                out = mcmc.propose(generator, dynamics, params, x, do_mh_step=True, **kw)
                x = out.x_next
                trace.append(x if collect else out.p_accept)
            return x, torch.stack(trace)
        if n_steps <= 0:
            raise ValueError("n_steps must be positive")
        chunk = min(_SAMPLE_CHUNK, n_steps)
        steps = _SampleSteps(dynamics, params, x0, chunk, collect)
        trace = torch.empty((n_steps, *steps.out.shape[1:]), dtype=x0.dtype, device=x0.device)

        def chunk_draws(k0, k1):
            if draws is not None:
                v, u_dir, u_acc = draws
                return _pack_rows([(v[k], None if dynamics.hmc else u_dir[k], u_acc[k])
                                   for k in range(k0, k1)], x0.device)
            n, dim = x0.shape
            return _pack_rows([propose_draws(generator, n, dim, hmc=dynamics.hmc, accept=True)
                               for _ in range(k0, k1)], x0.device)

        pending = chunk_draws(0, chunk)
        for k0 in range(0, n_steps, chunk):
            k1 = min(k0 + chunk, n_steps)
            steps.run(pending)
            trace[k0:k1].copy_(steps.out[: k1 - k0])
            if k1 < n_steps:
                # the next chunk's draws are made while the card runs this one
                pending = chunk_draws(k1, min(k1 + chunk, n_steps))
        return steps.x, trace


def hmc_sample_chain(
    target, eps: float, T: int, x0: torch.Tensor, n_steps: int,
    generator: torch.Generator, *, capture: Optional[bool] = None,
):
    """Plain-HMC baseline chain (reference utils/notebook_utils.py:25-39)."""
    dyn = Dynamics(dim=x0.shape[1], energy=target.energy,
                   grad_energy=target.grad_energy, T=T, hmc=True)
    params = dyn.init_params(generator, eps=eps, device=x0.device)
    return sample_chain(dyn, params, x0, n_steps, generator, capture=capture)


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
