"""Adam with a staircase learning-rate decay, global-norm clipping and
skip-on-non-finite, by hand on a params tree (counterpart of the optax chain
that ``l2hmc_tpu/train/scg.py``'s ``make_optimizer`` builds), and the VAE
apps' optimizer map (``OPTIMIZERS``: adam, rmsprop, sgd, nesterov) with
their piecewise-constant schedule (what ``l2hmc_tpu/apps/vae.py`` takes from
optax).

The semantics are optax's, step for step:
  - ``exponential_decay(staircase=True)``: lr0 * rate ** floor(count / steps),
    evaluated at the optimizer's own count before it is incremented;
  - ``adam``: b1 0.9, b2 0.999, eps 1e-8 (optax's defaults, eps_root 0),
    bias correction at count + 1, update = -lr * mu_hat / (sqrt(nu_hat) + eps);
  - ``clip_by_global_norm`` before Adam when ``grad_clip > 0``: g stays if
    its global norm is below the limit, else becomes (g / norm) * limit;
  - ``apply_if_finite``: a gradient with any non-finite entry gives a zero
    update and leaves both moments and the count as they were, so the
    learning-rate schedule does not advance on a skipped step.

  - ``rmsprop``: decay 0.9, eps 1e-8 inside the root, no momentum:
    nu = 0.9 nu + 0.1 g^2, update = -lr * g / sqrt(nu + eps);
  - ``sgd``: update = -lr * g; with momentum m the trace t = g + m t and the
    update -lr * t, or -lr * (g + m t) with ``nesterov``;
  - every optimizer evaluates its schedule at its own count of updates made
    so far, before the count is incremented.

All state is float32 (count int32) on the params' device, and the finiteness
test is a device-side select, so a step never waits for the device. The
moments are kept as one flat vector over the params tree's leaves (an empty
vector where an optimizer keeps none), in one state type for all.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

B1 = 0.9
B2 = 0.999
EPS = 1e-8


def tree_leaves(tree: Any) -> list:
    """Leaves of a nested dict / tuple / list tree, dict keys in sorted
    order (the JAX package's order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for node in tree for leaf in tree_leaves(node)]
    return [tree]


def tree_unflatten(tree: Any, leaves) -> Any:
    """A tree of ``tree``'s structure with ``leaves`` (in ``tree_leaves``
    order) in place of its leaves."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (tuple, list)):
            return type(node)(build(n) for n in node)
        return next(it)

    return build(tree)


def exponential_decay(init_value: float, transition_steps: int, decay_rate: float) -> Callable:
    """optax.exponential_decay(staircase=True) without transition_begin or
    end_value: ``schedule(count)`` -> float32 learning rate."""

    def schedule(count) -> torch.Tensor:
        c = torch.as_tensor(count).to(torch.float32)
        p = torch.floor(c / transition_steps)
        return torch.where(c <= 0, torch.full_like(c, init_value),
                           init_value * torch.pow(decay_rate, p))

    return schedule


def piecewise_constant_schedule(init_value: float, boundaries_and_scales=None) -> Callable:
    """optax.piecewise_constant_schedule: ``init_value`` times every scale
    whose boundary the count has reached, in float32."""
    items = sorted((boundaries_and_scales or {}).items())
    if any(scale < 0.0 for _, scale in items):
        raise ValueError("piecewise_constant_schedule expects non-negative scale factors")

    def schedule(count) -> torch.Tensor:
        c = torch.as_tensor(count).to(torch.float32)
        v = torch.full_like(c, init_value)
        for threshold, scale in items:
            indicator = torch.clamp(torch.sign(threshold - c), min=0.0)
            v = v * indicator + (1 - indicator) * scale * v
        return v

    return schedule


def _as_schedule(learning_rate) -> Callable:
    if callable(learning_rate):
        return learning_rate
    return lambda count: torch.as_tensor(learning_rate, dtype=torch.float32)


def _clip(g: torch.Tensor, grad_clip: float) -> torch.Tensor:
    """optax.clip_by_global_norm on the flat gradient."""
    if grad_clip <= 0:
        return g
    norm = torch.sqrt(torch.sum(g * g))
    return torch.where(norm < grad_clip, g, (g / norm) * grad_clip)


class AdamState(NamedTuple):
    count: torch.Tensor  # () int32: steps applied (skipped steps not counted)
    mu: torch.Tensor  # flat first moment over the params leaves
    nu: torch.Tensor  # flat second moment


@dataclasses.dataclass(frozen=True)
class Adam:
    """Adam over a params tree; ``init(params)``, then
    ``update(grads, state) -> (updates tree, state)``."""

    schedule: Callable
    grad_clip: float = 0.0
    skip_nonfinite: bool = True

    def init(self, params) -> AdamState:
        flat = _flatten(tree_leaves(params))
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=flat.device),
            mu=torch.zeros_like(flat),
            nu=torch.zeros_like(flat),
        )

    def update(self, grads, state: AdamState):
        leaves = tree_leaves(grads)
        g = _flatten(leaves)
        gc = _clip(g, self.grad_clip)
        mu = (1 - B1) * gc + B1 * state.mu
        nu = (1 - B2) * (gc * gc) + B2 * state.nu
        count_inc = state.count + 1
        c = count_inc.to(torch.float32)
        mu_hat = mu / (1 - torch.pow(B1, c))
        nu_hat = nu / (1 - torch.pow(B2, c))
        u = mu_hat / (torch.sqrt(nu_hat) + EPS)
        u = -self.schedule(state.count) * u
        if self.skip_nonfinite:
            ok = torch.isfinite(g).all()
            u = torch.where(ok, u, torch.zeros_like(u))
            mu = torch.where(ok, mu, state.mu)
            nu = torch.where(ok, nu, state.nu)
            count_inc = torch.where(ok, count_inc, state.count)
        return tree_unflatten(grads, _split(u, leaves)), AdamState(count_inc, mu, nu)


@dataclasses.dataclass(frozen=True)
class RmsProp:
    """optax.rmsprop with its defaults over a params tree; the state is an
    ``AdamState`` whose first moment is empty."""

    schedule: Callable
    grad_clip: float = 0.0
    decay: float = 0.9
    eps: float = 1e-8

    def init(self, params) -> AdamState:
        flat = _flatten(tree_leaves(params))
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=flat.device),
            mu=flat.new_zeros(0),
            nu=torch.zeros_like(flat),
        )

    def update(self, grads, state: AdamState):
        leaves = tree_leaves(grads)
        g = _clip(_flatten(leaves), self.grad_clip)
        nu = (1 - self.decay) * (g * g) + self.decay * state.nu
        u = -self.schedule(state.count) * (torch.rsqrt(nu + self.eps) * g)
        return (tree_unflatten(grads, _split(u, leaves)),
                AdamState(state.count + 1, state.mu, nu))


@dataclasses.dataclass(frozen=True)
class Sgd:
    """optax.sgd over a params tree, with optional (Nesterov) momentum; the
    state is an ``AdamState`` whose first moment is the trace (empty without
    momentum) and whose second is empty."""

    schedule: Callable
    grad_clip: float = 0.0
    momentum: Optional[float] = None
    nesterov: bool = False

    def init(self, params) -> AdamState:
        flat = _flatten(tree_leaves(params))
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=flat.device),
            mu=flat.new_zeros(0) if self.momentum is None else torch.zeros_like(flat),
            nu=flat.new_zeros(0),
        )

    def update(self, grads, state: AdamState):
        leaves = tree_leaves(grads)
        g = _clip(_flatten(leaves), self.grad_clip)
        mu = state.mu
        u = g
        if self.momentum is not None:
            mu = g + self.momentum * state.mu
            u = g + self.momentum * mu if self.nesterov else mu
        u = -self.schedule(state.count) * u
        return (tree_unflatten(grads, _split(u, leaves)),
                AdamState(state.count + 1, mu, state.nu))


# name -> factory(learning rate or schedule, grad_clip) of the VAE apps'
# optimizers; Adam here is plain optax.adam, without the non-finite skip
OPTIMIZERS = {
    "adam": lambda lr, grad_clip=0.0: Adam(_as_schedule(lr), grad_clip, skip_nonfinite=False),
    "rmsprop": lambda lr, grad_clip=0.0: RmsProp(_as_schedule(lr), grad_clip),
    "sgd": lambda lr, grad_clip=0.0: Sgd(_as_schedule(lr), grad_clip),
    "nesterov": lambda lr, grad_clip=0.0: Sgd(_as_schedule(lr), grad_clip, momentum=0.9,
                                              nesterov=True),
}


def apply_updates(params, updates):
    """params + updates, leaf by leaf (optax.apply_updates)."""
    return tree_unflatten(
        params, [p + u for p, u in zip(tree_leaves(params), tree_leaves(updates))]
    )


def _flatten(leaves) -> torch.Tensor:
    return torch.cat([leaf.reshape(-1) for leaf in leaves])


def _split(flat: torch.Tensor, like) -> list:
    sizes = [leaf.numel() for leaf in like]
    return [part.view(leaf.shape) for part, leaf in zip(torch.split(flat, sizes), like)]
