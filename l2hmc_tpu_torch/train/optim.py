"""Adam with a staircase learning-rate decay, global-norm clipping and
skip-on-non-finite, by hand on a params tree (counterpart of the optax chain
that ``l2hmc_tpu/train/scg.py``'s ``make_optimizer`` builds).

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

All state is float32 (count int32) on the params' device, and the finiteness
test is a device-side select, so a step never waits for the device. The
moments are kept as one flat vector over the params tree's leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

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
        gc = g
        if self.grad_clip > 0:
            norm = torch.sqrt(torch.sum(g * g))
            gc = torch.where(norm < self.grad_clip, g, (g / norm) * self.grad_clip)
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
