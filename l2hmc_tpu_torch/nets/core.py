"""Minimal functional module system (counterpart of ``l2hmc_tpu/nets/core.py``).

A ``Module`` is an (init, apply) pair over a nested params tree of plain
dicts and tuples of tensors, with the JAX package's structure leaf for leaf,
so that ``convert.params_from_jax`` is a tree map and the fused kernels'
host prep (``ops.fused_dynamics._extract_net``) reads the same paths.

``init(generator, device)`` draws from an explicit ``torch.Generator`` on
the generator's own device and moves the result, so a seed gives the same
weights on every device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

from l2hmc_tpu_torch.config import resolve_compute_dtype

Params = Any


def lowered(t: torch.Tensor, cd) -> torch.Tensor:
    """``t`` as a product's operand of dtype ``cd``: rounded to ``cd`` (to
    nearest, ties to even) and back to float32, so the product sums exact
    float32 terms; ``t`` itself for ``cd`` None. Autograd rounds the
    cotangent the same way, as the JAX package's VJP of ``astype`` does."""
    return t if cd is None else t.to(cd).to(t.dtype)


# Standard deviation of a unit normal truncated to [-2, 2]; the variance
# scaling initializer divides by it so the truncated draw keeps the target
# variance (same constant as jax.nn.initializers.variance_scaling).
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class Module:
    """A pure (init, apply) pair.

    init(generator, device) -> params tree
    apply(params, x) -> output
    """

    init: Callable[[torch.Generator, Any], Params]
    apply: Callable[[Params, Any], Any]

    def __call__(self, params: Params, x: Any) -> Any:
        return self.apply(params, x)


def linear(
    in_dim: int, out_dim: int, factor: float = 1.0, compute_dtype=None
) -> Module:
    """Dense layer with the reference's variance-scaling init: truncated
    normal, scale ``2 * factor``, fan-in mode, zero bias.

    ``compute_dtype`` (``config.Precision.compute_dtype``; bfloat16) lowers
    the product's operands only, as the JAX layer does: x and w rounded to
    bfloat16, the product summed in float32, the bias added in float32; the
    params stay float32. The gradients are the VJP of that rounding: the
    cotangents of x and of w are each rounded to bfloat16 per product."""
    cd = resolve_compute_dtype(compute_dtype)
    std = (2.0 * factor / in_dim) ** 0.5 / _TRUNC_STD

    def init(generator: torch.Generator, device) -> Params:
        w = torch.empty((in_dim, out_dim), dtype=torch.float32, device=generator.device)
        torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        return {
            "w": w.to(device),
            "b": torch.zeros((out_dim,), dtype=torch.float32, device=device),
        }

    def apply(params: Params, x: torch.Tensor) -> torch.Tensor:
        return lowered(x, cd) @ lowered(params["w"], cd) + params["b"]

    return Module(init, apply)


def scale_tanh(dim: int) -> Module:
    """exp(learned scale) * tanh(x)."""

    def init(generator: torch.Generator, device) -> Params:
        return {"log_scale": torch.zeros((1, dim), dtype=torch.float32, device=device)}

    def apply(params: Params, x: torch.Tensor) -> torch.Tensor:
        return torch.exp(params["log_scale"]) * torch.tanh(x)

    return Module(init, apply)


def activation(fn: Callable[[torch.Tensor], torch.Tensor]) -> Module:
    """Stateless elementwise module."""
    return Module(init=lambda generator, device: (), apply=lambda params, x: fn(x))


def _init_all(mods: Sequence[Module]):
    def init(generator: torch.Generator, device) -> Params:
        return tuple(m.init(generator, device) for m in mods)

    return init


def sequential(*mods: Module) -> Module:
    """Composition. Params = tuple per layer."""

    def apply(params: Params, x: Any) -> Any:
        for m, p in zip(mods, params):
            x = m.apply(p, x)
        return x

    return Module(_init_all(mods), apply)


def parallel(*mods: Module) -> Module:
    """Fan-out: same input to every branch, list of outputs."""

    def apply(params: Params, x: Any) -> Any:
        return [m.apply(p, x) for m, p in zip(mods, params)]

    return Module(_init_all(mods), apply)


def zip_modules(*mods: Module) -> Module:
    """Per-input branch: i-th module applied to i-th input."""

    def apply(params: Params, xs: Sequence[Any]) -> Any:
        if len(xs) != len(mods):
            raise ValueError(f"zip_modules expects {len(mods)} inputs, got {len(xs)}")
        return [m.apply(p, x) for m, p, x in zip(mods, params, xs)]

    return Module(_init_all(mods), apply)


def add_inputs() -> Module:
    """Sum a list of inputs."""
    return Module(
        init=lambda generator, device: (),
        apply=lambda params, xs: sum(xs[1:], start=xs[0]),
    )


def constant_zero() -> Module:
    """The reference's ``lambda _: 0.`` aux placeholder."""
    return Module(init=lambda generator, device: (), apply=lambda params, x: 0.0)
