"""Target-distribution interface (counterpart of ``l2hmc_tpu/targets/base.py``).

A target is a frozen dataclass holding numpy constants with batched torch
functions:

  - ``energy(x)``            : (n, dim) -> (n,) unnormalized negative log-density
  - ``grad_energy(x)``       : (n, dim) -> (n, dim), analytic where the target
                               gives one, else autograd of the summed energy
  - ``log_density(x)``       : (n, dim) -> (n,) normalized where tractable
  - ``sample(generator, n)`` : exact sampler driven by a ``torch.Generator``
"""

from __future__ import annotations

import abc
from typing import Callable

import torch


class Target(abc.ABC):
    """Analytic target distribution."""

    dim: int

    @abc.abstractmethod
    def energy(self, x: torch.Tensor) -> torch.Tensor:
        """Batched unnormalized energy, shape (n, dim) -> (n,)."""

    @abc.abstractmethod
    def sample(self, generator: torch.Generator, n: int, device=None) -> torch.Tensor:
        """Exact sampler, shape (n, dim)."""

    def log_density(self, x: torch.Tensor) -> torch.Tensor:
        """Normalized log-density where tractable; default raises."""
        raise NotImplementedError(
            f"{type(self).__name__} has no tractable normalized log-density"
        )

    def grad_energy(self, x: torch.Tensor) -> torch.Tensor:
        """Per-row energy gradient via autograd (rows are independent)."""
        return batched_grad(self.energy)(x)


def batched_grad(energy: Callable[..., torch.Tensor]) -> Callable[..., torch.Tensor]:
    """Per-row gradient of a batched row-independent energy: the gradient of
    the sum equals the stacked per-row gradients, so one backward pass serves
    the whole batch. Where autograd is on and ``x`` carries a gradient, the
    result stays differentiable (a training loss differentiates through the
    trajectory's gradient calls); otherwise it is detached."""

    def grad_fn(x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        if torch.is_grad_enabled() and x.requires_grad:
            (g,) = torch.autograd.grad(energy(x, *args, **kwargs).sum(), x, create_graph=True)
            return g
        with torch.enable_grad():
            y = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(energy(y, *args, **kwargs).sum(), y)
        return g

    return grad_fn
