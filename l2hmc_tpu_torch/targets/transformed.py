"""Bijector-reparameterised targets (counterpart of
``l2hmc_tpu/targets/transformed.py``): the pullback of a target through an
analytic diffeomorphism x = f(y), p_Y(y) = p_X(f(y)) |det df/dy|. ESS
against raw-space baselines is computed on ``bijector.forward(chain)``."""

from __future__ import annotations

import dataclasses

import torch

from l2hmc_tpu_torch.targets.base import Target


class Bijector:
    """Invertible map ``x = forward(y)`` with per-row ``log|det df/dy|``."""

    def forward(self, y: torch.Tensor) -> torch.Tensor:  # (n, d) -> (n, d)
        raise NotImplementedError

    def inverse(self, x: torch.Tensor) -> torch.Tensor:  # (n, d) -> (n, d)
        raise NotImplementedError

    def forward_log_det(self, y: torch.Tensor) -> torch.Tensor:  # (n, d) -> (n,)
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FunnelWhiten(Bijector):
    """The funnel's whitening map: x[:, 0] = y[:, 0], x[:, 1:] = y[:, 1:]
    exp(v / 2), with v clipped at 4 sigma as the funnel's energy clips it;
    log|det df/dy| = (d - 1) v / 2."""

    dim: int
    sigma: float = 2.0

    @property
    def clip(self) -> float:
        return 4.0 * self.sigma

    def _scale(self, v: torch.Tensor) -> torch.Tensor:
        return torch.exp(torch.clamp(v, -self.clip, self.clip) / 2.0)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        v = y[:, :1]
        return torch.cat([v, y[:, 1:] * self._scale(v)], dim=1)

    def inverse(self, x: torch.Tensor) -> torch.Tensor:
        v = x[:, :1]
        return torch.cat([v, x[:, 1:] / self._scale(v)], dim=1)

    def forward_log_det(self, y: torch.Tensor) -> torch.Tensor:
        v = torch.clamp(y[:, 0], -self.clip, self.clip)
        return (self.dim - 1) * v / 2.0


@dataclasses.dataclass(frozen=True)
class TransformedTarget(Target):
    """Pullback of ``base`` through ``bijector``, the Y-space target:
    energy_Y(y) = energy_X(f(y)) - log|det df/dy|. ``sigma`` is the
    pullback's covariance where it is known in closed form (None
    otherwise). The gradient comes from autograd (``batched_grad``)."""

    base: Target
    bijector: Bijector
    sigma: object = None  # optional (dim, dim) ndarray

    def __post_init__(self):
        object.__setattr__(self, "dim", self.base.dim)

    def energy(self, y: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        x = self.bijector.forward(y)
        return self.base.energy(x, *args, **kwargs) - self.bijector.forward_log_det(y)

    def log_density(self, y: torch.Tensor) -> torch.Tensor:
        return -self.energy(y)

    def sample(self, generator: torch.Generator, n: int, device=None) -> torch.Tensor:
        return self.bijector.inverse(self.base.sample(generator, n, device))
