"""Rough well target (counterpart of ``l2hmc_tpu/targets/rough_well.py``)."""

from __future__ import annotations

import dataclasses

import torch

from l2hmc_tpu_torch.config import resolve_device
from l2hmc_tpu_torch.targets.base import Target


@dataclasses.dataclass(frozen=True)
class RoughWell(Target):
    """Quadratic well perturbed by a high-frequency cosine:

    energy(x) = 0.5 ||x||^2 + eps * sum(cos(x / freq)),

    freq = eps^2 (hard mode) or eps (easy mode). For small eps the marginal
    is about N(0, I), which is what the exact sampler returns. The gradient
    is analytic."""

    dim: int
    eps: float
    easy: bool = False

    @property
    def freq(self) -> float:
        return self.eps if self.easy else self.eps * self.eps

    def energy(self, x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        n = torch.sum(torch.square(x), dim=1)
        return 0.5 * n + self.eps * torch.sum(torch.cos(x / self.freq), dim=1)

    def grad_energy(self, x: torch.Tensor) -> torch.Tensor:
        """x - (eps / freq) sin(x / freq), what autograd of ``energy`` gives."""
        return x - (self.eps / self.freq) * torch.sin(x / self.freq)

    def sample(self, generator: torch.Generator, n: int, device=None) -> torch.Tensor:
        """N(0, I) draws, made on the generator's device and then moved."""
        return torch.randn((n, self.dim), generator=generator, dtype=torch.float32,
                           device=generator.device).to(resolve_device(device))
