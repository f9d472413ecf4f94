"""The 2-D phi^4 lattice field theory target (counterpart of
``l2hmc_tpu/targets/lattice.py``).

A scalar field on an L x L periodic lattice, flattened to (n, L*L) with site
r*L + c:

    S(phi) = sum_x [ 0.5 * sum_mu (phi(x+mu) - phi(x))^2
                     + 0.5 m^2 phi(x)^2 + lam * phi(x)^4 ]

The kinetic term is computed with ``torch.roll`` shifts of the (n, L, L)
field, as the JAX package's ``jnp.roll``. In the broken phase (m^2 < 0,
lam > 0) each site's potential is a double well and the magnetization has
two modes: the mode-hopping benchmark. The gradient is analytic.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from l2hmc_tpu_torch.config import resolve_device
from l2hmc_tpu_torch.targets.base import Target


@dataclasses.dataclass(frozen=True)
class Phi4Lattice(Target):
    """2-D phi^4 scalar lattice. State is flattened (n, L*L)."""

    L: int = 16
    m2: float = -4.0  # bare mass squared (negative: broken phase)
    lam: float = 1.0  # quartic coupling

    def __post_init__(self):
        object.__setattr__(self, "dim", self.L * self.L)

    def _field(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[0], self.L, self.L)

    def energy(self, x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        phi = self._field(x)
        kin = 0.0
        for axis in (1, 2):
            dphi = torch.roll(phi, -1, dims=axis) - phi
            kin = kin + 0.5 * torch.sum(torch.square(dphi), dim=(1, 2))
        pot = torch.sum(0.5 * self.m2 * torch.square(phi) + self.lam * phi**4, dim=(1, 2))
        return kin + pot

    def grad_energy(self, x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        """4 phi - (right + left + down + up) + m^2 phi + 4 lam phi^3, what
        autograd of ``energy`` gives."""
        phi = self._field(x)
        nbrs = (torch.roll(phi, -1, dims=2) + torch.roll(phi, 1, dims=2)
                + torch.roll(phi, -1, dims=1) + torch.roll(phi, 1, dims=1))
        g = 4.0 * phi - nbrs + self.m2 * phi + (4.0 * self.lam) * phi**3
        return g.reshape(x.shape)

    def sample(self, generator: torch.Generator, n: int, device=None) -> torch.Tensor:
        """Hot start near the broken-phase minima +-v, v = sqrt(-m2/(4 lam)):
        a random sign per chain plus 0.3 N(0, 1) per site (exact sampling is
        intractable; this seeds chains in both modes). Drawn on the
        generator's device, then moved."""
        v = math.sqrt(-self.m2 / (4.0 * self.lam)) if self.m2 < 0 else 0.0
        gd = generator.device
        sign = torch.where(torch.rand((n, 1), generator=generator, device=gd) < 0.5, 1.0, -1.0)
        noise = 0.3 * torch.randn((n, self.dim), generator=generator, dtype=torch.float32,
                                  device=gd)
        return (sign * v + noise).to(resolve_device(device))

    # -- observables ---------------------------------------------------------

    def magnetization(self, x: torch.Tensor) -> torch.Tensor:
        """Per-chain mean field, (n,)."""
        return torch.mean(x, dim=1)

    def susceptibility(self, traces_m: torch.Tensor) -> torch.Tensor:
        """chi = V * (<m^2> - <|m|>^2) over a magnetization trace."""
        return self.dim * (torch.mean(torch.square(traces_m))
                           - torch.square(torch.mean(torch.abs(traces_m))))
