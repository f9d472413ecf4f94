"""Gaussian funnel target (counterpart of ``l2hmc_tpu/targets/funnel.py``).

x[:, 0] = v, x[:, 1:] | v ~ N(0, e^v I). The energy clamps v to
[-clip, clip] before the exp, which keeps gradients finite deep in the
neck, and its value equals the reference's clipped energy."""

from __future__ import annotations

import dataclasses
import math

import torch

from l2hmc_tpu_torch.config import resolve_device
from l2hmc_tpu_torch.targets.base import Target


@dataclasses.dataclass(frozen=True)
class GaussianFunnel(Target):
    """Funnel with the clipped energy; the gradient is analytic."""

    dim: int = 2
    sigma: float = 2.0

    @property
    def clip(self) -> float:
        return 4.0 * self.sigma

    def energy(self, x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        v = x[:, 0]
        log_p_v = torch.square(v / self.sigma)
        sum_sq = torch.sum(torch.square(x[:, 1:]), dim=1)
        n = float(self.dim - 1)
        s = torch.exp(torch.clamp(v, -self.clip, self.clip))
        return 0.5 * (log_p_v + sum_sq / s + n * torch.log(2.0 * math.pi * s))

    def grad_energy(self, x: torch.Tensor) -> torch.Tensor:
        """The gradient of ``energy``: the v-part goes through the clamp only
        strictly inside (-clip, clip), the neck's is x_i e^-w."""
        v = x[:, :1]
        w = torch.clamp(v, -self.clip, self.clip)
        inv_s = torch.exp(-w)
        inside = ((v > -self.clip) & (v < self.clip)).to(x.dtype)
        sum_sq = torch.sum(torch.square(x[:, 1:]), dim=1, keepdim=True)
        g_v = (v / self.sigma) / self.sigma + 0.5 * inside * (
            float(self.dim - 1) - sum_sq * inv_s)
        return torch.cat([g_v, x[:, 1:] * inv_s], dim=1)

    def sample(self, generator: torch.Generator, n: int, device=None) -> torch.Tensor:
        """Exact draws: v = sigma z0, the neck s z with s = exp(v / 2); made on
        the generator's device and then moved."""
        gdev = generator.device
        v = self.sigma * torch.randn((n, 1), generator=generator, dtype=torch.float32,
                                     device=gdev)
        rest = torch.exp(v / 2.0) * torch.randn((n, self.dim - 1), generator=generator,
                                                dtype=torch.float32, device=gdev)
        return torch.cat([v, rest], dim=1).to(resolve_device(device))

    def log_density(self, x: torch.Tensor) -> torch.Tensor:
        """Unnormalised: -energy."""
        return -self.energy(x)

    def net_input_transform(self):
        """The state-conditioned net-input features (``Dynamics.net_input_fn``):
        x-like inputs become [v, x[1:] exp(-v/2)], energy-gradient inputs
        [g0, g[1:] exp(v/2)], v clipped as in the energy; momentum inputs
        pass through. A fixed function of the substep's own arguments, so
        invertibility and the log-det are untouched."""
        clip = self.clip

        def fn(net: str, inputs: list) -> list:
            def whiten_x(x):
                s = torch.exp(torch.clamp(x[:, :1], -clip, clip) / 2.0)
                return torch.cat([x[:, :1], x[:, 1:] / s], dim=1)

            if net == "vnet":  # inputs: [x, grad_energy, time, aux]
                x, grad = inputs[0], inputs[1]
                s = torch.exp(torch.clamp(x[:, :1], -clip, clip) / 2.0)
                gw = torch.cat([grad[:, :1], grad[:, 1:] * s], dim=1)
                return [whiten_x(x), gw, *inputs[2:]]
            # xnet inputs: [momentum, masked x, time, aux]
            return [inputs[0], whiten_x(inputs[1]), *inputs[2:]]

        return fn
