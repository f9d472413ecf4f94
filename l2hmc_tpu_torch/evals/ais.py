"""Annealed importance sampling (counterpart of ``l2hmc_tpu/evals/ais.py``;
Wu et al. 2016).

One annealed-HMC loop: per inverse temperature beta a plain leapfrog
trajectory at the interpolated energy, the importance-weight update before
the transition, and an MH accept with momentum flip on rejection.
Randomness comes from an explicit ``torch.Generator`` or from injected
draws (``init_v`` and ``draws(step) -> (normals (n, d), uniforms (n,))``),
which is how the tests hold it against the JAX package on the same numbers.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from l2hmc_tpu_torch.mcmc.sampler import _uniform, normal_like
from l2hmc_tpu_torch.targets.base import batched_grad

EnergyFn = Callable[..., torch.Tensor]


def _with_aux(fn: EnergyFn, aux) -> EnergyFn:
    return fn if aux is None else (lambda z: fn(z, aux=aux))


def _leapfrog(
    energy: EnergyFn, x, v, eps: float, T: int, aux=None,
    grad_energy: Optional[EnergyFn] = None,
):
    """Plain leapfrog (the HMC-mode reduction of the augmented integrator).
    The gradient is ``grad_energy`` or autograd of ``energy``; the gradient
    at the end of one step is reused as the first of the next (the same
    point, so the same value)."""
    grad = _with_aux(grad_energy if grad_energy is not None else batched_grad(energy), aux)
    g = grad(x)
    for _ in range(T):
        v = v - 0.5 * eps * g
        x = x + eps * v
        g = grad(x)
        v = v - 0.5 * eps * g
    return x, v


def anneal_schedule(anneal_steps: int) -> np.ndarray:
    """beta = linspace(0, 1, anneal_steps + 1)[1:] in float32."""
    return np.linspace(0.0, 1.0, anneal_steps + 1, dtype=np.float32)[1:]


def logmeanexp(z: torch.Tensor, dim: int = 0) -> torch.Tensor:
    return torch.logsumexp(z, dim=dim) - math.log(z.shape[dim])


def ais_estimate(
    generator: Optional[torch.Generator],
    init_energy: EnergyFn,
    final_energy: EnergyFn,
    anneal_steps: int,
    initial_x: torch.Tensor,
    *,
    aux=None,
    step_size: float = 0.5,
    leapfrogs: int = 25,
    num_splits: int = 1,
    refresh: bool = False,
    refreshment: float = 0.1,
    init_grad: Optional[EnergyFn] = None,
    final_grad: Optional[EnergyFn] = None,
    init_v: Optional[torch.Tensor] = None,
    draws: Optional[Callable] = None,
):
    """Estimate log Z_final / Z_init by annealing from ``init_energy`` to
    ``final_energy`` (which takes ``aux=`` when ``aux`` is given).

    Schedule: beta = linspace(0, 1, anneal_steps + 1)[1:], with the weight
    update w += (beta[1] - beta[0]) * (E_init - E_final)(x) evaluated
    before each transition. With both ``init_grad`` and ``final_grad`` the
    leapfrog uses them; otherwise autograd of the interpolated energy.

    Returns (log estimate, mean acceptance probability). With
    ``num_splits > 1`` the chains are split into consecutive groups and the
    per-group logmeanexp estimates are summed (one group per datapoint in
    the VAE protocol).
    """
    x = initial_x
    n = x.shape[0]
    beta = anneal_schedule(anneal_steps)
    beta_diff = float(beta[1] - beta[0] if anneal_steps > 1 else beta[0])
    beta = beta.tolist()
    fe = _with_aux(final_energy, aux)
    analytic = init_grad is not None and final_grad is not None
    fg = _with_aux(final_grad, aux) if analytic else None

    if refresh:
        v = normal_like(generator, x) if init_v is None else init_v
    w = torch.zeros(n, dtype=x.dtype, device=x.device)
    px_sum = torch.zeros_like(w)
    for i, b in enumerate(beta):
        if draws is not None:
            xi, u = draws(i)
        else:
            xi, u = normal_like(generator, x), None
        v_ref = (
            v * math.sqrt(1.0 - refreshment) + xi * math.sqrt(refreshment)
            if refresh else xi
        )
        w = w + beta_diff * (init_energy(x) - fe(x))

        def curr_energy(z, b=b):
            return (1.0 - b) * init_energy(z) + b * fe(z)

        curr_grad = None
        if analytic:
            def curr_grad(z, b=b):
                return (1.0 - b) * init_grad(z) + b * fg(z)

        X, V = _leapfrog(curr_energy, x, v_ref, step_size, leapfrogs, grad_energy=curr_grad)
        h0 = curr_energy(x) + 0.5 * torch.sum(v_ref * v_ref, dim=1)
        h1 = curr_energy(X) + 0.5 * torch.sum(V * V, dim=1)
        px = torch.exp(torch.clamp(h0 - h1, max=0.0))
        px = torch.where(torch.isfinite(px), px, torch.zeros_like(px))
        if u is None:
            u = _uniform(generator, px.shape, px)
        acc = (px - u >= 0.0)[:, None]
        x = torch.where(acc, X, x)
        v = torch.where(acc, V, -V)
        px_sum = px_sum + px

    avg_accept = torch.mean(px_sum) / anneal_steps
    if num_splits == 1:
        return logmeanexp(w), avg_accept
    if n % num_splits != 0:
        raise ValueError(f"{n} chains do not split into {num_splits} groups")
    return torch.sum(logmeanexp(w.reshape(num_splits, -1), dim=1)), avg_accept


def standard_normal_energy(z: torch.Tensor) -> torch.Tensor:
    """E(z) = 0.5 ||z||^2, the N(0, I) AIS prior."""
    return 0.5 * torch.sum(z * z, dim=1)


def standard_normal_grad(z: torch.Tensor) -> torch.Tensor:
    """Gradient of :func:`standard_normal_energy`."""
    return z
