"""Gaussian-family targets (counterpart of ``l2hmc_tpu/targets/gaussian.py``).

Energies are torch functions on (n, dim) tensors; the constants live as numpy
float64 and are cast to the input's device and dtype on first use (one copy
per device, kept for later calls). The gradient is analytic.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from l2hmc_tpu_torch.config import resolve_device
from l2hmc_tpu_torch.targets.base import Target


def quadratic_form(x: torch.Tensor, mu: torch.Tensor, prec: torch.Tensor) -> torch.Tensor:
    """0.5 * (x-mu)^T prec (x-mu), batched: (n,d) -> (n,)."""
    d = x - mu
    return 0.5 * torch.einsum("ni,ij,nj->n", d, prec, d)


@dataclasses.dataclass(frozen=True)
class Gaussian(Target):
    """N(mu, sigma); energy is the exact negative log-density up to a constant."""

    mu: np.ndarray
    sigma: np.ndarray

    def __post_init__(self):
        mu = np.asarray(self.mu, np.float64)
        sigma = np.asarray(self.sigma, np.float64)
        object.__setattr__(self, "mu", mu)
        object.__setattr__(self, "sigma", sigma)
        object.__setattr__(self, "dim", mu.shape[0])
        object.__setattr__(self, "_prec", np.linalg.inv(sigma))
        object.__setattr__(self, "_chol", np.linalg.cholesky(sigma))
        sign, logdet = np.linalg.slogdet(sigma)
        if sign <= 0:
            raise ValueError("covariance must be positive definite")
        object.__setattr__(self, "_logdet_sigma", logdet)
        object.__setattr__(self, "_cache", {})

    def _consts(self, like: torch.Tensor):
        """(mu, prec, symmetric prec, chol^T) on ``like``'s device and dtype."""
        key = (like.device, like.dtype)
        c = self._cache.get(key)
        if c is None:
            sym = 0.5 * (self._prec + self._prec.T)
            c = tuple(
                torch.as_tensor(a, dtype=like.dtype, device=like.device)
                for a in (self.mu, self._prec, sym, self._chol.T)
            )
            self._cache[key] = c
        return c

    def energy(self, x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        mu, prec, _, _ = self._consts(x)
        return quadratic_form(x, mu, prec)

    def grad_energy(self, x: torch.Tensor) -> torch.Tensor:
        """Analytic gradient 0.5 (P + P^T)(x - mu), what autograd of
        ``energy`` gives."""
        mu, _, sym, _ = self._consts(x)
        return (x - mu) @ sym

    def log_density(self, x: torch.Tensor) -> torch.Tensor:
        const = 0.5 * (self.dim * np.log(2.0 * np.pi) + self._logdet_sigma)
        return -self.energy(x) - const

    def sample(self, generator: torch.Generator, n: int, device=None) -> torch.Tensor:
        """Exact draws. The normals come from ``generator`` on its own device
        and are then moved, so a seed gives the same draws on any device."""
        dev = resolve_device(device)
        z = torch.randn(
            (n, self.dim), generator=generator, dtype=torch.float32,
            device=generator.device,
        ).to(dev)
        mu, _, _, chol_t = self._consts(z)
        return z @ chol_t + mu


def scg_gaussian() -> Gaussian:
    """The 2-D strongly-correlated Gaussian of SCGExperiment.ipynb cell 5."""
    cov = np.array([[50.05, -49.95], [-49.95, 50.05]])
    return Gaussian(np.zeros(2), cov)


def random_tilted_gaussian(
    seed: int, dim: int, log_min: float = -2.0, log_max: float = 2.0
) -> Gaussian:
    """Random rotation of a log-uniform diagonal covariance, reproducible from
    a numpy seed (the JAX package draws the same law from a JAX key)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((dim, dim))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diag(r))  # Haar-distributed orthogonal
    exps = rng.uniform(log_min, log_max, dim)
    diag = np.diag(np.exp(np.log(10.0) * exps)) + 1e-6 * np.eye(dim)
    sigma = q.T @ diag @ q
    return Gaussian(np.zeros(dim), sigma)


def tilted_gaussian(seed: int, dim: int, log_min: float, log_max: float) -> Gaussian:
    """The reference's TiltedGaussian: the law of ``random_tilted_gaussian``."""
    return random_tilted_gaussian(seed, dim, log_min, log_max)


def ill_conditioned_gaussian(dim: int = 50, log10_cond: float = 2.0) -> Gaussian:
    """Paper's 50-d ill-conditioned Gaussian: diagonal covariance with
    eigenvalues log-spaced over ``log10_cond`` decades (arXiv 1711.09268 S5.1)."""
    diag = np.logspace(-log10_cond / 2.0, log10_cond / 2.0, dim)
    return Gaussian(np.zeros(dim), np.diag(diag))
