"""Gaussian-mixture targets (counterpart of ``l2hmc_tpu/targets/gmm.py``):
all components stacked into (k, d) / (k, d, d) arrays, the energy one
batched einsum and a logsumexp."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from l2hmc_tpu_torch.config import resolve_device
from l2hmc_tpu_torch.targets.base import Target


@dataclasses.dataclass(frozen=True)
class GMM(Target):
    """Mixture of Gaussians with full covariances:

    energy(x) = -logsumexp_i [ log pi_i - 0.5 log((2 pi)^d det Sigma_i)
                               - 0.5 (x-mu_i)^T Sigma_i^{-1} (x-mu_i) ].

    The constants live as numpy float64 (``_precs``, ``_chols``,
    ``_log_consts``, as the JAX package holds them) and are cast to the
    input's device and dtype on first use. The gradient is analytic."""

    mus: np.ndarray  # (k, d)
    sigmas: np.ndarray  # (k, d, d)
    pis: np.ndarray  # (k,)

    def __post_init__(self):
        mus = np.asarray(self.mus, np.float64)
        sigmas = np.asarray(self.sigmas, np.float64)
        pis = np.asarray(self.pis, np.float64)
        if mus.ndim != 2 or sigmas.shape != mus.shape + (mus.shape[1],):
            raise ValueError(f"mus (k, d) and sigmas (k, d, d) expected, got "
                             f"{mus.shape} and {sigmas.shape}")
        if pis.shape != (mus.shape[0],):
            raise ValueError(f"pis must have shape ({mus.shape[0]},), got {pis.shape}")
        if abs(pis.sum() - 1.0) >= 1e-8:
            raise ValueError("mixture weights must sum to 1")
        signs, logdets = np.linalg.slogdet(sigmas)
        if not np.all(signs > 0):
            raise ValueError("covariances must be positive definite")
        object.__setattr__(self, "mus", mus)
        object.__setattr__(self, "sigmas", sigmas)
        object.__setattr__(self, "pis", pis)
        object.__setattr__(self, "dim", mus.shape[1])
        object.__setattr__(self, "n_components", mus.shape[0])
        object.__setattr__(self, "_precs", np.linalg.inv(sigmas))
        object.__setattr__(self, "_chols", np.linalg.cholesky(sigmas))
        # log pi_i - 0.5 * (d log 2pi + log det Sigma_i), stacked (k,)
        object.__setattr__(self, "_log_consts", np.log(pis) - 0.5 * (
            mus.shape[1] * np.log(2.0 * np.pi) + logdets))
        object.__setattr__(self, "_cache", {})

    def _consts(self, like: torch.Tensor):
        """(mus, precs, symmetric precs, chols, log consts) on ``like``'s
        device and dtype."""
        key = (like.device, like.dtype)
        c = self._cache.get(key)
        if c is None:
            sym = 0.5 * (self._precs + np.swapaxes(self._precs, 1, 2))
            c = self._cache[key] = tuple(
                torch.as_tensor(a, dtype=like.dtype, device=like.device)
                for a in (self.mus, self._precs, sym, self._chols, self._log_consts))
        return c

    def _log_weights(self, x: torch.Tensor, precs: torch.Tensor):
        mus, _, _, _, log_consts = self._consts(x)
        d = x[:, None, :] - mus[None, :, :]  # (n, k, d)
        quad = 0.5 * torch.einsum("nki,kij,nkj->nk", d, precs, d)
        return log_consts[None, :] - quad, d

    def energy(self, x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        lw, _ = self._log_weights(x, self._consts(x)[1])
        return -torch.logsumexp(lw, dim=1)

    def grad_energy(self, x: torch.Tensor) -> torch.Tensor:
        """sum_k softmax_k 0.5 (P_k + P_k^T)(x - mu_k), what autograd of
        ``energy`` gives."""
        _, precs, sym, _, _ = self._consts(x)
        lw, d = self._log_weights(x, precs)
        w = torch.softmax(lw, dim=1)  # (n, k)
        return torch.einsum("nk,kij,nkj->ni", w, sym, d)

    def log_density(self, x: torch.Tensor) -> torch.Tensor:
        return -self.energy(x)

    def sample(self, generator: torch.Generator, n: int, device=None) -> torch.Tensor:
        """Exact draws: a component per row, then its affine map of a normal;
        both drawn on the generator's device, the result then moved."""
        gdev = generator.device
        comp = torch.multinomial(torch.as_tensor(self.pis, dtype=torch.float64, device=gdev),
                                 n, replacement=True, generator=generator)
        z = torch.randn((n, self.dim), generator=generator, dtype=torch.float32, device=gdev)
        mus, _, _, chols, _ = self._consts(z)
        x = torch.einsum("nij,nj->ni", chols[comp], z) + mus[comp]
        return x.to(resolve_device(device))


def gen_ring(r: float = 1.0, var: float = 1.0, nb_mixtures: int = 2) -> GMM:
    """GMM with means on a circle of radius r."""
    ts = 2.0 * np.pi * np.arange(nb_mixtures) / nb_mixtures
    mus = np.stack([r * np.cos(ts), r * np.sin(ts)], axis=1)
    sigmas = np.stack([var * np.eye(2)] * nb_mixtures)
    pis = np.full((nb_mixtures,), 1.0 / nb_mixtures)
    pis[0] += 1.0 - pis.sum()
    return GMM(mus, sigmas, pis)


def mog2(distance: float = 2.0, var: float = 0.1) -> GMM:
    """Two modes on a line, the paper's MoG benchmark shape."""
    mus = np.array([[distance / 2.0, 0.0], [-distance / 2.0, 0.0]])
    sigmas = np.stack([var * np.eye(2)] * 2)
    return GMM(mus, sigmas, np.array([0.5, 0.5]))
