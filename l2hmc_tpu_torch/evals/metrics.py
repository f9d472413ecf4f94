"""Sampler-quality metrics: autocovariance, ACL spectrum, ESS, and the small
helpers beside them (counterpart of ``l2hmc_tpu/evals/metrics.py``). They
run on the trace's own device; a (T, N, D) trace on the card stays there."""

from __future__ import annotations

import numpy as np
import torch


def autocovariance(X: torch.Tensor, tau: int = 0) -> torch.Tensor:
    """Mean over t of sum_{n,d} X[t]·X[t+tau] / N for a (T, N, D) trace."""
    dT, dN, _ = X.shape
    s = torch.sum(X[: dT - tau] * X[tau:dT], dim=(1, 2)) / dN
    return torch.mean(s)


def acl_spectrum(X: torch.Tensor, scale, max_lag: int | None = None) -> torch.Tensor:
    """Autocovariance at lags 0..max_lag-1 of X/scale (default: all n-1
    lags), one lag at a time so memory stays at one trace."""
    X = torch.as_tensor(X) / scale
    dT = X.shape[0]
    L = dT - 1 if max_lag is None else max_lag
    return torch.stack([autocovariance(X, tau) for tau in range(L)])


def ess(spectrum: torch.Tensor, threshold: float = 0.05) -> torch.Tensor:
    """ESS = 1 / (1 + 2 * sum_{t>=1} rho_t * 1[rho_t > threshold])."""
    A = spectrum * (spectrum > threshold)
    return 1.0 / (1.0 + 2.0 * torch.sum(A[1:]))


def ess_per_step(X: torch.Tensor, scale, max_lag: int | None = None) -> torch.Tensor:
    """Trace tensor -> ESS per MH step."""
    return ess(acl_spectrum(X, scale, max_lag))


def accept_numpy(x_i: np.ndarray, x_p: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Host-side MH accept with numpy's global generator."""
    assert x_i.shape == x_p.shape
    u = np.random.uniform(size=(x_i.shape[0],))
    m = (p - u >= 0).astype(np.int32)[:, None]
    return x_i * (1 - m) + x_p * m


def normal_kl(q_means, q_stddevs, p_means, p_stddevs) -> torch.Tensor:
    """KL(N(q) || N(p)) summed over the last axis; the p side may be plain
    numbers."""
    p_means = torch.as_tensor(p_means, dtype=q_means.dtype, device=q_means.device)
    p_stddevs = torch.as_tensor(p_stddevs, dtype=q_means.dtype, device=q_means.device)
    q_entropy = 0.5 + torch.log(q_stddevs)
    cross = 0.5 * torch.square(q_stddevs / p_stddevs)
    cross = cross + 0.5 * torch.square((q_means - p_means) / p_stddevs)
    cross = cross + torch.log(p_stddevs)
    return torch.sum(-q_entropy + cross, dim=-1)


def gaussian_log_likelihood(x, target) -> float:
    """Mean log-density of samples under a Gaussian target."""
    return float(torch.mean(target.log_density(torch.as_tensor(x))))


def numerical_jacobian(fn, x: torch.Tensor) -> torch.Tensor:
    """Dense Jacobian of a single-row map (the log-det tests' oracle)."""
    return torch.autograd.functional.jacobian(fn, x)
