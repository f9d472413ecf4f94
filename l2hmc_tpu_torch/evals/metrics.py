"""Sampler-quality metrics: autocovariance, ACL spectrum, ESS
(counterpart of ``l2hmc_tpu/evals/metrics.py``). They run on the trace's own
device; a (T, N, D) trace on the card stays there."""

from __future__ import annotations

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
