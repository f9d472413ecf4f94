"""ESJD-surrogate training losses (counterpart of ``l2hmc_tpu/mcmc/losses.py``).

All losses act on ``loss_vec = sum((X - x)^2, dim=1) * p_accept + 1e-4``:
the expected squared jump distance weighted by the acceptance probability,
floored for the reciprocal terms. States are (n, d), acceptances (n,).
"""

from __future__ import annotations

import math

import torch


def loss_vec(x: torch.Tensor, x_prop: torch.Tensor, p_accept: torch.Tensor) -> torch.Tensor:
    """(n,) ESJD vector."""
    return torch.sum(torch.square(x_prop - x), dim=1) * p_accept + 1e-4


def loss_std(x, x_prop, p_accept) -> torch.Tensor:
    """-E[v]."""
    return -torch.mean(loss_vec(x, x_prop, p_accept))


def loss_inverse(x, x_prop, p_accept) -> torch.Tensor:
    """-1 / E[1/v]."""
    v = loss_vec(x, x_prop, p_accept)
    return -1.0 / torch.mean(1.0 / (v + 1e-4))


def loss_logsumexp(x, x_prop, p_accept) -> torch.Tensor:
    """logmeanexp(-v)."""
    v = loss_vec(x, x_prop, p_accept)
    return torch.logsumexp(-v, dim=0) - math.log(v.shape[0])


def loss_mixed(x, x_prop, p_accept, scale=1.0) -> torch.Tensor:
    """E[1/(v/scale)] - E[v/scale]."""
    v = loss_vec(x, x_prop, p_accept) / scale
    return torch.mean(1.0 / v) - torch.mean(v)


def loss_mixed_per_dim(x, x_prop, p_accept, scale=1.0) -> torch.Tensor:
    """Per-dimension mixed ESJD: with the chain-expected per-dimension jump
    ``v_d = E_n[(X_d - x_d)^2 p] + 1e-4`` the loss is
    ``mean_d[scale / v_d - v_d / scale]``, so a dimension with a small
    expected jump pays the full reciprocal penalty."""
    jump = torch.square(x_prop - x) * p_accept[:, None]
    v_d = torch.mean(jump, dim=0) + 1e-4
    return torch.mean(scale / v_d) - torch.mean(v_d / scale)


def scg_joint_loss(x, lx, px, z, lz, pz, scale: float = 0.1) -> torch.Tensor:
    """The notebook's joint target-chain + burn-in-chain loss
    (SCGExperiment.ipynb cell 9):

      scale*(E[1/v1] + E[1/v2]) - (E[v1] + E[v2])/scale
    """
    v1 = loss_vec(x, lx, px)
    v2 = loss_vec(z, lz, pz)
    return (
        scale * (torch.mean(1.0 / v1) + torch.mean(1.0 / v2))
        - (torch.mean(v1) + torch.mean(v2)) / scale
    )


_REGISTRY = {
    "mixed": loss_mixed,
    "standard": loss_std,
    "inverse": loss_inverse,
    "logsumexp": loss_logsumexp,
}


def get_loss(name: str):
    """Loss by name: mixed, standard, inverse or logsumexp."""
    return _REGISTRY[name]
