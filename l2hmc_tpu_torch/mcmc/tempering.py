"""Parallel tempering (replica exchange) over the chain axis (counterpart of
``l2hmc_tpu/mcmc/tempering.py``).

The K temperature rungs ride a leading axis of the state, (K, n, d); rung k
samples exp(-U(x) / temps[k]). Each step makes one direction-randomised
proposal for all rungs at once (``mcmc.propose`` on the K n chains with one
temperature a chain, as the JAX package vmaps it over the rungs), then,
every ``swap_every`` steps, an adjacent-rung swap move with alternating
parity: even parity swaps the pairs (0, 1), (2, 3), ..., odd parity (1, 2),
(3, 4), ..., each with the replica-exchange rule
A = min(1, exp[(beta_k - beta_{k+1}) (U_k - U_{k+1})]). The JAX package has
no kernel here: all of it is plain PyTorch.

Randomness comes from a ``torch.Generator`` in a fixed order (per step, the
K n chains' momenta, direction and accept draws, then the swap uniforms), or
is given (``draws``), which is how the tests hold the port to the JAX
package on the same numbers. Requires a ``Dynamics`` built with
``use_temperature=True``. The JAX functions' ``aux`` is not taken: no
tempered target has one.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from l2hmc_tpu_torch.dynamics.core import Dynamics
from l2hmc_tpu_torch.mcmc.sampler import propose


def geometric_temps(t_max: float, n_rungs: int, device=None) -> torch.Tensor:
    """Geometric float32 ladder 1 = T_0 < ... < T_{K-1} = t_max."""
    if n_rungs < 2:
        return torch.ones((max(n_rungs, 1),), dtype=torch.float32, device=device)
    return torch.logspace(0.0, math.log10(t_max), n_rungs, dtype=torch.float32,
                          device=device)


def swap_step(generator: Optional[torch.Generator], x: torch.Tensor, U: torch.Tensor,
              temps: torch.Tensor, parity, u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One parity-alternating adjacent-rung swap move.

    x: (K, n, d) replica states; U: (K, n) energies at temperature 1; temps:
    (K,); parity 0 or 1. ``u``, the (K-1, n) acceptance uniforms, is drawn
    from ``generator`` when not given. The pairs of one parity are disjoint,
    so the move is one select: rung k takes rung k+1's state where its pair
    swaps from below, rung k-1's where it swaps from above."""
    return _swap(generator, x, U, temps, parity, u)[0]


def _swap(generator, x, U, temps, parity, u):
    """``swap_step``'s new states and its (K-1, n) mask of the pairs that
    swapped."""
    K, n = x.shape[0], x.shape[1]
    beta = 1.0 / temps
    logA = (beta[:-1, None] - beta[1:, None]) * (U[:-1] - U[1:])  # (K-1, n)
    if u is None:
        u = torch.rand(logA.shape, generator=generator, dtype=x.dtype,
                       device=generator.device).to(x.device)
    k_idx = torch.arange(K - 1, device=x.device)
    do = (torch.log(torch.clamp(u, min=1e-38)) < logA) & ((k_idx[:, None] % 2) == parity)
    zero = torch.zeros((1, n), dtype=torch.bool, device=x.device)
    do_up = torch.cat([do, zero])  # rung k trades with k+1
    do_dn = torch.cat([zero, do])  # rung k trades with k-1
    x_up = torch.roll(x, -1, dims=0)
    x_dn = torch.roll(x, 1, dims=0)
    return torch.where(do_up[..., None], x_up, torch.where(do_dn[..., None], x_dn, x)), do


def pt_sample_chain(
    dynamics: Dynamics,
    params,
    x0: torch.Tensor,
    temps,
    n_steps: int,
    generator: Optional[torch.Generator],
    *,
    collect: bool = True,
    swap_every: int = 1,
    draws: Optional[Callable] = None,
    stats: Optional[dict] = None,
):
    """Parallel-tempered MH sampling; returns (x_final (K, n, d), trace): the
    (n_steps, n, d) states of the temperature-1 rung, or with ``collect``
    False the (n_steps,) mean acceptance probability over all rungs.

    A ``stats`` dict, where given, receives "rung_accept", each rung's mean
    acceptance probability over the steps and its chains (K,), and
    "swap_rate", each adjacent pair's share of accepted swaps among the
    swap moves that tried it (K-1,; NaN for a pair never tried).

    ``draws(step)`` optionally gives every random number of a step instead
    of ``generator``: (a list of K (momentum (n, d), direction uniforms (n,)
    or None in HMC mode, accept uniforms (n,)), the swap uniforms (K-1, n)
    or None on a step without a swap move)."""
    if not dynamics.use_temperature:
        raise ValueError("parallel tempering needs use_temperature=True")
    temps = torch.as_tensor(temps, dtype=x0.dtype).to(x0.device)
    K, n, d = x0.shape
    t_chain = temps.repeat_interleave(n)  # rung k's temperature on its n chains

    def energies(x):
        return dynamics.energy(x.reshape(K * n, d)).reshape(K, n)

    def cat(parts):
        return None if parts[0] is None else torch.cat(parts)

    x = x0
    trace = []
    rung_px = torch.zeros(K, dtype=x0.dtype, device=x0.device)
    swaps = torch.zeros(K - 1, dtype=x0.dtype, device=x0.device)
    tries = torch.zeros(K - 1, dtype=x0.dtype, device=x0.device)
    pair_parity = torch.arange(K - 1, device=x0.device) % 2
    with torch.no_grad():
        for step in range(n_steps):
            kw, swap_u = {}, None
            if draws is not None:
                rung_draws, swap_u = draws(step)
                v, u_dir, u_acc = (cat(list(p)) for p in zip(*rung_draws))
                kw = dict(init_v=v, dir_u=u_dir, accept_u=u_acc)
            out = propose(generator, dynamics, params, x.reshape(K * n, d),
                          temperature=t_chain, do_mh_step=True, **kw)
            x = out.x_next.reshape(K, n, d)
            rung_px += out.p_accept.reshape(K, n).mean(dim=1)
            if step % swap_every == 0:
                parity = (step // swap_every) % 2
                x, did = _swap(generator, x, energies(x), temps, parity, swap_u)
                swaps += did.sum(dim=1)
                tries += (pair_parity == parity) * n
            trace.append(x[0] if collect else torch.mean(out.p_accept))
    if stats is not None:
        stats["rung_accept"] = rung_px / max(n_steps, 1)
        stats["swap_rate"] = swaps / tries
    return x, torch.stack(trace)


def pt_hmc_sample_chain(target, eps: float, T: int, x0: torch.Tensor, temps, n_steps: int,
                        generator: torch.Generator, *, draws: Optional[Callable] = None,
                        stats: Optional[dict] = None):
    """Parallel-tempered plain-HMC baseline (cf. ``train.hmc_sample_chain``,
    the reference's utils/notebook_utils.py:25-39, a single rung)."""
    dyn = Dynamics(dim=x0.shape[-1], energy=target.energy, grad_energy=target.grad_energy,
                   T=T, hmc=True, use_temperature=True)
    params = dyn.init_params(generator, eps=eps, device=x0.device)
    return pt_sample_chain(dyn, params, x0, temps, n_steps, generator, draws=draws, stats=stats)
