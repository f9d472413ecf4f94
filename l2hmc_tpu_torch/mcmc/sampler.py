"""MH sampling machinery: propose / accept / chain composition (counterpart
of ``l2hmc_tpu/mcmc/sampler.py``).

All randomness comes from an explicit ``torch.Generator``; draws are made on
the generator's device and moved to the state's, so a seed gives the same
chain on every device. ``propose`` and ``metropolis`` also take the draws
themselves (momentum, direction and accept uniforms), which is how the
tests hold them against the JAX package on the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch

from l2hmc_tpu_torch.dynamics.core import Dynamics

Params = Any


@dataclasses.dataclass(frozen=True)
class ProposeOut:
    """Outputs of one direction-randomized proposal."""

    x_prop: torch.Tensor  # proposed state, (n, d)
    v_prop: torch.Tensor  # proposed momentum, (n, d)
    p_accept: torch.Tensor  # MH acceptance probability, (n,)
    log_jac: torch.Tensor  # accumulated log-det-Jacobian, (n,)
    x_next: Optional[torch.Tensor] = None  # post-MH state (when do_mh_step)


def _uniform(generator: torch.Generator, shape, like: torch.Tensor) -> torch.Tensor:
    return torch.rand(shape, generator=generator, dtype=like.dtype,
                      device=generator.device).to(like.device)


def normal_like(generator: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    """Standard normals of ``like``'s shape, dtype and device, drawn on the
    generator's device."""
    return torch.randn(like.shape, generator=generator, dtype=like.dtype,
                       device=generator.device).to(like.device)


def metropolis_mask(generator, p_accept: torch.Tensor, u=None) -> torch.Tensor:
    """Boolean accept mask ``p_accept - u >= 0``; ``u`` is drawn when not given."""
    if u is None:
        u = _uniform(generator, p_accept.shape, p_accept)
    return p_accept - u >= 0.0


def metropolis(generator, x, x_prop, p_accept, u=None) -> torch.Tensor:
    """Per-chain accept/reject."""
    return torch.where(metropolis_mask(generator, p_accept, u)[:, None], x_prop, x)


def propose(
    generator: Optional[torch.Generator],
    dynamics: Dynamics,
    params: Params,
    x: torch.Tensor,
    *,
    init_v: Optional[torch.Tensor] = None,
    dir_u: Optional[torch.Tensor] = None,
    accept_u: Optional[torch.Tensor] = None,
    aux=None,
    do_mh_step: bool = False,
) -> ProposeOut:
    """Direction-randomized proposal.

    Per chain: momentum (``init_v`` or a normal draw) and a direction,
    forward where the uniform ``dir_u`` (or a draw) is below 0.5. Both maps
    run for every chain and the results are mixed per chain. In HMC mode
    only the forward map runs. With ``do_mh_step`` the accept uniform is
    ``accept_u`` or a draw. The draws are made in the order momentum,
    direction, accept. ``aux`` goes to the dynamics' energy and nets.
    """
    v = normal_like(generator, x) if init_v is None else init_v

    if dynamics.hmc:
        xf, vf, ljf = dynamics.forward(params, x, v, aux=aux)
        px = dynamics.p_accept(params, x, v, xf, vf, ljf, aux=aux)
        out = ProposeOut(xf, vf, px, ljf)
    else:
        if dir_u is None:
            dir_u = _uniform(generator, (x.shape[0],), x)
        forward_mask = (dir_u < 0.5).to(x.dtype)
        xf, vf, ljf = dynamics.forward(params, x, v, aux=aux)
        xb, vb, ljb = dynamics.backward(params, x, v, aux=aux)
        m = forward_mask[:, None]
        x_prop = m * xf + (1.0 - m) * xb
        v_prop = m * vf + (1.0 - m) * vb
        log_jac = forward_mask * ljf + (1.0 - forward_mask) * ljb
        px = dynamics.p_accept(params, x, v, x_prop, v_prop, log_jac, aux=aux)
        out = ProposeOut(x_prop, v_prop, px, log_jac)

    if do_mh_step:
        out = dataclasses.replace(
            out, x_next=metropolis(generator, x, out.x_prop, out.p_accept, accept_u)
        )
    return out


def chain_operator(
    generator: Optional[torch.Generator],
    dynamics: Dynamics,
    params: Params,
    x: torch.Tensor,
    nb_steps: int,
    max_steps: int,
    *,
    init_v: Optional[torch.Tensor] = None,
    op_v: Optional[Sequence[torch.Tensor]] = None,
    op_dir_u: Optional[Sequence[torch.Tensor]] = None,
    accept_u: Optional[torch.Tensor] = None,
    aux=None,
    do_mh_step: bool = False,
    faithful_momentum: bool = False,
) -> ProposeOut:
    """Compose ``nb_steps`` proposals under a single terminal accept.

    The JAX package scans a static ``max_steps`` bound and masks the ops at
    ``i >= nb_steps``; here the loop simply stops after ``nb_steps`` (at
    most ``max_steps``) ops, which gives the same result.

    Momentum: by default one momentum is threaded through the composed ops,
    so the terminal ``p_accept`` compares Hamiltonians of the composite
    trajectory. With ``faithful_momentum`` every op draws fresh momentum
    and the terminal accept pairs the never-integrated initial draw with
    the last op's output momentum, as the reference implementation
    executes. The draws can be given: ``init_v`` (the initial momentum),
    ``op_v[i]`` (op i's fresh momentum, faithful reading only),
    ``op_dir_u[i]`` (op i's direction uniforms) and ``accept_u``.
    """
    v0 = normal_like(generator, x) if init_v is None else init_v
    cx, cv = x, v0
    log_jac = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for i in range(min(int(nb_steps), max_steps)):
        if faithful_momentum:
            v_i = None if op_v is None else op_v[i]
        else:
            v_i = cv
        out = propose(
            generator, dynamics, params, cx, init_v=v_i,
            dir_u=None if op_dir_u is None else op_dir_u[i], aux=aux,
        )
        cx, cv, log_jac = out.x_prop, out.v_prop, log_jac + out.log_jac
    px = dynamics.p_accept(params, x, v0, cx, cv, log_jac, aux=aux)
    x_next = metropolis(generator, x, cx, px, accept_u) if do_mh_step else None
    return ProposeOut(cx, cv, px, log_jac, x_next)
