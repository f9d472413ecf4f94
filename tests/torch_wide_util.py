"""Helpers of the site VJP's factor tests (``test_torch_wide_traj.py``,
``test_torch_wide_specs.py``): the weight cotangents the site-parallel
backward kernel forms from its factors, on the CPU, against the plain VJP
and against the JAX package's backward kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from l2hmc_tpu.ops import fused_dynamics as jfd
from l2hmc_tpu_torch.ops import fused_dynamics as fd


def jax_array_cotangents(jd, jt, jp, a, direction, tile):
    """The cotangents of both nets' 13 kernel arrays (``_extract_net``'s)
    by the JAX package's backward kernel in interpret mode, for the
    cotangents a["cX"], a["cV"], a["cld"] of the trajectory at a["x"],
    a["v"]: (xnet's 13, vnet's 13)."""
    with jax.enable_x64(False):
        jdfd = jfd.differentiable_fused(jd, jt, tile=tile, interpret=True)
        dyn = jdfd.dynamics
        p = jax.tree_util.tree_map(jnp.asarray, jp)
        xs, vs = jfd._net_scales(dyn)
        xw = jfd._extract_net(p["xnet"], dyn.times, xs)
        vw = jfd._extract_net(p["vnet"], dyn.times, vs)
        eps = jfd._eps_col(dyn.eps(p), dyn.dim)
        _, pull = jax.vjp(jdfd._traj(direction == "backward"), xw, vw, eps,
                          jnp.asarray(a["x"]), jnp.asarray(a["v"]))
        dxw, dvw, *_ = pull((jnp.asarray(a["cX"]), jnp.asarray(a["cV"]),
                             jnp.asarray(a["cld"])))
    return [np.asarray(g) for g in dxw], [np.asarray(g) for g in dvw]


def port_inputs(td, tt, tp, a, n=None):
    """The port's kernel inputs on the CPU and the (D, n) states and
    cotangents of a, its first n chains."""
    inp = fd.prepare(td, fd.energy_spec_for_target(tt), tp, "cpu")

    def col(k):
        return torch.tensor(a[k][:n]).T.contiguous()

    dld = torch.tensor(a["cld"][:n])[None, :].contiguous()
    return inp, col("x"), col("v"), col("cX"), col("cV"), dld


def reduced_from_factors(inp, x, v, dX, dV, dld, reverse):
    """The factors the site VJP writes, recorded on the plain route
    (``site_factors_plain``), reduced by ``reduce_factors`` (its plain
    version on the CPU): ([xnet's w1, w2, wh, ws, wt, wq], [vnet's]), the
    flat factors and K."""
    D, H, H2, _ = inp.dims
    flat, K = fd.site_factors_plain(inp, x, v, dX, dV, dld, reverse)
    return fd.reduced_weights(fd.reduce_factors(flat, D, H, H2, K), D, H, H2), flat, K
