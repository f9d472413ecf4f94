"""Port's S/T/Q nets vs the JAX package's, on converted params (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu import nets as jnets
from l2hmc_tpu_torch import nets
from l2hmc_tpu_torch.convert import params_from_jax


def _tree_paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _tree_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (tuple, list)):
        if not tree:
            return [prefix + ("()",)]
        return [p for i, v in enumerate(tree) for p in _tree_paths(v, prefix + (i,))]
    return [prefix + (tuple(np.shape(tree)),)]


@pytest.mark.parametrize("dim,hidden,factor", [(2, 10, 1.0), (5, 7, 2.0)])
def test_stq_net_forward_matches_jax(dim, hidden, factor):
    """Same params, same inputs -> same S/T/Q, atol 1e-6 (float32 products
    of width <= 10 in another summation order)."""
    jnet = jnets.scg_net_factory(dim, factor=factor, hidden=hidden)
    jp = jnet.init(jax.random.key(3))
    # lift the 0.001 output factor so S/T/Q are O(0.1-1), not ~0
    jp = jax.tree_util.tree_map(lambda a: a + 0.03 * jnp.ones_like(a), jp)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    n = 64
    a = rng.standard_normal((n, dim)).astype(np.float32)
    b = rng.standard_normal((n, dim)).astype(np.float32)
    t = rng.standard_normal((n, 2)).astype(np.float32)
    ref = jnet.apply(jp, [jnp.asarray(a), jnp.asarray(b), jnp.asarray(t), None])
    tnet = nets.scg_net_factory(dim, factor=factor, hidden=hidden)
    out = tnet.apply(tp, [torch.tensor(a), torch.tensor(b), torch.tensor(t), None])
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=1e-6)


def test_params_tree_matches_jax_structure():
    """Port init gives the JAX params tree path for path, shape for shape,
    which is what params_from_jax and _extract_net rely on."""
    jp = jnets.scg_net_factory(2, factor=2.0).init(jax.random.key(0))
    tp = nets.scg_net_factory(2, factor=2.0).init(torch.Generator().manual_seed(0), "cpu")
    assert _tree_paths(tp) == _tree_paths(jax.tree_util.tree_map(np.asarray, jp))


@pytest.mark.parametrize("factor", [1.0, 1.0 / 3, 0.001])
def test_linear_init_statistics(factor):
    """Variance-scaling truncated normal (PARITY C3): std sqrt(2*factor /
    fan_in), truncated at two standard deviations of the untruncated
    normal, zero bias; the same statistics as the JAX initializer. The
    std tolerance (3%) is ~6 standard errors at 40k draws."""
    fan_in, fan_out = 200, 200
    lin = nets.linear(fan_in, fan_out, factor=factor)
    p = lin.init(torch.Generator().manual_seed(0), "cpu")
    w = p["w"].numpy()
    want = np.sqrt(2.0 * factor / fan_in)
    assert abs(w.std() / want - 1.0) < 0.03
    assert np.abs(w).max() <= 2.0 * want / 0.87962566103423978 + 1e-9
    assert np.all(p["b"].numpy() == 0.0)
    jw = np.asarray(
        jnets.linear(fan_in, fan_out, factor=factor).init(jax.random.key(0))["w"]
    )
    assert abs(w.std() / jw.std() - 1.0) < 0.04


def test_init_reproducible_from_generator_seed():
    net = nets.scg_net_factory(2, factor=1.0)
    a = net.init(torch.Generator().manual_seed(5), "cpu")
    b = net.init(torch.Generator().manual_seed(5), "cpu")
    torch.testing.assert_close(a[0][0]["w"], b[0][0]["w"], rtol=0, atol=0)


def test_combinators():
    lin = nets.linear(3, 4)
    p = lin.init(torch.Generator().manual_seed(0), "cpu")
    x = torch.ones(2, 3)
    par = nets.parallel(lin, lin)
    outs = par.apply((p, p), x)
    torch.testing.assert_close(outs[0], outs[1])
    z = nets.zip_modules(lin, nets.constant_zero())
    o = z.apply((p, ()), [x, None])
    assert o[1] == 0.0
    s = nets.add_inputs().apply((), [x, x, 0.0])
    torch.testing.assert_close(s, 2 * x)
    st = nets.scale_tanh(3)
    sp = st.init(torch.Generator(), "cpu")
    torch.testing.assert_close(st.apply(sp, x), torch.tanh(x))
    with pytest.raises(ValueError):
        z.apply((p, ()), [x])
