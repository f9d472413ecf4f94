"""The phi^4 lattice target and the lattice conv S/T/Q nets on the CPU: the
port against the JAX package on numpy-seeded inputs and converted params,
in float32, and the JAX tests' properties (periodic boundaries, the Z2
symmetry, translation equivariance, the hot start's two modes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from l2hmc_tpu import nets as jnets
from l2hmc_tpu.targets.lattice import Phi4Lattice as JaxPhi4Lattice
from l2hmc_tpu.train import ScgConfig as JaxScgConfig
from l2hmc_tpu.train import build_dynamics as jax_build_dynamics
from l2hmc_tpu_torch import nets, targets
from l2hmc_tpu_torch.convert import params_from_jax
from l2hmc_tpu_torch.train import ScgConfig, build_dynamics

# (L, m2, lam): the JAX test's broken phase (tests/test_fused_dynamics.py:87)
# and the app's couplings at L = 8
LATTICES = [(4, -4.0, 1.0), (8, -1.0, 0.5)]


def _field(L, n=6, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal((n, L * L))).astype(np.float32)


def _roll_flat(x, shift, L):
    """Translate a flattened (n, L*L) field by (shift, shift) sites."""
    n = x.shape[0]
    return torch.roll(x.reshape(n, L, L), (shift, shift), dims=(1, 2)).reshape(n, L * L)


@pytest.mark.parametrize("L,m2,lam", LATTICES)
def test_energy_and_gradient_match_jax(L, m2, lam):
    """Energy against the JAX target's in float32 (1e-5 relative), the
    analytic gradient against ``jax.grad`` of it (1e-5 of the largest)."""
    x = _field(L, scale=1.5)
    jt, tt = JaxPhi4Lattice(L=L, m2=m2, lam=lam), targets.Phi4Lattice(L=L, m2=m2, lam=lam)
    assert tt.dim == jt.dim == L * L
    xj = jnp.asarray(x, jnp.float32)
    ref_e = np.asarray(jt.energy(xj))
    ref_g = np.asarray(jax.grad(lambda a: jnp.sum(jt.energy(a)))(xj))
    np.testing.assert_allclose(tt.energy(torch.tensor(x)).numpy(), ref_e, rtol=1e-5, atol=1e-5)
    got_g = tt.grad_energy(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got_g, ref_g, rtol=0, atol=1e-5 * np.abs(ref_g).max())


@pytest.mark.parametrize("L,m2,lam", LATTICES)
def test_gradient_matches_autograd_in_float64(L, m2, lam):
    t = targets.Phi4Lattice(L=L, m2=m2, lam=lam)
    x = torch.tensor(_field(L, seed=1), dtype=torch.float64, requires_grad=True)
    (ref,) = torch.autograd.grad(t.energy(x).sum(), x)
    torch.testing.assert_close(t.grad_energy(x.detach()), ref, rtol=1e-12, atol=1e-12)


def test_energy_is_invariant_under_shifts_and_sign():
    """Periodic boundaries: the energy is invariant under lattice shifts; the
    Z2 symmetry S(phi) = S(-phi); in the broken phase the uniform vacuum
    +-v has a lower action than phi = 0."""
    t = targets.Phi4Lattice(L=4)
    x = torch.tensor(_field(4, n=3, seed=2))
    shifted = torch.roll(x.reshape(3, 4, 4), (1, 2), dims=(1, 2)).reshape(3, 16)
    torch.testing.assert_close(t.energy(shifted), t.energy(x), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(t.energy(-x), t.energy(x), rtol=0, atol=0)
    t4 = targets.Phi4Lattice(L=4, m2=-4.0, lam=1.0)
    vac = torch.full((1, 16), 1.0)
    assert float(t4.energy(vac)[0]) < float(t4.energy(torch.zeros((1, 16)))[0])


def test_hot_start_covers_both_modes_and_observables_match_jax():
    """The hot start seeds chains near both minima +-v (v = 1 at m2 = -4,
    lam = 1) with 0.3 noise; magnetization and susceptibility are the JAX
    target's."""
    t = targets.Phi4Lattice(L=4, m2=-4.0, lam=1.0)
    x = t.sample(torch.Generator().manual_seed(0), 256, device="cpu")
    m = t.magnetization(x)
    assert x.shape == (256, 16) and x.dtype == torch.float32
    assert (m > 0).any() and (m < 0).any()
    np.testing.assert_allclose(m.abs().numpy(), 1.0, atol=0.3)
    jt = JaxPhi4Lattice(L=4, m2=-4.0, lam=1.0)
    trace = np.random.default_rng(3).standard_normal((50, 8)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(jt.magnetization(jnp.asarray(x.numpy()))), m.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(t.susceptibility(torch.tensor(trace))),
                               float(jt.susceptibility(jnp.asarray(trace))), rtol=1e-5)


def _jax_conv_net(L, factor, channels, lift):
    jnet = jnets.lattice_net_factory(L, factor=factor, channels=channels)
    jp = jnet.init(jax.random.key(3))
    # lift the 0.001 head factor so that S/T/Q are not ~0
    jp = jax.tree_util.tree_map(lambda a: (a + lift).astype(jnp.float32), jp)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    return jnet, jp, params_from_jax(jp, device="cpu")


def test_conv2d_matches_jax_and_the_periodic_stencil():
    """conv2d on converted HWIO params against the JAX module (1e-5), and a
    plus-shaped kernel gives the roll-sum of the four neighbours."""
    mod, jmod = nets.conv2d(3, 5), jnets.conv2d(3, 5)
    jp = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.key(0)))
    jp["b"] = np.linspace(-1, 1, 5).astype(np.float32)
    x = np.random.default_rng(4).standard_normal((2, 6, 6, 3)).astype(np.float32)
    ref = np.asarray(jmod.apply(jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x)))
    got = mod.apply(params_from_jax(jp, device="cpu"), torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    w = np.zeros((3, 3, 1, 1), np.float32)
    for di, dj in ((0, 1), (2, 1), (1, 0), (1, 2)):
        w[di, dj, 0, 0] = 1.0
    img = torch.tensor(x[..., :1])
    out = nets.conv2d(1, 1).apply({"w": torch.tensor(w), "b": torch.zeros(1)}, img)[..., 0]
    im = img[..., 0]
    want = (torch.roll(im, 1, 1) + torch.roll(im, -1, 1) + torch.roll(im, 1, 2)
            + torch.roll(im, -1, 2))
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("L,channels,factor", [(4, 4, 1.0), (8, 8, 2.0)])
def test_conv_stq_outputs_match_jax(L, channels, factor):
    """The conv S/T/Q net on converted params against the JAX net: S, T, Q
    within 1e-5 (3x3 convs of <= 8 channels in another summation order);
    the params tree is the JAX one leaf for leaf."""
    jnet, jp, tp = _jax_conv_net(L, factor, channels, 0.02)
    tnet = nets.lattice_net_factory(L, factor=factor, channels=channels)
    init = tnet.init(torch.Generator().manual_seed(0), "cpu")
    leaves = jax.tree_util.tree_leaves(jp)
    from l2hmc_tpu_torch.train.optim import tree_leaves

    assert [tuple(a.shape) for a in tree_leaves(init)] == [a.shape for a in leaves]
    rng = np.random.default_rng(5)
    a, b = (rng.standard_normal((5, L * L)).astype(np.float32) for _ in range(2))
    t = rng.standard_normal((5, 2)).astype(np.float32)
    ref = jnet.apply(jax.tree_util.tree_map(jnp.asarray, jp),
                     (jnp.asarray(a), jnp.asarray(b), jnp.asarray(t), None))
    out = tnet.apply(tp, (torch.tensor(a), torch.tensor(b), torch.tensor(t), None))
    for o, r in zip(out, ref):
        assert o.shape == (5, L * L)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


def test_conv_stq_translation_equivariance():
    """Translating both field inputs translates S, T and Q the same way (the
    dense net has no such property)."""
    L = 8
    tnet = nets.lattice_net_factory(L, factor=2.0, channels=8)
    params = tnet.init(torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    x, gr = torch.randn((4, L * L), generator=g), torch.randn((4, L * L), generator=g)
    t = torch.tensor([[np.cos(0.3), np.sin(0.3)]], dtype=torch.float32).repeat(4, 1)
    out = tnet.apply(params, (x, gr, t, None))
    out_shift = tnet.apply(params, (_roll_flat(x, 3, L), _roll_flat(gr, 3, L), t, None))
    for a, b in zip(out, out_shift):
        torch.testing.assert_close(_roll_flat(a, 3, L), b, rtol=1e-5, atol=1e-6)


def test_conv_init_keeps_heads_small():
    """The 0.001 head factor keeps the initial S and T near zero, as the
    JAX test asserts."""
    tnet = nets.lattice_net_factory(4, factor=1.0, channels=4)
    params = tnet.init(torch.Generator().manual_seed(0), "cpu")
    x = torch.randn((3, 16), generator=torch.Generator().manual_seed(1))
    s, t, q = tnet.apply(params, (x, x, torch.zeros((3, 2)), None))
    assert s.shape == t.shape == q.shape == (3, 16)
    assert float(s.abs().max()) < 0.1 and float(t.abs().max()) < 0.1


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_conv_dynamics_trajectory_matches_jax(direction):
    """``build_dynamics`` with ``net_type="conv"`` at L = 4 (the JAX test's
    fixture): the trajectory on converted, lifted params against the JAX
    package's, 2e-4; forward then backward inverts."""
    jt, tt = JaxPhi4Lattice(L=4, m2=-1.0, lam=0.5), targets.Phi4Lattice(L=4, m2=-1.0, lam=0.5)
    kw = dict(dim=16, n_chains=32, T=3, net_type="conv", conv_channels=4, eps=0.05)
    jd, _ = jax_build_dynamics(JaxScgConfig(**kw), jt)
    td, _ = build_dynamics(ScgConfig(**kw), tt)
    jp = jd.init_params(jax.random.key(0), eps=0.05)
    jp = jax.tree_util.tree_map(lambda a: (a + 0.02 * jnp.ones_like(a) if a.ndim >= 1 else a)
                                .astype(jnp.float32), jp)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    tp = params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(6)
    x, v = (rng.standard_normal((32, 16)).astype(np.float32) for _ in range(2))
    ref = getattr(jd, direction)(jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x),
                                 jnp.asarray(v))
    got = getattr(td, direction)(tp, torch.tensor(x), torch.tensor(v))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), rtol=2e-4, atol=2e-4)
    inverse = "backward" if direction == "forward" else "forward"
    x2, v2, ld2 = getattr(td, inverse)(tp, *got[:2])
    torch.testing.assert_close(x2, torch.tensor(x), rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(ld2 + got[2], torch.zeros(32), rtol=0, atol=1e-4)


def test_build_dynamics_net_type_errors():
    """JAX's errors: conv needs a square dim, an unknown type is refused;
    fused training refuses conv nets."""
    from l2hmc_tpu_torch.train import train

    with pytest.raises(ValueError, match="square lattice"):
        build_dynamics(ScgConfig(dim=10, net_type="conv"), targets.Phi4Lattice(L=4))
    with pytest.raises(ValueError, match="net_type"):
        build_dynamics(ScgConfig(dim=4, net_type="mlpx"))
    with pytest.raises(ValueError, match="dense"):
        train(ScgConfig(dim=16, n_chains=4, n_steps=1, net_type="conv", fused_train=True),
              targets.Phi4Lattice(L=4), device="cpu")
