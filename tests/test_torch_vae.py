"""The VAE model half of the port vs the JAX package at a small size
(latent 8, hidden 32, sampler sizes 16): the same parameters (one JAX init,
converted) and numpy-seeded inputs through both, float32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_vae_util import SMALL, build_pair, inputs

from l2hmc_tpu.apps import data as jdata
from l2hmc_tpu.apps import vae as jvae
from l2hmc_tpu_torch.apps import data as tdata
from l2hmc_tpu_torch.apps import vae as tvae
from l2hmc_tpu_torch.convert import params_from_jax
from l2hmc_tpu_torch.targets.base import batched_grad

N, D = 48, SMALL["latent_dim"]
TOL = dict(rtol=2e-5, atol=2e-5)  # float32 sums in another order


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _aux(jm, jp, tm, tp, x_raw):
    jemb = jm.aux_encoder.apply(jp["smp"]["aux_enc"], jnp.asarray(x_raw))
    temb = tm.aux_encoder.apply(tp["smp"]["aux_enc"], torch.tensor(x_raw))
    jaux = {"raw": jnp.asarray(x_raw), "emb": jemb, "dec": jp["dec"]}
    taux = {"raw": torch.tensor(x_raw), "emb": temb, "dec": tp["dec"]}
    return jaux, taux


def test_config_has_every_field_with_the_same_default():
    jf = {f.name: f.default for f in dataclasses.fields(jvae.VaeConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tvae.VaeConfig)}
    assert jf == tf


@pytest.mark.parametrize("kw", [{"fused_train": True}, {"fused_compute_dtype": "bfloat16"}])
def test_config_raises_for_what_is_not_ported(kw):
    with pytest.raises(NotImplementedError, match="not ported"):
        tvae.VaeConfig(**kw)


@pytest.mark.parametrize("hmc", [False, True])
def test_init_params_tree_has_the_jax_structure(hmc):
    """Leaf for leaf: same nesting, keys, empty tuples and shapes; a seed
    gives the same params twice; init scales follow the factors."""
    jm = jvae.VaeModel.build(jvae.VaeConfig(**SMALL, hmc=hmc))
    tm = tvae.VaeModel.build(tvae.VaeConfig(**SMALL, hmc=hmc))
    jp = _np(jm.init_params(jax.random.key(0)))
    tp = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    tp2 = tm.init_params(torch.Generator().manual_seed(0), device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return tuple(shapes(v) for v in tree)
        return tuple(tree.shape)

    assert shapes(tp) == shapes(jp)
    torch.testing.assert_close(tp["dec"][0]["w"], tp2["dec"][0]["w"], rtol=0, atol=0)
    assert float(tp["smp"]["alpha"]) == pytest.approx(np.log(0.1), rel=1e-6)
    # last decoder layer: factor 0.01, fan-in 32 -> std sqrt(2 * 0.01 / 32)
    assert float(tp["dec"][4]["w"].std()) == pytest.approx(0.025, rel=0.15)
    assert float(tp["dec"][0]["w"].std()) == pytest.approx(0.5, rel=0.15)


def test_params_from_jax_on_the_vae_tree():
    jm, jp, _, tp = build_pair()
    ref = _np(jp)
    assert set(tp) == {"enc", "dec", "smp"}
    assert set(tp["smp"]) == {"alpha", "xnet", "vnet", "aux_enc"}
    assert tp["dec"][1] == () and tp["enc"][3] == () and tp["smp"]["xnet"][0][3] == ()
    assert isinstance(tp["enc"][4], tuple) and len(tp["enc"][4]) == 2
    leaves_t = [l for l in jax.tree_util.tree_leaves(tp)]
    leaves_j = jax.tree_util.tree_leaves(ref)
    assert len(leaves_t) == len(leaves_j)
    for a, b in zip(leaves_t, leaves_j):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b.astype(np.float32))
    with pytest.raises(TypeError, match="float"):
        params_from_jax({"a": np.arange(3)}, device="cpu")


def test_encoder_decoder_and_aux_encoder_match_jax():
    jm, jp, tm, tp = build_pair()
    x_raw, z0 = inputs(N, D)
    jmu, jls = jm.encoder.apply(jp["enc"], jnp.asarray(x_raw))
    tmu, tls = tm.encoder.apply(tp["enc"], torch.tensor(x_raw))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), **TOL)
    np.testing.assert_allclose(tls.numpy(), np.asarray(jls), **TOL)
    np.testing.assert_allclose(
        tm.decoder.apply(tp["dec"], torch.tensor(z0)).numpy(),
        np.asarray(jm.decoder.apply(jp["dec"], jnp.asarray(z0))), **TOL)
    np.testing.assert_allclose(
        tm.aux_encoder.apply(tp["smp"]["aux_enc"], torch.tensor(x_raw)).numpy(),
        np.asarray(jm.aux_encoder.apply(jp["smp"]["aux_enc"], jnp.asarray(x_raw))), **TOL)


@pytest.mark.parametrize("net", ["xnet", "vnet"])
def test_stq_net_with_aux_matches_jax(net):
    """The nets' fourth Zip input is the embedding; S, T, Q to 2e-5, and a
    different embedding gives different outputs."""
    jm, jp, tm, tp = build_pair()
    x_raw, z0 = inputs(N, D)
    jaux, taux = _aux(jm, jp, tm, tp, x_raw)
    rng = np.random.default_rng(2)
    b = rng.standard_normal((N, D)).astype(np.float32)
    t = np.tile(np.array([[0.5, -0.8]], np.float32), (N, 1))
    jout = getattr(jm.dynamics, net).apply(
        jp["smp"][net], [jnp.asarray(z0), jnp.asarray(b), jnp.asarray(t), jaux])
    tout = getattr(tm.dynamics, net).apply(
        tp["smp"][net], [torch.tensor(z0), torch.tensor(b), torch.tensor(t), taux])
    for g, r in zip(tout, jout):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    other = getattr(tm.dynamics, net).apply(
        tp["smp"][net], [torch.tensor(z0), torch.tensor(b), torch.tensor(t),
                         {**taux, "emb": taux["emb"] + 1.0}])
    assert not torch.allclose(other[0], tout[0])


def test_vae_net_factory_matches_jax():
    """``vae_net_factory`` (its own aux encoder as the fourth input)."""
    from l2hmc_tpu.nets import core as jcore
    from l2hmc_tpu.nets.stq import vae_net_factory as jfactory
    from l2hmc_tpu_torch.nets import core as tcore
    from l2hmc_tpu_torch.nets.stq import vae_net_factory as tfactory

    jnet = jfactory(D, 2.0, size1=16, size2=12, aux_encoder=jcore.linear(20, 16))
    tnet = tfactory(D, 2.0, size1=16, size2=12, aux_encoder=tcore.linear(20, 16))
    jp = jnet.init(jax.random.key(0))
    tp = params_from_jax(_np(jp), device="cpu")
    rng = np.random.default_rng(3)
    a, b = (rng.standard_normal((N, D)).astype(np.float32) for _ in range(2))
    t = rng.standard_normal((N, 2)).astype(np.float32)
    aux = rng.standard_normal((N, 20)).astype(np.float32)
    jout = jnet.apply(jp, [jnp.asarray(v) for v in (a, b, t, aux)])
    tout = tnet.apply(tp, [torch.tensor(v) for v in (a, b, t, aux)])
    for g, r in zip(tout, jout):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_posterior_energy_and_its_gradient_match_jax_and_autograd():
    """Energy to 1e-5 relative (values of a few hundred); the analytic
    gradient vs jax.grad and vs torch autograd of the energy to 2e-4."""
    jm, jp, tm, tp = build_pair()
    x_raw, z0 = inputs(N, D)
    jaux, taux = _aux(jm, jp, tm, tp, x_raw)
    je = jm.dynamics.energy(jnp.asarray(z0), aux=jaux)
    te = tm.dynamics.energy(torch.tensor(z0), aux=taux)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5, atol=1e-4)
    jg = jm.dynamics.grad_energy(jnp.asarray(z0), jaux)
    tg = tm.dynamics.grad_energy(torch.tensor(z0), aux=taux)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=2e-4, atol=2e-4)
    auto = batched_grad(tm.dynamics.energy)(torch.tensor(z0), aux=taux)
    np.testing.assert_allclose(tg.numpy(), auto.numpy(), rtol=2e-4, atol=2e-4)
    assert float(np.abs(np.asarray(jg) - z0).max()) > 0.1  # the decoder term matters


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_dynamics_with_aux_matches_jax(direction):
    """A whole trajectory with the aux-conditioned nets and the decoder
    energy, and the acceptance that follows, to 2e-4."""
    jm, jp, tm, tp = build_pair()
    x_raw, z0 = inputs(N, D)
    jaux, taux = _aux(jm, jp, tm, tp, x_raw)
    v = np.random.default_rng(6).standard_normal((N, D)).astype(np.float32)
    jX, jV, jld = getattr(jm.dynamics, direction)(
        jp["smp"], jnp.asarray(z0), jnp.asarray(v), aux=jaux)
    tX, tV, tld = getattr(tm.dynamics, direction)(
        tp["smp"], torch.tensor(z0), torch.tensor(v), aux=taux)
    for g, r in ((tX, jX), (tV, jV), (tld, jld)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-4, atol=2e-4)
    jpx = jm.dynamics.p_accept(jp["smp"], jnp.asarray(z0), jnp.asarray(v), jX, jV, jld, aux=jaux)
    tpx = tm.dynamics.p_accept(tp["smp"], torch.tensor(z0), torch.tensor(v), tX, tV, tld,
                               aux=taux)
    np.testing.assert_allclose(tpx.numpy(), np.asarray(jpx), rtol=2e-3, atol=2e-4)
    assert float(np.abs(np.asarray(jld)).max()) > 1e-3  # the nets are not ~0


def test_forward_then_backward_inverts_with_aux():
    _, _, tm, tp = build_pair()
    x_raw, z0 = inputs(N, D)
    xr = torch.tensor(x_raw)
    aux = {"raw": xr, "emb": tm.aux_encoder.apply(tp["smp"]["aux_enc"], xr), "dec": tp["dec"]}
    v = torch.tensor(np.random.default_rng(7).standard_normal((N, D)).astype(np.float32))
    X, V, ld = tm.dynamics.forward(tp["smp"], torch.tensor(z0), v, aux=aux)
    x2, v2, ld2 = tm.dynamics.backward(tp["smp"], X, V, aux=aux)
    torch.testing.assert_close(x2, torch.tensor(z0), rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(v2, v, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(ld + ld2, torch.zeros_like(ld), rtol=0, atol=1e-3)


def test_encode_and_generate_samples():
    jm, jp, tm, tp = build_pair()
    x_raw, _ = inputs(N, D)
    key = jax.random.key(9)
    jz, jmu, jls = jvae.encode(jm, jp, jnp.asarray(x_raw), key)
    noise = np.asarray(jax.random.normal(key, jmu.shape, jmu.dtype))
    tz, tmu, tls = tvae.encode(tm, tp, torch.tensor(x_raw), None, noise=torch.tensor(noise))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **TOL)
    drawn, _, _ = tvae.encode(tm, tp, torch.tensor(x_raw), torch.Generator().manual_seed(0))
    assert drawn.shape == (N, D) and not torch.allclose(drawn, tmu)
    imgs = tvae.generate_samples(tm, tp, torch.Generator().manual_seed(0), n=5)
    assert imgs.shape == (5, 784) and float(imgs.min()) >= 0 and float(imgs.max()) <= 1


def test_data_streams_equal_the_jax_packages():
    """Same seed, same numpy stream: the synthetic set, the binarization
    and the shuffle are bit for bit the JAX package's."""
    jd = jdata.synthetic_mnist(n_train=24, n_test=8, seed=3)
    td = tdata.synthetic_mnist(n_train=24, n_test=8, seed=3)
    np.testing.assert_array_equal(td.train, jd.train)
    np.testing.assert_array_equal(td.test, jd.test)
    assert td.is_synthetic and td.source == jd.source
    np.testing.assert_array_equal(
        tdata.binarize(np.random.default_rng(5), td.train),
        jdata.binarize(np.random.default_rng(5), jd.train))
    np.testing.assert_array_equal(
        tdata.binarize_and_shuffle(np.random.default_rng(5), td.train),
        jdata.binarize_and_shuffle(np.random.default_rng(5), jd.train))
    with pytest.raises(ValueError, match="0, 1"):
        tdata.binarize(np.random.default_rng(0), td.train * 2.0)


def test_get_data_resolves_as_the_jax_packages(tmp_path, monkeypatch):
    """With no MNIST files both packages resolve to the same source; an
    ``mnist.npz`` under a search root is read by the port."""
    assert tdata.get_data().source == jdata.get_data().source
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "mnist.npz",
             x_train=rng.integers(0, 256, (6, 28, 28)).astype(np.uint8),
             x_test=rng.integers(0, 256, (2, 28, 28)).astype(np.uint8))
    monkeypatch.setattr(tdata, "_SEARCH_ROOTS", (str(tmp_path),))
    got = tdata.get_data()
    assert got.source == "mnist" and not got.is_synthetic
    assert got.train.shape == (6, 784) and got.test.dtype == np.float32
    assert float(got.train.max()) <= 1.0
