"""Shared set-up of the VAE port's tests: the small VAE of
tests/test_fused_dynamics.py built in both packages from one JAX init, and
inputs made with numpy from a seed."""

import jax
import numpy as np

from l2hmc_tpu.apps import vae as jvae
from l2hmc_tpu_torch.apps import vae as tvae
from l2hmc_tpu_torch.convert import params_from_jax

SMALL = dict(latent_dim=8, leapfrogs=3, enc_hidden=32, sampler_size1=16, sampler_size2=16)
C0 = float(np.sqrt(-2.0 * np.log(1e-7)))  # Box-Muller of all-zero random bits


def build_pair(lift=0.02, seed=0, **overrides):
    """(jax model, jax params, torch model, torch params on the CPU). The
    S/T/Q nets' weights are lifted by ``lift`` (their heads are initialised
    with factor 0.01, which would leave S, T, Q at ~0) and the decoder's
    last layer is scaled by 10 so that logits are O(1)."""
    kw = {**SMALL, **overrides}
    jm = jvae.VaeModel.build(jvae.VaeConfig(**kw))
    tm = tvae.VaeModel.build(tvae.VaeConfig(**kw))
    jp = jm.init_params(jax.random.key(seed))
    if not kw.get("hmc", False):
        for net in ("xnet", "vnet"):
            jp["smp"][net] = jax.tree_util.tree_map(lambda a: a + lift, jp["smp"][net])
    dec = list(jp["dec"])
    dec[4] = {"w": dec[4]["w"] * 10.0, "b": dec[4]["b"] + 0.1}
    jp["dec"] = tuple(dec)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def inputs(n, latent_dim, seed=1):
    """(x_raw (n, 784) in {0, 1}, z0 (n, latent)) float32 numpy."""
    rng = np.random.default_rng(seed)
    x_raw = (rng.random((n, 784)) < 0.3).astype(np.float32)
    z0 = rng.standard_normal((n, latent_dim)).astype(np.float32)
    return x_raw, z0
