"""Checkpoints of the port (CPU): a state tree through ``save_checkpoint`` /
``restore_checkpoint`` with its generator, the config sidecar and its
coercions against the JAX package's, and ``vae.restore`` rebuilding the
sampler, masks included, from ``mask_seed``."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from l2hmc_tpu.apps import vae as jvae
from l2hmc_tpu.io import config_from_dict as jax_config_from_dict
from l2hmc_tpu_torch.apps import data as tdata
from l2hmc_tpu_torch.apps import vae as tvae
from l2hmc_tpu_torch.io import (
    config_from_dict,
    load_config,
    restore_checkpoint,
    save_checkpoint,
)
from l2hmc_tpu_torch.train.optim import tree_leaves

SMALL = dict(latent_dim=4, leapfrogs=2, enc_hidden=32, sampler_size1=16, sampler_size2=16,
             mh_steps=2, batch_size=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These sizes are tiny: one intra-op thread is the fastest, and the
    test workers do not fight over cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trained(tmp_path, **kw):
    cfg = tvae.VaeConfig(**SMALL, epochs=1, **kw)
    ds = tdata.synthetic_mnist(n_train=32, n_test=16)
    return cfg, ds, tvae.train(cfg, ds, logdir=str(tmp_path), verbose=False, device="cpu")


def test_round_trip_keeps_every_leaf_and_the_generator(tmp_path):
    """Params, the three optimizer states, the step and the generator come
    back bit for bit: the restored generator goes on with the same draws."""
    model = tvae.VaeModel.build(tvae.VaeConfig(**SMALL))
    state = tvae.init_state(model, 2, device="cpu")
    state.generator.manual_seed(7)
    torch.randn(5, generator=state.generator)  # advance it
    state = state._replace(step=11, opt_smp=state.opt_smp._replace(
        mu=torch.arange(state.opt_smp.mu.numel(), dtype=torch.float32)))
    path = str(tmp_path / "sub" / "ckpt")
    save_checkpoint(path, state, config=model.cfg)
    template = tvae.init_state(model, 2, device="cpu")
    got = restore_checkpoint(path, template)
    assert isinstance(got, tvae.VaeState) and got.step == 11
    assert type(got.opt_smp) is type(state.opt_smp)
    for a, b in zip(tree_leaves(got.params), tree_leaves(state.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for name in ("opt_enc", "opt_dec", "opt_smp"):
        for a, b in zip(getattr(got, name), getattr(state, name)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert got.generator is not state.generator
    torch.testing.assert_close(torch.randn(9, generator=got.generator),
                               torch.randn(9, generator=state.generator), rtol=0, atol=0)
    # the tree structure is kept: tuples of dicts, empty tuples for activations
    assert got.params["dec"][1] == () and isinstance(got.params["enc"][4], tuple)


def test_restore_refuses_another_shape(tmp_path):
    model = tvae.VaeModel.build(tvae.VaeConfig(**SMALL))
    save_checkpoint(str(tmp_path / "ckpt"), tvae.init_state(model, 1, device="cpu"))
    other = tvae.VaeModel.build(tvae.VaeConfig(**{**SMALL, "latent_dim": 6}))
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path / "ckpt"), tvae.init_state(other, 1, device="cpu"))
    assert load_config(str(tmp_path / "ckpt")) is None  # no config was given


def test_config_sidecar_and_coercions_match_jax(tmp_path):
    """The sidecar is the dataclass as JSON; ``config_from_dict`` coerces as
    the JAX package's does (strings to bools and numbers, unknown keys and
    nulls ignored)."""
    cfg = tvae.VaeConfig(**SMALL, mask_seed=5, hmc=True, eps=0.25)
    save_checkpoint(str(tmp_path / "ckpt"), {"w": torch.zeros(2)}, config=cfg)
    d = load_config(str(tmp_path / "ckpt"))
    assert d == json.loads(json.dumps(dataclasses.asdict(cfg)))
    assert config_from_dict(tvae.VaeConfig, d) == cfg
    messy = {**d, "hmc": "True", "stop_gradient": "0", "latent_dim": "4", "eps": "0.25",
             "optimizer": None, "not_a_field": 3}
    got = config_from_dict(tvae.VaeConfig, messy)
    ref = jax_config_from_dict(jvae.VaeConfig, messy)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.hmc is True and got.stop_gradient is False and got.optimizer == "adam"

    @dataclasses.dataclass(frozen=True)
    class WithTuple:
        grid: tuple = (0.1, 0.2)
        name: str = "a"

    assert config_from_dict(WithTuple, {"grid": [1, 2, 3]}).grid == (1, 2, 3)


def test_vae_restore_rebuilds_model_masks_and_state(tmp_path):
    """``restore`` in the place of a fresh process: the model from the config
    JSON, the masks from ``mask_seed``, the state from the checkpoint; the
    restored sampler computes what the trained one computes."""
    cfg, ds, (model, state, _) = _trained(tmp_path, mask_seed=9, seed=2)
    r_model, r_state = tvae.restore(str(tmp_path / "ckpt"), device="cpu")
    assert r_model.cfg == cfg
    np.testing.assert_array_equal(r_model.dynamics.masks, model.dynamics.masks)
    default_masks = tvae.VaeModel.build(tvae.VaeConfig(**SMALL)).dynamics.masks
    assert not np.array_equal(r_model.dynamics.masks, default_masks)
    assert r_state.step == state.step == 2
    for a, b in zip(tree_leaves(r_state.params), tree_leaves(state.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(r_state.generator.get_state(), state.generator.get_state(),
                               rtol=0, atol=0)
    # one more step from either state gives the same metrics
    batch = torch.tensor(tdata.binarize(np.random.default_rng(0), ds.train[:16]))
    step, r_step = tvae.make_train_step(model, 2), tvae.make_train_step(r_model, 2)
    _, m = step(state, batch)
    _, r_m = r_step(r_state, batch)
    assert {k: float(v) for k, v in m.items()} == {k: float(v) for k, v in r_m.items()}
    with pytest.raises(FileNotFoundError, match="no config JSON"):
        tvae.restore(str(tmp_path / "missing"), device="cpu")
