"""Plain Kingma-Welling VAE baseline (counterpart of
``l2hmc_tpu/apps/baseline_vae.py``): the L2HMC VAE's encoder and decoder,
one optimizer on the ELBO."""

from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from l2hmc_tpu_torch.apps import data as data_lib
from l2hmc_tpu_torch.apps.vae import VaeConfig, bce_logits, build_decoder, build_encoder
from l2hmc_tpu_torch.config import resolve_device
from l2hmc_tpu_torch.evals.metrics import normal_kl
from l2hmc_tpu_torch.io import MetricsWriter, save_checkpoint
from l2hmc_tpu_torch.train.optim import OPTIMIZERS, apply_updates, tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class BaselineVaeConfig:
    """Hyperparameters (the JAX package's ``BaselineVaeConfig``)."""

    learning_rate: float = 1e-3
    epochs: int = 300
    optimizer: str = "adam"
    batch_size: int = 512
    latent_dim: int = 50
    eval_samples_every: int = 5
    enc_hidden: int = 1024
    seed: int = 0


class BaselineState(NamedTuple):
    params: Any  # {"enc", "dec"}
    opt_state: Any
    generator: torch.Generator  # CPU; a train step advances it in place
    step: int


def build(cfg: BaselineVaeConfig):
    vcfg = VaeConfig(latent_dim=cfg.latent_dim, enc_hidden=cfg.enc_hidden)
    return build_encoder(vcfg), build_decoder(vcfg)


def make_train_step(cfg: BaselineVaeConfig, encoder, decoder, optimizer):
    """``step(state, batch, noise=None) -> (state, {"elbo"})``; ``noise``
    replaces the generator's encoder noise."""

    def elbo_fn(params, batch, noise):
        mu, log_sigma = encoder.apply(params["enc"], batch)
        latent_q = mu + noise * torch.exp(log_sigma)
        logits = decoder.apply(params["dec"], latent_q)
        kl = normal_kl(mu, torch.exp(log_sigma), 0.0, 1.0)
        return torch.mean(kl + bce_logits(logits, batch))

    def step(state: BaselineState, batch: torch.Tensor, noise=None):
        if noise is None:
            noise = torch.randn((batch.shape[0], cfg.latent_dim), generator=state.generator,
                                device=state.generator.device).to(batch.device)
        leaves = [leaf.detach().requires_grad_(True) for leaf in tree_leaves(state.params)]
        elbo = elbo_fn(tree_unflatten(state.params, leaves), batch, noise)
        grads = tree_unflatten(state.params, torch.autograd.grad(elbo, leaves))
        updates, opt_state = optimizer.update(grads, state.opt_state)
        params = apply_updates(state.params, updates)
        return (BaselineState(params, opt_state, state.generator, state.step + 1),
                {"elbo": elbo.detach()})

    return step


def train(
    cfg: BaselineVaeConfig,
    dataset: Optional[data_lib.MnistData] = None,
    *,
    logdir: Optional[str] = None,
    log_every: int = 50,
    verbose: bool = True,
    device=None,
):
    """The training loop on ``device`` (``cuda`` unless the caller says
    otherwise); returns ((encoder, decoder), final state, last logged
    metrics)."""
    dev = resolve_device(device)
    dataset = dataset if dataset is not None else data_lib.get_data()
    if verbose and dataset.source != "mnist":
        print(f"[baseline_vae] data source: {dataset.source}")
    batch_per_epoch = max(dataset.train.shape[0] // cfg.batch_size, 1)
    encoder, decoder = build(cfg)

    gen = torch.Generator().manual_seed(cfg.seed)
    params = {"enc": encoder.init(gen, dev), "dec": decoder.init(gen, dev)}
    optimizer = OPTIMIZERS[cfg.optimizer](cfg.learning_rate)
    state = BaselineState(params, optimizer.init(params), gen, 0)
    step_fn = make_train_step(cfg, encoder, decoder, optimizer)

    writer = MetricsWriter(logdir) if logdir else None
    rng = np.random.default_rng(cfg.seed)
    t0 = time.time()
    last = {}
    for e in range(cfg.epochs):
        x_train = data_lib.binarize_and_shuffle(rng, dataset.train)
        for t in range(batch_per_epoch):
            batch = torch.as_tensor(
                x_train[t * cfg.batch_size : (t + 1) * cfg.batch_size], device=dev)
            state, metrics = step_fn(state, batch)
            if t % log_every == 0:
                last = {k: float(v) for k, v in metrics.items()}
                if verbose:
                    print(f"{t}/{batch_per_epoch}::ELBO: {last['elbo']:.2e}::"
                          f"Time: {time.time()-t0:.2e}")
                    t0 = time.time()
                if writer:
                    writer.write(state.step, metrics)
        if logdir and e % cfg.eval_samples_every == 0:
            save_checkpoint(f"{logdir}/ckpt", state, config=cfg)
    return (encoder, decoder), state, last


def generate_samples(decoder, params, generator: torch.Generator, n: int = 64):
    """Decode z ~ N(0, I) into pixel probabilities."""
    w = params["dec"][0]["w"]
    z = torch.randn((n, w.shape[0]), generator=generator, device=generator.device).to(w.device)
    return torch.sigmoid(decoder.apply(params["dec"], z))
