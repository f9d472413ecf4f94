"""MNIST VAE with an L2HMC posterior sampler: the model half (counterpart of
``l2hmc_tpu/apps/vae.py``).

Three parameter groups: ``enc`` (784 -> h -> h -> (mu, log_sigma)), ``dec``
(latent -> h -> h -> 784 logits) and ``smp`` (the sampler: alpha, the two
S/T/Q nets and the aux encoder 784 -> 512 -> 512 -> size1 whose embedding
both nets add to their hidden layer). The embedding is computed once per
batch and handed to the nets through ``aux``, a dict
``{"raw": batch, "emb": embedded batch, "dec": decoder params}``: the
posterior energy reads the raw pixels and the decoder params, the nets the
embedding.

Ported here: the config, the builders, the posterior energy with its
analytic gradient, ``VaeModel``, ``encode`` and ``generate_samples`` — what
posterior sampling and the AIS evaluation need. Training (``make_train_step``,
``make_optimizers``, ``train``, ``restore``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from l2hmc_tpu_torch.config import resolve_device
from l2hmc_tpu_torch.dynamics import Dynamics
from l2hmc_tpu_torch.mcmc.sampler import normal_like
from l2hmc_tpu_torch.nets import core as nets
from l2hmc_tpu_torch.nets.stq import stq_net


@dataclasses.dataclass(frozen=True)
class VaeConfig:
    """Hyperparameters (the JAX package's ``VaeConfig``, field for field)."""

    learning_rate: float = 1e-3
    epochs: int = 100
    leapfrogs: int = 5
    mh_steps: int = 5
    optimizer: str = "adam"
    batch_size: int = 512
    latent_dim: int = 50
    update_sampler_every: int = 1
    eval_samples_every: int = 1
    random_lf_composition: int = 0
    stop_gradient: bool = False
    hmc: bool = False
    eps: float = 0.1
    energy_scale: float = 0.0
    enc_hidden: int = 1024
    sampler_size1: int = 200
    sampler_size2: int = 200
    grad_clip: float = 5.0
    lr_drop_epoch: int = 500
    faithful_loss_accum: bool = False
    seed: int = 0
    mask_seed: int = 0
    # fused VAE training and bf16 kernel operands: not ported yet
    fused_train: bool = False
    fused_tile: int = 256
    fused_compute_dtype: str = ""

    def __post_init__(self):
        if self.fused_train:
            raise NotImplementedError("VaeConfig.fused_train is not ported yet")
        if self.fused_compute_dtype:
            raise NotImplementedError("VaeConfig.fused_compute_dtype is not ported yet")


# -- model builders ------------------------------------------------------------


def build_encoder(cfg: VaeConfig) -> nets.Module:
    """784 -> h -> h -> [mu, log_sigma]."""
    h = cfg.enc_hidden
    return nets.sequential(
        nets.linear(784, h),
        nets.activation(F.softplus),
        nets.linear(h, h),
        nets.activation(F.softplus),
        nets.parallel(nets.linear(h, cfg.latent_dim), nets.linear(h, cfg.latent_dim)),
    )


def build_decoder(cfg: VaeConfig) -> nets.Module:
    """latent -> h -> h -> 784 logits, last layer's init factor 0.01."""
    h = cfg.enc_hidden
    return nets.sequential(
        nets.linear(cfg.latent_dim, h),
        nets.activation(F.softplus),
        nets.linear(h, h),
        nets.activation(F.softplus),
        nets.linear(h, 784, factor=0.01),
    )


def build_sampler_aux_encoder(cfg: VaeConfig) -> nets.Module:
    """784 -> 512 -> 512 -> size1, shared by the X and V nets."""
    return nets.sequential(
        nets.linear(784, 512),
        nets.activation(F.softplus),
        nets.linear(512, 512),
        nets.activation(F.softplus),
        nets.linear(512, cfg.sampler_size1),
    )


def _emb_passthrough() -> nets.Module:
    """Aux branch of the S/T/Q Zip: pick the precomputed embedding."""
    return nets.Module(init=lambda generator, device: (), apply=lambda p, aux: aux["emb"])


def build_sampler_net(cfg: VaeConfig, factor: float) -> nets.Module:
    return stq_net(
        cfg.latent_dim, cfg.sampler_size1, factor, out_factor=0.01, embed_factor=0.33,
        hidden2=cfg.sampler_size2, aux_module=_emb_passthrough(),
    )


def bce_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Sigmoid cross-entropy with logits, summed over pixels, in the stable
    form max(l, 0) - l x + log1p(exp(-|l|))."""
    return torch.sum(
        torch.clamp(logits, min=0.0) - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits))),
        dim=1,
    )


def _decoder_layers(dec_params):
    lin1, _, lin2, _, lin3 = dec_params
    return lin1, lin2, lin3


def posterior_energy(decoder: nets.Module):
    """(energy, grad_energy) of U(z | x) = BCE(decoder(z), x) + 0.5 ||z||^2.

    Both take ``aux = {"raw": x, "dec": decoder params, ...}``. The gradient
    is analytic, one forward and one transposed sweep of the decoder
    (softplus' = sigmoid): dU/dz = J_dec(z)^T (sigmoid(logits) - x) + z. It
    is not differentiable itself (the plain sampling paths need no second
    derivative) and assumes the decoder of :func:`build_decoder`.
    """

    def energy(z: torch.Tensor, aux=None) -> torch.Tensor:
        logits = decoder.apply(aux["dec"], z)
        return bce_logits(logits, aux["raw"]) + 0.5 * torch.sum(z * z, dim=1)

    def grad_energy(z: torch.Tensor, aux=None) -> torch.Tensor:
        lin1, lin2, lin3 = _decoder_layers(aux["dec"])
        with torch.no_grad():
            p1 = z @ lin1["w"] + lin1["b"]
            p2 = F.softplus(p1) @ lin2["w"] + lin2["b"]
            logits = F.softplus(p2) @ lin3["w"] + lin3["b"]
            d3 = torch.sigmoid(logits) - aux["raw"]
            d2 = (d3 @ lin3["w"].T) * torch.sigmoid(p2)
            d1 = (d2 @ lin2["w"].T) * torch.sigmoid(p1)
            return d1 @ lin1["w"].T + z

    return energy, grad_energy


def build_dynamics(cfg: VaeConfig, decoder: nets.Module) -> Dynamics:
    """The sampler dynamics on the decoder posterior."""
    energy, grad_energy = posterior_energy(decoder)
    return Dynamics(
        dim=cfg.latent_dim,
        energy=energy,
        grad_energy=grad_energy,
        T=cfg.leapfrogs,
        xnet=None if cfg.hmc else build_sampler_net(cfg, factor=2.0),
        vnet=None if cfg.hmc else build_sampler_net(cfg, factor=1.0),
        hmc=cfg.hmc,
        eps_trainable=True,
        use_temperature=False,
        mask_seed=cfg.mask_seed,
    )


@dataclasses.dataclass(frozen=True)
class VaeModel:
    """Static bundle: modules + dynamics + config."""

    cfg: VaeConfig
    encoder: nets.Module
    decoder: nets.Module
    aux_encoder: nets.Module
    dynamics: Dynamics

    @staticmethod
    def build(cfg: VaeConfig) -> "VaeModel":
        decoder = build_decoder(cfg)
        return VaeModel(
            cfg=cfg,
            encoder=build_encoder(cfg),
            decoder=decoder,
            aux_encoder=build_sampler_aux_encoder(cfg),
            dynamics=build_dynamics(cfg, decoder),
        )

    def init_params(self, generator: torch.Generator, device=None) -> Any:
        """{"enc", "dec", "smp": {"alpha", "xnet", "vnet", "aux_enc"}}, on
        ``cuda`` unless ``device`` says otherwise."""
        dev = resolve_device(device)
        enc = self.encoder.init(generator, dev)
        dec = self.decoder.init(generator, dev)
        smp = self.dynamics.init_params(generator, eps=self.cfg.eps, device=dev)
        smp["aux_enc"] = self.aux_encoder.init(generator, dev)
        return {"enc": enc, "dec": dec, "smp": smp}


def generate_samples(model: VaeModel, params, generator: torch.Generator, n: int = 64):
    """Decode z ~ N(0, I) into pixel probabilities."""
    dev = params["dec"][0]["w"].device
    z = torch.randn((n, model.cfg.latent_dim), generator=generator,
                    device=generator.device).to(dev)
    return torch.sigmoid(model.decoder.apply(params["dec"], z))


def encode(model: VaeModel, params, batch: torch.Tensor, generator: torch.Generator,
           noise: torch.Tensor | None = None):
    """Posterior draw latent_q = mu + noise * sigma; returns (latent_q, mu,
    log_sigma). ``noise`` is drawn from ``generator`` when not given."""
    mu, log_sigma = model.encoder.apply(params["enc"], batch)
    if noise is None:
        noise = normal_like(generator, mu)
    return mu + noise * torch.exp(log_sigma), mu, log_sigma
