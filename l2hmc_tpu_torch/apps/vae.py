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

Training updates the three groups jointly with three optimizers:
  - encoder <- the ELBO at the reparameterized posterior sample;
  - sampler <- the sigma_q-scaled expected-squared-jump loss over ``mh_steps``
    MH refinement steps, plus an optional energy term, its gradient clipped
    to global norm ``grad_clip``;
  - decoder <- the negative log p(x, z) at the sampler-refined latent.
One backward pass over the sum of the three objectives gives the three
per-group gradients: each objective sees the other groups' parameters
detached. ``faithful_loss_accum`` resets the sampler loss's accumulators at
every MH step, so that only the last step counts (scaled by 1 / mh_steps);
the default averages all steps. With ``fused_train`` the trajectories run
through the fused CUDA kernels (``ops.DifferentiableFusedVae``), else
through ``Dynamics`` with plain autograd, second order through the
energy's gradient.

Randomness comes from a CPU ``torch.Generator`` seeded from
``VaeConfig.seed``, so a seed gives the same run on every device; a train
step also takes every draw from outside (``VaeStepDraws``).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from l2hmc_tpu_torch import mcmc
from l2hmc_tpu_torch.apps import data as data_lib
from l2hmc_tpu_torch.config import resolve_compute_dtype, resolve_device
from l2hmc_tpu_torch.dynamics import Dynamics
from l2hmc_tpu_torch.evals.metrics import normal_kl
from l2hmc_tpu_torch.io import (
    MetricsWriter,
    config_from_dict,
    load_config,
    restore_checkpoint,
    save_checkpoint,
)
from l2hmc_tpu_torch.mcmc.sampler import normal_like
from l2hmc_tpu_torch.nets import core as nets
from l2hmc_tpu_torch.nets.stq import stq_net
from l2hmc_tpu_torch.train.optim import (
    OPTIMIZERS,
    apply_updates,
    piecewise_constant_schedule,
    tree_leaves,
    tree_unflatten,
)


@dataclasses.dataclass(frozen=True)
class VaeConfig:
    """Hyperparameters (the JAX package's ``VaeConfig``, field for field).
    ``fused_tile`` is not read: each CUDA kernel has its own tiling, one
    configuration each. The sampler kernel (``vae_chain``) runs 16 chains
    per cluster of 8 CTAs, the training kernels 40 chains per cluster of 8
    CTAs, and the AIS kernel 8 chains per CTA in clusters of 2 CTAs."""

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
    # run the training trajectories through the fused CUDA kernels with
    # their hand-written VJP (ops.DifferentiableFusedVae)
    fused_train: bool = False
    fused_tile: int = 256
    # "bfloat16" lowers the fused trajectories' product operands (f32
    # accumulation); read only with fused_train and not hmc, as in JAX
    fused_compute_dtype: str = ""

    def __post_init__(self):
        resolve_compute_dtype(self.fused_compute_dtype or None)


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
    (softplus' = sigmoid): dU/dz = J_dec(z)^T (sigmoid(logits) - x) + z, and
    assumes the decoder of :func:`build_decoder`. Where autograd is on and
    ``z`` carries a gradient (training differentiates through the
    trajectory), the six products are recorded, so that a backward pass
    through them gives the Hessian-vector product; otherwise they run
    unrecorded, as the sampling paths need no second derivative.
    """

    def energy(z: torch.Tensor, aux=None) -> torch.Tensor:
        logits = decoder.apply(aux["dec"], z)
        return bce_logits(logits, aux["raw"]) + 0.5 * torch.sum(z * z, dim=1)

    def grad_energy(z: torch.Tensor, aux=None) -> torch.Tensor:
        lin1, lin2, lin3 = _decoder_layers(aux["dec"])
        with torch.set_grad_enabled(torch.is_grad_enabled() and z.requires_grad):
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


# -- training ------------------------------------------------------------------


class VaeState(NamedTuple):
    params: Any  # {"enc", "dec", "smp": {"alpha", "xnet", "vnet", "aux_enc"}}
    opt_enc: Any
    opt_dec: Any
    opt_smp: Any
    generator: torch.Generator  # CPU; a train step advances it in place
    step: int


class VaeStepDraws(NamedTuple):
    """Every random number of one train step, in the order a step draws them
    from its generator: the encoder noise, then per MH step the op count
    (``random_lf_composition`` only), the momentum, the direction uniforms
    and the accept uniforms. With ``random_lf_composition`` entry t of
    ``dir_u`` is a sequence of one (n,) tensor per composed op. HMC mode
    reads no direction uniforms."""

    noise: torch.Tensor  # (n, latent)
    v: Sequence[torch.Tensor]  # mh_steps x (n, latent)
    dir_u: Sequence[Any]  # mh_steps x (n,)
    acc_u: Sequence[torch.Tensor]  # mh_steps x (n,)
    nb: Optional[Sequence[int]] = None  # mh_steps op counts


def make_lr_schedule(cfg: VaeConfig, batch_per_epoch: int):
    """Piecewise constant: the learning rate times 0.1 from epoch
    ``lr_drop_epoch`` on."""
    boundary = batch_per_epoch * cfg.lr_drop_epoch
    return piecewise_constant_schedule(cfg.learning_rate, {boundary: 0.1})


def make_optimizers(cfg: VaeConfig, batch_per_epoch: int):
    """(encoder's, decoder's, sampler's optimizer, schedule); only the
    sampler's clips its gradient."""
    schedule = make_lr_schedule(cfg, batch_per_epoch)
    opt_fn = OPTIMIZERS[cfg.optimizer]
    return opt_fn(schedule), opt_fn(schedule), opt_fn(schedule, cfg.grad_clip), schedule


def init_state(model: VaeModel, batch_per_epoch: int, device=None) -> VaeState:
    """Params and optimizer states on ``device`` (``cuda`` unless the caller
    says otherwise), drawn from one CPU generator seeded with ``cfg.seed``;
    training goes on drawing from it."""
    cfg = model.cfg
    gen = torch.Generator().manual_seed(cfg.seed)
    params = model.init_params(gen, device=device)
    opt_enc, opt_dec, opt_smp, _ = make_optimizers(cfg, batch_per_epoch)
    return VaeState(
        params=params,
        opt_enc=opt_enc.init(params["enc"]),
        opt_dec=opt_dec.init(params["dec"]),
        opt_smp=opt_smp.init(params["smp"]),
        generator=gen,
        step=0,
    )


def _detached(tree):
    return tree_unflatten(tree, [leaf.detach() for leaf in tree_leaves(tree)])


def make_train_step(model: VaeModel, batch_per_epoch: int):
    """One training step ``step(state, batch, draws=None) -> (state,
    metrics)``: the ELBO for the encoder, the MH refinement loop for the
    sampler, the likelihood at the refined latent for the decoder, one
    backward pass and the three updates. ``draws`` (a ``VaeStepDraws``)
    replaces the generator's numbers. ``step.losses(params, batch,
    generator, draws)`` is the shared forward pass: (elbo, sampler_loss,
    likelihood, sampler metrics, latent_T)."""
    cfg = model.cfg
    opt_enc, opt_dec, opt_smp, _ = make_optimizers(cfg, batch_per_epoch)
    dyn = model.dynamics
    if cfg.fused_train and not cfg.hmc:
        from l2hmc_tpu_torch.ops import DifferentiableFusedVae

        dyn = DifferentiableFusedVae(model.dynamics, compute_dtype=cfg.fused_compute_dtype)

    def sampler_refine(smp, dec_params, batch, log_sigma, latent_q, gen, draws):
        """The MH refinement loop; returns (latent_T, sampler_loss, metrics)."""
        emb = model.aux_encoder.apply(smp["aux_enc"], batch)
        aux = {"raw": batch, "emb": emb, "dec": dec_params}
        init_x = latent_q.detach()
        sigma2 = torch.exp(2.0 * log_sigma).detach()

        inverse_term = other_term = energy_loss = 0.0
        px_last = None
        for t in range(cfg.mh_steps):
            if cfg.faithful_loss_accum:
                inverse_term = other_term = energy_loss = 0.0
            if cfg.stop_gradient:
                init_x = init_x.detach()
            kw = {} if draws is None else dict(init_v=draws.v[t], accept_u=draws.acc_u[t])
            if cfg.random_lf_composition > 0:
                if draws is None:
                    nb = int(torch.randint(1, cfg.random_lf_composition, (), generator=gen))
                else:
                    nb = int(draws.nb[t])
                    kw["op_dir_u"] = draws.dir_u[t]
                out = mcmc.chain_operator(
                    gen, dyn, smp, init_x, nb, max_steps=cfg.random_lf_composition,
                    aux=aux, do_mh_step=True, **kw,
                )
            else:
                if draws is not None:
                    kw["dir_u"] = draws.dir_u[t]
                out = mcmc.propose(gen, dyn, smp, init_x, aux=aux, do_mh_step=True, **kw)
            final_x, px, mh_x = out.x_prop, out.p_accept, out.x_next

            # the jump distance in units of the encoder's posterior variance
            v = torch.square(final_x - init_x) / (sigma2 + 1e-4)
            v = torch.sum(v, dim=1) * px + 1e-4
            inverse_term = inverse_term + (1.0 / cfg.mh_steps) * torch.mean(1.0 / v)
            other_term = other_term - (1.0 / cfg.mh_steps) * torch.mean(v)
            # the energy-difference term, on both branches
            e_fx = dyn.energy(final_x, aux=aux)
            e_ix = dyn.energy(init_x, aux=aux)
            e_diff = torch.square(e_fx - e_ix) * px + 1e-4
            energy_loss = energy_loss + (1.0 / cfg.mh_steps) * (
                torch.mean(1.0 / e_diff) - torch.mean(e_diff))
            px_last = px
            init_x = mh_x

        sampler_loss = inverse_term + other_term + cfg.energy_scale * energy_loss
        metrics = {
            "inverse_term": inverse_term.detach(),
            "other_term": other_term.detach(),
            "energy_loss": energy_loss.detach(),
            "p_accept": torch.mean(px_last.detach()),
        }
        return init_x, sampler_loss, metrics

    def losses(params, batch, gen, draws=None):
        mu, log_sigma = model.encoder.apply(params["enc"], batch)
        noise = normal_like(gen, mu) if draws is None else draws.noise
        latent_q = mu + noise * torch.exp(log_sigma)

        # encoder objective: the ELBO, decoder detached
        dec_sg = _detached(params["dec"])
        logits = model.decoder.apply(dec_sg, latent_q)
        kl = normal_kl(mu, torch.exp(log_sigma), 0.0, 1.0)
        elbo = torch.mean(kl + bce_logits(logits, batch))

        # sampler objective: decoder detached here, encoder inside
        latent_T, sampler_loss, smp_metrics = sampler_refine(
            params["smp"], dec_sg, batch, log_sigma, latent_q, gen, draws)

        # decoder objective: -log p(x, z) at the refined latent
        z_T = latent_T.detach()
        logits_T = model.decoder.apply(params["dec"], z_T)
        log_partition = 0.5 * cfg.latent_dim * math.log(2.0 * math.pi)
        prior_probs = log_partition + 0.5 * torch.sum(torch.square(z_T), dim=1)
        likelihood = torch.mean(prior_probs + bce_logits(logits_T, batch))
        return elbo, sampler_loss, likelihood, smp_metrics, latent_T

    def train_step(state: VaeState, batch: torch.Tensor,
                   draws: Optional[VaeStepDraws] = None):
        leaves = [leaf.detach().requires_grad_(True) for leaf in tree_leaves(state.params)]
        params = tree_unflatten(state.params, leaves)
        elbo, sampler_loss, likelihood, smp_metrics, _ = losses(
            params, batch, state.generator, draws)
        grads = torch.autograd.grad(elbo + sampler_loss + likelihood, leaves,
                                    allow_unused=True)
        # a leaf no objective reaches (the aux encoder in HMC mode) gets
        # zeros, as in JAX
        grads = tree_unflatten(state.params, [
            torch.zeros_like(leaf) if g is None else g for g, leaf in zip(grads, leaves)])

        u_enc, o_enc = opt_enc.update(grads["enc"], state.opt_enc)
        u_dec, o_dec = opt_dec.update(grads["dec"], state.opt_dec)
        # HMC leaves the sampler untouched; off-steps of update_sampler_every
        # keep its params and its optimizer state
        new_smp, o_smp = state.params["smp"], state.opt_smp
        if not cfg.hmc and state.step % cfg.update_sampler_every == 0:
            u_smp, o_smp = opt_smp.update(grads["smp"], state.opt_smp)
            new_smp = apply_updates(state.params["smp"], u_smp)
        new_params = {
            "enc": apply_updates(state.params["enc"], u_enc),
            "dec": apply_updates(state.params["dec"], u_dec),
            "smp": new_smp,
        }
        metrics = {
            "elbo": elbo.detach(),
            "sampler_loss": sampler_loss.detach(),
            "log_prob": likelihood.detach(),
            **smp_metrics,
        }
        new_state = VaeState(new_params, o_enc, o_dec, o_smp, state.generator,
                             state.step + 1)
        return new_state, metrics

    train_step.losses = losses
    return train_step


def train(
    cfg: VaeConfig,
    dataset: Optional[data_lib.MnistData] = None,
    *,
    logdir: Optional[str] = None,
    log_every: int = 50,
    verbose: bool = True,
    device=None,
) -> tuple[VaeModel, VaeState, dict]:
    """The full training loop on ``device`` (``cuda`` unless the caller says
    otherwise): ``cfg.epochs`` passes over the freshly binarized and
    shuffled training set; with ``logdir`` metrics every ``log_every``
    batches and, every ``eval_samples_every`` epochs, a checkpoint and a
    grid of decoded samples. Returns (model, final state, last logged
    metrics)."""
    dev = resolve_device(device)
    dataset = dataset if dataset is not None else data_lib.get_data()
    n = dataset.train.shape[0]
    batch_per_epoch = max(n // cfg.batch_size, 1)

    model = VaeModel.build(cfg)
    state = init_state(model, batch_per_epoch, device=dev)
    step_fn = make_train_step(model, batch_per_epoch)

    writer = MetricsWriter(logdir) if logdir else None
    rng = np.random.default_rng(cfg.seed)
    last = {}
    t0 = time.time()
    for e in range(cfg.epochs):
        x_train = data_lib.binarize_and_shuffle(rng, dataset.train)
        for t in range(batch_per_epoch):
            batch = torch.as_tensor(
                x_train[t * cfg.batch_size : (t + 1) * cfg.batch_size], device=dev)
            state, metrics = step_fn(state, batch)
            if t % log_every == 0:
                last = {k: float(v) for k, v in metrics.items()}
                if verbose:
                    print(
                        f"Step:{state.step}::{t}/{batch_per_epoch}::"
                        f"ELBO: {last['elbo']:.3e}::Loss sampler: "
                        f"{last['sampler_loss']:.3e}:: Log prob: "
                        f"{last['log_prob']:.3e}:: Time: {time.time()-t0:.2e}"
                    )
                    t0 = time.time()
                if writer:
                    writer.write(state.step, metrics)
        if logdir and e % cfg.eval_samples_every == 0:
            save_checkpoint(f"{logdir}/ckpt", state, config=cfg)
            _save_sample_grid(model, state, logdir, e)
    return model, state, last


def restore(ckpt_path: str, batch_per_epoch: int = 1, device=None) -> tuple[VaeModel, VaeState]:
    """Rebuild the model and the state from a checkpoint saved by
    :func:`train`, on ``device`` (``cuda`` unless the caller says
    otherwise). The config JSON beside it (with its ``mask_seed``)
    reconstructs the exact sampler, masks included, in a fresh process; the
    checkpoint restores params, optimizer states, generator and step.
    ``batch_per_epoch`` only shapes the learning-rate schedule."""
    cfg_dict = load_config(ckpt_path)
    if cfg_dict is None:
        raise FileNotFoundError(f"no config JSON next to {ckpt_path}")
    cfg = config_from_dict(VaeConfig, cfg_dict)
    model = VaeModel.build(cfg)
    template = init_state(model, batch_per_epoch, device=device)
    return model, restore_checkpoint(ckpt_path, template)


def _save_sample_grid(model: VaeModel, state: VaeState, logdir: str, epoch: int):
    """A grid of decoded samples per evaluation epoch; skipped without
    matplotlib."""
    try:
        from l2hmc_tpu_torch.apps.notebook_utils import plot_grid
    except Exception:
        return
    with torch.no_grad():
        imgs = generate_samples(model, state.params, torch.Generator().manual_seed(epoch),
                                n=64)
    try:
        plot_grid(imgs.cpu().numpy(), n=8, path=f"{logdir}/samples_{epoch:04d}.png")
    except Exception:
        pass  # matplotlib optional
