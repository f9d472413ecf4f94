"""Trained-sampler quality evaluation (counterpart of
``l2hmc_tpu/apps/eval_sampler.py``).

Protocol: fix one data point, tile it over 200 chains, start the chains at
the encoder's posterior draw, run 2000 recorded steps of the trained sampler
(1-3 random op compositions per step) against plain HMC at eps in
{0.05, ..., 0.2}, and compare the mean-centred autocovariance spectra.

The trained chain has two routes. ``run_trained_chain`` composes nb
proposals under one terminal accept (``mcmc.chain_operator``).
``run_trained_chain_fused`` is one launch of the sampler kernel, which makes
nb full MH ops, each with fresh momentum and its own accept. Both leave the
posterior invariant, so their posterior moments agree, but they are two
different Markov kernels and their autocovariances differ.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from l2hmc_tpu_torch import mcmc
from l2hmc_tpu_torch.apps import data as data_lib
from l2hmc_tpu_torch.apps.vae import VaeModel, encode
from l2hmc_tpu_torch.config import resolve_device
from l2hmc_tpu_torch.dynamics import Dynamics
from l2hmc_tpu_torch.evals import autocovariance


@dataclasses.dataclass(frozen=True)
class EvalSamplerConfig:
    """The protocol's constants (the JAX package's ``EvalSamplerConfig``)."""

    leapfrogs: int = 5
    latent_dim: int = 50
    n_chains: int = 200
    n_steps: int = 2000
    burn_in: int = 1000
    max_composition: int = 4  # ops per recorded step ~ U{1..3}
    datapoint_index: int = 456
    hmc_eps_grid: tuple = (0.05, 0.075, 0.1, 0.125, 0.15, 0.175, 0.2)
    max_autocov_lag: int = 199


def run_trained_chain(
    model: VaeModel, params, aux: dict, z0: torch.Tensor, cfg: EvalSamplerConfig,
    generator: torch.Generator,
) -> torch.Tensor:
    """(n_steps, n_chains, latent) trace of the trained sampler with random
    1..max_composition-1 proposal compositions per step; row t is the state
    before step t."""
    trace = torch.empty((cfg.n_steps, *z0.shape), dtype=z0.dtype, device=z0.device)
    z = z0
    for t in range(cfg.n_steps):
        trace[t] = z
        nb = int(torch.randint(1, cfg.max_composition, (), generator=generator,
                               device=generator.device))
        z = mcmc.chain_operator(
            generator, model.dynamics, params["smp"], z, nb,
            max_steps=cfg.max_composition, aux=aux, do_mh_step=True,
        ).x_next
    return trace


def run_trained_chain_fused(
    model: VaeModel, params, x_raw: torch.Tensor, emb: torch.Tensor, z0: torch.Tensor,
    cfg: EvalSamplerConfig, generator: torch.Generator, seed: int,
) -> torch.Tensor:
    """The whole composition protocol in one launch of the sampler kernel
    (``FusedVaeSampler`` with the trace). The ops-per-step sequence is drawn
    from ``generator``; momentum, direction and accept draws are the
    kernel's own Philox stream under ``seed``. Row t is the state after
    step t."""
    from l2hmc_tpu_torch.ops import FusedVaeSampler

    _, _, trace = FusedVaeSampler(model.dynamics).run(
        params["smp"], params["dec"], x_raw, emb, z0, seed=seed, n_mh_steps=cfg.n_steps,
        collect_trace=True, max_composition=cfg.max_composition, comp_key=generator,
    )
    return trace


def run_hmc_chain(
    model: VaeModel, params, aux: dict, z0: torch.Tensor, eps: float,
    cfg: EvalSamplerConfig, generator: torch.Generator,
) -> torch.Tensor:
    """Plain-HMC baseline chain at fixed eps; row t is the state before
    step t."""
    dyn = Dynamics(
        dim=cfg.latent_dim, energy=model.dynamics.energy,
        grad_energy=model.dynamics.grad_energy, T=cfg.leapfrogs, hmc=True,
    )
    hmc_params = dyn.init_params(generator, eps=eps, device=z0.device)
    trace = torch.empty((cfg.n_steps, *z0.shape), dtype=z0.dtype, device=z0.device)
    z = z0
    with torch.no_grad():
        for t in range(cfg.n_steps):
            trace[t] = z
            z = mcmc.propose(generator, dyn, hmc_params, z, aux=aux, do_mh_step=True).x_next
    return trace


def autocov_curve(trace: torch.Tensor, mu: torch.Tensor, max_lag: int) -> np.ndarray:
    """|autocovariance| spectrum of the mean-centred trace."""
    centered = trace - mu
    return np.abs(np.array(
        torch.stack([autocovariance(centered, tau=t) for t in range(max_lag)]).cpu()
    ))


def protocol_inputs(model: VaeModel, params, cfg: EvalSamplerConfig,
                    dataset: data_lib.MnistData, seed: int, device):
    """What every chain of the protocol starts from: the chosen datapoint of
    the seeded binarization tiled over the chains (n, 784), its aux
    embedding (n, H) and the encoder's posterior draw z0 (n, latent)."""
    x_train = data_lib.binarize(np.random.default_rng(seed), dataset.train)
    x0 = torch.as_tensor(
        np.tile(x_train[cfg.datapoint_index][None, :], (cfg.n_chains, 1)).astype(np.float32),
        device=device,
    )
    emb = model.aux_encoder.apply(params["smp"]["aux_enc"], x0)
    z0, _, _ = encode(model, params, x0, torch.Generator().manual_seed(seed))
    return x0, emb, z0


def run(
    model: VaeModel,
    params,
    cfg: EvalSamplerConfig = EvalSamplerConfig(),
    dataset: Optional[data_lib.MnistData] = None,
    *,
    seed: int = 0,
    plot_path: Optional[str] = None,
    use_fused: str = "auto",
    device=None,
) -> dict:
    """Full protocol; returns {'trained': curve, 'hmc': {eps: curve},
    'data_source': provenance, 'trace': the trained chain's trace}.

    Runs on ``cuda`` unless ``device`` says otherwise; ``params`` live
    there. ``use_fused``: "auto" runs the trained chain as one launch of
    the sampler kernel on a CUDA device and as the ``chain_operator`` loop
    on the CPU; "always" goes through ``FusedVaeSampler`` on any device (on
    the CPU its plain version runs); "never" forces the loop. A kernel
    failure is never caught."""
    if use_fused not in ("auto", "always", "never"):
        raise ValueError(f"use_fused must be auto, always or never, got {use_fused!r}")
    dev = resolve_device(device)
    dataset = dataset if dataset is not None else data_lib.get_data()
    print(f"[eval_sampler] data source: {dataset.source}")

    def gen(offset):
        return torch.Generator().manual_seed(seed + offset)

    with torch.no_grad():
        x0, emb, z0 = protocol_inputs(model, params, cfg, dataset, seed, dev)
        aux = {"raw": x0, "emb": emb, "dec": params["dec"]}

        if use_fused == "always" or (use_fused == "auto" and dev.type == "cuda"):
            trace = run_trained_chain_fused(model, params, x0, emb, z0, cfg, gen(1),
                                            seed=seed + 13)
            print("[eval_sampler] trained chain: fused single-launch")
        else:
            trace = run_trained_chain(model, params, aux, z0, cfg, gen(1))
        post = trace[cfg.burn_in:]
        mu = torch.mean(post, dim=(0, 1))

        curves = {"trained": autocov_curve(post, mu, cfg.max_autocov_lag)}
        hmc_curves = {}
        for i, eps in enumerate(cfg.hmc_eps_grid):
            # independent randomness per grid point
            h = run_hmc_chain(model, params, aux, z0, float(eps), cfg, gen(100 + i))
            hmc_curves[float(eps)] = autocov_curve(h[cfg.burn_in:], mu, cfg.max_autocov_lag)
    curves["hmc"] = hmc_curves
    curves["data_source"] = dataset.source
    curves["trace"] = trace

    if plot_path:
        _plot(curves, plot_path)
    return curves


def _plot(curves: dict, path: str) -> None:
    """Autocovariance comparison figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for eps, c in curves["hmc"].items():
        plt.plot(c, label=f"$\\epsilon={eps:.2f}$")
    plt.plot(curves["trained"], label="L2HMC")
    plt.xlabel("# MH steps")
    plt.ylabel("Autocovariance")
    plt.legend()
    plt.savefig(path)
    plt.close()
