"""Decoder log-likelihood evaluation via AIS (counterpart of
``l2hmc_tpu/apps/eval_vae.py``).

For each datapoint: ``chains_per_datapoint`` importance chains annealed
from N(0, I) to the decoder posterior, ``num_splits`` datapoints batched per
AIS run, the per-datapoint logmeanexp summed, the average appended to
``<split>_ll.txt``. On a CUDA device a batch is one launch of the AIS kernel
(``FusedVaeAis``); on the CPU it is the ``ais_estimate`` loop.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from l2hmc_tpu_torch.apps import data as data_lib
from l2hmc_tpu_torch.apps.vae import VaeModel
from l2hmc_tpu_torch.config import resolve_device
from l2hmc_tpu_torch.evals.ais import ais_estimate, standard_normal_energy, standard_normal_grad
from l2hmc_tpu_torch.io import MetricsWriter


@dataclasses.dataclass(frozen=True)
class EvalVaeConfig:
    """The protocol's constants (the JAX package's ``EvalVaeConfig``)."""

    leapfrogs: int = 10
    anneal_steps: int = 100
    split: str = "test"
    latent_dim: int = 50
    step_size: float = 0.1
    chains_per_datapoint: int = 20
    num_splits: int = 50  # datapoints per AIS batch


def decoder_log_likelihood(
    model: VaeModel,
    params,
    x: np.ndarray,
    cfg: EvalVaeConfig,
    generator: torch.Generator,
    *,
    max_datapoints: Optional[int] = None,
    logdir: Optional[str] = None,
    verbose: bool = True,
    use_fused: str = "auto",
    device=None,
) -> float:
    """Average AIS log-likelihood over datapoints.

    Runs on ``cuda`` unless ``device`` says otherwise. ``use_fused``:
    "auto" runs each AIS batch as one launch of the AIS kernel on a CUDA
    device and as the ``ais_estimate`` loop on the CPU; "always" goes
    through ``FusedVaeAis`` on any device (on the CPU its plain version
    runs); "never" forces the loop. A kernel failure is never caught."""
    if use_fused not in ("auto", "always", "never"):
        raise ValueError(f"use_fused must be auto, always or never, got {use_fused!r}")
    dev = resolve_device(device)
    n = x.shape[0] if max_datapoints is None else min(max_datapoints, x.shape[0])
    k_chains = cfg.chains_per_datapoint
    fused = use_fused == "always" or (use_fused == "auto" and dev.type == "cuda")

    def start(batch_x):
        tiled = torch.repeat_interleave(batch_x, k_chains, dim=0)
        z0 = torch.randn((tiled.shape[0], cfg.latent_dim), generator=generator,
                         device=generator.device).to(dev)
        return tiled, z0

    def fused_batch(batch_x):
        from l2hmc_tpu_torch.ops import FusedVaeAis

        tiled, z0 = start(batch_x)
        seed = int(torch.randint(0, 2**31 - 1, (), generator=generator,
                                 device=generator.device))
        w, acc = FusedVaeAis(latent_dim=cfg.latent_dim).run(
            params["dec"], tiled, z0, seed=seed, anneal_steps=cfg.anneal_steps,
            step_size=cfg.step_size, leapfrogs=cfg.leapfrogs,
        )
        # per-datapoint logmeanexp over its consecutive group of chains
        groups = w.reshape(batch_x.shape[0], k_chains)
        per_group = torch.logsumexp(groups, dim=1) - math.log(k_chains)
        return torch.sum(per_group), torch.mean(acc)

    def ais_batch(batch_x):
        tiled, z0 = start(batch_x)
        aux = {"raw": tiled, "dec": params["dec"]}
        return ais_estimate(
            generator, standard_normal_energy, model.dynamics.energy, cfg.anneal_steps,
            z0, aux=aux, step_size=cfg.step_size, leapfrogs=cfg.leapfrogs,
            num_splits=batch_x.shape[0], init_grad=standard_normal_grad,
            final_grad=model.dynamics.grad_energy,
        )

    est_log_p = 0.0
    count = 0
    t0 = time.time()
    with torch.no_grad():
        for i in range(0, n, cfg.num_splits):
            batch = torch.as_tensor(x[i : min(i + cfg.num_splits, n)], dtype=torch.float32,
                                    device=dev)
            est, acc = fused_batch(batch) if fused else ais_batch(batch)
            est_log_p += float(est)
            count += batch.shape[0]
            if verbose and i > 0:
                print(f"{i} / {n} in {time.time() - t0:.2e}s, "
                      f"est={est_log_p / count:.2f}, accept={float(acc):.2f}")
                t0 = time.time()
    avg = est_log_p / count
    if logdir:
        MetricsWriter(logdir).append_text(f"{cfg.split}_ll.txt", str(avg))
    return avg


def run(
    model: VaeModel,
    params,
    cfg: EvalVaeConfig = EvalVaeConfig(),
    dataset: Optional[data_lib.MnistData] = None,
    *,
    seed: int = 0,
    max_datapoints: Optional[int] = None,
    logdir: Optional[str] = None,
    use_fused: str = "auto",
    device=None,
) -> float:
    """Full eval protocol on a seeded binarization of the chosen split."""
    dataset = dataset if dataset is not None else data_lib.get_data()
    print(f"[eval_vae] data source: {dataset.source}")
    raw = dataset.train if cfg.split == "train" else dataset.test
    x = data_lib.binarize(np.random.default_rng(seed), raw)
    return decoder_log_likelihood(
        model, params, x, cfg, torch.Generator().manual_seed(seed),
        max_datapoints=max_datapoints, logdir=logdir, use_fused=use_fused, device=device,
    )
