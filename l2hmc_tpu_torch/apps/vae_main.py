"""Command line of the L2HMC-VAE experiment family (counterpart of
``l2hmc_tpu/apps/vae_main.py``).

Usage:
    python -m l2hmc_tpu_torch.apps.vae_main --hparams latent_dim=50,leapfrogs=5 \\
        --exp_id myrun [--eval] [--device cuda]

``--hparams`` takes a comma-separated name=value list of ``VaeConfig``
fields. With ``--eval`` the AIS log-likelihood sweep and the sampler
evaluation run in the same process after training; ``--restore`` skips
training and evaluates a checkpoint. Everything runs on ``--device``
(default ``cuda``; there is no fallback to the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from l2hmc_tpu_torch.apps import data as data_lib
from l2hmc_tpu_torch.apps import eval_sampler, eval_vae, vae


def parse_hparams(spec: str, cfg_cls, base=None):
    """Comma-separated name=value overrides onto a dataclass config."""
    base = base if base is not None else cfg_cls()
    if not spec:
        return base
    fields = {f.name for f in dataclasses.fields(cfg_cls)}
    overrides = {}
    for item in spec.split(","):
        name, _, value = item.partition("=")
        name = name.strip()
        if name not in fields:
            raise ValueError(f"unknown hparam {name!r}")
        current = getattr(base, name)
        if isinstance(current, bool):
            overrides[name] = value.strip().lower() in ("1", "true", "yes")
        else:
            overrides[name] = type(current)(value)
    return dataclasses.replace(base, **overrides)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--hparams", type=str, default="",
                   help="comma-separated name=value overrides")
    p.add_argument("--exp_id", type=str, default="default")
    p.add_argument("--logdir_root", type=str, default="logs")
    p.add_argument("--eval", action="store_true",
                   help="run AIS + sampler evals after training")
    p.add_argument("--anneal_steps", type=int, nargs="*",
                   default=[64, 256, 1024, 4096, 8192], help="AIS schedule sweep")
    p.add_argument("--max_eval_datapoints", type=int, default=None,
                   help="cap datapoints per AIS split (None = the full split)")
    p.add_argument("--restore", type=str, default=None,
                   help="checkpoint path (logdir/ckpt): skip training, rebuild the "
                        "model from the config JSON + mask_seed and run evals")
    p.add_argument("--device", type=str, default="cuda",
                   help="device everything runs on")
    args = p.parse_args(argv)

    logdir = os.path.join(args.logdir_root, args.exp_id)
    print(f"Saving logs to {logdir}")

    dataset = data_lib.get_data()
    if dataset.is_synthetic:
        print("WARNING: MNIST not found; training on synthetic data")
    elif dataset.source != "mnist":
        print(f"NOTE: MNIST not found; training on real data: {dataset.source}")

    if args.restore:
        model, state = vae.restore(args.restore, device=args.device)
        cfg = model.cfg
        last = {"restored_step": state.step}
        print(f"restored step {state.step} from {args.restore}")
        args.eval = True  # eval-only mode: restoring without evals is a no-op
    else:
        cfg = parse_hparams(args.hparams, vae.VaeConfig)
        model, state, last = vae.train(cfg, dataset, logdir=logdir, device=args.device)
        print("final:", json.dumps({k: float(v) for k, v in last.items()}))

    results = {
        "hparams": dataclasses.asdict(cfg),
        "synthetic_data": bool(dataset.is_synthetic),
        "data_source": dataset.source,
        "restored_from": args.restore,
        "final_train_metrics": {k: float(v) for k, v in last.items()},
        "ais_log_likelihood": {},
    }
    if args.eval:
        for anneal in args.anneal_steps:
            for split in ("train", "test"):
                ecfg = eval_vae.EvalVaeConfig(
                    anneal_steps=anneal, split=split, latent_dim=cfg.latent_dim, leapfrogs=10)
                print(f"{split} fold evaluation. AS steps: {anneal}")
                ll = eval_vae.run(model, state.params, ecfg, dataset, logdir=logdir,
                                  max_datapoints=args.max_eval_datapoints,
                                  device=args.device)
                print(f"  avg log-likelihood: {ll:.2f}")
                results["ais_log_likelihood"][f"{split}_as{anneal}"] = ll
        print("Sampler eval")
        eval_sampler.run(
            model, state.params,
            eval_sampler.EvalSamplerConfig(leapfrogs=cfg.leapfrogs, latent_dim=cfg.latent_dim),
            dataset, plot_path=os.path.join(logdir, "sampler_eval.png"), device=args.device,
        )
        results["sampler_eval_plot"] = os.path.join(logdir, "sampler_eval.png")
    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, "vae_results.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(f"results -> {logdir}/vae_results.json")
    return last


if __name__ == "__main__":
    main()
