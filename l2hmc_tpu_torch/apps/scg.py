"""Command line of the SCG experiment (counterpart of
``l2hmc_tpu/apps/scg.py``).

Usage:
    # train + evaluate, checkpointing the final TrainState:
    python -m l2hmc_tpu_torch.apps.scg --n_steps 5000 --n_chains 200 --logdir logs/scg

    # evaluate a checkpoint only (the config sidecar and its mask_seed
    # rebuild the sampler):
    python -m l2hmc_tpu_torch.apps.scg --restore logs/scg/ckpt

Everything runs on ``--device`` (default ``cuda``; there is no fallback to
the CPU): training and the two evaluation chains replay captured steps there.
"""

from __future__ import annotations

import argparse
import json

from l2hmc_tpu_torch.io import (
    MetricsWriter,
    config_from_dict,
    load_config,
    restore_checkpoint,
    save_checkpoint,
)
from l2hmc_tpu_torch.train import (
    ScgConfig,
    TrainState,
    build_dynamics,
    evaluate_trained,
    init_state,
    make_optimizer,
    run_experiment,
)


def restore_state(ckpt_path: str, device=None) -> tuple[ScgConfig, TrainState]:
    """(config, TrainState) from a checkpoint saved by this command line, on
    ``device``: the template is rebuilt from the config alone
    (``init_state``), then filled from disk."""
    cfg_dict = load_config(ckpt_path)
    if cfg_dict is None:
        raise FileNotFoundError(f"no config JSON next to {ckpt_path}")
    cfg = config_from_dict(ScgConfig, cfg_dict)
    dynamics, _ = build_dynamics(cfg)
    optimizer, _ = make_optimizer(cfg)
    template = init_state(cfg, dynamics, optimizer, device=device)
    return cfg, restore_checkpoint(ckpt_path, template)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n_steps", type=int, default=5000)
    p.add_argument("--n_chains", type=int, default=200)
    p.add_argument("--leapfrogs", type=int, default=10)
    p.add_argument("--eps", type=float, default=0.1)
    p.add_argument("--hidden", type=int, default=10)
    p.add_argument("--eval_steps", type=int, default=2000)
    p.add_argument("--hmc_eps", type=float, default=0.15)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--logdir", type=str, default=None)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--restore", type=str, default=None,
                   help="checkpoint path: skip training, evaluate from disk")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    if args.restore:
        cfg, state = restore_state(args.restore, device=args.device)
        summary = evaluate_trained(cfg, state.params, eval_steps=args.eval_steps,
                                   hmc_eps=args.hmc_eps, device=args.device)
        summary["restored_from"] = args.restore
        summary["restored_step"] = int(state.step)
    else:
        cfg = ScgConfig(n_steps=args.n_steps, n_chains=args.n_chains, T=args.leapfrogs,
                        eps=args.eps, hidden=args.hidden, seed=args.seed)
        metrics, state = run_experiment(cfg, eval_steps=args.eval_steps, hmc_eps=args.hmc_eps,
                                        log_every=args.log_every, return_state=True,
                                        device=args.device)
        summary = {k: v for k, v in metrics.items() if k != "history"}

    print(
        f"ESS L2HMC: {summary['ess_l2hmc']:.2e} -- "
        f"ESS HMC: {summary['ess_hmc']:.2e} -- "
        f"Ratio: {int(summary['ess_ratio'])}"
    )
    if args.logdir:
        w = MetricsWriter(args.logdir)
        if not args.restore:
            h = metrics["history"]
            for i in range(0, len(h["loss"]), args.log_every):
                w.write(i, {k: v[i] for k, v in h.items()})
            save_checkpoint(f"{args.logdir}/ckpt", state, config=cfg)
            summary["checkpoint"] = f"{args.logdir}/ckpt"
        with open(f"{args.logdir}/summary.json", "w") as f:
            json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
