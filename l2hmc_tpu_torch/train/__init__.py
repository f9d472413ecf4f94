"""The SCG experiment: training and evaluation (counterpart of
``l2hmc_tpu/train``)."""

from l2hmc_tpu_torch.train.optim import Adam, AdamState, exponential_decay
from l2hmc_tpu_torch.train.scg import (
    ScgConfig,
    StepDraws,
    TrainState,
    build_dynamics,
    evaluate_ess,
    evaluate_trained,
    hmc_sample_chain,
    init_state,
    make_optimizer,
    make_train_step,
    run_experiment,
    sample_chain,
    temperature_at,
    train,
)

__all__ = [
    "Adam",
    "AdamState",
    "ScgConfig",
    "StepDraws",
    "TrainState",
    "build_dynamics",
    "evaluate_ess",
    "evaluate_trained",
    "exponential_decay",
    "hmc_sample_chain",
    "init_state",
    "make_optimizer",
    "make_train_step",
    "run_experiment",
    "sample_chain",
    "temperature_at",
    "train",
]
