"""The SCG experiment: training and evaluation (counterpart of
``l2hmc_tpu/train``)."""

from l2hmc_tpu_torch.train.optim import (
    OPTIMIZERS,
    Adam,
    AdamState,
    RmsProp,
    Sgd,
    exponential_decay,
    piecewise_constant_schedule,
)
from l2hmc_tpu_torch.train.scg import (
    ScgConfig,
    StepDraws,
    TrainState,
    build_dynamics,
    draw_step,
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
    "OPTIMIZERS",
    "Adam",
    "AdamState",
    "RmsProp",
    "ScgConfig",
    "Sgd",
    "StepDraws",
    "TrainState",
    "build_dynamics",
    "draw_step",
    "evaluate_ess",
    "evaluate_trained",
    "exponential_decay",
    "hmc_sample_chain",
    "init_state",
    "make_optimizer",
    "make_train_step",
    "piecewise_constant_schedule",
    "run_experiment",
    "sample_chain",
    "temperature_at",
    "train",
]
