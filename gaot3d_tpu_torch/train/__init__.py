"""Training for the port: learning-rate schedules and optimizers
(`schedule.py`) and the train and eval steps (`step.py`)."""
from .schedule import (OptimizerargsConfig, ScheduledOptimizer, make_lr_schedule,
                       make_optimizer, mix_phase_lengths)
from .step import TrainBatch, eval_step, masked_mse, train_step

__all__ = [
    "OptimizerargsConfig",
    "ScheduledOptimizer",
    "make_lr_schedule",
    "make_optimizer",
    "mix_phase_lengths",
    "TrainBatch",
    "eval_step",
    "masked_mse",
    "train_step",
]
