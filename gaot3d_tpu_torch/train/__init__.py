"""Training for the port: learning-rate schedules and optimizers
(`schedule.py`), the train and eval steps (`step.py`), and the trainer with
its metrics, plots and checkpoints (`trainer.py`, `metrics.py`, `plotting.py`,
`checkpoint.py`; import those from their modules)."""
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
