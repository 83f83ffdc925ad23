"""Training for the port: learning-rate schedules and optimizers
(`schedule.py`), the train and eval steps (`step.py`), and the trainer with
its metrics, plots and checkpoints (`trainer.py`, `metrics.py`, `plotting.py`,
`checkpoint.py`; import those from their modules)."""
from .schedule import (OptimizerargsConfig, ScheduledOptimizer, make_lr_schedule,
                       make_optimizer, mix_phase_lengths)
from .step import (NeuralField, TrainBatch, eval_step, gather_nodes, masked_mse,
                   neural_field_loss, sample_nodes_without_replacement, train_step)

__all__ = [
    "OptimizerargsConfig",
    "ScheduledOptimizer",
    "make_lr_schedule",
    "make_optimizer",
    "mix_phase_lengths",
    "NeuralField",
    "TrainBatch",
    "eval_step",
    "gather_nodes",
    "masked_mse",
    "neural_field_loss",
    "sample_nodes_without_replacement",
    "train_step",
]
