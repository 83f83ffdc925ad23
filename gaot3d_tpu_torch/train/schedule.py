"""Learning-rate schedules and optimizer construction (port of
gaot3d_tpu/train/schedule.py).

The reference steps its scheduler once per epoch; like the JAX package, the
port evaluates the schedule per step from epoch = step // steps_per_epoch,
which gives the same piecewise-constant curve: 'step', 'cos', 'exp', the
three-phase 'mix' (linear warm-up from lr to max_lr over 2% of the epochs,
cosine from max_lr to min_lr, exponential tail from min_lr to final_lr) and a
constant otherwise. The Adam wrapper of the reference gives the cosine 96% of
the epochs and the AdamW wrapper 90%; `make_optimizer` keeps that.

optax reads a schedule at the count BEFORE the update, so the first step runs
at schedule(0); `ScheduledOptimizer.step` sets the rate of the wrapped
`torch.optim` optimizer from its own count and then steps. `optax.adamw`
decays every parameter, biases and norm weights included, and so does
`torch.optim.AdamW` given all parameters in one group.

The arithmetic is numpy float32 in the JAX code's order of operations, so the
two packages agree to float32 rounding.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Tuple

import numpy as np
import torch

_f32 = np.float32


@dataclass
class OptimizerargsConfig:
    """The fields and defaults of the JAX `OptimizerargsConfig`: what the
    schedule, the optimizer and the train step read, and the trainer's
    cadences (`eval_every_eps`, `early_save_metric`, `save_every_epochs`,
    `validate_on_test`)."""

    lr: float = 1e-3
    weight_decay: float = 1e-3
    epoch: int = 100
    loss_scale: float = 1.0  # multiplies the differentiated loss only
    eval_every_eps: int = 2
    scheduler: str = "mix"  # ['step','cos','exp','mix','none']
    early_save_metric: str = "val"  # ['train','val']
    max_lr: float = 1e-2
    min_lr: float = 1e-5
    final_lr: float = 1e-5
    scheduler_step_size: int = 100
    scheduler_gamma: float = 0.8
    scheduler_T_max: int = 100
    scheduler_eta_min: float = 1e-4
    save_every_epochs: int = 0  # > 0: a versioned checkpoint artifact at this cadence
    validate_on_test: bool = False  # validate on the test loader, as the reference does


def mix_phase_lengths(total_epochs: int, cosine_frac: float) -> Tuple[int, int, int]:
    """Warm-up, cosine and exponential epochs of 'mix', with the reference's
    guards against an empty phase."""
    warmup = int(0.02 * total_epochs)
    cosine = int(cosine_frac * total_epochs)
    exp_decay = total_epochs - warmup - cosine
    if warmup == 0:
        warmup = 1
        cosine -= 1
    if exp_decay == 0:
        exp_decay = 1
        cosine -= 1
    return warmup, cosine, exp_decay


def mix_lr_at_epoch(epoch: int, total_epochs: int, initial_lr: float, max_lr: float,
                    min_lr: float, final_lr: float, cosine_frac: float = 0.90) -> float:
    """Rate at an epoch index under 'mix'."""
    warmup, cosine, exp_decay = mix_phase_lengths(total_epochs, cosine_frac)
    e = _f32(epoch)
    if epoch < warmup:
        return float(_f32(initial_lr)
                     + _f32(max_lr - initial_lr) * (e / _f32(max(1, warmup - 1))))
    if epoch < warmup + cosine:
        ratio = (_f32(1) + np.cos(_f32(np.pi) * (e - _f32(warmup)) / _f32(cosine))) / _f32(2)
        return float(_f32(min_lr) + _f32(max_lr - min_lr) * ratio)
    xe = e - _f32(warmup) - _f32(cosine)
    return float(_f32(min_lr)
                 * np.power(_f32(final_lr / min_lr), xe / _f32(max(1, exp_decay - 1))))


def make_lr_schedule(config: OptimizerargsConfig, steps_per_epoch: int,
                     cosine_frac: float = 0.90) -> Callable[[int], float]:
    """step -> learning rate, constant within an epoch."""
    spe = max(1, steps_per_epoch)

    def schedule(step: int) -> float:
        epoch = int(step) // spe
        if config.scheduler == "mix":
            return mix_lr_at_epoch(epoch, config.epoch, config.lr, config.max_lr,
                                   config.min_lr, config.final_lr, cosine_frac)
        if config.scheduler == "step":
            n = epoch // config.scheduler_step_size
            return float(_f32(config.lr) * np.power(_f32(config.scheduler_gamma), _f32(n)))
        if config.scheduler == "cos":
            ratio = (_f32(1) + np.cos(_f32(np.pi) * _f32(epoch)
                                      / _f32(config.scheduler_T_max))) / _f32(2)
            return float(_f32(config.scheduler_eta_min)
                         + _f32(config.lr - config.scheduler_eta_min) * ratio)
        if config.scheduler == "exp":
            return float(_f32(config.lr) * np.power(_f32(config.scheduler_gamma), _f32(epoch)))
        return float(_f32(config.lr))

    return schedule


class ScheduledOptimizer:
    """A `torch.optim` optimizer whose learning rate follows `schedule`: each
    `step()` sets the rate to schedule(count), steps, and counts. It carries
    the configured `loss_scale` for `train_step`."""

    def __init__(self, optimizer: torch.optim.Optimizer, schedule: Callable[[int], float],
                 loss_scale: float = 1.0):
        self.optimizer = optimizer
        self.schedule = schedule
        self.loss_scale = loss_scale
        self.count = 0

    @property
    def learning_rate(self) -> float:
        """The rate the next step will use."""
        return self.schedule(self.count)

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        lr = self.schedule(self.count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.count += 1


def make_optimizer(name: str, params: Iterable[torch.nn.Parameter],
                   config: OptimizerargsConfig, steps_per_epoch: int) -> ScheduledOptimizer:
    """Adam or AdamW over `params` with the configured schedule (cosine share
    96% for Adam, 90% for AdamW, as in the reference)."""
    name = name.lower()
    if name not in ("adam", "adamw"):
        raise ValueError(f"unsupported optimizer: {name} (supported: adam, adamw)")
    schedule = make_lr_schedule(config, steps_per_epoch, 0.96 if name == "adam" else 0.90)
    if name == "adam":
        opt = torch.optim.Adam(params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8)
    else:
        opt = torch.optim.AdamW(params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=config.weight_decay)
    return ScheduledOptimizer(opt, schedule, config.loss_scale)
