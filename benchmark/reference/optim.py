"""The configuration's optimizer in plain PyTorch, and the first training
steps of the reference.

AdamW (betas 0.9, 0.999, eps 1e-8, decoupled weight decay on every
parameter) at the rate of the 'mix' schedule: epoch = step // steps a epoch;
linear warm-up from lr to max_lr over the first 2% of the epochs, a cosine
from max_lr to min_lr over the next 90%, an exponential tail to final_lr.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import model as ref

_f32 = np.float32


def mix_lr(step: int, steps_per_epoch: int, epochs: int, lr: float, max_lr: float,
           min_lr: float, final_lr: float, cosine_frac: float = 0.90) -> float:
    warmup, cosine = int(0.02 * epochs), int(cosine_frac * epochs)
    tail = epochs - warmup - cosine
    if warmup == 0:
        warmup, cosine = 1, cosine - 1
    if tail == 0:
        tail, cosine = 1, cosine - 1
    epoch = step // max(1, steps_per_epoch)
    e = _f32(epoch)
    if epoch < warmup:
        return float(_f32(lr) + _f32(max_lr - lr) * (e / _f32(max(1, warmup - 1))))
    if epoch < warmup + cosine:
        ratio = (_f32(1) + np.cos(_f32(np.pi) * (e - _f32(warmup)) / _f32(cosine))) / _f32(2)
        return float(_f32(min_lr) + _f32(max_lr - min_lr) * ratio)
    xe = e - _f32(warmup) - _f32(cosine)
    return float(_f32(min_lr) * np.power(_f32(final_lr / min_lr), xe / _f32(max(1, tail - 1))))


class AdamW:
    def __init__(self, params: Dict[str, torch.Tensor], weight_decay: float,
                 betas=(0.9, 0.999), eps=1e-8):
        self.params = params
        self.wd, self.betas, self.eps = weight_decay, betas, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        self.t += 1
        b1, b2 = self.betas
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            p.mul_(1 - lr * self.wd)
            self.m[k].lerp_(g, 1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / math.sqrt(bc2)).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-lr / bc1)


def train_steps(W0: Dict[str, torch.Tensor], spec: ref.Spec, meshes: Sequence[Tuple],
                seeds: Sequence[Sequence[int]], optim: dict, steps_per_epoch: int
                ) -> Tuple[List[float], Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Steps of the reference from weights W0, one a mesh of `meshes`
    ((pos, feats, target, cells, valid) each) with the dropout seeds of that
    step: (losses, the first step's gradients, the weights after the last)."""
    params = {k: v.detach().clone().float() for k, v in W0.items()}
    opt = AdamW(params, float(optim["weight_decay"]))
    losses, first = [], None
    for t, ((pos, feats, target, cells, valid), step_seeds) in enumerate(zip(meshes, seeds)):
        for p in params.values():
            p.requires_grad_(True)
        pred = ref.forward(params, spec, pos, feats, cells, valid, step_seeds)
        if spec.control == "half_batch":  # the fault: half the nodes left out of the mean
            pred, target = pred[:pred.shape[0] // 2], target[:target.shape[0] // 2]
        loss = ref.masked_mse(pred, target)
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))
        del pred
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        for p in params.values():
            p.requires_grad_(False)
        lr = mix_lr(t, steps_per_epoch, int(optim["epoch"]), float(optim["lr"]),
                    float(optim["max_lr"]), float(optim["min_lr"]), float(optim["final_lr"]))
        opt.step(grads, lr)
    return losses, first, params
