"""One train step and one eval step of the port (port of
gaot3d_tpu/train/trainer.py `masked_mse`, `_train_step`, `_eval_step`).

A step runs where its batch lies: on the card for CUDA tensors, through the
kernels' plain versions for CPU tensors. The model must be on the same
device. Attention dropout takes its seeds from the `torch.Generator` handed
to `train_step`; nothing reads a global random state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from ..models.gaot3d import GAOT3D
from .schedule import ScheduledOptimizer


@dataclass
class TrainBatch:
    """One batch with precomputed edges. With sectioned slots, pos, feats
    and target are in the sections' permuted node order; with flat edge lists
    they stay in the caller's."""

    pos: torch.Tensor  # [B, N, 3]
    feats: torch.Tensor  # [B, N, C_in]
    target: torch.Tensor  # [B, N, C_out]
    node_mask: torch.Tensor  # [B, N] bool
    enc_slots: Any  # EdgeSlots, SectionedEdgeSlots or FlatEdgeChunks
    dec_slots: Any


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean squared error over the valid nodes only."""
    diff = (pred - target) * mask[..., None]
    denom = (mask.sum() * pred.shape[-1]).clamp_min(1)
    return (diff * diff).sum() / denom


def _check_devices(model: GAOT3D, batch: TrainBatch) -> None:
    device = next(model.parameters()).device
    if batch.pos.device != device:
        raise ValueError(f"the batch is on {batch.pos.device} and the model on {device}")


def _forward(model: GAOT3D, batch: TrainBatch,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    return model(batch.pos, batch.feats, batch.node_mask, encoder_slots=[batch.enc_slots],
                 decoder_slots=[batch.dec_slots], generator=generator)


def train_step(model: GAOT3D, optimizer: ScheduledOptimizer, batch: TrainBatch,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward in train mode, masked MSE, backward, one optimizer step.
    Returns (loss, gradient global norm) as 0-d tensors on the batch's device.
    The optimizer's `loss_scale` (from its config) multiplies the
    differentiated loss only: the loss returned is unscaled, the norm is that
    of the scaled gradients the optimizer sees."""
    _check_devices(model, batch)
    model.train()
    optimizer.zero_grad()
    loss = masked_mse(_forward(model, batch, generator), batch.target, batch.node_mask)
    scale = optimizer.loss_scale
    (loss * scale if scale != 1.0 else loss).backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    grad_norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    optimizer.step()
    return loss.detach(), grad_norm


def eval_step(model: GAOT3D, batch: TrainBatch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward in eval mode (no dropout): (prediction, masked MSE)."""
    _check_devices(model, batch)
    model.eval()
    with torch.no_grad():
        pred = _forward(model, batch, None)
        return pred, masked_mse(pred, batch.target, batch.node_mask)
