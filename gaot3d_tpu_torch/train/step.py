"""One train step and one eval step of the port (port of
gaot3d_tpu/train/trainer.py `masked_mse`, `sample_nodes_without_replacement`,
`gather_nodes`, `_forward_loss`, `_train_step`, `_eval_step`).

A step runs where its batch lies: on the card for CUDA tensors, through the
kernels' plain versions for CPU tensors. The model must be on the same
device. Attention dropout and the edge sampling ('ratio', 'max_neighbors')
take their draws from the `torch.Generator` handed to `train_step`, the
neural-field node sampler from the generator of its `NeuralField`; nothing
reads a global random state.

Training strategies, as in the JAX trainer:
  - full grid (`neural_field=None`): every node is an input and a query;
  - neural field (`NeuralField`): a uniform draw of input nodes and of query
    nodes a graph, the edges of both built from the sampled coordinates
    inside the forward, the loss on the valid queries (the reference's
    stat.py:438-514).
Evaluation is always full grid.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from ..models.gaot3d import GAOT3D
from .schedule import ScheduledOptimizer


@dataclass
class TrainBatch:
    """One batch, with precomputed edges or without (None: the model builds
    slots from the nodes). With sectioned slots, pos, feats and target are in
    the sections' permuted node order; with flat edge lists they stay in the
    caller's."""

    pos: torch.Tensor  # [B, N, 3]
    feats: torch.Tensor  # [B, N, C_in]
    target: torch.Tensor  # [B, N, C_out]
    node_mask: torch.Tensor  # [B, N] bool
    enc_slots: Any  # EdgeSlots, SectionedEdgeSlots, FlatEdgeChunks, a list of them
    dec_slots: Any  # (one a scale) or None


@dataclass
class NeuralField:
    """The neural-field strategy: `input_nodes` and `query_nodes` drawn a
    graph each step (each clipped to the padded node count), from
    `generator`, a torch.Generator on the batch's device."""

    input_nodes: int
    query_nodes: int
    generator: torch.Generator


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean squared error over the valid nodes only."""
    diff = (pred - target) * mask[..., None]
    denom = (mask.sum() * pred.shape[-1]).clamp_min(1)
    return (diff * diff).sum() / denom


def sample_nodes_without_replacement(mask: torch.Tensor, k: int,
                                     generator: torch.Generator
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A uniform draw of k distinct nodes a graph: [B, N] mask -> (idx [B, k]
    int64, valid [B, k]). Each node draws r uniform in [0, 1), invalid nodes
    +inf, and the k smallest are taken in ascending order (a stable sort: on
    a tie the lower index, as jax.lax.top_k). When k exceeds a graph's valid
    count its extra picks are invalid nodes, with `valid` false."""
    r = torch.rand(mask.shape, generator=generator, device=mask.device)
    r = torch.where(mask, r, torch.full_like(r, float("inf")))
    idx = torch.sort(r, dim=1, stable=True).indices[:, :k]
    return idx, torch.gather(mask, 1, idx)


def gather_nodes(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr [B, N, C], idx [B, k] -> [B, k, C]."""
    return torch.gather(arr, 1, idx[..., None].expand(-1, -1, arr.shape[-1]))


def neural_field_loss(model: GAOT3D, batch: TrainBatch, sampling: NeuralField,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Masked MSE on sampled query nodes of a forward from sampled input
    nodes; both sides' slots are built from the sampled coordinates. With as
    many inputs as queries the queries are the inputs (the reference's
    stat.py:478-480)."""
    n = batch.pos.shape[1]
    k_in, k_q = min(sampling.input_nodes, n), min(sampling.query_nodes, n)
    in_idx, in_valid = sample_nodes_without_replacement(batch.node_mask, k_in,
                                                        sampling.generator)
    in_pos = gather_nodes(batch.pos, in_idx)
    if k_in == k_q:
        q_idx, q_valid, q_pos = in_idx, in_valid, in_pos
    else:
        q_idx, q_valid = sample_nodes_without_replacement(batch.node_mask, k_q,
                                                          sampling.generator)
        q_pos = gather_nodes(batch.pos, q_idx)
    pred = model(in_pos, gather_nodes(batch.feats, in_idx), in_valid, query_pos=q_pos,
                 query_mask=q_valid, generator=generator)
    return masked_mse(pred, gather_nodes(batch.target, q_idx), q_valid)


def _check_devices(model: GAOT3D, batch: TrainBatch) -> None:
    device = next(model.parameters()).device
    if batch.pos.device != device:
        raise ValueError(f"the batch is on {batch.pos.device} and the model on {device}")


def _forward(model: GAOT3D, batch: TrainBatch,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    def as_list(edges):  # one structure (one scale) or a list of them
        return None if edges is None else (edges if isinstance(edges, list) else [edges])

    return model(batch.pos, batch.feats, batch.node_mask,
                 encoder_slots=as_list(batch.enc_slots), decoder_slots=as_list(batch.dec_slots),
                 generator=generator)


def train_step(model: GAOT3D, optimizer: ScheduledOptimizer, batch: TrainBatch,
               generator: Optional[torch.Generator] = None,
               neural_field: Optional[NeuralField] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward in train mode, masked MSE, backward, one optimizer step, on
    the full grid or, given `neural_field`, by that strategy. Returns (loss,
    gradient global norm) as 0-d tensors on the batch's device. The
    optimizer's `loss_scale` (from its config) multiplies the differentiated
    loss only: the loss returned is unscaled, the norm is that of the scaled
    gradients the optimizer sees."""
    _check_devices(model, batch)
    model.train()
    optimizer.zero_grad()
    if neural_field is not None:
        loss = neural_field_loss(model, batch, neural_field, generator)
    else:
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
