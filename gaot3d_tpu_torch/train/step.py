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
import torch.distributed as dist

from ..models.gaot3d import GAOT3D
from ..parallel.sharding import (active_placement, all_reduce_, all_reduce_gradients,
                                 world_group)
from ..tracing import span
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
    condition: Optional[torch.Tensor] = None  # c [B, 1] of a conditioned model


@dataclass
class NeuralField:
    """The neural-field strategy: `input_nodes` and `query_nodes` drawn a
    graph each step (each clipped to the padded node count), from
    `generator`, a torch.Generator on the batch's device."""

    input_nodes: int
    query_nodes: int
    generator: torch.Generator


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean squared error over the valid nodes only. Inside a sharded step
    it is this rank's share of the global one: its squared errors over the
    valid count of the whole global batch (the shares sum to the global
    masked mean)."""
    diff = (pred - target) * mask[..., None]
    count = all_reduce_(mask.sum() * pred.shape[-1], world_group())
    return (diff * diff).sum() / count.clamp_min(1)


def _global(loss: torch.Tensor) -> torch.Tensor:
    """The global loss of a sharded step: the ranks' shares summed."""
    group = world_group()
    return loss if group is None else all_reduce_(loss.detach().clone(), group)


def sample_nodes_without_replacement(mask: torch.Tensor, k: int,
                                     generator: torch.Generator, row_offset: int = 0,
                                     total_rows: Optional[int] = None
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A uniform draw of k distinct nodes a graph: [B, N] mask -> (idx [B, k]
    int64, valid [B, k]). Each node draws r uniform in [0, 1), invalid nodes
    +inf, and the k smallest are taken in ascending order (a stable sort: on
    a tie the lower index, as jax.lax.top_k). When k exceeds a graph's valid
    count its extra picks are invalid nodes, with `valid` false. The mask
    may be rows [row_offset, row_offset + B) of a batch of `total_rows`: the
    draw is then the whole batch's, cut to those rows."""
    B, N = mask.shape
    total = B if total_rows is None else total_rows
    r = torch.rand((total, N), generator=generator, device=mask.device)
    r = r[row_offset:row_offset + B]
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
    stat.py:478-480).

    Inside a sharded step the draw is the global batch's: every data rank
    draws the whole batch's numbers and keeps its rows, and the node ranks of
    a cloud draw over the whole cloud (their node masks gathered) and each
    keeps the drawn nodes of its own shard, the rest of the k rows invalid:
    the encoder's node-group sum and the global loss then see the nodes one
    process sees."""
    node_mask = batch.node_mask
    draw, shard = {}, None
    place = active_placement()
    if place is not None:
        # every data rank draws the global batch's numbers and keeps its rows
        draw = dict(row_offset=place.batch_offset,
                    total_rows=batch.pos.shape[0] * place.mesh.data)
        if place.mesh.node > 1:
            mesh = place.mesh
            parts = [torch.empty_like(node_mask, dtype=torch.uint8) for _ in range(mesh.node)]
            dist.all_gather(parts, node_mask.to(torch.uint8).contiguous(),
                            group=mesh.node_group)
            node_mask = torch.cat(parts, dim=1).bool()
            shard = mesh.node_rank * batch.pos.shape[1]
    n = node_mask.shape[1]
    k_in, k_q = min(sampling.input_nodes, n), min(sampling.query_nodes, n)

    def take(k):
        idx, valid = sample_nodes_without_replacement(node_mask, k, sampling.generator, **draw)
        if shard is not None:  # this rank's share of the drawn nodes
            local = idx - shard
            mine = (local >= 0) & (local < batch.pos.shape[1])
            idx, valid = torch.where(mine, local, 0), valid & mine
        return idx, valid
    in_idx, in_valid = take(k_in)
    in_pos = gather_nodes(batch.pos, in_idx)
    if k_in == k_q:
        q_idx, q_valid, q_pos = in_idx, in_valid, in_pos
    else:
        q_idx, q_valid = take(k_q)
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

    return model(batch.pos, batch.feats, batch.node_mask, condition=batch.condition,
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
    gradients the optimizer sees. Inside a sharded step the gradients are
    summed over every rank before the optimizer steps, and the loss and norm
    are the global ones."""
    _check_devices(model, batch)
    with span("gaot.train.step"):
        model.train()
        optimizer.zero_grad()
        with span("gaot.train.forward"):
            if neural_field is not None:
                loss = neural_field_loss(model, batch, neural_field, generator)
            else:
                loss = masked_mse(_forward(model, batch, generator), batch.target,
                                  batch.node_mask)
        scale = optimizer.loss_scale
        with span("gaot.train.backward"):
            (loss * scale if scale != 1.0 else loss).backward()
        place = active_placement()
        if place is not None:
            with span("gaot.train.allreduce"):
                all_reduce_gradients(model, place.mesh)
        with span("gaot.train.optimizer"):
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            grad_norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
            optimizer.step()
        return _global(loss.detach()), grad_norm


def eval_step(model: GAOT3D, batch: TrainBatch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward in eval mode (no dropout): (prediction, masked MSE; the global
    one inside a sharded step, the prediction being the rank's rows)."""
    _check_devices(model, batch)
    model.eval()
    with torch.no_grad():
        pred = _forward(model, batch, None)
        return pred, _global(masked_mse(pred, batch.target, batch.node_mask))
