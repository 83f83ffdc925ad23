"""The reference's training steps over a mesh too large for one card's
autograd memory: the same loss and gradients as `optim.train_steps`, with
the encoder's accumulator and the decoder's loss taken in node blocks under
activation checkpointing.

Each block's share of the encoder's accumulator (model.encode_parts' inner
loop over the block's points) and each block's squared errors (model.decode
on the block's points) are recomputed in the backward, so autograd keeps a
block's activations at a time. Everything else is model.py's: the cell
features, z-normalisation and geoembed on the summed accumulator, the
processor with its dropout seeds, the configuration's precision and its
controls.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import model as ref
from .optim import AdamW, mix_lr

BLOCK = 524288  # points a checkpointed block


def _encode_block(W: ref.Weights, spec: ref.Spec, acc, pos, feats, cells, valid):
    """acc [M, C + 11] with the block's edges added (encode_parts' loop)."""
    lifted = ref.dense(feats, W, "encoder.lifting.fcs.0", spec)
    for c0 in range(0, pos.shape[0], spec.chunk):
        node, slot = valid[c0:c0 + spec.chunk].nonzero(as_tuple=True)
        node = node + c0
        cell = cells[node, slot]
        pt, cp = pos[node], spec.grid.cell_pos(cell)
        vals = ref.kernel_mlp(torch.cat([pt, cp], dim=-1), W, "encoder.gno.channel_mlp.fcs",
                              spec.enc_layers, spec) * lifted[node]
        acc = acc.index_add(0, cell, torch.cat([vals, ref._moments(pt - cp)], dim=-1))
    return acc


def _block_sse(W: ref.Weights, spec: ref.Spec, latent, pos, target, cells, valid):
    diff = ref.decode(W, spec, latent, pos, cells, valid) - target
    return (diff * diff).sum()


def loss(W: ref.Weights, spec: ref.Spec, pos, feats, target, cells, valid,
         seeds: Sequence[int], block: int = BLOCK) -> torch.Tensor:
    """The masked MSE of a training forward over every point of the mesh."""
    C = W["encoder.lifting.fcs.0.weight"].shape[0]
    acc = torch.zeros((spec.grid.cells, C + 11), dtype=torch.float32, device=pos.device)
    blocks = [slice(b, b + block) for b in range(0, pos.shape[0], block)]
    for b in blocks:
        acc = checkpoint(_encode_block, W, spec, acc, pos[b], feats[b], cells[b], valid[b],
                         use_reentrant=False)
    moments = acc[:, C:].detach()
    gno = acc[:, :C] / moments[:, :1].clamp_min(1.0)
    z = ref._znorm(ref._cell_features(moments))
    geo = ref.dense(F.relu(ref.dense(z, W, "encoder.geoembed.mlp.0", spec)), W,
                    "encoder.geoembed.mlp.2", spec)
    latent = ref.process(W, spec, ref.recover(W, spec, gno, geo), seeds)
    sse = sum(checkpoint(_block_sse, W, spec, latent, pos[b], target[b], cells[b], valid[b],
                         use_reentrant=False) for b in blocks)
    return sse / target.numel()


def train_steps(W0: Dict[str, torch.Tensor], spec: ref.Spec, meshes: Sequence[Tuple],
                seeds: Sequence[Sequence[int]], optim: dict, steps_per_epoch: int,
                block: int = BLOCK
                ) -> Tuple[List[float], Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """optim.train_steps with the loss taken in node blocks: (losses, the
    first step's gradients, the weights after the last)."""
    params = {k: v.detach().clone().float() for k, v in W0.items()}
    opt = AdamW(params, float(optim["weight_decay"]))
    losses, first = [], None
    for t, ((pos, feats, target, cells, valid), step_seeds) in enumerate(zip(meshes, seeds)):
        for p in params.values():
            p.requires_grad_(True)
        value = loss(params, spec, pos, feats, target, cells, valid, step_seeds, block)
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(value, [params[k] for k in names])))
        losses.append(float(value.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        for p in params.values():
            p.requires_grad_(False)
        lr = mix_lr(t, steps_per_epoch, int(optim["epoch"]), float(optim["lr"]),
                    float(optim["max_lr"]), float(optim["min_lr"]), float(optim["final_lr"]))
        opt.step(grads, lr)
    return losses, first, params
