"""Masked segment sum and masked row gather in plain PyTorch (port of
gaot3d_tpu/ops/segment.py `segment_sum` and `gather_table`).

They sit beneath the kernels: the plain versions of the encoder-payload
kernel K5 (kernels/encoder_payload.py) and of the decoder-payload kernel K9
(kernels/decoder_payload.py) use them, and so do the ops and the models
(ops/segment.py, models/integral_transform.py).
"""
from __future__ import annotations

from typing import Optional

import torch


def segment_sum(
    data: torch.Tensor,  # [E, ...]
    segment_ids: torch.Tensor,  # [E] integer
    num_segments: int,
    mask: Optional[torch.Tensor] = None,  # [E] bool
) -> torch.Tensor:
    """[E, ...] -> [num_segments, ...]. Masked rows contribute nothing, and
    their segment id is never used, whatever it holds: they are routed to an
    extra segment that is dropped."""
    ids = segment_ids.long()
    if mask is not None:
        ids = torch.where(mask, ids, torch.full_like(ids, num_segments))
        m = mask.reshape(mask.shape + (1,) * (data.ndim - mask.ndim))
        data = torch.where(m, data, torch.zeros((), dtype=data.dtype, device=data.device))
    out = torch.zeros((num_segments + 1,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    out.index_add_(0, ids, data)
    return out[:num_segments]


class _GatherTable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, mask):
        S = table.shape[0]
        ctx.save_for_backward(idx, mask)
        ctx.num_rows = S
        return table[idx.long().clamp(0, S - 1)] * mask[:, None].to(table.dtype)

    @staticmethod
    def backward(ctx, ct):
        idx, mask = ctx.saved_tensors
        S = ctx.num_rows
        # the masked segment sum at the unclipped index: a row whose index
        # lies outside the table gives it nothing, as jax.ops.segment_sum
        # drops it (autograd's backward of the clipped gather would not)
        keep = mask & (idx >= 0) & (idx < S)
        return segment_sum(ct, idx, S, keep), None, None


def gather_table(table: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked row gather: table [S, C], idx [E], mask [E] -> [E, C], the
    index clipped into the table and masked rows 0. Its backward is the
    masked segment sum of the cotangent at the unclipped index, as the JAX
    function's custom backward."""
    return _GatherTable.apply(table, idx, mask)
