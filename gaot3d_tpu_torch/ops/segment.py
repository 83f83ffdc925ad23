"""Masked segment reductions (port of gaot3d_tpu/ops/segment.py: every
reduction it holds).

`segment_sum` (the plain PyTorch form of the scatter that the
encoder-payload kernel, kernels/encoder_payload.py, fuses with the payload
computation) and `gather_table` come from utils/scatter.py, beneath the
kernels; `segment_max` and `segment_softmax` are plain PyTorch too, as they
are XLA in the JAX package. The sorted folds below
them reduce through the kernels K6, K7 and K8; `fold_max` is a plain segment
max over the sorted rows (JAX's segmented cummax gives the same values).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels.segment_sum_sorted import segment_sum_sorted
from ..kernels.tile_segment_sum import (boundary_difference, tile_boundaries, tile_segment_sum,
                                        tile_starts)
from ..utils.scatter import gather_table, segment_sum  # noqa: F401


def _segment_amax(data: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Max of data [E, ...] over ids [E] in [0, num_segments], -inf where a
    segment is empty; the last segment is the one masked rows go to. Its
    gradient is shared evenly between tied rows, as jax.ops.segment_max's."""
    idx = ids.reshape(ids.shape + (1,) * (data.ndim - 1)).expand(data.shape)
    out = torch.full((num_segments + 1,) + tuple(data.shape[1:]), float("-inf"),
                     dtype=data.dtype, device=data.device)
    return out.scatter_reduce(0, idx, data, "amax", include_self=True)


def segment_max(
    data: torch.Tensor,  # [E, ...]
    segment_ids: torch.Tensor,  # [E] integer
    num_segments: int,
    mask: Optional[torch.Tensor] = None,  # [E] bool
    empty_value: float = 0.0,
) -> torch.Tensor:
    """Max per segment; empty segments give `empty_value`, masked rows
    nothing."""
    ids = segment_ids.long()
    if mask is not None:
        ids = torch.where(mask, ids, torch.full_like(ids, num_segments))
    out = _segment_amax(data, ids, num_segments)[:num_segments]
    return torch.where(out == float("-inf"), torch.full_like(out, empty_value), out)


def segment_softmax(
    scores: torch.Tensor,  # [E]
    segment_ids: torch.Tensor,  # [E] integer
    num_segments: int,
    mask: Optional[torch.Tensor] = None,  # [E] bool
) -> torch.Tensor:
    """Softmax of the scores within each segment: a weight per edge, 0 for
    masked edges; the denominator is floored at the dtype's smallest normal
    number, as in the JAX function."""
    smax = segment_max(scores, segment_ids, num_segments, mask=mask, empty_value=0.0)
    ids = segment_ids.long()
    exp = torch.exp(scores - smax[ids])
    zero = torch.zeros((), dtype=scores.dtype, device=scores.device)
    if mask is not None:
        exp = torch.where(mask, exp, zero)
    denom = segment_sum(exp, segment_ids, num_segments, mask=mask)
    denom = denom.clamp_min(torch.finfo(scores.dtype).tiny)
    w = exp / denom[ids]
    return torch.where(mask, w, zero) if mask is not None else w


# ---------------------------------------------------------------------------
# Sorted segment folds (port of gaot3d_tpu/ops/segment.py `SegmentFoldCtx` ..
# `fold_mean`, `TileFold` .. `fold_sum_tile_lite`,
# `pallas_segment_sum_presorted`).
#
# Sorting the edges of a chunk by destination turns a segment sum into
# contiguous reads. Three forms, each a hand-written kernel on the card and
# none with atomics, so each gives the same bits on every run:
#   fold_sum / fold_sum_sorted: sum_m = Z[start[m+1]] - Z[start[m]] with Z the
#     prefix sum of the sorted rows (kernels/prefix_sum.py, K7). Its error
#     scales with the running prefix |Z|, not with the segment's own sum;
#   fold_sum_tile / fold_sum_tile_lite: the tile kernel over the sorted rows
#     (kernels/tile_segment_sum.py, K8), exact sums in row order;
#   pallas_segment_sum_presorted: the batched kernel over rows that arrive
#     sorted (kernels/segment_sum_sorted.py, K6), exact sums in row order.
# Every backward is the masked gather ct[key], as in the JAX package.
# ---------------------------------------------------------------------------


class SegmentFoldCtx(NamedTuple):
    perm: torch.Tensor  # [E] int32 destination-sorted edge order (invalid edges last)
    sorted_seg: torch.Tensor  # [E] int32 segment id per sorted edge (S for invalid)
    starts: torch.Tensor  # [S+1] int32 first sorted row of each segment
    valid: torch.Tensor  # [E] bool per sorted edge
    key: torch.Tensor  # [E] int32 keyed segment id in ORIGINAL edge order (S = invalid)


def _keyed(segment_ids: torch.Tensor, num_segments: int,
           mask: Optional[torch.Tensor]) -> torch.Tensor:
    ids = segment_ids.to(torch.int32)
    if mask is None:
        return ids
    return torch.where(mask, ids, torch.full_like(ids, num_segments))


def _segment_starts(sorted_key: torch.Tensor, num_segments: int) -> torch.Tensor:
    bounds = torch.arange(num_segments + 1, dtype=sorted_key.dtype, device=sorted_key.device)
    return torch.searchsorted(sorted_key.contiguous(), bounds, out_int32=True)


def make_segment_fold(segment_ids: torch.Tensor, num_segments: int,
                      mask: Optional[torch.Tensor] = None) -> SegmentFoldCtx:
    """Sort edges by (validity-keyed) destination, once per chunk. The sort is
    stable, as `jnp.argsort` is: the order inside a segment decides the float
    sum."""
    key = _keyed(segment_ids, num_segments, mask)
    perm = torch.argsort(key, stable=True)
    sorted_seg = key[perm]
    return SegmentFoldCtx(perm=perm.to(torch.int32), sorted_seg=sorted_seg,
                          starts=_segment_starts(sorted_seg, num_segments),
                          valid=sorted_seg < num_segments, key=key)


def make_segment_fold_presorted(segment_ids: torch.Tensor, num_segments: int,
                                mask: Optional[torch.Tensor] = None) -> SegmentFoldCtx:
    """SegmentFoldCtx for edges ALREADY sorted ascending by destination with
    invalid edges packed last (the FlatEdgeChunks layout): no argsort, and
    `fold_sum_sorted` skips the permutation gather."""
    key = _keyed(segment_ids, num_segments, mask)
    return SegmentFoldCtx(
        perm=torch.arange(key.shape[0], dtype=torch.int32, device=key.device),
        sorted_seg=key, starts=_segment_starts(key, num_segments),
        valid=key < num_segments, key=key)


def _gather_cotangent(ct: torch.Tensor, key: torch.Tensor, num_segments: int) -> torch.Tensor:
    """d out[m] / d data[e] = 1 iff key[e] == m: the backward of every fold
    is the gather ct[key], zero for rows the forward dropped. ct [..., S] or
    [..., S, C] with key [..., E]."""
    kept = (key >= 0) & (key < num_segments)
    idx = key.clamp(0, num_segments - 1).long()
    if ct.ndim == key.ndim:
        return torch.take_along_dim(ct, idx, dim=-1) * kept.to(ct.dtype)
    return torch.take_along_dim(ct, idx[..., None], dim=-2) * kept[..., None].to(ct.dtype)


def _zero_invalid(rows: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    v = valid if rows.ndim == 1 else valid[:, None]
    return torch.where(v, rows, 0.0)


class _FoldSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, perm, starts, valid, key):
        rows = data if perm is None else data[perm.long()]
        ctx.save_for_backward(key)
        ctx.num_segments = starts.shape[0] - 1
        rows = _zero_invalid(rows, valid)
        out = boundary_difference(rows if rows.ndim == 2 else rows[:, None], starts)
        return (out if rows.ndim == 2 else out[:, 0]).to(data.dtype)

    @staticmethod
    def backward(ctx, ct):
        (key,) = ctx.saved_tensors
        return _gather_cotangent(ct, key, ctx.num_segments), None, None, None, None


def fold_sum(ctx: SegmentFoldCtx, data: torch.Tensor) -> torch.Tensor:
    """data [E] or [E, C] in unsorted edge order -> [S(, C)] segment sums."""
    return _FoldSum.apply(data, ctx.perm, ctx.starts, ctx.valid, ctx.key)


def fold_sum_centred(ctx: SegmentFoldCtx, data: torch.Tensor,
                     base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`fold_sum`, taken as the fold of each row's deviation from its
    segment's baseline plus the baseline times the segment's count: the same
    sums, but the prefix that K7 runs, whose rounding grows with its size,
    is that of the deviations. base [S(, C)]: a baseline a segment (the cell
    centre for coordinates); by default every segment's is the mean of the
    valid rows. The fold of raw positive values (distances, softmax weights)
    or coordinates ordered with the cells would lose digits a cell in f32."""
    S = ctx.starts.shape[0] - 1
    tail = (1,) * (data.ndim - 1)
    if base is None:
        valid = (ctx.key < S).reshape(ctx.key.shape + tail).to(data.dtype)
        mean = (data * valid).sum(0) / valid.sum().clamp_min(1.0)
        base = mean.expand((S,) + tuple(data.shape[1:]))
    rows = base[ctx.key.long().clamp(0, S - 1)]
    cnt = fold_count(ctx, data.dtype).reshape((S,) + tail)
    return fold_sum(ctx, data - rows) + cnt * base


def fold_sum_sorted(ctx: SegmentFoldCtx, data: torch.Tensor) -> torch.Tensor:
    """`fold_sum` for a presorted ctx: no permutation gather."""
    return _FoldSum.apply(data, None, ctx.starts, ctx.valid, ctx.key)


def fold_count(ctx: SegmentFoldCtx, dtype=torch.float32) -> torch.Tensor:
    return (ctx.starts[1:] - ctx.starts[:-1]).to(dtype)


def fold_mean(ctx: SegmentFoldCtx, data: torch.Tensor) -> torch.Tensor:
    total = fold_sum(ctx, data)
    cnt = fold_count(ctx, total.dtype).clamp_min(1.0)
    return total / cnt.reshape(cnt.shape + (1,) * (total.ndim - 1))


def fold_max(ctx: SegmentFoldCtx, data: torch.Tensor, empty_value: float = 0.0) -> torch.Tensor:
    """data [E] or [E, C] in unsorted edge order -> [S(, C)] segment max of
    the sorted rows; empty segments give `empty_value`."""
    num_segments = ctx.starts.shape[0] - 1
    rows = data[ctx.perm.long()]
    out = _segment_amax(rows, ctx.sorted_seg.long(), num_segments)[:num_segments]
    nonempty = ctx.starts[1:] > ctx.starts[:-1]
    if out.ndim > 1:
        nonempty = nonempty[:, None]
    return torch.where(nonempty, out, torch.full_like(out, empty_value))


class TileFold(NamedTuple):
    perm: torch.Tensor  # [E] int32 destination-sorted edge order (invalid last)
    sorted_seg: torch.Tensor  # [E] int32 segment id per sorted edge (S for invalid)
    ts: torch.Tensor  # [T+1] int32 first sorted row of each segment tile
    key: torch.Tensor  # [E] int32 keyed segment id in ORIGINAL edge order


def make_tile_fold(segment_ids: torch.Tensor, num_segments: int,
                   mask: Optional[torch.Tensor] = None, seg_tile: int = 512) -> TileFold:
    """The sort of `make_segment_fold` with the T + 1 tile boundaries in place
    of the S + 1 segment starts."""
    key = _keyed(segment_ids, num_segments, mask)
    perm = torch.argsort(key, stable=True)
    sorted_seg = key[perm]
    return TileFold(perm=perm.to(torch.int32), sorted_seg=sorted_seg,
                    ts=tile_boundaries(sorted_seg, num_segments, seg_tile), key=key)


class _FoldSumTile(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, perm, sorted_seg, ts, key, num_segments, seg_tile):
        ctx.save_for_backward(key)
        ctx.num_segments = num_segments
        rows = data if data.ndim == 2 else data[:, None]
        out = tile_segment_sum(rows.to(torch.float32), sorted_seg, ts=ts,
                               num_segments=num_segments, seg_tile=seg_tile, perm=perm)
        return (out if data.ndim == 2 else out[:, 0]).to(data.dtype)

    @staticmethod
    def backward(ctx, ct):
        (key,) = ctx.saved_tensors
        return (_gather_cotangent(ct, key, ctx.num_segments),) + (None,) * 6


def fold_sum_tile(ctx: SegmentFoldCtx, data: torch.Tensor, seg_tile: int = 512) -> torch.Tensor:
    """`fold_sum` through the tile kernel, boundaries read from ctx.starts."""
    return _FoldSumTile.apply(data, ctx.perm, ctx.sorted_seg, tile_starts(ctx.starts, seg_tile),
                              ctx.key, ctx.starts.shape[0] - 1, seg_tile)


def fold_sum_tile_lite(tf: TileFold, data: torch.Tensor, num_segments: int,
                       seg_tile: int = 512) -> torch.Tensor:
    """`fold_sum` through the tile kernel from tile boundaries only."""
    return _FoldSumTile.apply(data, tf.perm, tf.sorted_seg, tf.ts, tf.key, num_segments,
                              seg_tile)


class _SegmentSumPresorted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data_be, key_be, num_segments, passes):
        ctx.save_for_backward(key_be)
        ctx.num_segments = num_segments
        return segment_sum_sorted(data_be, key_be, num_segments, passes=passes)

    @staticmethod
    def backward(ctx, ct):
        (key_be,) = ctx.saved_tensors
        return _gather_cotangent(ct, key_be, ctx.num_segments), None, None, None


def pallas_segment_sum_presorted(data_be: torch.Tensor, seg_be: torch.Tensor,
                                 mask_be: Optional[torch.Tensor], num_segments: int,
                                 passes: int = 2) -> torch.Tensor:
    """data [B, E, P] with rows sorted by destination within a batch, seg
    [B, E], mask [B, E] (invalid rows packed last) -> [B, num_segments, P]
    through K6; the name is the JAX function's. `passes` changes nothing:
    the CUDA kernel sums in exact float32."""
    return _SegmentSumPresorted.apply(data_be.to(torch.float32),
                                      _keyed(seg_be, num_segments, mask_be), num_segments,
                                      passes)
