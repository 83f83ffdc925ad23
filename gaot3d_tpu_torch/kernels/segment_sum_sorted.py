"""Segment sum of rows sorted by segment id (K6,
`csrc/segment_sum_sorted.cu`) with its plain PyTorch version and its
ordered twin.

Replaces gaot3d_tpu/ops/pallas_segment.py `segment_sum_sorted_pallas` and the
batch-stride wrapper gaot3d_tpu/ops/segment.py `_pallas_sum_sorted_b`. The
model reaches it through ops/segment.py `pallas_segment_sum_presorted`
(`flat_order: dst` with `flat_reduce_impl: pallas`). The kernel's design and
what bounds it on an H100 are in its source.

Contract: within a batch the ids are nondecreasing; a row to drop carries an
id of `num_segments` or more, so such rows sit at the tail. Rows with a
negative id are dropped too. Sums are exact float32 taken in row order, the
same bits on every launch; `passes` (the TPU kernel's bf16 hi/lo split) is
accepted and changes nothing.

The kernel splits each batch's merged sequence of rows and segment
boundaries into shares of `share_items(P)` items, one a CTA (it takes the
share as an argument). `merge_path_split` computes that split with plain
torch ops, and `segment_sum_sorted_ordered_reference` sums along it: each
segment by its one owner, in row order from 0.0, which gives the kernel's
bits. On the CPU `index_add_` adds in row order too, so the plain version
gives the same bits there; on the card its order is not fixed.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .build import load_cuda_library

# the kernel a call launches, by the name a profiler shows
DEVICE_KERNELS = ("segment_sum_sorted_kernel",)

# items of a CTA's share times P, and the floats of rows it stages at once:
# at P = 43 a share is 190 items, and an H100 SM holds the shared memory of
# the kernel's 6 CTAs
SHARE_FLOATS = 8192


def share_items(P: int) -> int:
    """Items (rows and segment boundaries) of the merged sequence a CTA takes."""
    return max(1, SHARE_FLOATS // P)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_cuda_library("segment_sum_sorted", "segment_sum_sorted.cu",
                            headers=["hopper.cuh"])
    lib.gaot_segment_sum_sorted.restype = ctypes.c_int
    lib.gaot_segment_sum_sorted.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.gaot_segment_sum_sorted_ctas_per_sm.restype = ctypes.c_int
    lib.gaot_segment_sum_sorted_ctas_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


def segment_sum_sorted_reference(data: torch.Tensor, ids: torch.Tensor,
                                 num_segments: int) -> torch.Tensor:
    """Plain version of `segment_sum_sorted` (it does not need sorted ids)."""
    squeeze = data.ndim == 2
    if squeeze:
        data, ids = data[None], ids[None]
    B, _, P = data.shape
    idx = ids.long()
    idx = torch.where((idx >= 0) & (idx < num_segments), idx,
                      torch.full_like(idx, num_segments))
    out = torch.zeros((B, num_segments + 1, P), dtype=torch.float32, device=data.device)
    for b in range(B):
        out[b].index_add_(0, idx[b], data[b].to(torch.float32))
    out = out[:, :num_segments]
    return out[0] if squeeze else out


def merge_path_split(ids: torch.Tensor, num_segments: int, share: int) -> dict:
    """The kernel's split of one batch: ids [E] nondecreasing. Row r stands
    at r + clamp(ids[r] + 1, 0, M) of the merged sequence of E rows and M
    boundaries, boundary s at s + (rows with an id below s). CTA j takes the
    items [j * share, (j + 1) * share) and owns the segments [s0, s1) whose
    boundaries fall there; it reads the rows [a, z) of those segments, past
    its share's last row r1 when the last of them goes on. Returns int64
    tensors [ctas] under those names (and r0, where its share begins)."""
    M, E = num_segments, ids.shape[0]
    idx = ids.long()
    pos = torch.arange(E, device=ids.device) + (idx + 1).clamp(0, M)
    d0 = torch.arange(0, E + M, share, device=ids.device)
    d1 = (d0 + share).clamp_max(E + M)
    r0 = torch.searchsorted(pos, d0)
    r1 = torch.searchsorted(pos, d1)
    s0, s1 = d0 - r0, d1 - r1
    return {"r0": r0, "r1": r1, "s0": s0, "s1": s1,
            "a": torch.searchsorted(idx, s0), "z": torch.searchsorted(idx, s1)}


def sum_in_row_order(rows: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """rows [n, P] whose segment ids `seg` [n] (in [0, num_segments)) keep
    each segment's rows adjacent -> [num_segments, P]: each segment's sum
    starts from 0.0 and adds its k-th row for k = 0, 1, ... in float32."""
    out = torch.zeros((num_segments, rows.shape[1]), dtype=torch.float32, device=rows.device)
    if seg.numel() == 0:
        return out
    # rank of each row within its segment; the rows of rank k, k = 0, 1, ...
    pos = torch.arange(seg.numel(), device=seg.device)
    first = torch.ones_like(seg, dtype=torch.bool)
    first[1:] = seg[1:] != seg[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), dim=0).values
    order = torch.argsort(rank, stable=True)
    counts = torch.bincount(rank).tolist()  # segments with more than k rows: nonincreasing
    lo = 0
    for count in counts:
        if count == 1:
            # one segment has rows of this rank and above: add them one after
            # the other (numpy's accumulate adds in order, in the array's type)
            s = seg[order[lo]]
            tail = torch.cat([out[s][None], rows[order[lo:]]]).cpu().numpy()
            out[s] = torch.from_numpy(np.add.accumulate(tail, axis=0)[-1]).to(out.device)
            break
        at = order[lo:lo + count]
        out[seg[at]] = out[seg[at]] + rows[at]
        lo += count
    return out


def segment_sum_sorted_ordered_reference(data: torch.Tensor, ids: torch.Tensor,
                                         num_segments: int, share: int) -> torch.Tensor:
    """`segment_sum_sorted` along the kernel's own split (`merge_path_split`
    with `share`): each CTA that owns segments sums the rows [a, z) it reads
    into them, each segment in row order from 0.0, in float32 additions. The
    same bits as the kernel, and as K8 on the same sorted rows."""
    squeeze = data.ndim == 2
    if squeeze:
        data, ids = data[None], ids[None]
    outs = []
    for b in range(data.shape[0]):
        split = merge_path_split(ids[b], num_segments, share)
        owns = split["s0"] < split["s1"]
        a, n = split["a"][owns], (split["z"] - split["a"])[owns]
        # the rows of [a, a + n) of each owner, one owner after the other
        read = (torch.repeat_interleave(a - (torch.cumsum(n, 0) - n), n)
                + torch.arange(int(n.sum()), device=n.device))
        outs.append(sum_in_row_order(data[b][read].to(torch.float32), ids[b][read].long(),
                                     num_segments))
    out = torch.stack(outs)
    return out[0] if squeeze else out


def segment_sum_sorted(data: torch.Tensor, ids: torch.Tensor, num_segments: int,
                       passes: int = 1) -> torch.Tensor:
    """data [B, E, P] (or [E, P]) float32, ids [B, E] (or [E]) int32 sorted
    within a batch -> [B, num_segments, P] (or [num_segments, P])."""
    if data.ndim not in (2, 3) or ids.shape != data.shape[:-1]:
        raise ValueError(f"data must be [B, E, P] or [E, P] with ids of its leading shape, "
                         f"got {tuple(data.shape)} and {tuple(ids.shape)}")
    if num_segments <= 0:
        raise ValueError(f"num_segments must be positive, got {num_segments}")
    if data.device.type == "cpu":
        return segment_sum_sorted_reference(data, ids, num_segments)
    if data.device.type != "cuda":
        raise ValueError(f"segment_sum_sorted: no kernel for device {data.device}")
    if data.dtype != torch.float32 or ids.dtype != torch.int32:
        raise ValueError(f"segment_sum_sorted takes float32 data and int32 ids, got "
                         f"{data.dtype} and {ids.dtype}")
    if ids.device != data.device:
        raise ValueError(f"ids are on {ids.device}, data on {data.device}")
    squeeze = data.ndim == 2
    data3 = (data[None] if squeeze else data).contiguous()
    ids2 = (ids[None] if squeeze else ids).contiguous()
    B, E, P = data3.shape
    out = torch.empty((B, num_segments, P), dtype=torch.float32, device=data.device)
    if P == 0:
        return out[0] if squeeze else out
    lib = _library()
    args = (data3.data_ptr(), ids2.data_ptr(), out.data_ptr(), B, E, P, num_segments,
            share_items(P), torch.cuda.current_stream(data.device).cuda_stream)
    if data.device.index == torch.cuda.current_device():
        err = lib.gaot_segment_sum_sorted(*args)
    else:
        with torch.cuda.device(data.device):
            err = lib.gaot_segment_sum_sorted(*args)
    if err != 0:
        raise RuntimeError(f"segment_sum_sorted launch failed: cudaError {err}")
    segment_sum_sorted.launches += 1
    return out[0] if squeeze else out


segment_sum_sorted.launches = 0
