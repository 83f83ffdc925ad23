"""Segment sum of rows sorted by segment id (K6,
`csrc/segment_sum_sorted.cu`) with its plain PyTorch version.

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
"""
from __future__ import annotations

import ctypes

import torch

from .build import load_cuda_library

# the kernel a call launches, by the name a profiler shows
DEVICE_KERNELS = ("segment_sum_sorted_kernel",)


def _library() -> ctypes.CDLL:
    lib = load_cuda_library("segment_sum_sorted", "segment_sum_sorted.cu",
                            headers=["segment_walk.cuh"])
    lib.gaot_segment_sum_sorted.restype = ctypes.c_int
    lib.gaot_segment_sum_sorted.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
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
    with torch.cuda.device(data.device):
        err = _library().gaot_segment_sum_sorted(
            data3.data_ptr(), ids2.data_ptr(), out.data_ptr(), B, E, P, num_segments,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_sum_sorted launch failed: cudaError {err}")
    segment_sum_sorted.launches += 1
    return out[0] if squeeze else out


segment_sum_sorted.launches = 0
