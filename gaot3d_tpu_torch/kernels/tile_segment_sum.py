"""Segment sum of destination-sorted rows from tile boundaries (K8,
`csrc/tile_segment_sum.cu`) with its plain PyTorch version, the boundary
helper and the cumsum form of the same sum.

Replaces gaot3d_tpu/ops/pallas_kernels.py `tile_segment_sum`
(`_tile_segment_sum_call`), `tile_boundaries` and `_sorted_fold`. The model
reaches the kernel through ops/segment.py `fold_sum_tile_lite`
(`segment_impl: tile`). The kernel's design and what bounds it on an H100 are
in its source.

Contract: rows are in ascending segment order, rows to drop carry an id of
`num_segments` or more and so sort last; the caller names the row at which
each tile of `seg_tile` segments begins, either as `ts` [T + 1] with
`num_segments`, or as the full per-segment `starts` [S + 1] from which the
tile boundaries are read. The TPU kernel visits at most `max_blocks` blocks of
`edge_block` rows per tile and falls back to `_sorted_fold` beyond that; the
CUDA kernel loops over a tile's rows however many they are, so both
parameters are accepted and ignored. With `perm`, `sorted_data` holds the
rows in their original order and row r of the sorted order is
`sorted_data[perm[r]]`: the kernel gathers while it sums.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .build import load_cuda_library
from .prefix_sum import cumsum_fast


def _library() -> ctypes.CDLL:
    lib = load_cuda_library("tile_segment_sum", "tile_segment_sum.cu",
                            headers=["segment_walk.cuh"])
    lib.gaot_tile_segment_sum.restype = ctypes.c_int
    lib.gaot_tile_segment_sum.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return lib


def tile_boundaries(sorted_seg: torch.Tensor, num_segments: int,
                    seg_tile: int = 512) -> torch.Tensor:
    """ts[t] = first row whose segment id is >= t * seg_tile, for t = 0..T
    (ts[T] = first row to drop), int32 [T + 1]."""
    tiles = -(-num_segments // seg_tile)
    bounds = torch.arange(tiles + 1, dtype=sorted_seg.dtype, device=sorted_seg.device) * seg_tile
    return torch.searchsorted(sorted_seg.contiguous(), bounds.clamp_max(num_segments),
                              out_int32=True)


def tile_starts(starts: torch.Tensor, seg_tile: int) -> torch.Tensor:
    """Per-segment starts [S + 1] -> the tile boundaries ts [T + 1] among them."""
    S = starts.shape[0] - 1
    at = torch.arange(-(-S // seg_tile) + 1, device=starts.device) * seg_tile
    return starts[at.clamp_max(S)]


def boundary_difference(sorted_rows: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Sorted rows [E, C] with the rows to drop already zeroed, per-segment
    starts [S + 1] -> segment sums [S, C] as Z[starts[m+1]] - Z[starts[m]],
    Z the prefix sum through K7. The error grows with the running prefix, not
    with a segment's own sum."""
    z = cumsum_fast(sorted_rows)
    zpad = torch.cat([torch.zeros_like(z[:1]), z], dim=0)
    idx = starts.long()
    return zpad[idx[1:]] - zpad[idx[:-1]]


def _sorted_fold(sorted_data: torch.Tensor, starts: torch.Tensor,
                 num_valid) -> torch.Tensor:
    """Cumsum + boundary-difference segment sum over destination-sorted rows
    [E, P] with per-segment starts [S + 1]; rows from `num_valid` on are
    dropped."""
    keep = torch.arange(sorted_data.shape[0], device=sorted_data.device)[:, None] < num_valid
    return boundary_difference(torch.where(keep, sorted_data, 0.0), starts)


def tile_segment_sum_reference(sorted_data: torch.Tensor, sorted_seg: torch.Tensor,
                               ts: torch.Tensor, num_segments: int,
                               perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of `tile_segment_sum`: rows before ts[-1] whose id lies
    in [0, num_segments) are added to their segment in row order."""
    rows = sorted_data if perm is None else sorted_data[perm.long()]
    ids = sorted_seg.long()
    E = ids.shape[0]
    keep = (torch.arange(E, device=ids.device) < ts[-1]) & (ids >= 0) & (ids < num_segments)
    ids = torch.where(keep, ids, torch.full_like(ids, num_segments))
    out = torch.zeros((num_segments + 1, rows.shape[1]), dtype=torch.float32,
                      device=rows.device)
    out.index_add_(0, ids, rows.to(torch.float32))
    return out[:num_segments]


def tile_segment_sum(sorted_data: torch.Tensor, sorted_seg: torch.Tensor,
                     starts: Optional[torch.Tensor] = None, *,
                     ts: Optional[torch.Tensor] = None, num_segments: Optional[int] = None,
                     seg_tile: int = 512, edge_block: int = 1024, max_blocks: int = 8,
                     perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sorted_data [E, P] float32, sorted_seg [E] int32, boundaries as
    `starts` [S + 1] or as `ts` [T + 1] with `num_segments` -> [S, P] float32
    (see the module docstring for the contract)."""
    if sorted_data.ndim != 2 or sorted_seg.shape != sorted_data.shape[:1]:
        raise ValueError(f"sorted_data must be [E, P] and sorted_seg [E], got "
                         f"{tuple(sorted_data.shape)} and {tuple(sorted_seg.shape)}")
    if seg_tile <= 0:
        raise ValueError(f"seg_tile must be positive, got {seg_tile}")
    if ts is None:
        if starts is None:
            raise ValueError("pass starts [S + 1], or ts with num_segments")
        num_segments = starts.shape[0] - 1
        ts = tile_starts(starts, seg_tile)
    elif num_segments is None:
        raise ValueError("ts needs num_segments")
    if num_segments <= 0:
        raise ValueError(f"num_segments must be positive, got {num_segments}")
    if ts.shape != (-(-num_segments // seg_tile) + 1,):
        raise ValueError(f"ts must hold {-(-num_segments // seg_tile) + 1} boundaries, got "
                         f"{tuple(ts.shape)}")
    if sorted_data.device.type == "cpu":
        return tile_segment_sum_reference(sorted_data, sorted_seg, ts, num_segments, perm)
    if sorted_data.device.type != "cuda":
        raise ValueError(f"tile_segment_sum: no kernel for device {sorted_data.device}")
    if sorted_data.dtype != torch.float32 or sorted_seg.dtype != torch.int32:
        raise ValueError(f"tile_segment_sum takes float32 rows and int32 ids, got "
                         f"{sorted_data.dtype} and {sorted_seg.dtype}")
    E, P = sorted_data.shape
    others = {"sorted_seg": sorted_seg, "ts": ts}
    if perm is not None:
        if perm.shape != (E,):
            raise ValueError(f"perm must be [{E}], got {tuple(perm.shape)}")
        others["perm"] = perm
    for name, t in others.items():
        if t.device != sorted_data.device:
            raise ValueError(f"{name} is on {t.device}, the rows on {sorted_data.device}")
    out = torch.empty((num_segments, P), dtype=torch.float32, device=sorted_data.device)
    if P == 0:
        return out
    data = sorted_data.contiguous()
    ids = sorted_seg.contiguous()
    ts32 = ts.to(torch.int32).contiguous()
    perm32 = None if perm is None else perm.to(torch.int32).contiguous()
    with torch.cuda.device(data.device):
        err = _library().gaot_tile_segment_sum(
            data.data_ptr(), ids.data_ptr(), None if perm32 is None else perm32.data_ptr(),
            ts32.data_ptr(), out.data_ptr(), P, num_segments, seg_tile,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"tile_segment_sum launch failed: cudaError {err}")
    tile_segment_sum.launches += 1
    return out


tile_segment_sum.launches = 0
