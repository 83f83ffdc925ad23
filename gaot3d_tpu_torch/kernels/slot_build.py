"""The budgeted slot build in one pass (K10, `csrc/slot_build.cu`), and the
predicate that picks it.

`ops/grid_graph.py` `build_budgeted_slots` makes the edge slots between
points [B, N, 3] and the latent grid: each point's stencil window, the
radius and kNN tests, then `compact_slots` to `budget` columns. Its plain
version holds a [B, chunk, K] window in memory a node chunk at a time and
sorts it. K10 does the whole build in one launch, a thread a point, and
writes only the compacted [B, N, budget] `EdgeSlots`, with the plain
version's bits (the kernel's source says how).

- `engages` is the one predicate, which `build_budgeted_slots` alone asks:
  points on a card in float32, a budget below the window's K and at most
  MAX_BUDGET, window widths of at most MAX_WIDTH and at most MAX_KNN kNN
  picks. Everything else keeps the plain path: CPU tensors (the plain
  version the CPU tests use), no budget (edge sampling and caps), wider
  windows, more picks or larger budgets.
- `slot_build` is K10 on CUDA tensors; it checks its inputs, then refuses
  any other device.

`slot_build.launches` counts K10's launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from ..edges import EdgeSlots, LatentGrid, window_spec
from .build import load_cuda_library

MAX_WIDTH = 16    # cells a window spans on one axis
MAX_KNN = 8       # kNN picks a row: each takes one more pass over the window
MAX_BUDGET = 256  # slots a row: a block stages at least a warp's rows in 48 KB of shared memory


def _library() -> ctypes.CDLL:
    lib = load_cuda_library("slot_build", "slot_build.cu")
    lib.gaot_slot_build.restype = ctypes.c_int
    lib.gaot_slot_build.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 3
        + [ctypes.c_float] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 2
        + [ctypes.c_void_p] * 3)
    return lib


def _built_for(widths, knn: int, budget: Optional[int]) -> bool:
    return (budget is not None and 0 < budget < math.prod(widths) and budget <= MAX_BUDGET
            and all(w <= MAX_WIDTH for w in widths) and knn <= MAX_KNN)


def engages(device, dtype: torch.dtype, grid: LatentGrid, radius: float, k_neighbors: int,
            strategy: str, budget: Optional[int]) -> bool:
    """Whether `build_budgeted_slots` runs K10: points on `device` a card, of
    `dtype` float32, `budget` set and below the window's K, the window's
    widths and kNN picks within what K10 is built for."""
    if torch.device(device).type != "cuda" or dtype != torch.float32:
        return False
    widths, _, knn = window_spec(grid, radius, k_neighbors, strategy)
    return _built_for(widths, knn, budget)


def _check(points, point_mask, widths, knn, budget):
    if points.dtype != torch.float32:
        raise ValueError(f"points must be float32, got {points.dtype}")
    if points.ndim != 3 or points.shape[-1] != 3:
        raise ValueError(f"points must be [B, N, 3], got {tuple(points.shape)}")
    if not points.is_contiguous():
        raise ValueError("points must be contiguous")
    if point_mask is not None:
        if point_mask.dtype != torch.bool:
            raise ValueError(f"point_mask must be bool, got {point_mask.dtype}")
        if point_mask.shape != points.shape[:2]:
            raise ValueError(f"point_mask must be {list(points.shape[:2])}, got "
                             f"{list(point_mask.shape)}")
        if not point_mask.is_contiguous():
            raise ValueError("point_mask must be contiguous")
        if point_mask.device != points.device:
            raise ValueError(f"point_mask is on {point_mask.device}, points on {points.device}")
    if not _built_for(widths, knn, budget):
        raise ValueError(f"K10 takes a budget in [1, K) of at most {MAX_BUDGET}, widths of at "
                         f"most {MAX_WIDTH} and at most {MAX_KNN} kNN picks: got budget "
                         f"{budget}, widths {widths}, {knn} picks")


def slot_build(points: torch.Tensor, grid: LatentGrid, radius: float, k_neighbors: int,
               strategy: str, point_mask: Optional[torch.Tensor], budget: int) -> EdgeSlots:
    """`build_budgeted_slots` of points [B, N, 3] float32 (point_mask [B, N]
    bool or None, on the same card) at `budget` -> EdgeSlots [B, N, budget],
    in one launch of K10."""
    widths, _, knn = window_spec(grid, radius, k_neighbors, strategy)
    _check(points, point_mask, widths, knn, budget)
    if points.device.type != "cuda":
        raise ValueError(f"slot_build: no kernel for device {points.device}")
    B, N, _ = points.shape
    lat_idx = torch.empty((B, N, budget), dtype=torch.int32, device=points.device)
    mask = torch.empty((B, N, budget), dtype=torch.bool, device=points.device)
    launch_build(points, point_mask, grid, radius, k_neighbors, strategy, lat_idx, mask)
    slot_build.launches += 1
    return EdgeSlots(lat_idx, mask)


def launch_build(points, point_mask, grid, radius, k_neighbors, strategy, lat_idx, mask):
    """One launch of K10 on checked, contiguous tensors: points [B, N, 3],
    point_mask [B, N] or None, into lat_idx and mask [B, N, budget]."""
    widths, radius_test, knn = window_spec(grid, radius, k_neighbors, strategy)
    r = np.float32(radius)
    with torch.cuda.device(points.device):
        err = _library().gaot_slot_build(
            points.data_ptr(), None if point_mask is None else point_mask.data_ptr(),
            points.shape[0] * points.shape[1], *grid.dims, *grid.lo, *grid.spacing, *widths,
            int(radius_test), float(r * r), knn, lat_idx.shape[-1], lat_idx.data_ptr(),
            mask.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"slot_build launch failed: cudaError {err}")


slot_build.launches = 0
