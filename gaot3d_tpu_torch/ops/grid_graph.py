"""The edge build on the device (port of gaot3d_tpu/ops/grid_graph.py
`_candidate_window`, `build_edge_slots`, `build_edge_slots_batched`,
`stencil_base_cell`, `compact_slots` and `max_slot_degree`).

Edges between N points and the regular latent grid live in the formats of
`gaot3d_tpu_torch/edges.py`, which this module names too (`LatentGrid`,
`EdgeSlots`, `FlatEdgeChunks`, `SectionedEdgeSlots`, `stencil_widths`,
`window_spec`), as the JAX module does. The host-side code that makes slots
is in `gaot3d_tpu_torch/data/host_graph.py`; `build_edge_slots_batched`
makes them from tensors where those lie (the card, or the CPU), in plain
tensor operations that repeat the JAX build's f32 operations one by one;
`build_budgeted_slots` picks K10 (`kernels/slot_build.py`) where it engages.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..edges import (EdgeSlots, FlatEdgeChunks, LatentGrid, SectionedEdgeSlots,  # noqa: F401
                     stencil_widths, window_spec)
from ..kernels import slot_build as k10


def compact_slots(slots: EdgeSlots, budget: int) -> EdgeSlots:
    """Pack valid slots to the front of each row (slot order kept) and keep
    `budget` columns. Exact when budget >= the max per-row degree."""
    order = torch.argsort((~slots.mask).to(torch.uint8), dim=-1, stable=True)[..., :budget]
    return EdgeSlots(torch.gather(slots.lat_idx, -1, order),
                     torch.gather(slots.mask, -1, order))


def max_slot_degree(slots: EdgeSlots) -> int:
    """The most valid slots of any row (one host sync), to hold a slot budget
    against real data."""
    return int(slots.mask.sum(dim=-1).max())


def _candidate_window(points: torch.Tensor, grid: LatentGrid, widths: Tuple[int, int, int]):
    """Per-axis candidate cells [..., N, w_a] (int32, clamped inside the grid)
    and their coordinates, in the JAX build's f32 operations, each rounded
    on its own: floor((p - lo) / h), and lo + i * h as a product and then a
    sum (one fused multiply-add would round once and move a few candidates
    across the radius)."""
    idx_axes, coord_axes = [], []
    for a in range(3):
        w, h, lo, dim = widths[a], grid.spacing[a], grid.lo[a], grid.dims[a]
        p = points[..., a]
        if h == 0.0:
            f = torch.zeros(p.shape, dtype=torch.int32, device=p.device)
        else:
            # the divisor lies on the points' device: CUDA turns a division by
            # a host scalar into a product with its reciprocal
            f = torch.floor((p - lo) / torch.full((), h, dtype=p.dtype, device=p.device))
            f = f.to(torch.int32)
        base = (f - (w // 2 - 1)).clamp_(0, max(dim - w, 0))
        idx = base[..., None] + torch.arange(w, dtype=torch.int32, device=p.device)
        idx_axes.append(idx)
        coord_axes.append(idx.to(p.dtype) * h + lo)
    return idx_axes, coord_axes


def build_edge_slots_batched(points: torch.Tensor, grid: LatentGrid, radius: float,
                             k_neighbors: int = 1, strategy: str = "radius",
                             point_mask: Optional[torch.Tensor] = None) -> EdgeSlots:
    """Stencil edge slots of a batch of clouds [B, N, 3] -> EdgeSlots
    [B, N, K], K the window's size, on the points' device.

    - radius: a slot holds its cell when d^2 = d0^2 + d1^2 + d2^2 (summed in
      that order) is at most r^2 rounded in f32;
    - knn: the k nearest cells of the window, the lower slot on a tie (as
      `jax.lax.top_k` keeps it): k passes of a first-occurrence argmin;
    - bidirectional: their union; reverse: the same slot set;
    - point_mask [B, N] (all true by default): false rows hold no edge.
    The JAX build's f32 operations one by one, so the same bits on the CPU
    and on the card."""
    widths, radius_test, k = window_spec(grid, radius, k_neighbors, strategy)
    if points.ndim != 3 or points.shape[-1] != 3:
        raise ValueError(f"points must be [B, N, 3], got {tuple(points.shape)}")
    B, N, _ = points.shape
    K = widths[0] * widths[1] * widths[2]
    with torch.no_grad():
        idx_axes, (c0, c1, c2) = _candidate_window(points, grid, widths)
        _, D1, D2 = grid.dims
        # slot (a, b, c) of the window is the base cell plus (a * D1 + b) * D2 + c
        a, b, c = (torch.arange(w, dtype=torch.int32, device=points.device) for w in widths)
        offsets = ((a[:, None, None] * D1 + b[None, :, None]) * D2 + c[None, None, :]).reshape(K)
        lat_idx = _base_cell(idx_axes, grid)[..., None] + offsets
        d0 = c0[..., :, None, None] - points[..., 0, None, None, None]
        d1 = c1[..., None, :, None] - points[..., 1, None, None, None]
        d2 = c2[..., None, None, :] - points[..., 2, None, None, None]
        dist2 = (d0 * d0 + d1 * d1 + d2 * d2).reshape(B, N, K)
        del d0, d1, d2
        mask = torch.zeros((B, N, K), dtype=torch.bool, device=points.device)
        if radius_test:
            r = np.float32(radius)
            mask |= dist2 <= torch.full((), r * r, dtype=points.dtype, device=points.device)
        if k:
            left = dist2 if k <= 1 else dist2.clone()
            for j in range(k):
                pick = left.argmin(dim=-1, keepdim=True)
                mask.scatter_(-1, pick, True)
                if j + 1 < k:
                    left.scatter_(-1, pick, float("inf"))
        if point_mask is not None:
            mask &= point_mask[..., None]
    return EdgeSlots(lat_idx, mask)


def build_edge_slots(points: torch.Tensor, grid: LatentGrid, radius: float,
                     k_neighbors: int = 1, strategy: str = "radius",
                     point_mask: Optional[torch.Tensor] = None) -> EdgeSlots:
    """`build_edge_slots_batched` for one cloud [N, 3] -> EdgeSlots [N, K]."""
    slots = build_edge_slots_batched(
        points[None], grid, radius, k_neighbors, strategy,
        None if point_mask is None else point_mask[None])
    return EdgeSlots(slots.lat_idx[0], slots.mask[0])


def build_budgeted_slots(points: torch.Tensor, grid: LatentGrid, radius: float,
                         k_neighbors: int, strategy: str,
                         point_mask: Optional[torch.Tensor] = None,
                         budget: Optional[int] = None,
                         chunk: Optional[int] = None) -> EdgeSlots:
    """`build_edge_slots_batched`, then `compact_slots` to `budget` where it
    is below the window's K. On a card, where `kernels/slot_build.py`
    `engages`, one launch of K10 does both and writes [B, N, budget] alone;
    otherwise the plain version runs over node chunks of `chunk` rows, so
    that one chunk's [B, chunk, K] window is the largest transient. Both
    steps work row by row, so the chunks give one build's bits, and K10
    gives them too."""
    if k10.engages(points.device, points.dtype, grid, radius, k_neighbors, strategy, budget):
        return k10.slot_build(points.detach().contiguous(), grid, radius, k_neighbors,
                              strategy, None if point_mask is None else point_mask.contiguous(),
                              budget)
    n = points.shape[1]
    step = n if not chunk or chunk >= n else int(chunk)
    parts = []
    for c0 in range(0, n, step):
        pm = None if point_mask is None else point_mask[:, c0:c0 + step]
        slots = build_edge_slots_batched(points[:, c0:c0 + step], grid, radius, k_neighbors,
                                         strategy, pm)
        if budget is not None and budget < slots.lat_idx.shape[-1]:
            slots = compact_slots(slots, budget)
        parts.append(slots)
    if len(parts) == 1:
        return parts[0]
    return EdgeSlots(torch.cat([s.lat_idx for s in parts], dim=1),
                     torch.cat([s.mask for s in parts], dim=1))


def stencil_base_cell(points: torch.Tensor, grid: LatentGrid, radius: float,
                      k_neighbors: int, strategy: str) -> torch.Tensor:
    """Flattened base cell of each point's stencil window [..., N] (int32):
    lat_idx[n, k] is stencil_base_cell(n) plus an offset that depends on k
    alone, which is how `build_edge_slots_batched` makes lat_idx."""
    eff = "bidirectional" if strategy == "reverse" else strategy
    widths = stencil_widths(grid, radius, k_neighbors, eff)
    with torch.no_grad():
        return _base_cell(_candidate_window(points, grid, widths)[0], grid)


def _base_cell(idx_axes, grid: LatentGrid) -> torch.Tensor:
    """The flattened cell of each window's first slot, from
    `_candidate_window`'s per-axis cells."""
    i0, i1, i2 = (idx[..., 0] for idx in idx_axes)
    _, D1, D2 = grid.dims
    return (i0 * D1 + i1) * D2 + i2
