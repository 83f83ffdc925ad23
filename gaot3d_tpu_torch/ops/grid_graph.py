"""Latent grid, edge-slot containers and the edge build on the device (port
of gaot3d_tpu/ops/grid_graph.py `LatentGrid`, `EdgeSlots`, `FlatEdgeChunks`,
`SectionedEdgeSlots`, `stencil_widths`, `_candidate_window`,
`build_edge_slots`, `build_edge_slots_batched`, `stencil_base_cell`,
`compact_slots` and `max_slot_degree`).

Edges between N points and the regular latent grid live in a static slot
layout: `lat_idx[..., n, k]` is the flattened latent cell of slot k of point n
and `mask[..., n, k]` says whether that edge exists. Masked slots may carry any
index; every consumer drops them. The host-side code that makes these arrays
is in `gaot3d_tpu_torch/data/host_graph.py`; `build_edge_slots_batched` makes
them from tensors where those lie (the card, or the CPU), in plain tensor
operations that repeat the JAX build's f32 operations one by one.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

DECODER_STRATEGIES = ("knn", "radius", "bidirectional", "reverse")


@dataclass(frozen=True)
class LatentGrid:
    """Regular D x H x W grid of latent tokens over an axis-aligned box."""

    dims: Tuple[int, int, int]
    lo: Tuple[float, float, float] = (-1.0, -1.0, -1.0)
    hi: Tuple[float, float, float] = (1.0, 1.0, 1.0)

    @property
    def num_tokens(self) -> int:
        d, h, w = self.dims
        return d * h * w

    @property
    def spacing(self) -> Tuple[float, float, float]:
        return tuple(
            (self.hi[a] - self.lo[a]) / max(self.dims[a] - 1, 1) for a in range(3)
        )

    @staticmethod
    def from_domain(dims: Sequence[int], domain_lo, domain_hi, rescale_to=None) -> "LatentGrid":
        """Grid over a physical domain, optionally rescaled the way the
        trainer rescales coordinates: one affine map from the domain's SCALAR
        min and max to `rescale_to` (see data/transforms.py `rescale`)."""
        lo = tuple(float(v) for v in domain_lo)
        hi = tuple(float(v) for v in domain_hi)
        if rescale_to is not None:
            gmin, gmax = min(lo), max(hi)
            a, b = rescale_to
            scale = (b - a) / (gmax - gmin)
            lo = tuple((v - gmin) * scale + a for v in lo)
            hi = tuple((v - gmin) * scale + a for v in hi)
        return LatentGrid(dims=tuple(int(d) for d in dims), lo=lo, hi=hi)

    def axis_coords(self, a: int) -> np.ndarray:
        return np.linspace(self.lo[a], self.hi[a], self.dims[a], dtype=np.float64)

    def positions(self, device=None, dtype=torch.float32) -> torch.Tensor:
        """Token coordinates [M, 3] in ij meshgrid order."""
        gx, gy, gz = np.meshgrid(
            self.axis_coords(0), self.axis_coords(1), self.axis_coords(2), indexing="ij"
        )
        pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
        return torch.as_tensor(pts, dtype=dtype, device=device)

    def positions_from_idx(self, idx: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        """Cell-centre coordinates of flattened indices [...] -> [..., 3],
        computed from the index (f32: lo + i * h, as the reference does)."""
        _, H, W = self.dims
        i2 = idx % W
        i1 = torch.div(idx, W, rounding_mode="floor") % H
        i0 = torch.div(idx, W * H, rounding_mode="floor")
        h = self.spacing
        return torch.stack(
            [self.lo[a] + i.to(dtype) * h[a] for a, i in enumerate((i0, i1, i2))],
            dim=-1,
        )


class EdgeSlots(NamedTuple):
    """Static edge structure between N points and the latent grid."""

    lat_idx: torch.Tensor  # [..., N, K] int32, flattened latent cell index
    mask: torch.Tensor  # [..., N, K] bool

    @staticmethod
    def from_numpy(lat_idx: np.ndarray, mask: np.ndarray, device=None) -> "EdgeSlots":
        return EdgeSlots(
            torch.as_tensor(np.ascontiguousarray(lat_idx, np.int32), device=device),
            torch.as_tensor(np.ascontiguousarray(mask, bool), device=device),
        )


class FlatEdgeChunks(NamedTuple):
    """Compacted edge lists, one per node chunk of the model's edge loop.

    The valid (node, slot) pairs of each chunk are packed into flat src/dst
    lists padded to one per-chunk length E; padding sits at the tail with
    mask false and src = dst = 0. `src` is the node index LOCAL to the chunk.
    Built on the host by `data.host_graph.flatten_slots_host_batched`, in
    'src' order (ascending node; what the decoder's fold by node needs) or in
    'dst' order (each chunk's valid rows sorted by latent cell; what the
    encoder's presorted reductions need, `MAGNOConfig.flat_order`). Outputs
    come back in the caller's node order.
    """

    src: torch.Tensor  # [B, nc, E] int32, node index local to the chunk
    dst: torch.Tensor  # [B, nc, E] int32, flattened latent cell index
    mask: torch.Tensor  # [B, nc, E] bool

    @property
    def num_chunks(self) -> int:
        return self.src.shape[-2]

    @property
    def edges_per_chunk(self) -> int:
        return self.src.shape[-1]

    @staticmethod
    def from_numpy(src: np.ndarray, dst: np.ndarray, mask: np.ndarray,
                   device=None) -> "FlatEdgeChunks":
        return FlatEdgeChunks(
            torch.as_tensor(np.ascontiguousarray(src, np.int32), device=device),
            torch.as_tensor(np.ascontiguousarray(dst, np.int32), device=device),
            torch.as_tensor(np.ascontiguousarray(mask, bool), device=device),
        )


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


def stencil_widths(grid: LatentGrid, radius: float, k_neighbors: int,
                   strategy: str) -> Tuple[int, int, int]:
    """Per-axis stencil window widths covering the radius ball and/or the k
    nearest latent cells."""
    need_radius = strategy in ("radius", "bidirectional", "reverse")
    need_knn = strategy in ("knn", "bidirectional", "reverse")
    wk = 2 if k_neighbors <= 1 else 2 * (1 + math.ceil((k_neighbors ** (1.0 / 3.0)) / 2.0))
    widths = []
    for a in range(3):
        h = grid.spacing[a]
        wr = 2 * math.ceil(radius / h) + 2 if (need_radius and h > 0) else 2
        w = max(wr if need_radius else 2, wk if need_knn else 2)
        widths.append(min(w, grid.dims[a]))
    return tuple(widths)


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
    if strategy not in DECODER_STRATEGIES:
        raise ValueError(f"unknown neighbor strategy: {strategy}")
    if points.ndim != 3 or points.shape[-1] != 3:
        raise ValueError(f"points must be [B, N, 3], got {tuple(points.shape)}")
    eff = "bidirectional" if strategy == "reverse" else strategy
    widths = stencil_widths(grid, radius, k_neighbors, eff)
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
        if eff in ("radius", "bidirectional"):
            r = np.float32(radius)
            mask |= dist2 <= torch.full((), r * r, dtype=points.dtype, device=points.device)
        if eff in ("knn", "bidirectional"):
            k = min(k_neighbors, K)
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
    is below the window's K, over node chunks of `chunk` rows so that one
    chunk's [B, chunk, K] window is the largest transient. Both steps work
    row by row, so the chunks give one build's bits."""
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


@dataclass(frozen=True)
class SectionedEdgeSlots:
    """Degree-sectioned slots: contiguous node ranges of the degree-sorted
    point arrays, each with its own slot width K.

    sections[i] covers nodes [sum_<i Ns, ...) of the PERMUTED point arrays;
    the permutation comes from `data.host_graph.section_slots_by_degree_np`
    or `section_slots_shared` and must be applied to pos/feats (per sample).
    Model outputs come back in that permuted node order.

    shards=S > 1 is the shard-aligned layout of node sharding
    (`data.host_graph.section_slots_shared(..., shards=S)`): each section is
    [B, S * ns_i, K_i] laid out shard-major (shard 0's ns_i rows, then shard
    1's, ...), and the permuted point arrays give shard s the contiguous
    range [s * N/S, (s + 1) * N/S). Section i's point rows are then
    s * N/S + [off_i, off_i + ns_i) in every shard, which the model reads
    through a [B, S, N/S, ...] view; `shard(s)` is shard s's own rows, an
    unsharded layout over N/S nodes.
    """

    sections: Tuple[EdgeSlots, ...]
    shards: int = 1

    def __post_init__(self):
        if self.shards < 1 or any(int(s.lat_idx.shape[-2]) % self.shards
                                  for s in self.sections):
            raise ValueError(f"shards {self.shards} must divide every section's rows")

    @property
    def num_nodes(self) -> int:
        return sum(int(s.lat_idx.shape[-2]) for s in self.sections)

    def shard(self, s: int) -> "SectionedEdgeSlots":
        """Shard s's rows of every section: the unsharded layout of the
        point rows [s * N/S, (s + 1) * N/S)."""
        def rows(t):
            n = t.shape[-2] // self.shards
            return t[..., s * n:(s + 1) * n, :]
        return SectionedEdgeSlots(tuple(EdgeSlots(rows(sec.lat_idx), rows(sec.mask))
                                        for sec in self.sections))

    @staticmethod
    def from_numpy(sections: Sequence[Tuple[np.ndarray, np.ndarray]],
                   device=None, shards: int = 1) -> "SectionedEdgeSlots":
        return SectionedEdgeSlots(
            tuple(EdgeSlots.from_numpy(lat, msk, device) for lat, msk in sections), shards)
