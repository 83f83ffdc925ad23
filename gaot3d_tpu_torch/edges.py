"""The edge formats between points and the latent grid, and the rules that
the data feed, the kernels, the ops, the sharding and the models agree on
(port of gaot3d_tpu/ops/grid_graph.py `LatentGrid`, the three formats and
`stencil_widths`, of gaot3d_tpu/models/magno.py `parse_*` and of
gaot3d_tpu/models/integral_transform.py `effective_chunk`). This module sits
beneath every other layer of the package.

Each format (`EdgeSlots`, `SectionedEdgeSlots`, `FlatEdgeChunks`) answers
for itself: `layout` ('slots', 'sectioned' or 'flat'), `check` (the
call-time validation, one device sync), `map` (each tensor through a
function: a device put, a cut of batch rows), `node_shard` (a node-sharded
step's cut) and, for sections and flat lists, `blocks` (the walk over their
node ranges). Code whose algorithm differs by format dispatches on `layout`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterator, List, NamedTuple, Optional, Sequence, Tuple, Union

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


Map = Callable[[torch.Tensor], torch.Tensor]


def _check_slots(sections: Sequence["EdgeSlots"], batch: int, num_cells: int) -> None:
    """Validate call-time slots: int32 cell ids and bool masks of
    [batch, n, K], and every valid slot's cell inside the grid (one device
    sync for all the sections)."""
    bad = None
    for sec in sections:
        if sec.lat_idx.dtype != torch.int32 or sec.mask.dtype != torch.bool:
            raise ValueError("slots need int32 lat_idx and bool mask")
        if sec.lat_idx.ndim != 3 or sec.lat_idx.shape != sec.mask.shape \
                or sec.lat_idx.shape[0] != batch:
            raise ValueError(f"slots must be [{batch}, n, K], got {tuple(sec.lat_idx.shape)}")
        out = (sec.mask & ((sec.lat_idx < 0) | (sec.lat_idx >= num_cells))).any()
        bad = out if bad is None else bad | out
    if bad is not None and bool(bad):
        raise ValueError(f"a valid slot points outside the latent grid [0, {num_cells})")


class EdgeSlots(NamedTuple):
    """Static edge structure between N points and the latent grid: slot k of
    point n holds a cell where its mask is true; a masked slot may carry any
    index, and every consumer drops it."""

    lat_idx: torch.Tensor  # [..., N, K] int32, flattened latent cell index
    mask: torch.Tensor  # [..., N, K] bool

    layout = "slots"

    @staticmethod
    def from_numpy(lat_idx: np.ndarray, mask: np.ndarray, device=None) -> "EdgeSlots":
        return EdgeSlots(
            torch.as_tensor(np.ascontiguousarray(lat_idx, np.int32), device=device),
            torch.as_tensor(np.ascontiguousarray(mask, bool), device=device),
        )

    def check(self, batch: int, num_nodes: int, num_cells: int,
              sorted_by: Optional[str] = None) -> None:
        """`_check_slots`; slots have no order to check."""
        _check_slots((self,), batch, num_cells)

    def map(self, fn: Map) -> "EdgeSlots":
        return EdgeSlots(fn(self.lat_idx), fn(self.mask))

    def node_shard(self, s: int, S: int) -> "EdgeSlots":
        """Node shard s of S: the point rows [s * N/S, (s + 1) * N/S)."""
        n = self.lat_idx.shape[1]
        return self.map(lambda t: t[:, s * n // S:(s + 1) * n // S])


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

    layout = "flat"

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

    def check(self, batch: int, num_nodes: int, num_cells: int,
              sorted_by: Optional[str] = None) -> None:
        """Validate call-time flat edge lists: int32 src and dst and a bool
        mask of [batch, nc, E] with nc dividing the node count, every valid
        edge's node inside its chunk and its cell inside the grid. With
        `sorted_by` ('src' or 'dst'), also the order a presorted reduction
        trusts: that key never decreases along a chunk's valid edges and the
        padding sits at the tail. One device sync in all."""
        if self.src.dtype != torch.int32 or self.dst.dtype != torch.int32 \
                or self.mask.dtype != torch.bool:
            raise ValueError("flat edges need int32 src and dst and a bool mask")
        if self.src.ndim != 3 or self.src.shape != self.dst.shape \
                or self.src.shape != self.mask.shape or self.src.shape[0] != batch:
            raise ValueError(f"flat edges must be [{batch}, nc, E], got {tuple(self.src.shape)}")
        nc = self.num_chunks
        if nc == 0 or num_nodes % nc != 0:
            raise ValueError(f"flat chunks ({nc}) must divide N ({num_nodes})")
        chunk = num_nodes // nc
        bad = self.mask & ((self.src < 0) | (self.src >= chunk)
                           | (self.dst < 0) | (self.dst >= num_cells))
        flags = [bad.any()]
        if sorted_by is not None:
            # padding takes the largest key, as the folds map it (ops/segment.py)
            ids = self.src if sorted_by == "src" else self.dst
            key = torch.where(self.mask, ids, torch.full_like(ids, torch.iinfo(torch.int32).max))
            flags.append((key[..., 1:] < key[..., :-1]).any())
        flags = torch.stack(flags).tolist()
        if flags[0]:
            raise ValueError(f"a valid flat edge points outside its chunk [0, {chunk}) or "
                             f"outside the latent grid [0, {num_cells})")
        if flags[-1]:
            raise ValueError(f"flat edges are not sorted by {sorted_by} within a chunk with the "
                             f"padding at the tail, as this side's reduction needs (build them "
                             f"with flatten_slots_host(..., order='{sorted_by}'))")

    def map(self, fn: Map) -> "FlatEdgeChunks":
        return FlatEdgeChunks(fn(self.src), fn(self.dst), fn(self.mask))

    def node_shard(self, s: int, S: int) -> "FlatEdgeChunks":
        """Node shard s of S: the chunks [s * nc/S, (s + 1) * nc/S) (their
        node indices are chunk-local)."""
        nc = self.num_chunks
        if nc % S:
            raise ValueError(f"{nc} flat chunks do not split over {S} node ranks")
        return self.map(lambda t: t[:, s * nc // S:(s + 1) * nc // S])

    def blocks(self, *arrays: Optional[torch.Tensor]
               ) -> Iterator[Tuple["FlatEdgeChunks", ...]]:
        """The node chunks in order, each with its rows of `arrays` (point
        arrays [B, N, ...], or None): tuples (the chunk's edges [B, E],
        rows...), the rows [B, N/nc, ...]."""
        nc, N = self.num_chunks, arrays[0].shape[1]
        if N % nc != 0:
            raise ValueError(f"flat chunks ({nc}) must divide N ({N})")
        n = N // nc
        for c in range(nc):
            yield (self.map(lambda t: t[:, c]),
                   *(None if a is None else a[:, c * n:(c + 1) * n] for a in arrays))


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
    s * N/S + [off_i, off_i + ns_i) in every shard, which `blocks` reads
    through a [B, S, N/S, ...] view; `node_shard(s, S)` is shard s's own
    rows, an unsharded layout over N/S nodes.
    """

    sections: Tuple[EdgeSlots, ...]
    shards: int = 1

    layout = "sectioned"

    def __post_init__(self):
        if self.shards < 1 or any(int(s.lat_idx.shape[-2]) % self.shards
                                  for s in self.sections):
            raise ValueError(f"shards {self.shards} must divide every section's rows")

    @property
    def num_nodes(self) -> int:
        return sum(int(s.lat_idx.shape[-2]) for s in self.sections)

    @staticmethod
    def from_numpy(sections: Sequence[Tuple[np.ndarray, np.ndarray]],
                   device=None, shards: int = 1) -> "SectionedEdgeSlots":
        return SectionedEdgeSlots(
            tuple(EdgeSlots.from_numpy(lat, msk, device) for lat, msk in sections), shards)

    def check(self, batch: int, num_nodes: int, num_cells: int,
              sorted_by: Optional[str] = None) -> None:
        """`_check_slots` of every section at once."""
        _check_slots(self.sections, batch, num_cells)

    def map(self, fn: Map) -> "SectionedEdgeSlots":
        return SectionedEdgeSlots(tuple(sec.map(fn) for sec in self.sections), self.shards)

    def node_shard(self, s: int, S: int) -> "SectionedEdgeSlots":
        """Shard s's rows of every section: the unsharded layout of the point
        rows [s * N/S, (s + 1) * N/S). The sections must be laid out for S
        shards."""
        if self.shards != S:
            raise ValueError(f"sections laid out for {self.shards} shards, the mesh has "
                             f"{S} node ranks (set the loader's section_shards to node_shards)")
        return SectionedEdgeSlots(tuple(sec.node_shard(s, S) for sec in self.sections))

    def blocks(self, *arrays: Optional[torch.Tensor]
               ) -> Iterator[Tuple[EdgeSlots, ...]]:
        """The sections in node order, each with its rows of `arrays` (point
        arrays [B, N, ...] in the permuted node order, or None): tuples
        (section, rows...), a section's rows [B, S * ns_i, ...] shard-major,
        as the section's slots are."""
        S = self.shards
        views = [None if a is None else a.reshape(a.shape[0], S, a.shape[1] // S, *a.shape[2:])
                 for a in arrays]
        off = 0
        for sec in self.sections:
            ns = int(sec.lat_idx.shape[-2]) // S  # a shard's rows of the section
            yield (sec, *(None if v is None
                          else v[:, :, off:off + ns].reshape(v.shape[0], S * ns, *v.shape[3:])
                          for v in views))
            off += ns

    def unblock(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Per-section outputs [B, S * ns_i, ...], in the order and row
        layout of `blocks`, as one [B, N, ...] in the permuted node order."""
        S = self.shards
        B, tail = parts[0].shape[0], parts[0].shape[2:]
        return torch.cat([p.reshape(B, S, p.shape[1] // S, *tail) for p in parts],
                         dim=2).reshape(B, self.num_nodes, *tail)


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


def window_spec(grid: LatentGrid, radius: float, k_neighbors: int,
                strategy: str) -> Tuple[Tuple[int, int, int], bool, int]:
    """(window widths, whether the radius test runs, kNN picks a row) of a
    build of `strategy`; 'reverse' builds 'bidirectional''s slots."""
    if strategy not in DECODER_STRATEGIES:
        raise ValueError(f"unknown neighbor strategy: {strategy}")
    eff = "bidirectional" if strategy == "reverse" else strategy
    widths = stencil_widths(grid, radius, k_neighbors, eff)
    K = widths[0] * widths[1] * widths[2]
    knn = max(0, min(k_neighbors, K)) if eff in ("knn", "bidirectional") else 0
    return widths, eff in ("radius", "bidirectional"), knn


def parse_neighbor_strategy(neighbor_strategy: Union[str, List[str]]) -> Tuple[str, str]:
    """scalar-or-pair -> (encoder, decoder)."""
    if isinstance(neighbor_strategy, str):
        return neighbor_strategy, neighbor_strategy
    if isinstance(neighbor_strategy, (list, tuple)) and len(neighbor_strategy) == 2:
        return neighbor_strategy[0], neighbor_strategy[1]
    raise ValueError(
        f"neighbor_strategy must be str or list of length 2, got {neighbor_strategy}")


def parse_geoembed_strategy(use_geoembed: Union[bool, List[bool]]) -> Tuple[bool, bool]:
    """scalar-or-pair -> (encoder, decoder)."""
    if isinstance(use_geoembed, bool):
        return use_geoembed, use_geoembed
    if isinstance(use_geoembed, (list, tuple)) and len(use_geoembed) == 2:
        return bool(use_geoembed[0]), bool(use_geoembed[1])
    raise ValueError(f"use_geoembed must be bool or list of length 2, got {use_geoembed}")


def parse_remat(remat) -> Tuple[bool, bool]:
    """(encoder, decoder) remat flags from a bool or an [encoder, decoder] pair."""
    if isinstance(remat, (list, tuple)):
        if len(remat) != 2:
            raise ValueError(f"remat must be a bool or a [encoder, decoder] pair, got {remat}")
        return bool(remat[0]), bool(remat[1])
    return bool(remat), bool(remat)


def parse_edge_layout(edge_layout: Union[str, List[str]]) -> Tuple[str, str]:
    """scalar-or-pair -> (encoder, decoder) layout, each 'slots' | 'flat' |
    'sectioned'. 'sectioned' must cover both sides: its degree sort permutes
    the sample's nodes, so a mixed pair would feed one side permuted inputs
    against unpermuted edges."""
    if isinstance(edge_layout, str):
        pair = (edge_layout, edge_layout)
    elif isinstance(edge_layout, (list, tuple)) and len(edge_layout) == 2:
        pair = (edge_layout[0], edge_layout[1])
    else:
        raise ValueError(f"edge_layout must be str or list of length 2, got {edge_layout}")
    for side in pair:
        if side not in ("slots", "flat", "sectioned"):
            raise ValueError(f"unknown edge_layout: {side!r}")
    if "sectioned" in pair and pair != ("sectioned", "sectioned"):
        raise ValueError("edge_layout 'sectioned' applies to both sides (the degree-sort "
                         f"permutation reorders the sample's nodes), got {pair}")
    return pair


def effective_chunk(N: int, chunk: Optional[int]) -> int:
    """Largest divisor of N that is <= chunk (N when chunk is None or >= N):
    the node chunk of the model's edge loops, which the data feed's flat
    lists must match."""
    if chunk is None or chunk >= N:
        return N
    for d in range(int(chunk), 0, -1):
        if N % d == 0:
            return d
    return N
