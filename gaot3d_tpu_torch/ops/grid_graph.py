"""Latent grid and precomputed edge-slot containers (port of
gaot3d_tpu/ops/grid_graph.py `LatentGrid`, `EdgeSlots`, `FlatEdgeChunks`,
`SectionedEdgeSlots`).

Edges between N points and the regular latent grid live in a static slot
layout: `lat_idx[..., n, k]` is the flattened latent cell of slot k of point n
and `mask[..., n, k]` says whether that edge exists. Masked slots may carry any
index; every consumer drops them. The host-side code that makes these arrays
is in `gaot3d_tpu_torch/data/host_graph.py`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch


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


@dataclass(frozen=True)
class SectionedEdgeSlots:
    """Degree-sectioned slots: contiguous node ranges of the degree-sorted
    point arrays, each with its own slot width K.

    sections[i] covers nodes [sum_<i Ns, ...) of the PERMUTED point arrays;
    the permutation comes from `data.host_graph.section_slots_by_degree_np`
    and must be applied to pos/feats (per sample). Model outputs come back in
    that permuted node order.

    Only the unsharded layout (shards=1) is ported; the node-sharded
    shard-major layout raises.
    """

    sections: Tuple[EdgeSlots, ...]
    shards: int = 1

    def __post_init__(self):
        if self.shards != 1:
            raise NotImplementedError(
                "shard-aligned sections (shards > 1) are not ported yet; "
                "the port runs unsharded on one device"
            )

    @property
    def num_nodes(self) -> int:
        return sum(int(s.lat_idx.shape[-2]) for s in self.sections)

    @staticmethod
    def from_numpy(sections: Sequence[Tuple[np.ndarray, np.ndarray]],
                   device=None) -> "SectionedEdgeSlots":
        return SectionedEdgeSlots(
            tuple(EdgeSlots.from_numpy(lat, msk, device) for lat, msk in sections)
        )
