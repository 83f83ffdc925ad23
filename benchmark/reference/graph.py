"""The radius graph between points and the latent grid, worked out from the
positions.

The grid has dims (D, H, W) over the box [lo, hi]; cell (i, j, k) lies at
lo + (i, j, k) * spacing (each coordinate an f32 product, then an f32 sum)
and has the flat index (i * H + j) * W + k. Under the 'bidirectional'
strategy a point is joined to every cell whose squared distance, summed in
f32 over the axes in order, is at most radius^2 (radius rounded to f32,
squared in f32), and to its nearest cell (the lowest index on a tie). With a
slot budget a point keeps the `budget` joined cells of lowest index.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch


class Grid:
    def __init__(self, dims: Sequence[int], lo=(-1.0, -1.0, -1.0), hi=(1.0, 1.0, 1.0)):
        self.dims = tuple(int(d) for d in dims)
        self.lo = tuple(float(v) for v in lo)
        self.hi = tuple(float(v) for v in hi)
        self.spacing = tuple((self.hi[a] - self.lo[a]) / max(self.dims[a] - 1, 1)
                             for a in range(3))

    @property
    def cells(self) -> int:
        return self.dims[0] * self.dims[1] * self.dims[2]

    def axis_coord(self, a: int, i: torch.Tensor) -> torch.Tensor:
        return i.to(torch.float32) * self.spacing[a] + self.lo[a]

    def cell_pos(self, idx: torch.Tensor) -> torch.Tensor:
        """Coordinates [..., 3] of flat cell indices [...]."""
        _, H, W = self.dims
        idx = idx.long()
        ijk = (torch.div(idx, H * W, rounding_mode="floor"),
               torch.div(idx, W, rounding_mode="floor") % H, idx % W)
        return torch.stack([self.axis_coord(a, i) for a, i in enumerate(ijk)], dim=-1)


def _candidates(p: torch.Tensor, grid: Grid, radius: float):
    """(squared distances, in-grid flags, flat cells) [n, C] of the cells
    around each point that can lie within `radius` or be its nearest, in
    ascending flat index."""
    n = p.shape[0]
    reach = [math.ceil(radius / h) if h > 0 else 0 for h in grid.spacing]
    _, H, W = grid.dims
    axes, inside, d2 = [], [], []
    for a in range(3):
        h = grid.spacing[a]
        base = (torch.floor((p[:, a] - grid.lo[a]) / torch.tensor(h, device=p.device)).long()
                if h > 0 else torch.zeros(n, dtype=torch.long, device=p.device))
        i = base[:, None] + torch.arange(-reach[a], reach[a] + 2, device=p.device)[None, :]
        inside.append((i >= 0) & (i < grid.dims[a]))
        i = i.clamp(0, grid.dims[a] - 1)
        d = grid.axis_coord(a, i) - p[:, a, None]
        axes.append(i)
        d2.append(d * d)
    sq = (d2[0][:, :, None, None] + d2[1][:, None, :, None]) + d2[2][:, None, None, :]
    ok = inside[0][:, :, None, None] & inside[1][:, None, :, None] & inside[2][:, None, None, :]
    flat = (axes[0][:, :, None, None] * H + axes[1][:, None, :, None]) * W \
        + axes[2][:, None, None, :]
    return sq.reshape(n, -1), ok.reshape(n, -1), flat.reshape(n, -1)


def _r2(radius: float, device) -> torch.Tensor:
    return torch.tensor(float(np.float32(radius) * np.float32(radius)), dtype=torch.float32,
                        device=device)


def joined_cells(pos: torch.Tensor, grid: Grid, radius: float, budget: int,
                 chunk: int = 65536) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cells [N, budget] int64, valid [N, budget] bool) of points [N, 3]: the
    joined cells of each point in ascending index, valid first."""
    N = pos.shape[0]
    r2 = _r2(radius, pos.device)
    cells_out = torch.zeros((N, budget), dtype=torch.int64, device=pos.device)
    valid_out = torch.zeros((N, budget), dtype=torch.bool, device=pos.device)
    for c0 in range(0, N, chunk):
        p = pos[c0:c0 + chunk]
        n = p.shape[0]
        sq, ok, flat = _candidates(p, grid, radius)
        joined = ok & (sq <= r2)
        nearest = torch.where(ok, sq, torch.full_like(sq, float("inf"))).argmin(dim=1)
        joined[torch.arange(n, device=p.device), nearest] = True
        order = torch.argsort((~joined).to(torch.uint8), dim=1, stable=True)[:, :budget]
        cells_out[c0:c0 + n] = torch.gather(flat, 1, order)
        valid_out[c0:c0 + n] = torch.gather(joined, 1, order)
    return cells_out, valid_out


def over_budget(pos: torch.Tensor, grid: Grid, radius: float, budget: int,
                chunk: int = 65536) -> int:
    """How many points [N, 3] are joined to more than `budget` cells: the
    edges a slot budget would drop, which the program and `joined_cells`
    would then both leave out."""
    r2 = _r2(radius, pos.device)
    over = 0
    for c0 in range(0, pos.shape[0], chunk):
        sq, ok, _ = _candidates(pos[c0:c0 + chunk], grid, radius)
        degree = (ok & (sq <= r2)).sum(dim=1).clamp_min(1)  # at least the nearest cell
        over += int((degree > budget).sum())
    return over


def undecided(pos: torch.Tensor, grid: Grid, radius: float, band: float = 3e-5,
              chunk: int = 65536) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nodes bool [N], cells bool [M]): the points whose edges f32 cannot
    decide, and the cells those edges would join. Two sound f32 evaluations
    of a squared distance (another order of the sum, fused multiply-adds,
    the cell's coordinate taken another way) differ by some 1e-6 of it, so
    a point is undecided when a cell's squared distance lies within `band`
    of radius^2, or when no cell is within the radius and the two nearest
    lie within `band` of each other (which is joined as nearest)."""
    r2 = _r2(radius, pos.device)
    nodes = torch.zeros(pos.shape[0], dtype=torch.bool, device=pos.device)
    cells = torch.zeros(grid.cells, dtype=torch.bool, device=pos.device)
    for c0 in range(0, pos.shape[0], chunk):
        sq, ok, flat = _candidates(pos[c0:c0 + chunk], grid, radius)
        sq = torch.where(ok, sq, torch.full_like(sq, float("inf")))
        near = (sq - r2).abs() <= band * r2
        two = sq.topk(2, dim=1, largest=False)
        tie = (two.values[:, 0] > r2) & (two.values[:, 1] - two.values[:, 0]
                                          <= band * two.values[:, 0])
        nodes[c0:c0 + chunk] = near.any(dim=1) | tie
        cells[flat[near]] = True
        cells[torch.gather(flat, 1, two.indices)[tie].reshape(-1)] = True
    return nodes, cells
