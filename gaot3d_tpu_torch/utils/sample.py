"""Point subsampling utilities (port of gaot3d_tpu/utils/sample.py; the
reference's src/utils/sample.py:5-60).

`subsample` draws a random subset of points (and aligned values); `grid`
produces a regular grid of query coordinates over a box. Host-side numpy,
for dataset downsampling and neural-field evaluation grids.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def subsample(points: np.ndarray, n: int, *values: np.ndarray,
              rng: Optional[np.random.Generator] = None) -> Tuple[np.ndarray, ...]:
    """Random subset of n points without replacement; extra arrays are
    indexed with the same selection."""
    rng = rng or np.random.default_rng()
    total = points.shape[0]
    sel = rng.choice(total, size=min(n, total), replace=False)
    return (np.asarray(points)[sel],) + tuple(np.asarray(v)[sel] for v in values)


def grid(resolution: Sequence[int], lo: Sequence[float] = (-1.0, -1.0, -1.0),
         hi: Sequence[float] = (1.0, 1.0, 1.0)) -> np.ndarray:
    """Regular grid of coordinates [prod(res), D] over the box (ij order)."""
    axes = [np.linspace(lo[a], hi[a], int(resolution[a])) for a in range(len(resolution))]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack(mesh, axis=-1).reshape(-1, len(resolution)).astype(np.float32)
