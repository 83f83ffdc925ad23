"""Coordinate / feature transforms (port of gaot3d_tpu/data/transforms.py).

NOTE the reference's rescale is a *global scalar* min-max over the whole tensor,
NOT per-axis (reference: src/utils/scale.py:13-25); rescale_new likewise reduces
the physical-domain tuple to scalar min/max (src/utils/scale.py:5-11). Parity
requires bit-matching this quirk, so both are reproduced here exactly.
"""
from __future__ import annotations

import numpy as np

EPSILON = 1e-10


def rescale(x: np.ndarray, lims=(-1.0, 1.0)) -> np.ndarray:
    """Global (scalar) min-max rescale to `lims` (reference: scale.py:13-25)."""
    x = np.asarray(x)
    lo, hi = float(x.min()), float(x.max())
    return (x - lo) / (hi - lo) * (lims[1] - lims[0]) + lims[0]


def rescale_new(x: np.ndarray, lims=(-1.0, 1.0), phys_domain=([-1, -1, -1], [1, 1, 1])) -> np.ndarray:
    """Rescale by the *scalar* min/max of the physical domain tuple
    (reference: scale.py:5-11 — note it is NOT per-axis either)."""
    x = np.asarray(x)
    dom = np.asarray(phys_domain, dtype=np.float64)
    lo, hi = float(dom.min()), float(dom.max())
    return ((x - lo) / (hi - lo)) * (lims[1] - lims[0]) + lims[0]


def normalize(x: np.ndarray, mean, std) -> np.ndarray:
    """Feature z-normalization with epsilon guard
    (reference: src/data/pyg_transforms.py:63-106)."""
    return (np.asarray(x) - np.asarray(mean)) / (np.asarray(std) + EPSILON)
