"""Seeding (port of gaot3d_tpu/utils/rand.py): `manual_seed` seeds Python,
numpy and torch; `rng_for` gives the per-stream numpy generators of the data
feed (epoch shuffles)."""
from __future__ import annotations

import random

import numpy as np
import torch


def manual_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """Deterministic per-stream numpy generator (epoch shuffles, subsampling)."""
    return np.random.default_rng([seed, *stream])
