"""The general generator of the benchmark's traffic: seeded car-surface
stand-ins, each a closed deformed sphere.

A mesh of n points: u, n draws of a 3-D standard normal, each scaled to unit
length; r = 1 + bump * sin(f0 u_x) cos(f1 u_y) + jitter * z with z one
standard normal draw a mesh; the points u * r, min-max rescaled as one scalar
range to the latent grid's box [-1, 1]^3. Features: u, the undeformed unit
normal of each point (3 channels). Target: sin(2 x) cos(1.5 y) + 0.5 z^2 of
the unscaled points (1 channel). Every mesh of a run has the same number of
points; a mesh's geometry differs with its seed only.

Meshes are made on the run's device from one `torch.Generator` a mesh, whose
seed mixes the run's `--seed` and the mesh's index; the same seed gives the
same meshes.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Mesh(NamedTuple):
    pos: torch.Tensor     # [N, 3] f32
    feats: torch.Tensor   # [N, 3] f32
    target: torch.Tensor  # [N, 1] f32


def stream_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for the stream `keys` of run seed `seed`."""
    words = np.random.SeedSequence([int(seed) % 2 ** 64, *keys]).generate_state(2, np.uint32)
    return int(words[0]) << 31 ^ int(words[1])


def make_mesh(nodes: int, seed: int, index: int, shape: dict, device) -> Mesh:
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, 1, index))
    u = torch.randn((nodes, 3), generator=g, device=device)
    u = u / torch.linalg.vector_norm(u, dim=1, keepdim=True)
    z = torch.randn((), generator=g, device=device)
    f0, f1 = shape["frequencies"]
    r = 1.0 + shape["bump"] * torch.sin(f0 * u[:, 0]) * torch.cos(f1 * u[:, 1]) \
        + shape["jitter"] * z
    raw = u * r[:, None]
    target = (torch.sin(2.0 * raw[:, 0]) * torch.cos(1.5 * raw[:, 1])
              + 0.5 * raw[:, 2] ** 2)[:, None]
    lo, hi = raw.min(), raw.max()
    pos = (raw - lo) / (hi - lo) * 2.0 - 1.0
    return Mesh(pos.contiguous(), u.contiguous(), target.contiguous())
