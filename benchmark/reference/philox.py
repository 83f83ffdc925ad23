"""The attention-dropout keep mask of a seed, from Philox4x32-10 in plain
int64 tensor arithmetic.

The configuration's dropout draws one 64-bit seed for each attention layer
and keeps probability (row, col) of (batch, head) bh when its 32-bit word is
at least uint32(rate * (2^32 - 1)). The word comes from the Philox4x32-10
block with counter (col >> 1, row >> 1, bh, 0) and key (seed low word,
seed high word); the element reads word (row & 1) * 2 + (col & 1).
"""
from __future__ import annotations

from typing import Tuple

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def seed_words(seed: int) -> Tuple[int, int]:
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & _MASK32, seed >> 32


def keep_threshold(rate: float) -> int:
    return int(min(max(float(rate), 0.0), 1.0) * 4294967295.0)


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of m * x, x a 32-bit word in int64: the
    64-bit product wraps in int64 and keeps its bit pattern."""
    prod = x * m
    return (prod >> 32) & _MASK32, prod & _MASK32


def philox(c0, c1, c2, c3, k0: int, k1: int):
    """Ten Philox4x32 rounds on int64 tensors of 32-bit words."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def keep_rows(seed: int, rate: float, heads: int, row0: int, row1: int, cols: int,
              device, bh0: int = 0) -> torch.Tensor:
    """bool keep mask [heads, row1 - row0, cols] of rows [row0, row1) (row0
    even) of batch*heads bh0 .. bh0 + heads - 1."""
    if row0 % 2:
        raise ValueError("row blocks start on an even row")
    k0, k1 = seed_words(seed)
    rp = torch.arange(row0 // 2, (row1 + 1) // 2, dtype=torch.int64, device=device)
    cp = torch.arange((cols + 1) // 2, dtype=torch.int64, device=device)
    bh = torch.arange(bh0, bh0 + heads, dtype=torch.int64, device=device) & _MASK32
    shape = (heads, rp.numel(), cp.numel())
    c0 = cp.view(1, 1, -1).expand(shape)
    c1 = rp.view(1, -1, 1).expand(shape)
    c2 = bh.view(-1, 1, 1).expand(shape)
    c3 = torch.zeros(shape, dtype=torch.int64, device=device)
    w = philox(c0, c1, c2, c3, k0, k1)
    thresh = keep_threshold(rate)
    # [heads, row pairs, 2 (row bit), col pairs, 2 (col bit)]
    keep = torch.stack([torch.stack([w[0] >= thresh, w[1] >= thresh], dim=-1),
                        torch.stack([w[2] >= thresh, w[3] >= thresh], dim=-1)], dim=2)
    keep = keep.reshape(heads, 2 * rp.numel(), 2 * cp.numel())
    return keep[:, :row1 - row0, :cols]
