"""Attention dispatch (port of gaot3d_tpu/ops/attention.py
`scaled_dot_product_attention`).

Every call goes through the flash-attention kernels
(kernels/flash_attention.py): K1 forward and, under autograd, K2 backward on
CUDA tensors, their plain versions on CPU tensors. Probability dropout takes
its mask from a 64-bit seed or from explicit bits.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels.flash_attention import attention


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 dropout_rate: float = 0.0, seed: Optional[int] = None,
                                 dropout_bits: Optional[torch.Tensor] = None,
                                 bh_offset: int = 0) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v for q [B,H,S,D], k, v [B,H,Skv,D], with
    dropout on the softmax weights when dropout_rate > 0 (needs `seed` or
    `dropout_bits` [B*H, S, Skv] uint32; a seeded mask from batch*head
    `bh_offset` of its stream on)."""
    return attention(q.contiguous(), k.contiguous(), v.contiguous(), dropout_rate, seed,
                     dropout_bits, bh_offset)
