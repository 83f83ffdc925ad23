"""Operations and bytes of the encoder payload's backward kernel K5b, counted
from shapes as counting.py counts the forward's: its kernel MLP's matrix
products only, on the valid edges of the benchmark's own graph.

K5b keeps no activation of the forward: for each valid edge it runs the
kernel MLP again, takes the cotangent back through every layer (the chain)
and adds each layer's weight gradient, so it makes three times the
forward's products. Its bytes: the points and the lifted features read
once, a cell index and a mask byte a valid edge, the accumulator's
cotangent read once, the features' gradient written once, the kernel MLP's
weights and their gradients.
"""
from __future__ import annotations

from typing import Tuple

from . import peaks
from .counting import Shapes, mlp_flops


def payload_backward(cfg: dict, nodes: int, edges: int) -> Tuple[float, float, float]:
    """(operations, bytes, peak operations a second) of K5b over one
    backward: bf16 products at the bf16 peak, f32 ones at the TF32 peak."""
    s = Shapes(cfg)
    flops = 3 * edges * mlp_flops(s.enc)
    weights = sum(a * b + b for a, b in zip(s.enc[:-1], s.enc[1:]))
    nbytes = nodes * (3 + 2 * s.lift) * 4 + edges * (4 + 1) \
        + s.cells * (s.lift + 11) * 4 + 2 * weights * 4
    return float(flops), float(nbytes), peaks.BF16_FLOPS if s.bf16_kernel else peaks.TF32_FLOPS
