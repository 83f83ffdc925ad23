"""Operations and bytes of the configurations' work, counted from shapes.

Only matrix products count as operations (2 a multiply-add); softmax,
exponentials, GELU, dropout, norms and reductions do not. A kernel's bytes
are its input arrays read once and its outputs written once. Edge counts are
those of the benchmark's own graph (reference/graph.py), never the
program's.
"""
from __future__ import annotations

from typing import Sequence, Tuple

from . import peaks


def mlp_flops(widths: Sequence[int]) -> int:
    """Operations of one row through dense layers of `widths` [in, ..., out]."""
    return sum(2 * a * b for a, b in zip(widths[:-1], widths[1:]))


class Shapes:
    """The sizes of a configuration file that the counts need."""

    def __init__(self, cfg: dict):
        m = cfg["model"]
        magno, tr = m["magno"], m["transformer"]
        self.c_in, self.c_out = int(cfg["input_channels"]), int(cfg["output_channels"])
        self.lift = int(magno["lifting_channels"])
        self.enc = [6] + list(magno["in_gno_channel_mlp_hidden_layers"]) + [self.lift]
        self.dec = [6] + list(magno["out_gno_channel_mlp_hidden_layers"]) + [self.lift]
        self.proj = int(magno["projection_channels"])
        self.bf16_kernel = magno.get("kernel_dtype", "float32") == "bfloat16"
        d = m["latent_tokens"]
        self.cells = int(d[0]) * int(d[1]) * int(d[2])
        self.patch = int(tr["patch_size"])
        self.tokens = self.cells // self.patch ** 3
        self.hidden = int(tr["hidden_size"])
        self.ffn = int(tr["ffn_config"]["hidden_size"])
        self.layers = int(tr["num_layers"])
        self.heads = int(tr["attn_config"]["num_heads"])
        self.head_dim = self.hidden // self.heads


def forward_flops(cfg: dict, nodes: int, edges: int) -> int:
    """Model operations of one eval forward over a mesh of `nodes` points
    with `edges` valid encoder edges (the decoder's are the same edges)."""
    s = Shapes(cfg)
    S, Hd, C = s.tokens, s.hidden, s.lift
    width = s.patch ** 3 * C
    enc = nodes * mlp_flops([s.c_in, C]) + edges * mlp_flops(s.enc) \
        + s.cells * (mlp_flops([9, 64, C]) + mlp_flops([2 * C, C]))
    proc = S * mlp_flops([width, Hd]) + s.layers * (
        S * (4 * 2 * Hd * Hd + 3 * 2 * Hd * s.ffn) + 4 * S * S * Hd) \
        + (s.layers // 2) * S * 2 * (2 * Hd) * Hd
    dec = edges * mlp_flops(s.dec) + nodes * mlp_flops([C, s.proj, s.c_out])
    return enc + proc + dec


def train_step_flops(cfg: dict, nodes: int, edges: int) -> int:
    """A training step: three times the forward (recomputation not counted)."""
    return 3 * forward_flops(cfg, nodes, edges)


def attention_train(cfg: dict) -> Tuple[float, float]:
    """(operations, bytes) of one step's attention kernels, forward with
    dropout and backward: a head and a layer do two S x S x D products
    forward and four backward, and move Q, K, V, O, dO, dQ, dK, dV (bf16)
    and the log-sum-exp (f32) once."""
    s = Shapes(cfg)
    n = s.heads * s.layers
    flops = n * 6 * 2 * s.tokens * s.tokens * s.head_dim
    nbytes = n * (8 * s.tokens * s.head_dim * 2 + s.tokens * 4)
    return float(flops), float(nbytes)


def payload(cfg: dict, nodes: int, edges: int) -> Tuple[float, float, float]:
    """(operations, bytes, peak operations a second) of the encoder payload
    kernel over one forward: its kernel MLP's products on the valid edges;
    the points and lifted features read once, a cell index and a mask byte
    for each valid edge, and the accumulator written once; bf16 products at
    the bf16 peak, f32 ones at the TF32 peak."""
    s = Shapes(cfg)
    flops = edges * mlp_flops(s.enc)
    nbytes = nodes * (3 + s.lift) * 4 + edges * (4 + 1) + s.cells * (s.lift + 11) * 4
    return float(flops), float(nbytes), peaks.BF16_FLOPS if s.bf16_kernel else peaks.TF32_FLOPS


def least_seconds(flops: float, nbytes: float, flops_rate: float = peaks.BF16_FLOPS) -> float:
    return max(flops / flops_rate, nbytes / peaks.HBM_BYTES)
