"""U-shaped Vision Transformer processor (port of
gaot3d_tpu/models/transformer.py).

Reference behaviours kept as they are:
  - GQA with bias-free q/k/v/o projections and kv-head repeat;
  - 'rope' applies 1-D sequence-order rotary to q and k and ignores the patch
    coordinates it is handed;
  - RMSNorm normalises in f32, casts back, then multiplies by the weight;
  - the FFN residual is taken from the NORMED h:
    h = x + attn(norm1(x)); h = norm2(h); out = h + ffn(h);
  - U-shape: num_layers // 2 encoder blocks push skips, an optional middle
    block, num_layers // 2 decoder blocks with skip_proj(cat[x, skip]).

Module names are the reference state-dict keys (`processor.encoder_layers.0
.attn.q_proj`, ...). Attention runs through ops.attention (the K1 and K2
kernels on CUDA).

Attention-probability dropout (training): the JAX code draws one key per
attention layer through `make_rng("dropout")`. Here the processor draws one
64-bit seed per block, in block order, from the `torch.Generator` its forward
is handed, and each attention layer passes its seed to the kernels. There is
no global random state: a training forward without a generator raises.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import scaled_dot_product_attention
from ..ops.rope import apply_rope


@dataclass
class AttentionConfig:
    hidden_size: int = 256
    num_heads: int = 8
    num_kv_heads: int = 8
    use_conditional_norm: bool = False
    cond_norm_hidden_size: int = 4
    atten_dropout: float = 0.1
    positional_embedding: str = "absolute"  # ['absolute', 'rope']
    H: Optional[int] = None
    W: Optional[int] = None
    D: Optional[int] = None
    attention_impl: str = "auto"  # accepted and ignored: K1 serves every shape
    attention_chunk_size: int = 1024  # accepted and ignored
    attention_dtype: str = "bfloat16"  # q/k/v type inside attention


@dataclass
class FFNConfig:
    hidden_size: int = 1024
    use_conditional_norm: bool = False
    cond_norm_hidden_size: int = 4


@dataclass
class TransformerConfig:
    patch_size: int = 8
    hidden_size: int = 256
    use_attn_norm: bool = True
    use_ffn_norm: bool = True
    norm_eps: float = 1e-6
    num_layers: int = 3
    positional_embedding: str = "absolute"
    use_long_range_skip: bool = True
    attn_config: AttentionConfig = field(default_factory=AttentionConfig)
    ffn_config: FFNConfig = field(default_factory=FFNConfig)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        normed = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + self.eps)
        return normed.to(x.dtype) * self.weight


class GroupQueryAttention(nn.Module):
    def __init__(self, output_size: int, cfg: AttentionConfig):
        super().__init__()
        if cfg.use_conditional_norm:
            raise NotImplementedError("use_conditional_norm is not ported yet (ROADMAP item 6b)")
        if cfg.positional_embedding not in ("absolute", "rope"):
            raise NotImplementedError(
                f"positional_embedding {cfg.positional_embedding!r} is not ported "
                "(supported: 'absolute', 'rope'; rope3d is ROADMAP item 6b)")
        if cfg.attention_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"unknown attention_dtype {cfg.attention_dtype!r}")
        if cfg.hidden_size % cfg.num_heads or cfg.num_heads % cfg.num_kv_heads:
            raise ValueError("hidden_size % num_heads and num_heads % num_kv_heads must be 0")
        self.num_heads = cfg.num_heads
        self.num_kv_heads = cfg.num_kv_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.rope = cfg.positional_embedding == "rope"
        self.atten_dropout = cfg.atten_dropout
        self.attention_dtype = torch.bfloat16 if cfg.attention_dtype == "bfloat16" else None
        kv_hidden = self.head_dim * cfg.num_kv_heads
        self.q_proj = nn.Linear(output_size, cfg.hidden_size, bias=False)
        self.k_proj = nn.Linear(output_size, kv_hidden, bias=False)
        self.v_proj = nn.Linear(output_size, kv_hidden, bias=False)
        self.o_proj = nn.Linear(cfg.hidden_size, output_size, bias=False)

    def forward(self, x: torch.Tensor, relative_positions=None,
                seed: Optional[int] = None) -> torch.Tensor:
        """`seed` is this layer's dropout seed; it is needed only in training
        with atten_dropout > 0."""
        B, S, _ = x.shape
        q = self.q_proj(x).reshape(B, S, self.num_heads, self.head_dim).transpose(1, 2)
        k = self.k_proj(x).reshape(B, S, self.num_kv_heads, self.head_dim).transpose(1, 2)
        v = self.v_proj(x).reshape(B, S, self.num_kv_heads, self.head_dim).transpose(1, 2)
        if self.num_kv_heads != self.num_heads:
            rep = self.num_heads // self.num_kv_heads
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)
        if relative_positions is not None and self.rope:
            q = apply_rope(q)
            k = apply_rope(k)
        if self.attention_dtype is not None:
            q, k, v = (t.to(self.attention_dtype) for t in (q, k, v))
        rate = self.atten_dropout if self.training else 0.0
        if rate > 0.0 and seed is None:
            raise ValueError("attention dropout needs a seed: pass a torch.Generator to the "
                             "model's forward (or call model.eval())")
        out = scaled_dot_product_attention(q, k, v, dropout_rate=rate, seed=seed)
        out = out.transpose(1, 2).reshape(B, S, -1).to(x.dtype)
        return self.o_proj(out)


class FFN(nn.Module):
    """SwiGLU: w2(silu(w1 x) * w3 x)."""

    def __init__(self, output_size: int, cfg: FFNConfig):
        super().__init__()
        if cfg.use_conditional_norm:
            raise NotImplementedError("use_conditional_norm is not ported yet (ROADMAP item 6b)")
        self.w1 = nn.Linear(output_size, cfg.hidden_size, bias=False)
        self.w3 = nn.Linear(output_size, cfg.hidden_size, bias=False)
        self.w2 = nn.Linear(cfg.hidden_size, output_size, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class TransformerBlock(nn.Module):
    def __init__(self, hidden: int, use_attn_norm: bool, use_ffn_norm: bool,
                 norm_eps: float, attn_config: AttentionConfig, ffn_config: FFNConfig,
                 skip_connection: bool = False):
        super().__init__()
        self.attn_norm = RMSNorm(hidden, norm_eps) if use_attn_norm else None
        self.attn = GroupQueryAttention(hidden, attn_config)
        self.ffn_norm = RMSNorm(hidden, norm_eps) if use_ffn_norm else None
        self.ffn = FFN(hidden, ffn_config)
        self.skip_proj = nn.Linear(2 * hidden, hidden) if skip_connection else None

    def forward(self, x, relative_positions=None, skip=None, seed: Optional[int] = None):
        if self.skip_proj is not None and skip is not None:
            x = self.skip_proj(torch.cat([x, skip], dim=-1))
        h = self.attn_norm(x) if self.attn_norm is not None else x
        h = x + self.attn(h, relative_positions, seed)
        h = self.ffn_norm(h) if self.ffn_norm is not None else h
        return h + self.ffn(h)


class UViTProcessor(nn.Module):
    def __init__(self, input_size: int, output_size: int, config: TransformerConfig):
        super().__init__()
        cfg = config
        hidden = cfg.hidden_size
        attn_cfg = AttentionConfig(**{**cfg.attn_config.__dict__,
                                      "positional_embedding": cfg.positional_embedding})
        self.input_proj = nn.Linear(input_size, hidden) if input_size != hidden else None

        def block(skip_connection):
            return TransformerBlock(hidden, cfg.use_attn_norm, cfg.use_ffn_norm,
                                    cfg.norm_eps, attn_cfg, cfg.ffn_config,
                                    skip_connection=skip_connection)

        n_half = cfg.num_layers // 2
        self.use_long_range_skip = cfg.use_long_range_skip
        self.encoder_layers = nn.ModuleList(block(False) for _ in range(n_half))
        self.middle_layer = block(False) if cfg.num_layers % 2 == 1 else None
        self.decoder_layers = nn.ModuleList(
            block(cfg.use_long_range_skip) for _ in range(n_half))
        self.output_proj = nn.Linear(hidden, output_size) if hidden != output_size else None

    def layer_seeds(self, generator: Optional[torch.Generator]) -> List[Optional[int]]:
        """One dropout seed per block, in block order, drawn from `generator`
        (None each when no generator is given)."""
        n = len(self.encoder_layers) + len(self.decoder_layers) + (
            self.middle_layer is not None)
        if generator is None:
            return [None] * n
        draws = torch.randint(0, 2 ** 63 - 1, (n,), dtype=torch.int64, generator=generator,
                              device=generator.device)
        return [int(s) for s in draws.tolist()]

    def forward(self, x: torch.Tensor, relative_positions=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.input_proj is not None:
            x = self.input_proj(x)
        seeds = iter(self.layer_seeds(generator))
        skips = []
        for blk in self.encoder_layers:
            x = blk(x, relative_positions, seed=next(seeds))
            skips.append(x)
        if self.middle_layer is not None:
            x = self.middle_layer(x, relative_positions, seed=next(seeds))
        for blk in self.decoder_layers:
            skip = skips.pop() if self.use_long_range_skip else None
            x = blk(x, relative_positions, skip=skip, seed=next(seeds))
        if self.output_proj is not None:
            x = self.output_proj(x)
        return x
