"""MAGNO encoder and decoder (port of gaot3d_tpu/models/magno.py
`MAGNOConfig`, `parse_edge_layout`, `MAGNOEncoder` on its fused path, and
`MAGNODecoder` with its GNO-only head over uniform slots, degree sections and
flat edge lists).

Each side takes the edges it is handed, or, given none, builds uniform slots
from its points where they lie (`ops/grid_graph.build_budgeted_slots`: the
stencil window, then the budget compaction), as the JAX model builds them
inside its forward.

Encoder: lift point features -> fused GNO + statistical geoembed
(models/fused_encoder.py) -> recovery([gno | geo]) -> [B, M, C].
Decoder: per node chunk, GNO from the latent grid to the points, then the
projection head (C -> projection_channels -> out, exact GELU).

`MAGNOConfig` has the JAX fields and defaults, so one config drives both
packages. The model dispatches on the type of the edge structure it is
handed; four fields say how the encoder reduces, as in the JAX package:
`segment_impl` (scatter | sort | tile) for slots, sections and src-ordered
flat lists, `flat_order` (src | dst) for how the encoder's flat lists were
built, `flat_reduce_impl` (fold | pallas) for dst-ordered flat lists.
`kernel_dtype` (float32 | bfloat16) sets the arithmetic of both sides' GNO
kernel MLPs, as JAX's magno.py passes it to its encoder and decoder scales. The
data side reads `edge_layout` (scalar or [encoder, decoder] pair, see
`parse_edge_layout`), `flat_order` and `flat_edges_per_chunk`
(`data.host_graph.flatten_slots_host_batched`). Values the port does not
support raise NotImplementedError, unknown values ValueError; the TPU-only
knobs (payload_impl, payload_layout, remat*, use_graph_cache,
gno_use_torch_*) are accepted and ignored.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple, Union

import torch
from torch import nn

from ..ops.grid_graph import (EdgeSlots, FlatEdgeChunks, LatentGrid, SectionedEdgeSlots,
                              build_budgeted_slots, compact_slots)
from ..kernels.encoder_payload import KERNEL_DTYPES
from .fused_encoder import FusedEncoderScale, StatisticalGeoEmbedding
from .integral_transform import IntegralTransform, effective_chunk
from .mlp import ChannelMLP


@dataclass
class MAGNOConfig:
    use_gno: bool = True
    gno_coord_dim: int = 3
    gno_radius: float = 0.033
    lifting_channels: int = 16
    encoder_feature_attr: Any = "x"
    in_gno_channel_mlp_hidden_layers: List[int] = field(default_factory=lambda: [64, 64, 64])
    in_gno_transform_type: str = "linear"
    projection_channels: int = 256
    out_gno_channel_mlp_hidden_layers: List[int] = field(default_factory=lambda: [64, 64])
    out_gno_transform_type: str = "linear"
    mlp_type: str = "channel"
    scales: List[float] = field(default_factory=lambda: [1.0])
    use_scale_weights: bool = False
    use_graph_cache: bool = True
    gno_use_torch_cluster: bool = False
    gno_use_torch_scatter: bool = True
    node_embedding: bool = False
    use_attn: Optional[bool] = None
    attention_type: str = "cosine"
    use_geoembed: Any = field(default_factory=lambda: [True, True])
    embedding_method: str = "statistical"
    pooling: str = "max"
    sampling_strategy: Optional[str] = None
    max_neighbors: Optional[int] = None
    sample_ratio: Optional[float] = None
    neighbor_strategy: Any = "radius"
    k_neighbors: int = 1
    precompute_edges: bool = True
    asynchronous_graph_building: bool = False
    max_radius_neighbors: Optional[int] = None
    edge_chunk_size: Optional[int] = None
    remat: Any = True
    remat_policy: str = "nothing"
    slot_budget: Optional[int] = None
    segment_impl: str = "scatter"
    payload_impl: str = "xla"
    fused_encoder: bool = True
    fused_decoder: bool = True
    kernel_dtype: str = "float32"
    flat_reduce_impl: str = "fold"
    payload_layout: str = "nk"
    fused_head: bool = True
    flat_edges_per_chunk: Optional[int] = None
    flat_order: str = "src"
    edge_layout: Any = "slots"
    sectioned_profile: Optional[List[int]] = None


def parse_neighbor_strategy(neighbor_strategy: Union[str, List[str]]) -> Tuple[str, str]:
    """scalar-or-pair -> (encoder, decoder)."""
    if isinstance(neighbor_strategy, str):
        return neighbor_strategy, neighbor_strategy
    if isinstance(neighbor_strategy, (list, tuple)) and len(neighbor_strategy) == 2:
        return neighbor_strategy[0], neighbor_strategy[1]
    raise ValueError(
        f"neighbor_strategy must be str or list of length 2, got {neighbor_strategy}")


def parse_geoembed_strategy(use_geoembed: Union[bool, List[bool]]) -> Tuple[bool, bool]:
    """scalar-or-pair -> (encoder, decoder)."""
    if isinstance(use_geoembed, bool):
        return use_geoembed, use_geoembed
    if isinstance(use_geoembed, (list, tuple)) and len(use_geoembed) == 2:
        return bool(use_geoembed[0]), bool(use_geoembed[1])
    raise ValueError(f"use_geoembed must be bool or list of length 2, got {use_geoembed}")


def parse_edge_layout(edge_layout: Union[str, List[str]]) -> Tuple[str, str]:
    """scalar-or-pair -> (encoder, decoder) layout, each 'slots' | 'flat' |
    'sectioned'. 'sectioned' must cover both sides: its degree sort permutes
    the sample's nodes, so a mixed pair would feed one side permuted inputs
    against unpermuted edges."""
    if isinstance(edge_layout, str):
        pair = (edge_layout, edge_layout)
    elif isinstance(edge_layout, (list, tuple)) and len(edge_layout) == 2:
        pair = (edge_layout[0], edge_layout[1])
    else:
        raise ValueError(f"edge_layout must be str or list of length 2, got {edge_layout}")
    for side in pair:
        if side not in ("slots", "flat", "sectioned"):
            raise ValueError(f"unknown edge_layout: {side!r}")
    if "sectioned" in pair and pair != ("sectioned", "sectioned"):
        raise ValueError("edge_layout 'sectioned' applies to both sides (the degree-sort "
                         f"permutation reorders the sample's nodes), got {pair}")
    return pair


def check_supported(cfg: MAGNOConfig) -> None:
    """Raise ValueError for unknown values of the reduction and layout fields
    and NotImplementedError for the config values the port does not run."""
    parse_edge_layout(cfg.edge_layout)
    for name, known in (("segment_impl", ("scatter", "sort", "tile")),
                        ("flat_order", ("src", "dst")),
                        ("flat_reduce_impl", ("fold", "pallas")),
                        ("kernel_dtype", KERNEL_DTYPES)):
        if getattr(cfg, name) not in known:
            raise ValueError(f"unknown {name}: {getattr(cfg, name)!r} (one of {known})")
    enc_geo, dec_geo = parse_geoembed_strategy(cfg.use_geoembed)
    unsupported = [
        (not cfg.use_gno, "use_gno: false"),
        (bool(cfg.use_attn), "use_attn (per-edge GNO attention)"),
        (len(cfg.scales) != 1, f"multiscale (scales {cfg.scales})"),
        (cfg.gno_coord_dim != 3, f"gno_coord_dim {cfg.gno_coord_dim}"),
        (not (enc_geo and cfg.embedding_method == "statistical" and cfg.fused_encoder),
         "an encoder other than the fused GNO + statistical geoembed"),
        (dec_geo, "decoder geoembed"),
        (cfg.in_gno_transform_type != "linear" or cfg.out_gno_transform_type != "linear",
         "GNO transform types other than 'linear'"),
        (cfg.sampling_strategy is not None or cfg.max_radius_neighbors is not None,
         "edge sampling / radius caps"),
    ]
    for bad, what in unsupported:
        if bad:
            raise NotImplementedError(f"{what} is not ported to gaot3d_tpu_torch")


def _budgeted(slots: EdgeSlots, budget: Optional[int]) -> EdgeSlots:
    if budget is not None and budget < slots.lat_idx.shape[-1]:
        return compact_slots(slots, budget)
    return slots


class SlotBuild:
    """The edge build of one side: uniform slots of `strategy` at the config's
    radius (one scale) and k, compacted to its slot budget, in node chunks of
    its edge_chunk_size."""

    def __init__(self, config: MAGNOConfig, grid: LatentGrid, strategy: str):
        self.grid = grid
        self.strategy = strategy
        self.radius = config.gno_radius * config.scales[0]
        self.k_neighbors = config.k_neighbors
        self.budget = config.slot_budget
        self.chunk = config.edge_chunk_size

    def __call__(self, pos: torch.Tensor, mask: Optional[torch.Tensor]) -> EdgeSlots:
        return build_budgeted_slots(pos, self.grid, self.radius, self.k_neighbors,
                                    self.strategy, mask, self.budget, self.chunk)

    def same_edges(self, other: "SlotBuild") -> bool:
        """Whether `other` builds the same slots from the same points."""
        return (self.grid, self.strategy, self.radius, self.k_neighbors, self.budget) == \
            (other.grid, other.strategy, other.radius, other.k_neighbors, other.budget)


class MAGNOEncoder(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, config: MAGNOConfig,
                 grid: LatentGrid):
        super().__init__()
        check_supported(config)
        cfg = config
        C = cfg.lifting_channels
        self.slot_budget = cfg.slot_budget
        enc_strategy, _ = parse_neighbor_strategy(cfg.neighbor_strategy)
        self.build_slots = SlotBuild(cfg, grid, enc_strategy)
        self.lifting = ChannelMLP([in_channels, C], cfg.mlp_type)
        self.gno = IntegralTransform(
            [2 * cfg.gno_coord_dim] + list(cfg.in_gno_channel_mlp_hidden_layers) + [C], grid,
            kernel_dtype=cfg.kernel_dtype)
        self.geoembed = StatisticalGeoEmbedding(cfg.gno_coord_dim, C)
        self.recovery = ChannelMLP([2 * C, C], cfg.mlp_type)
        self.fused = FusedEncoderScale(
            self.gno, self.geoembed, grid, C, cfg.edge_chunk_size,
            segment_impl=cfg.segment_impl, flat_dst_sorted=cfg.flat_order == "dst",
            flat_reduce_impl=cfg.flat_reduce_impl, kernel_dtype=cfg.kernel_dtype)

    def forward(self, point_pos: torch.Tensor, point_feats: torch.Tensor,
                slots=None, point_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """point_pos [B, N, 3], point_feats [B, N, C_in] -> [B, M, C]. Without
        `slots`, builds them from point_pos, point_mask [B, N] (all true by
        default) dropping the edges of false rows."""
        lifted = self.lifting(point_feats)
        if slots is None:
            slots = self.build_slots(point_pos, point_mask)
        if isinstance(slots, EdgeSlots):
            slots = _budgeted(slots, self.slot_budget)
        gno_out, geo = self.fused(slots, point_pos, lifted)
        return self.recovery(torch.cat([gno_out, geo], dim=-1))


class MAGNODecoder(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, config: MAGNOConfig,
                 grid: LatentGrid):
        super().__init__()
        check_supported(config)
        cfg = config
        self.out_channels = out_channels
        self.slot_budget = cfg.slot_budget
        self.edge_chunk_size = cfg.edge_chunk_size
        self.fused_head = cfg.fused_head
        _, dec_strategy = parse_neighbor_strategy(cfg.neighbor_strategy)
        self.build_slots = SlotBuild(cfg, grid, dec_strategy)
        self.gno = IntegralTransform(
            [2 * cfg.gno_coord_dim] + list(cfg.out_gno_channel_mlp_hidden_layers)
            + [in_channels], grid, kernel_dtype=cfg.kernel_dtype)
        self.projection = ChannelMLP(
            [in_channels, cfg.projection_channels, out_channels], cfg.mlp_type)

    def _decode(self, latent_feats, pos, slots: EdgeSlots) -> torch.Tensor:
        """GNO + projection head, one node chunk at a time."""
        n = pos.shape[1]
        chunk = effective_chunk(n, self.edge_chunk_size)
        outs = []
        for c0 in range(0, n, chunk):
            g = self.gno.decoder_chunk(latent_feats, pos[:, c0:c0 + chunk],
                                       slots.lat_idx[:, c0:c0 + chunk],
                                       slots.mask[:, c0:c0 + chunk])
            outs.append(self.projection(g))
        return torch.cat(outs, dim=1)

    def forward(self, latent_feats: torch.Tensor, query_pos: torch.Tensor,
                slots=None, query_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """latent_feats [B, M, C], query_pos [B, N, 3] -> [B, N, out]. With
        sectioned slots the rows come back in the sections' (degree-sorted)
        node order; with flat edge lists, in the caller's. Without `slots`,
        builds them from query_pos and query_mask [B, N] (all true by
        default); a false row has no edge and decodes to the head's bias."""
        if slots is None:
            slots = self.build_slots(query_pos, query_mask)
        if isinstance(slots, SectionedEdgeSlots):
            if not self.fused_head:
                raise ValueError("sectioned slots require fused_head=True")
            if slots.num_nodes != query_pos.shape[1]:
                raise ValueError(f"sectioned slots cover {slots.num_nodes} nodes, "
                                 f"queries have {query_pos.shape[1]}")
            outs, off = [], 0
            for sec in slots.sections:
                ns = int(sec.lat_idx.shape[-2])
                outs.append(self._decode(latent_feats, query_pos[:, off:off + ns], sec))
                off += ns
            return torch.cat(outs, dim=1)
        if isinstance(slots, FlatEdgeChunks):
            # packed edge lists: no compaction applies; src must be ascending
            # within a chunk (the fold by node trusts it)
            if not self.fused_head:
                return self.projection(self.gno(slots, query_pos, latent_feats))
            nc, n = slots.num_chunks, query_pos.shape[1]
            if n % nc != 0:
                raise ValueError(f"flat chunks ({nc}) must divide N ({n})")
            chunk = n // nc
            return torch.cat([
                self.projection(self.gno.decoder_chunk_flat(
                    latent_feats, query_pos[:, c * chunk:(c + 1) * chunk], slots.src[:, c],
                    slots.dst[:, c], slots.mask[:, c]))
                for c in range(nc)], dim=1)
        if isinstance(slots, EdgeSlots):
            return self._decode(latent_feats, query_pos, _budgeted(slots, self.slot_budget))
        raise NotImplementedError(
            f"edge layout {type(slots).__name__} is not ported "
            "(supported: EdgeSlots, SectionedEdgeSlots, FlatEdgeChunks)")
