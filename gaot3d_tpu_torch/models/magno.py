"""MAGNO encoder and decoder (port of gaot3d_tpu/models/magno.py
`MAGNOConfig`, `parse_edge_layout`, `apply_edge_sampling`, `MAGNOEncoder`
and `MAGNODecoder`: every variant the JAX model runs).

Each side takes the edges it is handed, one structure a scale, or, given
none, builds uniform slots from its points where they lie
(`ops/grid_graph.build_budgeted_slots`: the stencil window at the radius
times the scale, then the budget compaction), as the JAX model builds them
inside its forward. Slots then go through `apply_edge_sampling` (radius caps
always; 'ratio' and a random 'max_neighbors' draw in training only) before
the budget compaction; sections and flat edge lists take none of it.

Encoder: lift point features -> per scale, the fused GNO + statistical
geoembed (models/fused_encoder.py) when the geoembed is statistical, there
is no per-edge attention and `fused_encoder` is on; else the modular
`IntegralTransform` and `GeometricEmbedding` -> recovery([gno | geo]) when
both are on -> the scales summed, or weighted by a softmax of an MLP of the
latent coordinates (`use_scale_weights`) -> [B, M, C].
Decoder: per scale, the GNO from the latent grid to the points (with the
statistical geoembed fused, or modular, and the recovery when the decoder's
geoembed is on) -> the scales combined as in the encoder, from the query
positions -> the projection head (C -> projection_channels -> out, exact
GELU). Without a decoder geoembed the GNO, the combination and the head run
one node chunk at a time; in an eval forward on the card, a linear f32 GNO
over slots or sections takes its means first from one K9 launch a scale over
every node (kernels/decoder_payload.py), and only the combination and the
head run by chunks.

`MAGNOConfig` has the JAX fields and defaults, so one config drives both
packages. The model dispatches on the type of the edge structure it is
handed; four fields say how the encoder reduces, as in the JAX package:
`segment_impl` (scatter | sort | tile) for slots, sections and src-ordered
flat lists, `flat_order` (src | dst) for how the encoder's flat lists were
built, `flat_reduce_impl` (fold | pallas) for dst-ordered flat lists.
`kernel_dtype` (float32 | bfloat16) sets the arithmetic of both sides' GNO
kernel MLPs. The data side reads `edge_layout` (scalar or [encoder, decoder]
pair, see `parse_edge_layout`), `flat_order` and `flat_edges_per_chunk`
(`data.host_graph.flatten_slots_host_batched`). What the JAX model refuses
with sections or flat edge lists is refused here too, when the model is
built from a config that names that layout and when such edges are passed.
Still not ported, and refused with NotImplementedError: `gno_coord_dim`
other than 3 (the JAX kernel MLP takes [point | cell] on the 3-D grid).
Inside a node-sharded step (`parallel/sharding.py`) each encoder reduces its
rank's rows and the node ranks join the per-cell results (the fused
accumulator, the modular GNO's sums or softmax states, the geoembed's sums
or maxima) before any division; the decoder answers each rank's own query
rows.
`remat` (bool or [encoder, decoder] pair, JAX's default on) recomputes the
node chunks of the modular GNO and PointNet geoembed, and of the decoder
head with more scales, attention or a nonlinear kernel, in the backward
instead of keeping their per-edge activations; the fused encoder's K5b
recomputes its own, and the single-scale linear head keeps its activations.
Unknown values raise ValueError; the TPU-only knobs (payload_impl,
payload_layout, remat_policy, use_graph_cache, gno_use_torch_*) are accepted
and ignored.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterator, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..kernels.decoder_payload import decoder_payload, engages
from ..kernels.encoder_payload import KERNEL_DTYPES
from ..ops.grid_graph import (EdgeSlots, FlatEdgeChunks, LatentGrid, SectionedEdgeSlots,
                              build_budgeted_slots, compact_slots)
from ..ops.sampling import cap_per_query_gather, cap_per_query_scatter, dropout_edges
from .fused_decoder import FusedDecoderScale
from .fused_encoder import FusedEncoderScale
from .geoembed import GeometricEmbedding
from .integral_transform import (ATTENTION_TYPES, TRANSFORM_TYPES, IntegralTransform,
                                 effective_chunk, run_chunk)
from .mlp import ChannelMLP, kernel_weights


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


def parse_remat(remat) -> Tuple[bool, bool]:
    """(encoder, decoder) remat flags from a bool or an [encoder, decoder] pair."""
    if isinstance(remat, (list, tuple)):
        if len(remat) != 2:
            raise ValueError(f"remat must be a bool or a [encoder, decoder] pair, got {remat}")
        return bool(remat[0]), bool(remat[1])
    return bool(remat), bool(remat)


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




def _uses_fused(cfg: MAGNOConfig, geo: bool, side_fused: bool) -> bool:
    """Whether a side runs its fused scale: statistical geoembed on, no
    per-edge attention, and the side's `fused_encoder` / `fused_decoder`."""
    return bool(side_fused and geo and cfg.embedding_method == "statistical"
                and not cfg.use_attn)


def _edits_edges(cfg: MAGNOConfig) -> bool:
    return cfg.sampling_strategy is not None or cfg.max_radius_neighbors is not None


def _refusal(cfg: MAGNOConfig, enc_layout: str, dec_layout: str, enc_fused: bool,
             dec_geo: bool) -> Optional[str]:
    """What the JAX model refuses for an encoder layout and a decoder layout,
    in its own words, or None."""
    for side, layout in (("encoder", enc_layout), ("decoder", dec_layout)):
        if layout == "slots":
            continue
        name = "flat edges" if layout == "flat" else "sectioned slots"
        if side == "encoder" and not enc_fused:
            return ("flat edge layout requires the fused encoder" if layout == "flat"
                    else "sectioned slots require the fused encoder")
        if side == "decoder" and dec_geo:
            return ("flat edge layout: decoder geoembed unsupported" if layout == "flat"
                    else "sectioned slots: decoder geoembed unsupported")
        if _edits_edges(cfg):
            return (f"edge sampling / radius caps are not supported with {name} "
                    "(sampling_strategy and max_radius_neighbors must be None)")
        if layout == "sectioned" and len(cfg.scales) != 1:
            return ("sectioned slots support a single scale (sections would need one "
                    "shared node permutation across scales)")
    return None


def check_supported(cfg: MAGNOConfig) -> None:
    """Raise ValueError for unknown values and for what the JAX model refuses
    with the config's `edge_layout`, NotImplementedError for what the port
    does not run (`gno_coord_dim` other than 3)."""
    enc_layout, dec_layout = parse_edge_layout(cfg.edge_layout)
    for name, known in (("segment_impl", ("scatter", "sort", "tile")),
                        ("flat_order", ("src", "dst")),
                        ("flat_reduce_impl", ("fold", "pallas")),
                        ("kernel_dtype", KERNEL_DTYPES),
                        ("in_gno_transform_type", TRANSFORM_TYPES),
                        ("out_gno_transform_type", TRANSFORM_TYPES),
                        ("embedding_method", ("statistical", "pointnet")),
                        ("pooling", ("max", "mean")),
                        ("sampling_strategy", (None, "ratio", "max_neighbors"))):
        if getattr(cfg, name) not in known:
            raise ValueError(f"unknown {name}: {getattr(cfg, name)!r} (one of {known})")
    if cfg.use_attn and cfg.attention_type not in ATTENTION_TYPES:
        raise ValueError(f"Invalid attention_type: {cfg.attention_type}")
    if cfg.gno_coord_dim != 3:
        raise NotImplementedError(
            f"gno_coord_dim {cfg.gno_coord_dim} is not ported to gaot3d_tpu_torch (the kernel "
            "MLP takes [point | cell] on the 3-D latent grid, as in the JAX model)")
    enc_geo, dec_geo = parse_geoembed_strategy(cfg.use_geoembed)
    if not cfg.use_gno and not enc_geo:
        raise ValueError("GNO and GeoEmbed are both disabled.")
    bad = _refusal(cfg, enc_layout, dec_layout, _uses_fused(cfg, enc_geo, cfg.fused_encoder),
                   dec_geo)
    if bad is not None:
        raise NotImplementedError(bad)


def apply_edge_sampling(slots: EdgeSlots, cfg: MAGNOConfig, direction: str, train: bool,
                        rng, num_latent: int) -> EdgeSlots:
    """The JAX model's edge sampling of one side's slots: the radius cap
    `max_radius_neighbors` (the first edges in slot order) always; 'ratio'
    keeps each edge with probability sample_ratio in training with `rng`
    only; 'max_neighbors' keeps `max_neighbors` edges per query, at random
    by `rng` in training, the first in slot order without it (at eval too).
    The encoder caps per latent cell, the decoder per point. `rng` is a
    torch.Generator or the draws themselves (ops/sampling.py)."""
    if cfg.max_radius_neighbors is not None:
        if direction == "encoder":
            slots = cap_per_query_scatter(slots, cfg.max_radius_neighbors,
                                          num_segments=num_latent)
        else:
            slots = cap_per_query_gather(slots, cfg.max_radius_neighbors)
    if cfg.sampling_strategy is None:
        return slots
    if cfg.sampling_strategy == "ratio":
        if cfg.sample_ratio is None:
            raise ValueError("sample_ratio must be provided for 'ratio' sampling")
        if cfg.sample_ratio >= 1.0 or not train or rng is None:
            return slots
        return dropout_edges(slots, rate=1.0 - cfg.sample_ratio, rng=rng)
    if cfg.sampling_strategy == "max_neighbors":
        if cfg.max_neighbors is None:
            raise ValueError("max_neighbors must be provided for 'max_neighbors' sampling")
        if direction == "encoder":
            return cap_per_query_scatter(slots, cfg.max_neighbors, rng=rng,
                                         num_segments=num_latent)
        return cap_per_query_gather(slots, cfg.max_neighbors, rng=rng)
    raise ValueError(f"Invalid sampling strategy: {cfg.sampling_strategy}")


EdgeRng = Union[torch.Generator, Iterator[torch.Tensor], None]


def _draws(rng: EdgeRng):
    """The rng one side's sampling at one scale takes: the generator, or the
    next draws of an iterator of them (in the JAX model's order: the
    encoder's scales, then the decoder's)."""
    if rng is None or isinstance(rng, torch.Generator):
        return rng
    return next(rng)


class SlotBuild:
    """The edge build of one side at one scale: uniform slots of `strategy`
    at the config's radius times `scale` and k, compacted to its slot budget
    (but left at the stencil window when the config samples or caps edges,
    which comes first), in node chunks of its edge_chunk_size."""

    def __init__(self, config: MAGNOConfig, grid: LatentGrid, strategy: str, scale: float = 1.0):
        self.grid = grid
        self.strategy = strategy
        self.radius = config.gno_radius * scale
        self.k_neighbors = config.k_neighbors
        self.budget = None if _edits_edges(config) else config.slot_budget
        self.chunk = config.edge_chunk_size

    def __call__(self, pos: torch.Tensor, mask: Optional[torch.Tensor]) -> EdgeSlots:
        return build_budgeted_slots(pos, self.grid, self.radius, self.k_neighbors,
                                    self.strategy, mask, self.budget, self.chunk)

    def same_edges(self, other: "SlotBuild") -> bool:
        """Whether `other` builds the same slots from the same points."""
        return (self.grid, self.strategy, self.radius, self.k_neighbors, self.budget) == \
            (other.grid, other.strategy, other.radius, other.k_neighbors, other.budget)


def _layout(slots) -> str:
    if isinstance(slots, FlatEdgeChunks):
        return "flat"
    if isinstance(slots, SectionedEdgeSlots):
        return "sectioned"
    if isinstance(slots, EdgeSlots):
        return "slots"
    raise NotImplementedError(
        f"edge layout {type(slots).__name__} is not ported "
        "(supported: EdgeSlots, SectionedEdgeSlots, FlatEdgeChunks)")


class _Side(nn.Module):
    """What the encoder and the decoder share: the per-scale slot builds,
    the edge sampling before the budget compaction, and the scale
    combination."""

    def _init_side(self, cfg: MAGNOConfig, grid: LatentGrid, strategy: str,
                   fused: bool, geo: bool):
        self.cfg = cfg
        self.grid = grid
        self.use_fused = fused
        self.use_geo = geo
        self.builds = [SlotBuild(cfg, grid, strategy, s) for s in cfg.scales]
        if len(cfg.scales) > 1 and cfg.use_scale_weights:
            # keys scale_weighting.0 / .2, as the reference's Sequential
            self.scale_weighting = nn.Sequential(nn.Linear(cfg.gno_coord_dim, 16), nn.ReLU(),
                                                 nn.Linear(16, len(cfg.scales)))

    @property
    def build_slots(self) -> SlotBuild:
        """The first scale's build."""
        return self.builds[0]

    @build_slots.setter
    def build_slots(self, build: SlotBuild) -> None:
        self.builds[0] = build

    @property
    def sampling(self) -> bool:
        """Whether a training forward draws edges."""
        return self.cfg.sampling_strategy in ("ratio", "max_neighbors")

    def prepare(self, slots, direction: str, rng: EdgeRng):
        """One scale's edges as the forward runs them: slots sampled, then
        compacted to the slot budget; sections and flat lists as they are
        (with JAX's refusals)."""
        layout = _layout(slots)
        if layout != "slots":
            enc_layout, dec_layout = ((layout, "slots") if direction == "encoder"
                                      else ("slots", layout))
            bad = _refusal(self.cfg, enc_layout, dec_layout, self.use_fused, self.use_geo)
            if bad is not None:
                raise ValueError(bad)
            return slots
        train = self.training
        draws = None
        if train and self.sampling:
            draws = _draws(rng)
            if draws is None:
                raise ValueError(f"edge sampling ({self.cfg.sampling_strategy}) in a training "
                                 "forward needs a generator")
        slots = apply_edge_sampling(slots, self.cfg, direction, train, draws,
                                    self.grid.num_tokens)
        budget = self.cfg.slot_budget
        if budget is not None and budget < slots.lat_idx.shape[-1]:
            slots = compact_slots(slots, budget)
        return slots

    def combine_scales(self, per_scale: Sequence[torch.Tensor], pos: torch.Tensor) -> torch.Tensor:
        """The scales' outputs [.., Q, C] summed, or weighted by a softmax
        over the scales of an MLP of the query positions pos [.., Q, 3]."""
        if len(per_scale) == 1:
            return per_scale[0]
        stack = torch.stack(per_scale, dim=0)
        if not self.cfg.use_scale_weights:
            return stack.sum(0)
        w = torch.softmax(self.scale_weighting(pos), dim=-1)
        return (stack * torch.movedim(w, -1, 0)[..., None]).sum(0)


class MAGNOEncoder(_Side):
    def __init__(self, in_channels: int, out_channels: int, config: MAGNOConfig,
                 grid: LatentGrid):
        super().__init__()
        check_supported(config)
        cfg = config
        C = cfg.lifting_channels
        D = cfg.gno_coord_dim
        geo, _ = parse_geoembed_strategy(cfg.use_geoembed)
        strategy, _ = parse_neighbor_strategy(cfg.neighbor_strategy)
        self._init_side(cfg, grid, strategy, _uses_fused(cfg, geo, cfg.fused_encoder), geo)
        self.slot_budget = cfg.slot_budget
        remat, _ = parse_remat(cfg.remat)
        self.lifting = self.gno = self.geoembed = self.recovery = None
        if cfg.use_gno:
            self.lifting = ChannelMLP([in_channels, C], cfg.mlp_type)
            extra = C if cfg.in_gno_transform_type != "linear" else 0
            self.gno = IntegralTransform(
                [2 * D + extra] + list(cfg.in_gno_channel_mlp_hidden_layers) + [C], grid,
                cfg.in_gno_transform_type, cfg.kernel_dtype, use_attn=cfg.use_attn,
                coord_dim=D, attention_type=cfg.attention_type,
                edge_chunk_size=cfg.edge_chunk_size, segment_impl=cfg.segment_impl,
                remat=remat)
        if geo:
            self.geoembed = GeometricEmbedding(D, C, cfg.embedding_method, cfg.pooling,
                                               cfg.edge_chunk_size, cfg.segment_impl, grid,
                                               remat)
            if cfg.use_gno:
                self.recovery = ChannelMLP([2 * C, C], cfg.mlp_type)
        self.fused = None
        if self.use_fused:
            self.fused = FusedEncoderScale(
                self.gno, self.geoembed, grid, C, cfg.edge_chunk_size,
                segment_impl=cfg.segment_impl, flat_dst_sorted=cfg.flat_order == "dst",
                flat_reduce_impl=cfg.flat_reduce_impl, kernel_dtype=cfg.kernel_dtype)

    @property
    def flat_dst_sorted(self) -> bool:
        return self.cfg.flat_order == "dst"

    def _scale(self, slots, point_pos, lifted) -> torch.Tensor:
        if self.use_fused:
            gno_out, geo = self.fused(slots, point_pos, lifted)
        else:
            gno_out = (None if self.gno is None
                       else self.gno(slots, point_pos, lifted, direction="encoder"))
            geo = (None if self.geoembed is None
                   else self.geoembed(slots, point_pos, direction="encoder"))
        if gno_out is not None and geo is not None:
            return self.recovery(torch.cat([gno_out, geo], dim=-1))
        return gno_out if gno_out is not None else geo

    def forward(self, point_pos: torch.Tensor, point_feats: torch.Tensor,
                slots: Optional[Sequence] = None, point_mask: Optional[torch.Tensor] = None,
                rng: EdgeRng = None) -> torch.Tensor:
        """point_pos [B, N, 3], point_feats [B, N, C_in] -> [B, M, C].
        `slots`: one edge structure a scale; without it, slots are built from
        point_pos and point_mask [B, N] (all true by default), dropping the
        edges of false rows. `rng` feeds the edge sampling of a training
        forward (see `_draws`)."""
        lifted = self.lifting(point_feats) if self.lifting is not None else None
        outs = []
        for s, build in enumerate(self.builds):
            sl = slots[s] if slots is not None else build(point_pos, point_mask)
            outs.append(self._scale(self.prepare(sl, "encoder", rng), point_pos, lifted))
        # the weights' MLP reads the cell coordinates [1, M, 3], the same for every sample
        return self.combine_scales(
            outs, self.grid.positions(device=point_pos.device, dtype=point_pos.dtype)[None])


class MAGNODecoder(_Side):
    def __init__(self, in_channels: int, out_channels: int, config: MAGNOConfig,
                 grid: LatentGrid):
        super().__init__()
        check_supported(config)
        cfg = config
        C = in_channels
        D = cfg.gno_coord_dim
        _, geo = parse_geoembed_strategy(cfg.use_geoembed)
        _, strategy = parse_neighbor_strategy(cfg.neighbor_strategy)
        self._init_side(cfg, grid, strategy, _uses_fused(cfg, geo, cfg.fused_decoder), geo)
        self.out_channels = out_channels
        self.slot_budget = cfg.slot_budget
        self.edge_chunk_size = cfg.edge_chunk_size
        self.fused_head = cfg.fused_head
        _, remat = parse_remat(cfg.remat)
        # the single-scale linear GNO head keeps its activations (a few GiB at
        # the flagship's budget); more scales, attention or a nonlinear kernel
        # rematerialise each node chunk, as JAX's `remat`
        self.remat_head = remat and (len(cfg.scales) > 1 or bool(cfg.use_attn)
                                     or cfg.out_gno_transform_type != "linear")
        extra = C if cfg.out_gno_transform_type != "linear" else 0
        self.gno = IntegralTransform(
            [2 * D + extra] + list(cfg.out_gno_channel_mlp_hidden_layers) + [C], grid,
            cfg.out_gno_transform_type, cfg.kernel_dtype, use_attn=cfg.use_attn, coord_dim=D,
            attention_type=cfg.attention_type, edge_chunk_size=cfg.edge_chunk_size,
            segment_impl=cfg.segment_impl, remat=remat)
        self.geoembed = self.recovery = self.fused = None
        if geo:
            self.geoembed = GeometricEmbedding(D, C, cfg.embedding_method, cfg.pooling,
                                               cfg.edge_chunk_size, cfg.segment_impl, grid,
                                               remat)
            self.recovery = ChannelMLP([2 * C, C], cfg.mlp_type)
            if self.use_fused:
                self.fused = FusedDecoderScale(self.gno, self.geoembed, cfg.edge_chunk_size)
        self.projection = ChannelMLP(
            [in_channels, cfg.projection_channels, out_channels], cfg.mlp_type)

    def _payload_means(self, latent_feats, pos,
                       scale_slots: Sequence[EdgeSlots]) -> Optional[List[torch.Tensor]]:
        """Every scale's GNO mean [B, N, C] over all the nodes from K9, one
        launch a scale, where `decoder_payload.engages`; else None."""
        fcs = self.gno.channel_mlp.fcs
        widths = [fcs[0].weight.shape[1]] + [fc.weight.shape[0] for fc in fcs]
        k = max(s.lat_idx.shape[-1] for s in scale_slots)
        if not engages(latent_feats.device, self.gno.transform_type, self.gno.use_attn,
                       self.gno.kernel_dtype, widths, k):
            return None
        weights, biases = kernel_weights(fcs)
        return [decoder_payload(latent_feats, pos, s.lat_idx, s.mask, weights, biases, self.grid)
                for s in scale_slots]

    def _decode(self, latent_feats, pos, scale_slots: Sequence[EdgeSlots]) -> torch.Tensor:
        """GNO of every scale, their combination and the projection head, one
        node chunk at a time; in an eval forward on the card the GNO means
        come first from K9 over every node (`_payload_means`)."""
        n = pos.shape[1]
        chunk = effective_chunk(n, self.edge_chunk_size)
        means = self._payload_means(latent_feats, pos, scale_slots)
        if means is not None:
            return torch.cat([self.projection(self.combine_scales(
                [m[:, c0:c0 + chunk] for m in means], pos[:, c0:c0 + chunk]))
                for c0 in range(0, n, chunk)], dim=1)

        def body(latent_feats, pos_c, *slots_c):
            per_scale = [self.gno.decoder_chunk(latent_feats, pos_c, i, m)
                         for i, m in zip(slots_c[::2], slots_c[1::2])]
            return self.projection(self.combine_scales(per_scale, pos_c))

        outs = []
        for c0 in range(0, n, chunk):
            rows = slice(c0, c0 + chunk)
            slots_c = [t[:, rows] for s in scale_slots for t in (s.lat_idx, s.mask)]
            outs.append(run_chunk(self.remat_head, body, latent_feats, pos[:, rows], *slots_c))
        return torch.cat(outs, dim=1)

    def _decode_flat(self, latent_feats, pos, scale_slots: Sequence[FlatEdgeChunks]):
        ncs = {s.num_chunks for s in scale_slots}
        n = pos.shape[1]
        nc = ncs.pop()
        if ncs or n % nc != 0:
            raise ValueError(f"flat chunks ({nc}) must divide N ({n}), one chunking "
                             "for every scale")
        chunk = n // nc
        if not self.fused_head:
            per_scale = [self.gno(s, pos, latent_feats) for s in scale_slots]
            return self.projection(self.combine_scales(per_scale, pos))
        outs = []
        for c in range(nc):
            pos_c = pos[:, c * chunk:(c + 1) * chunk]
            per_scale = [self.gno.decoder_chunk_flat(latent_feats, pos_c, s.src[:, c],
                                                     s.dst[:, c], s.mask[:, c])
                         for s in scale_slots]
            outs.append(self.projection(self.combine_scales(per_scale, pos_c)))
        return torch.cat(outs, dim=1)

    def _decode_geo(self, latent_feats, pos, query_mask, scale_slots: Sequence[EdgeSlots]):
        """With the decoder geoembed: each scale over all the points (its
        z-normalisation spans the batch), then the head."""
        decoded = []
        for slots in scale_slots:
            if self.use_fused:
                gno_out, geo = self.fused(slots, pos, latent_feats, query_mask)
            else:
                gno_out = self.gno(slots, pos, latent_feats, direction="decoder")
                geo = self.geoembed(slots, pos, direction="decoder", query_mask=query_mask)
            decoded.append(self.recovery(torch.cat([gno_out, geo], dim=-1)))
        return self.projection(self.combine_scales(decoded, pos))

    def forward(self, latent_feats: torch.Tensor, query_pos: torch.Tensor,
                slots: Optional[Sequence] = None, query_mask: Optional[torch.Tensor] = None,
                rng: EdgeRng = None) -> torch.Tensor:
        """latent_feats [B, M, C], query_pos [B, N, 3] -> [B, N, out].
        `slots`: one edge structure a scale. With sectioned slots the rows
        come back in the sections' (degree-sorted) node order; with flat edge
        lists, in the caller's. Without `slots`, builds them from query_pos
        and query_mask [B, N] (all true by default); a false row has no edge
        and decodes to the head's bias. `rng`: see the encoder."""
        if slots is None:
            slots = [build(query_pos, query_mask) for build in self.builds]
        scale_slots = [self.prepare(s, "decoder", rng) for s in slots]
        layouts = {_layout(s) for s in scale_slots}
        if len(layouts) != 1:
            raise ValueError("all scales must share the edge layout")
        layout = layouts.pop()
        if layout == "sectioned":
            (sect,) = scale_slots
            if not self.fused_head:
                raise ValueError("sectioned slots require fused_head=True")
            if sect.num_nodes != query_pos.shape[1]:
                raise ValueError(f"sectioned slots cover {sect.num_nodes} nodes, "
                                 f"queries have {query_pos.shape[1]}")
            # shard-aligned sections (shards S > 1): a section's query rows
            # come through the [B, S, N/S, 3] view, and the outputs go back
            # shard by shard into the permuted global node order
            B, N = query_pos.shape[:2]
            S = sect.shards
            qpos_v = query_pos.reshape(B, S, N // S, -1)
            outs, off = [], 0
            for sec in sect.sections:
                ns = int(sec.lat_idx.shape[-2]) // S
                qsec = qpos_v[:, :, off:off + ns].reshape(B, S * ns, -1)
                outs.append(self._decode(latent_feats, qsec, [sec]).reshape(B, S, ns, -1))
                off += ns
            return torch.cat(outs, dim=2).reshape(B, N, -1)
        if layout == "flat":
            # packed edge lists: src must be ascending within a chunk (the
            # fold by node trusts it)
            return self._decode_flat(latent_feats, query_pos, scale_slots)
        if self.use_geo:
            return self._decode_geo(latent_feats, query_pos, query_mask, scale_slots)
        return self._decode(latent_feats, query_pos, scale_slots)
