"""GAOT3D: MAGNO encoder -> U-ViT processor -> MAGNO decoder (port of
gaot3d_tpu/models/gaot3d.py).

The forward pass takes precomputed edges for either side, one structure a
scale (uniform slots, degree sections or flat edge lists, each side its
own), or builds uniform slots for a side it is given none for, where its
points lie (the card or the CPU), as the JAX model does. In training the
forward takes a `torch.Generator`, from which the processor draws its
attention-dropout seeds and the MAGNO sides their edge sampling. Patchify and unpatchify
are the reference's exact reshapes and transposes. Both sides' GNO kernel
MLPs run at `magno_config.kernel_dtype` (float32 | bfloat16). A conditioned
model (`use_conditional_norm` in the processor's attention or FFN config)
takes `condition` c [B, 1] (a 0-d c is [1, 1]) and hands it to every block.

Inside a sharded step (`parallel.sharding.placed`) the forward is this
rank's part of the global batch: the encoder sums its accumulator over the
node group, the processor draws dropout at the rows' global batch index, and
the decoder answers the rank's own query rows.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.grid_graph import EdgeSlots, FlatEdgeChunks, LatentGrid, SectionedEdgeSlots
from ..parallel.sharding import active_placement
from ..tracing import span
from .magno import MAGNOConfig, MAGNODecoder, MAGNOEncoder
from .transformer import TransformerConfig, UViTProcessor


def absolute_sincos_embedding(positions: np.ndarray, embed_dim: int) -> np.ndarray:
    """Summed sin/cos embedding over coordinate dims: [T, dims] -> [T, embed_dim]."""
    positions = np.asarray(positions, dtype=np.float32)
    half = embed_dim // 2
    freq = 1.0 / (10000.0 ** (2.0 * np.arange(half, dtype=np.float32) / embed_dim))
    angles = positions[:, :, None] * freq[None, None, :]
    pe = np.zeros((positions.shape[0], embed_dim), dtype=np.float32)
    pe[:, 0::2] = np.sin(angles).sum(axis=1)
    pe[:, 1::2] = np.cos(angles).sum(axis=1)
    return pe


def patch_positions(dims, patch_size) -> np.ndarray:
    """Integer patch-grid coordinates [nP, 3] in ij order."""
    nd, nh, nw = (dims[0] // patch_size, dims[1] // patch_size, dims[2] // patch_size)
    gx, gy, gz = np.meshgrid(np.arange(nd, dtype=np.float32), np.arange(nh, dtype=np.float32),
                             np.arange(nw, dtype=np.float32), indexing="ij")
    return np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)


def _slot_sections(slots) -> Sequence[EdgeSlots]:
    if isinstance(slots, SectionedEdgeSlots):
        return slots.sections
    if isinstance(slots, EdgeSlots):
        return (slots,)
    raise NotImplementedError(
        f"edge layout {type(slots).__name__} is not ported "
        "(supported: EdgeSlots, SectionedEdgeSlots, FlatEdgeChunks)")


def check_flat_edges(flat: FlatEdgeChunks, batch: int, num_nodes: int, num_cells: int,
                     sorted_by: Optional[str] = None) -> None:
    """Validate call-time flat edge lists: int32 src and dst and a bool mask
    of [B, nc, E] with nc dividing the node count, every valid edge's node
    inside its chunk and its cell inside the grid. With `sorted_by` ('src' or
    'dst'), also the order a presorted reduction trusts: that key never
    decreases along a chunk's valid edges and the padding sits at the tail.
    One device sync in all."""
    if flat.src.dtype != torch.int32 or flat.dst.dtype != torch.int32 \
            or flat.mask.dtype != torch.bool:
        raise ValueError("flat edges need int32 src and dst and a bool mask")
    if flat.src.ndim != 3 or flat.src.shape != flat.dst.shape \
            or flat.src.shape != flat.mask.shape or flat.src.shape[0] != batch:
        raise ValueError(f"flat edges must be [{batch}, nc, E], got {tuple(flat.src.shape)}")
    nc = flat.num_chunks
    if nc == 0 or num_nodes % nc != 0:
        raise ValueError(f"flat chunks ({nc}) must divide N ({num_nodes})")
    chunk = num_nodes // nc
    bad = flat.mask & ((flat.src < 0) | (flat.src >= chunk)
                       | (flat.dst < 0) | (flat.dst >= num_cells))
    flags = [bad.any()]
    if sorted_by is not None:
        # padding takes the largest key, as the folds map it (ops/segment.py)
        ids = flat.src if sorted_by == "src" else flat.dst
        key = torch.where(flat.mask, ids, torch.full_like(ids, torch.iinfo(torch.int32).max))
        flags.append((key[..., 1:] < key[..., :-1]).any())
    flags = torch.stack(flags).tolist()
    if flags[0]:
        raise ValueError(f"a valid flat edge points outside its chunk [0, {chunk}) or outside "
                         f"the latent grid [0, {num_cells})")
    if flags[-1]:
        raise ValueError(f"flat edges are not sorted by {sorted_by} within a chunk with the "
                         f"padding at the tail, as this side's reduction needs (build them with "
                         f"flatten_slots_host(..., order='{sorted_by}'))")


def check_slots(slots, batch: int, num_nodes: int, num_cells: int,
                sorted_by: Optional[str] = None) -> None:
    """Validate call-time edges. Slots: int32 cell ids and bool masks of
    [B, n, K], and every valid slot's cell inside the grid (one device sync).
    Flat edge lists: see `check_flat_edges`, which alone reads `sorted_by`."""
    if isinstance(slots, FlatEdgeChunks):
        return check_flat_edges(slots, batch, num_nodes, num_cells, sorted_by)
    bad = None
    for sec in _slot_sections(slots):
        if sec.lat_idx.dtype != torch.int32 or sec.mask.dtype != torch.bool:
            raise ValueError("slots need int32 lat_idx and bool mask")
        if sec.lat_idx.ndim != 3 or sec.lat_idx.shape != sec.mask.shape \
                or sec.lat_idx.shape[0] != batch:
            raise ValueError(f"slots must be [{batch}, n, K], got {tuple(sec.lat_idx.shape)}")
        out = (sec.mask & ((sec.lat_idx < 0) | (sec.lat_idx >= num_cells))).any()
        bad = out if bad is None else bad | out
    if bad is not None and bool(bad):
        raise ValueError(f"a valid slot points outside the latent grid [0, {num_cells})")


class GAOT3D(nn.Module):
    def __init__(self, input_size: int, output_size: int,
                 magno_config: Optional[MAGNOConfig] = None,
                 attn_config: Optional[TransformerConfig] = None,
                 latent_tokens=(32, 32, 32), grid: Optional[LatentGrid] = None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.magno_config = magno_config or MAGNOConfig()
        self.attn_config = attn_config or TransformerConfig()
        self.latent_tokens = tuple(latent_tokens)
        self.grid = grid if grid is not None else LatentGrid(dims=self.latent_tokens)
        C = self.magno_config.lifting_channels
        P = self.attn_config.patch_size
        D, H, W = self.grid.dims
        if D % P or H % P or W % P:
            raise ValueError(f"latent dims {self.grid.dims} must be divisible by patch size {P}")
        width = P * P * P * C
        self.encoder = MAGNOEncoder(input_size, C, self.magno_config, self.grid)
        self.decoder = MAGNODecoder(C, output_size, self.magno_config, self.grid)
        self.patch_linear = nn.Linear(width, width)
        self.processor = UViTProcessor(width, width, self.attn_config)
        ppos = patch_positions(self.grid.dims, P)
        self.absolute = self.attn_config.positional_embedding == "absolute"
        self.register_buffer("patch_pos", torch.from_numpy(ppos), persistent=False)
        self.register_buffer("pos_emb", torch.from_numpy(absolute_sincos_embedding(ppos, width))
                             if self.absolute else None, persistent=False)

    def process(self, rndata: torch.Tensor, condition=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Patchify -> transformer -> unpatchify: [B, M, C] -> [B, M, C];
        `condition` c [B, 1] for a conditioned processor."""
        D, H, W = self.grid.dims
        P = self.attn_config.patch_size
        B, M, C = rndata.shape
        nd, nh, nw = D // P, H // P, W // P
        x = rndata.reshape(B, nd, P, nh, P, nw, P, C)
        x = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(B, nd * nh * nw, P * P * P * C)
        x = self.patch_linear(x)
        rel = None
        if self.absolute:
            x = x + self.pos_emb
        else:
            rel = self.patch_pos
        place = active_placement()
        x = self.processor(x, relative_positions=rel, generator=generator, condition=condition,
                           batch_offset=0 if place is None else place.batch_offset)
        x = x.reshape(B, nd, nh, nw, P, P, P, C)
        return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, D * H * W, C)

    def forward(self, point_pos: torch.Tensor, point_feats: torch.Tensor,
                point_mask: torch.Tensor, query_pos: Optional[torch.Tensor] = None,
                query_mask: Optional[torch.Tensor] = None, condition=None,
                encoder_slots: Optional[List] = None,
                decoder_slots: Optional[List] = None,
                generator: Optional[torch.Generator] = None,
                edge_draws: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """[B, N, 3] points with [B, N, C_in] features -> [B, Q, out] on the
        query points: the input points and their mask by default; given
        query_pos without query_mask, every query is valid.

        Each side takes one edge structure a scale. A side without
        precomputed edges builds its slots from its points and mask (a false
        row holds no edge); slots built so are valid by construction and are
        not checked, so the forward makes no host sync for them. When both
        sides build the same slots from the same points, they are built once.
        Precomputed edges carry their own masks. `generator` seeds the
        attention dropout of a training forward and draws its edge sampling
        ('ratio', 'max_neighbors'); `edge_draws`, when given, are the
        sampling's draws instead (keep masks or priority keys, see
        ops/sampling.py), one a scale, the encoder's scales first.
        `condition` c [B, 1] feeds the processor's ConditionedNorms."""
        if query_pos is None:
            query_pos, query_mask = point_pos, point_mask
        n_scales = len(self.magno_config.scales)
        for side in (encoder_slots, decoder_slots):
            if side is not None and len(side) != n_scales:
                raise ValueError(f"expected one edge structure a scale ({n_scales}), "
                                 f"got {len(side)}")
        enc = list(encoder_slots) if encoder_slots is not None else None
        dec = list(decoder_slots) if decoder_slots is not None else None
        if enc is not None or dec is not None:
            with span("gaot.check_edges"):
                self._check_edges(enc, dec, point_pos, query_pos)
        if enc is None or dec is None:
            with span("gaot.slot_build"):
                if enc is None:
                    enc = [build(point_pos, point_mask) for build in self.encoder.builds]
                    if dec is None and query_pos is point_pos and query_mask is point_mask:
                        dec = [e if db.same_edges(eb) else db(query_pos, query_mask)
                               for e, eb, db in zip(enc, self.encoder.builds,
                                                    self.decoder.builds)]
                if dec is None:
                    dec = [build(query_pos, query_mask) for build in self.decoder.builds]
        rng = iter(edge_draws) if edge_draws is not None else generator
        with span("gaot.encode"):
            rndata = self.encoder(point_pos, point_feats, enc, rng=rng)
        with span("gaot.process"):
            rndata = self.process(rndata, condition, generator)
        with span("gaot.decode"):
            return self.decoder(rndata, query_pos, dec, query_mask=query_mask, rng=rng)

    def _check_edges(self, enc: Optional[list], dec: Optional[list],
                     point_pos: torch.Tensor, query_pos: torch.Tensor) -> None:
        """Validate each side's call-time edges; the decoder's where they are
        not the encoder's own slots or sections, which are checked once."""
        if enc is not None:
            # the encoder folds by cell when its lists come sorted so; the
            # decoder always folds by node, so one flat list cannot serve both
            enc_order = "dst" if self.encoder.flat_dst_sorted else None
            for e in enc:
                check_slots(e, point_pos.shape[0], point_pos.shape[1], self.grid.num_tokens,
                            enc_order)
        if dec is not None:
            for s, d in enumerate(dec):
                if enc is None or d is not enc[s] or isinstance(d, FlatEdgeChunks):
                    check_slots(d, query_pos.shape[0], query_pos.shape[1],
                                self.grid.num_tokens, "src")
