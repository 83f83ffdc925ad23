"""GAOT3D: MAGNO encoder -> U-ViT processor -> MAGNO decoder (port of
gaot3d_tpu/models/gaot3d.py).

The forward pass takes precomputed edges for both sides (uniform slots,
degree sections or flat edge lists, each side its own); the on-device stencil
build is not ported. In training the forward takes a
`torch.Generator`, from which the processor draws its attention-dropout
seeds. Patchify and unpatchify
are the reference's exact reshapes and transposes.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.grid_graph import EdgeSlots, FlatEdgeChunks, LatentGrid, SectionedEdgeSlots
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

    def process(self, rndata: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Patchify -> transformer -> unpatchify: [B, M, C] -> [B, M, C]."""
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
        x = self.processor(x, relative_positions=rel, generator=generator)
        x = x.reshape(B, nd, nh, nw, P, P, P, C)
        return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, D * H * W, C)

    def forward(self, point_pos: torch.Tensor, point_feats: torch.Tensor,
                point_mask: torch.Tensor, query_pos: Optional[torch.Tensor] = None,
                query_mask: Optional[torch.Tensor] = None, condition=None,
                encoder_slots: Optional[List] = None,
                decoder_slots: Optional[List] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, N, 3] points with [B, N, C_in] features -> [B, Q, out] on the
        query points (the input points by default). The masks are accepted
        for signature parity; with precomputed slots the slots carry them.
        `generator` seeds the attention dropout of a training forward."""
        if condition is not None:
            raise NotImplementedError("conditioned models are not ported yet")
        if encoder_slots is None or decoder_slots is None:
            raise ValueError("the port needs precomputed encoder and decoder slots "
                             "(data/host_graph.py builds them)")
        if len(encoder_slots) != 1 or len(decoder_slots) != 1:
            raise NotImplementedError("one scale only: pass one slot structure per side")
        if query_pos is None:
            query_pos = point_pos
        enc, dec = encoder_slots[0], decoder_slots[0]
        # the encoder folds by cell when its lists come sorted so; the decoder
        # always folds by node, so one flat list cannot serve both sides then
        enc_order = "dst" if self.encoder.fused.flat_dst_sorted else None
        check_slots(enc, point_pos.shape[0], point_pos.shape[1], self.grid.num_tokens, enc_order)
        if dec is not enc or isinstance(dec, FlatEdgeChunks):
            check_slots(dec, query_pos.shape[0], query_pos.shape[1], self.grid.num_tokens, "src")
        rndata = self.encoder(point_pos, point_feats, enc)
        rndata = self.process(rndata, generator)
        return self.decoder(rndata, query_pos, dec)
