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

from ..edges import LatentGrid
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
        """Validate each side's call-time edges (their `check`); the decoder's
        where they are not the encoder's own slots or sections."""
        if enc is not None:
            # the encoder folds by cell when its lists come sorted so; the
            # decoder always folds by node, so one flat list cannot serve both
            enc_order = "dst" if self.encoder.flat_dst_sorted else None
            for e in enc:
                e.check(point_pos.shape[0], point_pos.shape[1], self.grid.num_tokens, enc_order)
        if dec is not None:
            for s, d in enumerate(dec):
                if enc is None or d is not enc[s] or d.layout == "flat":
                    d.check(query_pos.shape[0], query_pos.shape[1], self.grid.num_tokens, "src")
