"""Fused decoder scale: the decoder's GNO and its statistical geometric
embedding in one pass over the edge slots (port of
gaot3d_tpu/models/fused_decoder.py `FusedDecoderScale`, its 'nk' chunk
bodies `_gno_chunk` and `_geo_chunk`).

Per node chunk: the GNO mean over each point's K slots (the gradient-carrying
branch, models/integral_transform.py `decoder_chunk`), and the point's
statistical features from the same slots with the centroid taken within the
row (models/geoembed.py `decoder_features`, as JAX's `_geo_chunk`). The features
are geometry alone and take no gradient; they are z-normalised over the
batch's valid queries and fed through the embedding MLP. Everything is plain
PyTorch, as it is XLA in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.grid_graph import EdgeSlots
from ..parallel.sharding import world_group
from .geoembed import GeometricEmbedding, znorm_mlp
from .integral_transform import IntegralTransform, effective_chunk, run_chunk


class FusedDecoderScale:
    """One decoder scale over precomputed slots. Holds no parameters of its
    own: it runs the kernel MLP of `gno` and the feature MLP of `geoembed`,
    which the owning decoder registers under the reference key names."""

    def __init__(self, gno: IntegralTransform, geoembed: GeometricEmbedding,
                 edge_chunk_size: Optional[int] = None):
        self.gno = gno
        self.geoembed = geoembed
        self.edge_chunk_size = edge_chunk_size

    def __call__(self, slots: EdgeSlots, query_pos: torch.Tensor, latent_feats: torch.Tensor,
                 query_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """query_pos [B, N, 3], latent_feats [B, M, C] -> (gno_out [B, N, C],
        geo_out [B, N, C])."""
        N = query_pos.shape[1]
        chunk = effective_chunk(N, self.edge_chunk_size)
        parts = [(query_pos[:, c0:c0 + chunk], slots.lat_idx[:, c0:c0 + chunk],
                  slots.mask[:, c0:c0 + chunk]) for c0 in range(0, N, chunk)]
        gno = torch.cat([run_chunk(self.gno.remat, self.gno.decoder_chunk, latent_feats, *p)
                         for p in parts], dim=1)
        with torch.no_grad():
            feats = torch.cat([self.geoembed.decoder_features(*p) for p in parts], dim=1)
        # the queries are split over every rank of a sharded step
        return gno, znorm_mlp(feats, self.geoembed.mlp, query_mask, world_group())
