"""Fused encoder scale: GNO kernel transform + statistical geometric
embedding over one moment accumulator (port of
gaot3d_tpu/models/fused_encoder.py `FusedEncoderScale`, slotted and
sectioned layouts).

Every valid (node, slot) edge adds one payload row
[ gno values (C) | 1 | d | y (3) | yy^T sym (6) ] into acc[b, cell]; the
encoder-payload kernel K5 (kernels/encoder_payload.py) computes and scatters
the rows in one pass, and under autograd its backward K5b returns the
gradients of the lifted features and of the kernel MLP. `_finalize` turns the
accumulator into the GNO mean and the statistical features: count, mean
distance, distance variance, centroid offset and PCA eigenvalues of the local
covariance, z-normalised over the whole batch (ddof 1) and fed through the
geoembed MLP.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..kernels.encoder_payload import accumulate
from ..ops.eigh3 import eigvalsh3x3_desc
from ..ops.grid_graph import EdgeSlots, LatentGrid, SectionedEdgeSlots
from .integral_transform import IntegralTransform, effective_chunk


class StatisticalGeoEmbedding(nn.Module):
    """Feature MLP of the statistical geometric embedding (keys mlp.0, mlp.2)."""

    def __init__(self, coord_dim: int, out_channels: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(3 + 2 * coord_dim, 64), nn.ReLU(),
                                 nn.Linear(64, out_channels))


class FusedEncoderScale:
    """One encoder scale over precomputed slots. Holds no parameters of its
    own: it runs the kernel MLP of `gno` and the feature MLP of `geoembed`,
    which the owning encoder registers under the reference key names."""

    def __init__(self, gno: IntegralTransform, geoembed: StatisticalGeoEmbedding,
                 grid: LatentGrid, lifting_channels: int,
                 edge_chunk_size: Optional[int] = None):
        self.gno = gno
        self.geoembed = geoembed
        self.grid = grid
        self.lifting_channels = lifting_channels
        self.edge_chunk_size = edge_chunk_size

    def __call__(self, slots, point_pos: torch.Tensor,
                 lifted_feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """point_pos [B, N, 3], lifted_feats [B, N, C] -> (gno_out [B, M, C],
        geo_out [B, M, C])."""
        B, N = point_pos.shape[:2]
        C = self.lifting_channels
        acc = torch.zeros((B, self.grid.num_tokens, C + 11), dtype=torch.float32,
                          device=point_pos.device)
        if isinstance(slots, SectionedEdgeSlots):
            # one accumulator threaded through the sections in node order
            if slots.num_nodes != N:
                raise ValueError(f"sectioned slots cover {slots.num_nodes} nodes, "
                                 f"points have {N}")
            off = 0
            for sec in slots.sections:
                ns = int(sec.lat_idx.shape[-2])
                self._run_slotted(sec, point_pos[:, off:off + ns],
                                  lifted_feats[:, off:off + ns], acc)
                off += ns
        elif isinstance(slots, EdgeSlots):
            self._run_slotted(slots, point_pos, lifted_feats, acc)
        else:
            raise NotImplementedError(
                f"edge layout {type(slots).__name__} is not ported "
                "(supported: EdgeSlots, SectionedEdgeSlots)")
        return self._finalize(acc)

    def _run_slotted(self, slots: EdgeSlots, point_pos: torch.Tensor,
                     lifted_feats: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
        """Add the payload of one [B, n, K] slot tensor into acc."""
        fcs = self.gno.channel_mlp.fcs
        return accumulate(
            point_pos.contiguous(), lifted_feats.contiguous(),
            slots.lat_idx.contiguous(), slots.mask.contiguous(),
            [fc.weight for fc in fcs], [fc.bias for fc in fcs], self.grid, acc,
            chunk=effective_chunk(point_pos.shape[1], self.edge_chunk_size))

    def _finalize(self, acc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Moment accumulator [B, M, C+11] -> (gno_out, geo_out)."""
        B, M, _ = acc.shape
        C = self.lifting_channels
        # The 11 moment columns are functions of the positions alone, and
        # positions take no gradient (the JAX VJP returns none either), so
        # they are cut from the graph. Differentiating them would also put
        # NaN into the accumulator's cotangent: the closed-form eigenvalues
        # have an infinite derivative at an isotropic covariance (every empty
        # or single-point cell after the 1e-6 regulariser), and inf * 0 from
        # the torch.where guards below is NaN.
        moments = acc[..., C:].detach()
        cnt = moments[..., 0]
        d_sum = moments[..., 1]
        y_sum = moments[..., 2:5]
        yy = moments[..., 5:]  # sym moments 00, 01, 02, 11, 12, 22
        n_safe = cnt.clamp_min(1.0)
        gno_out = acc[..., :C] / n_safe[..., None]

        ybar = y_sum / n_safe[..., None]
        d_avg = d_sum / n_safe
        d2_avg = (yy[..., 0] + yy[..., 3] + yy[..., 5]) / n_safe
        d_var = (d2_avg - d_avg * d_avg).clamp_min(0.0)
        yym = yy / n_safe[..., None]
        cov = torch.stack([yym[..., 0], yym[..., 1], yym[..., 2],
                           yym[..., 1], yym[..., 3], yym[..., 4],
                           yym[..., 2], yym[..., 4], yym[..., 5]], dim=-1).reshape(B, M, 3, 3)
        cov = cov - ybar[..., :, None] * ybar[..., None, :]
        cov_reg = cov + 1e-6 * torch.eye(3, dtype=cov.dtype, device=cov.device)
        pca = eigvalsh3x3_desc(cov_reg)
        zero = torch.zeros((), dtype=pca.dtype, device=pca.device)
        pca = torch.where(pca > 1e-3 * pca[..., :1], pca, zero)  # f32-noise guard
        feats = torch.cat([cnt[..., None], d_avg[..., None], d_var[..., None], ybar, pca],
                          dim=-1)
        feats = torch.where((cnt > 0)[..., None], feats, zero)
        flat = feats.reshape(-1, feats.shape[-1])
        mean = flat.mean(dim=0, keepdim=True)
        std = flat.std(dim=0, keepdim=True, correction=1)
        std = torch.where(std < 1e-6, torch.ones((), dtype=std.dtype, device=std.device), std)
        normed = ((flat - mean) / std).reshape(feats.shape)
        return gno_out, self.geoembed.mlp(normed)
