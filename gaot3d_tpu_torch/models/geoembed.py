"""Geometric embedding over edge slots (port of
gaot3d_tpu/models/geoembed.py `GeometricEmbedding`, both methods and both
directions).

'statistical': per query [edge count, mean distance, distance variance,
centroid offset (3), eigenvalues of the neighbours' 3x3 covariance (3)],
z-normalised over every query of the batch (unbiased std; over the valid
queries when a query mask is given) and fed through MLP(9 -> 64 -> out).
The covariance is the centred two-pass form: first the moments (count,
sums of d, d^2 and x), then the sums of (x - centroid)(x - centroid)^T.
'pointnet': the centred neighbour coordinates through a shared
MLP(3 -> 32 -> 32), pooled per query by max or mean, then FC(32 -> out);
zero for a query with no edge.

Encoder (query = latent cell): segment reductions by cell of each node
chunk, by `segment_impl` 'sort' (the folds of ops/segment.py, so K7 on the
card for the sums, of the rows' deviations from a baseline: coordinates
about their cell's centre, the rest about their mean) or 'scatter'. Decoder (query = point): masked reductions
over the K slots of each point. The statistical features are functions of
the coordinates alone and take no gradient; with `remat` a PointNet chunk is
recomputed in the backward instead of keeping its activations.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.eigh3 import eigvalsh3x3_desc
from ..ops.grid_graph import EdgeSlots, LatentGrid
from ..ops.segment import (fold_count, fold_max, fold_sum_centred, make_segment_fold,
                           segment_max, segment_sum)
from ..parallel.sharding import (all_reduce_, all_reduce_max, all_reduce_sum, data_group,
                                 node_group, world_group)
from .integral_transform import effective_chunk, run_chunk

POINTNET_WIDTH = 32


def znorm_mlp(feats: torch.Tensor, mlp: nn.Module,
              query_mask: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
    """Statistical features [B, Q, F] z-normalised over all B*Q queries
    (those of query_mask [B, Q] when given; unbiased std, 1 where below
    1e-6), then the embedding MLP. With a process `group` the queries are
    those of every rank of it (the sums taken over the group); the features
    take no gradient, so neither do the statistics."""
    flat = feats.reshape(-1, feats.shape[-1])
    if group is not None:
        mean, std = _group_mean_std(flat, query_mask, group)
    elif query_mask is not None:
        qm = query_mask.reshape(-1, 1).to(flat.dtype)
        count = qm.sum().clamp_min(1.0)
        mean = (flat * qm).sum(0, keepdim=True) / count
        dev = torch.where(qm > 0, flat - mean, 0.0)
        std = torch.sqrt((dev * dev).sum(0, keepdim=True) / (count - 1.0).clamp_min(1.0))
    else:
        mean = flat.mean(dim=0, keepdim=True)
        std = flat.std(dim=0, keepdim=True, correction=1)
    std = torch.where(std < 1e-6, torch.ones((), dtype=std.dtype, device=std.device), std)
    return mlp(((flat - mean) / std).reshape(feats.shape))


def _group_mean_std(flat: torch.Tensor, query_mask: Optional[torch.Tensor], group):
    """Mean and unbiased std [1, F] of the rows of `flat` (those of
    query_mask) over every rank of `group`: two passes, as the one-rank
    statistics."""
    flat = flat.detach()
    qm = (torch.ones((flat.shape[0], 1), dtype=flat.dtype, device=flat.device)
          if query_mask is None else query_mask.reshape(-1, 1).to(flat.dtype))
    sums = all_reduce_(torch.cat([qm.sum(0), (flat * qm).sum(0)]), group)
    count = sums[:1].clamp_min(1.0)
    mean = (sums[1:] / count)[None]
    dev = torch.where(qm > 0, flat - mean, 0.0)
    sq = all_reduce_((dev * dev).sum(0), group)
    return mean, torch.sqrt(sq / (count - 1.0).clamp_min(1.0))[None]


def statistical_features(cnt, d_sum, d2_sum, x_sum, cov_sum, query_pos) -> torch.Tensor:
    """Moments and centred covariance sums of each query -> [..., 9]: zero
    for a query with no edge."""
    n_safe = cnt.clamp_min(1.0)
    d_avg = d_sum / n_safe
    d_var = (d2_sum / n_safe - d_avg * d_avg).clamp_min(0.0)
    delta = x_sum / n_safe[..., None] - query_pos
    cov = cov_sum / n_safe[..., None, None]
    cov_reg = cov + 1e-6 * torch.eye(3, dtype=cov.dtype, device=cov.device)
    pca = eigvalsh3x3_desc(cov_reg)
    zero = torch.zeros((), dtype=pca.dtype, device=pca.device)
    # f32-noise guard: eigenvalues below 0.1% of the leading one are solver
    # noise that the batch z-normalisation would blow up
    pca = torch.where(pca > 1e-3 * pca[..., :1], pca, zero)
    feats = torch.cat([cnt[..., None], d_avg[..., None], d_var[..., None], delta, pca], dim=-1)
    return torch.where((cnt > 0)[..., None], feats, zero)


class GeometricEmbedding(nn.Module):
    """Keys as the reference's: `mlp.0`, `mlp.2` (statistical);
    `pointnet_mlp.0`, `pointnet_mlp.2`, `fc.0` (pointnet)."""

    def __init__(self, input_dim: int = 3, output_dim: int = 16, method: str = "statistical",
                 pooling: str = "max", edge_chunk_size: Optional[int] = None,
                 segment_impl: str = "sort", grid: Optional[LatentGrid] = None,
                 remat: bool = False):
        super().__init__()
        if method == "statistical":
            self.mlp = nn.Sequential(nn.Linear(3 + 2 * input_dim, 64), nn.ReLU(),
                                     nn.Linear(64, output_dim))
        elif method == "pointnet":
            w = POINTNET_WIDTH
            self.pointnet_mlp = nn.Sequential(nn.Linear(input_dim, w), nn.ReLU(),
                                              nn.Linear(w, w), nn.ReLU())
            self.fc = nn.Sequential(nn.Linear(w, output_dim))
        else:
            raise ValueError(f"Unknown method: {method}")
        if pooling not in ("max", "mean"):
            raise ValueError(f"Unsupported pooling method: {pooling}. "
                             "Supported methods: 'max', 'mean'.")
        self.input_dim = input_dim
        self.method = method
        self.pooling = pooling
        self.edge_chunk_size = edge_chunk_size
        self.segment_impl = segment_impl
        self.grid = grid
        self.remat = remat

    def _edge_coords(self, pos_c, lat_idx_c, direction):
        """(source coords, query coords) of every slot of a chunk."""
        B, n, K = lat_idx_c.shape
        lat = self.grid.positions_from_idx(lat_idx_c, dtype=pos_c.dtype)
        pt = pos_c[:, :, None, :].expand(B, n, K, pos_c.shape[-1])
        return (pt, lat) if direction == "encoder" else (lat, pt)

    def _segments(self, lat_idx_c, mask_c):
        """Flattened cells and masks [B, n*K] and, under 'sort', their folds."""
        B = lat_idx_c.shape[0]
        seg, msk = lat_idx_c.reshape(B, -1), mask_c.reshape(B, -1)
        folds = None
        if self.segment_impl == "sort":
            folds = [make_segment_fold(g, self.grid.num_tokens, m) for g, m in zip(seg, msk)]
        return seg, msk, folds

    def _sum(self, data, seg, msk, folds, base=None):
        """Per-sample sums by cell of data [B, E, F] -> [B, M, F]; the folds
        run over the deviations from `base` ([B, M, F], default the mean row:
        see `fold_sum_centred`)."""
        if folds is not None:
            bases = [None] * len(folds) if base is None else base
            return torch.stack([fold_sum_centred(f, d, b)
                                for f, d, b in zip(folds, data, bases)])
        M = self.grid.num_tokens
        return torch.stack([segment_sum(d, g, M, m) for d, g, m in zip(data, seg, msk)])

    def _count(self, seg, msk, folds):
        if folds is not None:
            return torch.stack([fold_count(f) for f in folds])
        M = self.grid.num_tokens
        return torch.stack([segment_sum(torch.ones_like(g, dtype=torch.float32), g, M, m)
                            for g, m in zip(seg, msk)])

    # -- statistical ------------------------------------------------------------
    def _statistical_encoder(self, slots: EdgeSlots, point_pos, chunk):
        B, N, K = slots.mask.shape
        M = self.grid.num_tokens
        chunks = [slice(c0, c0 + chunk) for c0 in range(0, N, chunk)]
        cells = self.grid.positions(device=point_pos.device, dtype=point_pos.dtype)
        cnt = d_sum = d2_sum = x_sum = 0.0
        for rows in chunks:
            src, qry = self._edge_coords(point_pos[:, rows], slots.lat_idx[:, rows], "encoder")
            seg, msk, folds = self._segments(slots.lat_idx[:, rows], slots.mask[:, rows])
            dist = torch.linalg.vector_norm(src - qry, dim=-1)
            stacked = torch.cat([dist[..., None], (dist * dist)[..., None], src], dim=-1)
            stacked = stacked.reshape(B, -1, stacked.shape[-1])
            base = None
            if folds is not None:
                # coordinates about their cell's centre, d and d^2 about their mean
                keep = msk[..., None].to(stacked.dtype)
                mean = (stacked[..., :2] * keep).sum(1) / keep.sum(1).clamp_min(1.0)
                base = torch.cat([mean[:, None, :].expand(B, M, 2), cells.expand(B, M, 3)], -1)
            sums = self._sum(stacked, seg, msk, folds, base)
            cnt = cnt + self._count(seg, msk, folds)
            d_sum, d2_sum = d_sum + sums[..., 0], d2_sum + sums[..., 1]
            x_sum = x_sum + sums[..., 2:]
        # a node-sharded step sums each pass over the node group (parallel/sharding.py)
        group = node_group()
        if group is not None:
            first = all_reduce_sum(torch.cat([cnt[..., None], d_sum[..., None],
                                              d2_sum[..., None], x_sum], dim=-1), group)
            cnt, d_sum, d2_sum = first[..., 0], first[..., 1], first[..., 2]
            x_sum = first[..., 3:]
        centroid = x_sum / cnt.clamp_min(1.0)[..., None]
        cov_sum = 0.0
        for rows in chunks:
            idx = slots.lat_idx[:, rows]
            src, _ = self._edge_coords(point_pos[:, rows], idx, "encoder")
            cen = torch.gather(centroid, 1, idx.long().clamp(0, M - 1).reshape(B, -1, 1)
                               .expand(-1, -1, 3)).reshape(src.shape)
            c = src - cen
            cc = (c[..., :, None] * c[..., None, :]).reshape(B, -1, 9)
            seg, msk, folds = self._segments(idx, slots.mask[:, rows])
            cov_sum = cov_sum + self._sum(cc, seg, msk, folds)
        cov_sum = all_reduce_sum(cov_sum, group)
        qpos = self.grid.positions(device=point_pos.device, dtype=point_pos.dtype)
        return statistical_features(cnt, d_sum, d2_sum, x_sum, cov_sum.reshape(B, M, 3, 3),
                                    qpos.expand(B, M, 3))

    def decoder_features(self, pos_c, lat_idx_c, mask_c):
        """Statistical features [B, n, 9] of a chunk's points from their K
        slots (the centroid within the row)."""
        src, qry = self._edge_coords(pos_c, lat_idx_c, "decoder")
        dist = torch.linalg.vector_norm(src - qry, dim=-1)
        m3 = mask_c[..., None]
        cnt = mask_c.sum(-1).to(torch.float32)
        d_sum = torch.where(mask_c, dist, 0.0).sum(-1)
        d2_sum = torch.where(mask_c, dist * dist, 0.0).sum(-1)
        x_sum = torch.where(m3, src, 0.0).sum(2)
        cen = torch.where(m3, src, 0.0).sum(2) / cnt.clamp_min(1.0)[..., None]
        c = src - cen[:, :, None, :]
        cc = c[..., :, None] * c[..., None, :]
        cov_sum = torch.where(m3[..., None], cc, 0.0).sum(2)
        return statistical_features(cnt, d_sum, d2_sum, x_sum, cov_sum, pos_c)

    # -- pointnet -----------------------------------------------------------------
    def _pointnet_chunk(self, pos_c, lat_idx_c, mask_c, direction):
        """(pooled partial [B, Q, 32], edge count [B, Q]) of one chunk."""
        src, qry = self._edge_coords(pos_c, lat_idx_c, direction)
        h = self.pointnet_mlp(src - qry)  # [B, n, K, 32]
        B = h.shape[0]
        if direction == "encoder":
            seg, msk, folds = self._segments(lat_idx_c, mask_c)
            data = h.reshape(B, -1, POINTNET_WIDTH)
            cnt = self._count(seg, msk, folds)
            if self.pooling == "mean":
                return self._sum(data, seg, msk, folds), cnt
            if folds is not None:
                acc = [fold_max(f, d, empty_value=float("-inf")) for f, d in zip(folds, data)]
            else:
                acc = [segment_max(d, g, self.grid.num_tokens, m, empty_value=float("-inf"))
                       for d, g, m in zip(data, seg, msk)]
            return torch.stack(acc), cnt
        m3 = mask_c[..., None]
        cnt = mask_c.sum(-1).to(torch.float32)
        if self.pooling == "max":
            return torch.where(m3, h, float("-inf")).amax(dim=2), cnt
        return torch.where(m3, h, 0.0).sum(dim=2), cnt

    def _pointnet(self, slots: EdgeSlots, point_pos, direction, chunk):
        N = point_pos.shape[1]
        parts = [run_chunk(self.remat, self._pointnet_chunk, point_pos[:, c0:c0 + chunk],
                           slots.lat_idx[:, c0:c0 + chunk], slots.mask[:, c0:c0 + chunk],
                           direction)
                 for c0 in range(0, N, chunk)]
        if direction == "encoder":
            acc, cnt = parts[0]
            for a, c in parts[1:]:
                acc = torch.maximum(acc, a) if self.pooling == "max" else acc + a
                cnt = cnt + c
            # a node-sharded step pools over the node group (parallel/sharding.py)
            group = node_group()
            acc = (all_reduce_max if self.pooling == "max" else all_reduce_sum)(acc, group)
            cnt = all_reduce_sum(cnt, group)
        else:
            acc = torch.cat([a for a, _ in parts], dim=1)
            cnt = torch.cat([c for _, c in parts], dim=1)
        has_nb = (cnt > 0)[..., None]
        if self.pooling == "max":
            # an empty query pools to 0, as torch_scatter's 'max'
            pooled = torch.where(has_nb & torch.isfinite(acc), acc, 0.0)
        else:
            pooled = acc / cnt.clamp_min(1.0)[..., None]
        return torch.where(has_nb, self.fc(pooled), 0.0)

    def forward(self, slots: EdgeSlots, point_pos: torch.Tensor, direction: str,
                query_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """point_pos [B, N, 3] -> encoder [B, M, out] | decoder [B, N, out];
        query_mask [B, N] (decoder) leaves padded queries out of the
        z-normalisation."""
        if direction not in ("encoder", "decoder"):
            raise ValueError(f"direction must be encoder|decoder, got {direction}")
        if not isinstance(slots, EdgeSlots):
            raise NotImplementedError(
                f"edge layout {type(slots).__name__} is not ported for GeometricEmbedding "
                "(supported: EdgeSlots)")
        N = point_pos.shape[1]
        chunk = effective_chunk(N, self.edge_chunk_size)
        if self.method == "pointnet":
            return self._pointnet(slots, point_pos, direction, chunk)
        with torch.no_grad():
            if direction == "encoder":
                feats = self._statistical_encoder(slots, point_pos, chunk)
            else:
                feats = torch.cat([
                    self.decoder_features(point_pos[:, c0:c0 + chunk],
                                                    slots.lat_idx[:, c0:c0 + chunk],
                                                    slots.mask[:, c0:c0 + chunk])
                    for c0 in range(0, N, chunk)], dim=1)
        # the encoder's grid is replicated over a node group, its batch split
        # over the data ranks; the decoder's queries are split over every rank
        group = data_group() if direction == "encoder" else world_group()
        return znorm_mlp(feats, self.mlp, query_mask, group)


class StatisticalGeoEmbedding(GeometricEmbedding):
    """The statistical embedding (keys mlp.0, mlp.2), as the fused encoder
    (its MLP) and the fused decoder (with the grid) run it."""

    def __init__(self, coord_dim: int, out_channels: int, grid: Optional[LatentGrid] = None):
        super().__init__(coord_dim, out_channels, "statistical", grid=grid)
