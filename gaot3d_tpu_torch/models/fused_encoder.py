"""Fused encoder scale: GNO kernel transform + statistical geometric
embedding over one moment accumulator (port of
gaot3d_tpu/models/fused_encoder.py `FusedEncoderScale`: slotted, sectioned
and flat edge layouts, and the `scatter`, `sort` and `tile` reductions).

Every valid edge adds one payload row
[ gno values (C) | 1 | d | y (3) | yy^T sym (6) ] into acc[b, cell]. Which
code adds them follows the layout and `segment_impl`, as in the JAX package:

- slots or sections with `segment_impl: scatter`: the encoder-payload kernel
  K5 (kernels/encoder_payload.py) computes and scatters the rows in one pass
  with float atomics, and under autograd its backward K5b returns the
  gradients of the lifted features and of the kernel MLP;
- slots or sections with `segment_impl: sort` or `tile`: the rows are plain
  tensor code (`payload_rows`) and `_reduce` sorts a chunk's edges by cell
  and sums them through K7 (`fold_sum`) or K8 (`fold_sum_tile_lite`);
- `FlatEdgeChunks` in 'src' order: `payload_rows` over the packed valid
  edges, then `_reduce`;
- `FlatEdgeChunks` in 'dst' order (`flat_dst_sorted`): the edges arrive
  sorted by cell, and `flat_reduce_impl` picks the presorted fold through K7
  ('fold') or the sorted segment sum K6 ('pallas').
The sorted reductions use no atomics, so their accumulator is the same bits
on every run.

`_finalize` turns the accumulator into the GNO mean and the statistical
features: count, mean distance, distance variance, centroid offset and PCA
eigenvalues of the local covariance, z-normalised over the whole batch
(ddof 1) and fed through the geoembed MLP.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..kernels.encoder_payload import accumulate, encoder_payload_reference, payload_rows
from ..ops.eigh3 import eigvalsh3x3_desc
from ..ops.grid_graph import EdgeSlots, FlatEdgeChunks, LatentGrid, SectionedEdgeSlots
from ..ops.segment import (fold_sum, fold_sum_sorted, fold_sum_tile_lite, make_segment_fold,
                           make_segment_fold_presorted, make_tile_fold,
                           pallas_segment_sum_presorted, segment_sum)
from .integral_transform import IntegralTransform, effective_chunk


class StatisticalGeoEmbedding(nn.Module):
    """Feature MLP of the statistical geometric embedding (keys mlp.0, mlp.2)."""

    def __init__(self, coord_dim: int, out_channels: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(3 + 2 * coord_dim, 64), nn.ReLU(),
                                 nn.Linear(64, out_channels))


class FusedEncoderScale:
    """One encoder scale over precomputed edges. Holds no parameters of its
    own: it runs the kernel MLP of `gno` and the feature MLP of `geoembed`,
    which the owning encoder registers under the reference key names."""

    def __init__(self, gno: IntegralTransform, geoembed: StatisticalGeoEmbedding,
                 grid: LatentGrid, lifting_channels: int,
                 edge_chunk_size: Optional[int] = None, segment_impl: str = "scatter",
                 flat_dst_sorted: bool = False, flat_reduce_impl: str = "fold"):
        self.gno = gno
        self.geoembed = geoembed
        self.grid = grid
        self.lifting_channels = lifting_channels
        self.edge_chunk_size = edge_chunk_size
        self.segment_impl = segment_impl
        self.flat_dst_sorted = flat_dst_sorted
        self.flat_reduce_impl = flat_reduce_impl

    def __call__(self, slots, point_pos: torch.Tensor,
                 lifted_feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """point_pos [B, N, 3], lifted_feats [B, N, C] -> (gno_out [B, M, C],
        geo_out [B, M, C])."""
        B, N = point_pos.shape[:2]
        C = self.lifting_channels
        acc = torch.zeros((B, self.grid.num_tokens, C + 11), dtype=torch.float32,
                          device=point_pos.device)
        if isinstance(slots, FlatEdgeChunks):
            nc = slots.num_chunks
            if N % nc != 0:
                raise ValueError(f"flat chunks ({nc}) must divide N ({N})")
            chunk = N // nc
            for c in range(nc):
                rows = slice(c * chunk, (c + 1) * chunk)
                acc = acc + self._pass_chunk_flat(
                    lifted_feats[:, rows], point_pos[:, rows], slots.src[:, c],
                    slots.dst[:, c], slots.mask[:, c])
        elif isinstance(slots, SectionedEdgeSlots):
            # one accumulator threaded through the sections in node order
            if slots.num_nodes != N:
                raise ValueError(f"sectioned slots cover {slots.num_nodes} nodes, "
                                 f"points have {N}")
            off = 0
            for sec in slots.sections:
                ns = int(sec.lat_idx.shape[-2])
                acc = self._run_slotted(sec, point_pos[:, off:off + ns],
                                        lifted_feats[:, off:off + ns], acc)
                off += ns
        elif isinstance(slots, EdgeSlots):
            acc = self._run_slotted(slots, point_pos, lifted_feats, acc)
        else:
            raise NotImplementedError(
                f"edge layout {type(slots).__name__} is not ported "
                "(supported: EdgeSlots, SectionedEdgeSlots, FlatEdgeChunks)")
        return self._finalize(acc)

    def _kernel_mlp(self):
        fcs = self.gno.channel_mlp.fcs
        return [fc.weight for fc in fcs], [fc.bias for fc in fcs]

    def _run_slotted(self, slots: EdgeSlots, point_pos: torch.Tensor,
                     lifted_feats: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
        """Add the payload of one [B, n, K] slot tensor into acc."""
        n = point_pos.shape[1]
        chunk = effective_chunk(n, self.edge_chunk_size)
        weights, biases = self._kernel_mlp()
        if self.segment_impl == "scatter":
            return accumulate(
                point_pos.contiguous(), lifted_feats.contiguous(),
                slots.lat_idx.contiguous(), slots.mask.contiguous(),
                weights, biases, self.grid, acc, chunk=chunk)
        for c0 in range(0, n, chunk):
            rows = slice(c0, c0 + chunk)
            acc = acc + self._pass_chunk(lifted_feats[:, rows], point_pos[:, rows],
                                         slots.lat_idx[:, rows], slots.mask[:, rows])
        return acc

    def _reduce(self, payload: torch.Tensor, seg: torch.Tensor,
                msk: torch.Tensor) -> torch.Tensor:
        """[B, E, P] rows with cells seg [B, E] and validity msk -> [B, M, P];
        one reduction, by `segment_impl`."""
        M = self.grid.num_tokens
        if self.segment_impl == "tile":
            outs = [fold_sum_tile_lite(make_tile_fold(s, M, m), p, M)
                    for p, s, m in zip(payload, seg, msk)]
        elif self.segment_impl == "sort":
            outs = [fold_sum(make_segment_fold(s, M, m), p)
                    for p, s, m in zip(payload, seg, msk)]
        else:
            outs = [segment_sum(p, s, M, m) for p, s, m in zip(payload, seg, msk)]
        return torch.stack(outs)

    def _pass_chunk(self, feats_c: torch.Tensor, pos_c: torch.Tensor,
                    lat_idx_c: torch.Tensor, mask_c: torch.Tensor) -> torch.Tensor:
        """The payload of every slot of one node chunk, masked slots included
        (the reduction drops them), reduced onto the grid: [B, M, C+11]."""
        B, n, K = mask_c.shape
        weights, biases = self._kernel_mlp()
        payload = encoder_payload_reference(pos_c, feats_c, lat_idx_c, weights, biases,
                                            self.grid)
        return self._reduce(payload, lat_idx_c.reshape(B, n * K), mask_c.reshape(B, n * K))

    def _pass_chunk_flat(self, feats_c: torch.Tensor, pos_c: torch.Tensor,
                         src_e: torch.Tensor, dst_e: torch.Tensor,
                         emask_e: torch.Tensor) -> torch.Tensor:
        """One chunk of packed valid edges (src local node, dst cell, mask)
        [B, E]: no masked rows pay for the kernel MLP. -> [B, M, C+11]."""
        B, E = emask_e.shape
        M = self.grid.num_tokens
        idx = src_e.long()[..., None]
        pt = torch.gather(pos_c, 1, idx.expand(B, E, pos_c.shape[-1]))
        fe = torch.gather(feats_c, 1, idx.expand(B, E, feats_c.shape[-1]))
        weights, biases = self._kernel_mlp()
        payload = payload_rows(pt, fe, dst_e, weights, biases, self.grid)
        if not self.flat_dst_sorted:
            return self._reduce(payload, dst_e, emask_e)
        if self.flat_reduce_impl == "pallas":
            return pallas_segment_sum_presorted(payload, dst_e, emask_e, M)
        return torch.stack([fold_sum_sorted(make_segment_fold_presorted(d, M, m), p)
                            for p, d, m in zip(payload, dst_e, emask_e)])

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
