"""Fused encoder scale: GNO kernel transform + statistical geometric
embedding over one moment accumulator (port of
gaot3d_tpu/models/fused_encoder.py `FusedEncoderScale`: slotted, sectioned
and flat edge layouts, the `scatter`, `sort` and `tile` reductions, the three
transform types and `use_gno: false`).

Every valid edge adds one payload row
[ gno values (C) | 1 | d | y (3) | yy^T sym (6) ] into acc[b, cell]; with
`use_gno: false` (no `gno` module) the row is the 11 geometry columns alone.
Which code adds them follows the layout, `segment_impl` and the config, as
in the JAX package:

- slots or sections with `segment_impl: scatter` and a 'linear' GNO: the
  encoder-payload kernel K5 (kernels/encoder_payload.py) computes and
  scatters the rows in one pass with float atomics, and under autograd its
  backward K5b returns the gradients of the lifted features and of the
  kernel MLP; with another transform type, or without a GNO, the rows are
  plain tensor code and `segment_sum` adds them (K5 covers the linear GNO
  only, as JAX's payload kernel does);
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

The kernel MLP runs at `kernel_dtype` (float32 | bfloat16, as
kernels/encoder_payload.py `kernel_mlp` takes it) on every path: K5 and K5b
have a body for each, and the plain rows of the other paths get it from
`payload_rows`, as the JAX package's XLA path does.

`_finalize` turns the accumulator into the GNO mean and the statistical
features: count, mean distance, distance variance, centroid offset and PCA
eigenvalues of the local covariance, z-normalised over the whole batch
(ddof 1) and fed through the geoembed MLP.

Shard-aligned sections (`SectionedEdgeSlots.shards` S > 1) are read through
the [B, S, N/S, ...] view of the point arrays: section i's rows are
s * N/S + [off_i, off_i + ns_i) of every shard s. Inside a node-sharded step
each rank adds its own rows' payload (K5 on the rank's rows), and the raw
accumulator, value columns and moments alike, is summed over the node group
before `_finalize`, so the eigenvalues and the z-norm see the whole cloud;
the sum's backward sums the cotangent over the group, so K5b gets all of it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..edges import EdgeSlots, LatentGrid, effective_chunk
from ..kernels.encoder_payload import accumulate, moment_rows, payload_rows
from ..ops.eigh3 import eigvalsh3x3_desc
from ..ops.segment import (fold_sum, fold_sum_sorted, fold_sum_tile_lite, make_segment_fold,
                           make_segment_fold_presorted, make_tile_fold,
                           pallas_segment_sum_presorted, segment_sum)
from ..parallel.sharding import all_reduce_sum, data_group, node_group
from .geoembed import StatisticalGeoEmbedding, znorm_mlp
from .integral_transform import IntegralTransform

__all__ = ["FusedEncoderScale", "StatisticalGeoEmbedding"]


class FusedEncoderScale:
    """One encoder scale over precomputed edges. Holds no parameters of its
    own: it runs the kernel MLP of `gno` (None under `use_gno: false`) and
    the feature MLP of `geoembed`, which the owning encoder registers under
    the reference key names."""

    def __init__(self, gno: Optional[IntegralTransform], geoembed: StatisticalGeoEmbedding,
                 grid: LatentGrid, lifting_channels: int,
                 edge_chunk_size: Optional[int] = None, segment_impl: str = "scatter",
                 flat_dst_sorted: bool = False, flat_reduce_impl: str = "fold",
                 kernel_dtype: str = "float32"):
        self.gno = gno
        self.geoembed = geoembed
        self.grid = grid
        self.lifting_channels = lifting_channels
        self.edge_chunk_size = edge_chunk_size
        self.segment_impl = segment_impl
        self.flat_dst_sorted = flat_dst_sorted
        self.flat_reduce_impl = flat_reduce_impl
        self.kernel_dtype = kernel_dtype

    @property
    def width(self) -> int:
        """Value columns of the payload: C, or 0 without a GNO."""
        return self.lifting_channels if self.gno is not None else 0

    def __call__(self, slots, point_pos: torch.Tensor,
                 lifted_feats: Optional[torch.Tensor]
                 ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """point_pos [B, N, 3], lifted_feats [B, N, C] (None without a GNO)
        -> (gno_out [B, M, C] or None, geo_out [B, M, C])."""
        B, N = point_pos.shape[:2]
        acc = torch.zeros((B, self.grid.num_tokens, self.width + 11), dtype=torch.float32,
                          device=point_pos.device)
        if slots.layout == "flat":
            for e, pts, fe in slots.blocks(point_pos, lifted_feats):
                acc = acc + self._pass_chunk_flat(fe, pts, *e)
        elif slots.layout == "sectioned":
            # one accumulator threaded through the sections in node order
            if slots.num_nodes != N:
                raise ValueError(f"sectioned slots cover {slots.num_nodes} nodes, "
                                 f"points have {N}")
            for sec, pts, fe in slots.blocks(point_pos, lifted_feats):
                acc = self._run_slotted(sec, pts, fe, acc)
        else:
            acc = self._run_slotted(slots, point_pos, lifted_feats, acc)
        return self._finalize(all_reduce_sum(acc, node_group()))

    def _kernel_mlp(self):
        fcs = self.gno.channel_mlp.fcs
        return [fc.weight for fc in fcs], [fc.bias for fc in fcs]

    def _launches_k5(self) -> bool:
        """Whether a slotted pass runs through K5: a 'linear' GNO reduced by
        'scatter'."""
        return (self.segment_impl == "scatter" and self.gno is not None
                and self.gno.transform_type == "linear")

    def _rows(self, pt: torch.Tensor, fe: Optional[torch.Tensor],
              idx: torch.Tensor) -> torch.Tensor:
        """The payload of one edge per row: points pt [..., 3], lifted
        features fe [..., C] and cells idx [...] -> [..., width + 11]."""
        if self.gno is None:
            return moment_rows(pt, self.grid.positions_from_idx(idx, dtype=pt.dtype))
        if self.gno.transform_type == "linear":
            weights, biases = self._kernel_mlp()
            return payload_rows(pt, fe, idx, weights, biases, self.grid, self.kernel_dtype)
        cell = self.grid.positions_from_idx(idx, dtype=pt.dtype)
        return torch.cat([self.gno.edge_values(pt, cell, fe), moment_rows(pt, cell)], dim=-1)

    def _run_slotted(self, slots: EdgeSlots, point_pos: torch.Tensor,
                     lifted_feats: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
        """Add the payload of one [B, n, K] slot tensor into acc."""
        n = point_pos.shape[1]
        chunk = effective_chunk(n, self.edge_chunk_size)
        if self._launches_k5():
            weights, biases = self._kernel_mlp()
            return accumulate(
                point_pos.contiguous(), lifted_feats.contiguous(),
                slots.lat_idx.contiguous(), slots.mask.contiguous(),
                weights, biases, self.grid, acc, chunk=chunk, kernel_dtype=self.kernel_dtype)
        for c0 in range(0, n, chunk):
            rows = slice(c0, c0 + chunk)
            feats_c = None if lifted_feats is None else lifted_feats[:, rows]
            acc = acc + self._pass_chunk(feats_c, point_pos[:, rows],
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
        pt = pos_c[:, :, None, :].expand(B, n, K, 3)
        fe = None if feats_c is None else feats_c[:, :, None, :].expand(B, n, K, feats_c.shape[-1])
        payload = self._rows(pt, fe, lat_idx_c).reshape(B, n * K, -1)
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
        fe = (None if feats_c is None
              else torch.gather(feats_c, 1, idx.expand(B, E, feats_c.shape[-1])))
        payload = self._rows(pt, fe, dst_e)
        if not self.flat_dst_sorted:
            return self._reduce(payload, dst_e, emask_e)
        if self.flat_reduce_impl == "pallas":
            return pallas_segment_sum_presorted(payload, dst_e, emask_e, M)
        return torch.stack([fold_sum_sorted(make_segment_fold_presorted(d, M, m), p)
                            for p, d, m in zip(payload, dst_e, emask_e)])

    def _finalize(self, acc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Moment accumulator [B, M, C+11] -> (gno_out, geo_out)."""
        B, M, _ = acc.shape
        C = self.width
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
        gno_out = acc[..., :C] / n_safe[..., None] if self.gno is not None else None

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
        # the grid is replicated over a node group; the batch is split over data ranks
        return gno_out, znorm_mlp(feats, self.geoembed.mlp, group=data_group())
