"""Kernel integral transform (GNO) over edge slots (port of
gaot3d_tpu/models/integral_transform.py `effective_chunk` and
`IntegralTransform`: both directions, the three transform types and the
per-edge attention; callers slice node chunks directly instead of
`reshape_chunks`).

Per edge from a source to a query, kernel = MLP([source | query coords]
(+ source features for 'nonlinear' and 'nonlinear_kernelonly')) at
`kernel_dtype` (float32 | bfloat16, see models/mlp.py `kernel_mlp_apply`);
'linear' and 'nonlinear' multiply the kernel by the source features. Each
query takes the mean of its edges' values, or with `use_attn` their sum
weighted by a softmax over the query's edges of a cosine or dot-product
score of the coordinates.

- decoder (latent cells -> points): a masked mean, or softmax, over the K
  slots of each point, one node chunk at a time; flat edge lists sorted by
  node fold through the prefix-sum kernel K7;
- encoder (points -> latent cells): a segment sum by cell of each node
  chunk, through `segment_impl` 'sort' (the folds of ops/segment.py, so K7
  on the card, of the rows' deviations from their mean: `fold_sum_centred`)
  or 'scatter' (index_add_; 'tile' runs as 'scatter', as in the JAX module);
  with attention, the softmax is taken online across the
  chunks (a running max, exp-sum and weighted sum a cell).
The flagship's encoder (statistical geoembed, no attention) does not come
here: models/fused_encoder.py runs it, with this module's kernel MLP.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.grid_graph import EdgeSlots, FlatEdgeChunks, LatentGrid
from ..parallel.sharding import all_reduce_, all_reduce_sum, node_group
from ..ops.segment import (fold_count, fold_max, fold_sum_centred, fold_sum_sorted,
                           gather_table, make_segment_fold, make_segment_fold_presorted,
                           segment_max, segment_sum)
from .mlp import ChannelMLP, kernel_mlp_apply

TRANSFORM_TYPES = ("linear", "nonlinear", "nonlinear_kernelonly")
ATTENTION_TYPES = ("cosine", "dot_product")
ATTENTION_DIM = 64  # width of the dot-product query and key projections


def effective_chunk(N: int, chunk: Optional[int]) -> int:
    """Largest divisor of N that is <= chunk (N when chunk is None or >= N)."""
    if chunk is None or chunk >= N:
        return N
    for d in range(int(chunk), 0, -1):
        if N % d == 0:
            return d
    return N


def run_chunk(remat: bool, fn, *args):
    """fn(*args); with `remat` under autograd, its activations are not kept
    but recomputed in the backward (the JAX package's `remat` of a chunk
    body), so a chunk's per-edge intermediates are the largest transient."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def _gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [B, M, C], idx [B, ...] -> [B, ..., C] (`gather_table` of each
    sample with every row valid)."""
    B = table.shape[0]
    ones = torch.ones(idx[0].numel(), dtype=torch.bool, device=idx.device)
    rows = [gather_table(t, i.reshape(-1), ones) for t, i in zip(table, idx)]
    return torch.stack(rows).reshape(B, *idx.shape[1:], table.shape[-1])


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(eps)


class IntegralTransform(nn.Module):
    """The GNO; its kernel MLP sits in `channel_mlp`, the dot-product
    attention's projections in `query_proj` and `key_proj` (the reference's
    keys)."""

    def __init__(self, channel_mlp_layers: Sequence[int], grid: LatentGrid,
                 transform_type: str = "linear", kernel_dtype: str = "float32",
                 use_attn: Optional[bool] = None, coord_dim: int = 3,
                 attention_type: str = "cosine", edge_chunk_size: Optional[int] = None,
                 segment_impl: str = "sort", remat: bool = False):
        super().__init__()
        if transform_type not in TRANSFORM_TYPES:
            raise ValueError(f"unknown transform_type: {transform_type!r} "
                             f"(one of {TRANSFORM_TYPES})")
        if use_attn and attention_type not in ATTENTION_TYPES:
            raise ValueError(f"Invalid attention_type: {attention_type}")
        self.channel_mlp = ChannelMLP(channel_mlp_layers, "linear")
        self.grid = grid
        self.transform_type = transform_type
        self.kernel_dtype = kernel_dtype
        self.use_attn = bool(use_attn)
        self.coord_dim = coord_dim
        self.attention_type = attention_type
        self.edge_chunk_size = edge_chunk_size
        self.segment_impl = segment_impl
        self.remat = remat
        if self.use_attn and attention_type == "dot_product":
            self.query_proj = nn.Linear(coord_dim, ATTENTION_DIM)
            self.key_proj = nn.Linear(coord_dim, ATTENTION_DIM)

    # -- per-edge math ----------------------------------------------------------
    def edge_values(self, src_pos: torch.Tensor, dst_pos: torch.Tensor,
                    src_feat: Optional[torch.Tensor]) -> torch.Tensor:
        """kernel([src | dst coords] (+ src feats)) (* src feats)."""
        agg = torch.cat([src_pos, dst_pos], dim=-1)
        nonlinear = self.transform_type != "linear"
        if src_feat is not None and nonlinear:
            agg = torch.cat([agg, src_feat], dim=-1)
        out = kernel_mlp_apply(agg, self.channel_mlp.fcs, self.kernel_dtype)
        if src_feat is not None and self.transform_type != "nonlinear_kernelonly":
            out = out * src_feat
        return out

    def edge_scores(self, query: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
        """The attention score of each edge from its query's and its
        source's coordinates."""
        if self.attention_type == "dot_product":
            q, k = self.query_proj(query), self.key_proj(key)
            return (q * k).sum(-1) / (q.shape[-1] ** 0.5)
        return (_l2_normalize(query) * _l2_normalize(key)).sum(-1)

    def _slot_geometry(self, pos_c: torch.Tensor, lat_idx_c: torch.Tensor):
        """(cell coords, point coords) of every slot of a chunk: [B, n, K, 3]."""
        B, n, K = lat_idx_c.shape
        lat_pos = self.grid.positions_from_idx(lat_idx_c, dtype=pos_c.dtype)
        return lat_pos, pos_c[:, :, None, :].expand(B, n, K, pos_c.shape[-1])

    # -- decoder ----------------------------------------------------------------
    def decoder_chunk(self, latent_feats: torch.Tensor, pos_c: torch.Tensor,
                      lat_idx_c: torch.Tensor, mask_c: torch.Tensor) -> torch.Tensor:
        """latent_feats [B, M, C], pos_c [B, n, 3], slots [B, n, K] ->
        [B, n, C] (query = the point rows)."""
        lat_pos, pt_pos = self._slot_geometry(pos_c, lat_idx_c)
        src = _gather_rows(latent_feats, lat_idx_c)
        vals = self.edge_values(lat_pos, pt_pos, src)
        zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
        if self.use_attn:
            d = self.coord_dim
            scores = self.edge_scores(pt_pos[..., :d], lat_pos[..., :d]).float()
            neg = torch.where(mask_c, scores, float("-inf"))
            smax = neg.amax(dim=-1, keepdim=True)
            smax = torch.where(torch.isfinite(smax), smax, 0.0)
            ex = torch.where(mask_c, torch.exp(neg - smax), 0.0)
            w = ex / ex.sum(dim=-1, keepdim=True).clamp_min(torch.finfo(torch.float32).tiny)
            return (vals * w[..., None].to(vals.dtype)).sum(2)
        total = torch.where(mask_c[..., None], vals, zero).sum(2)
        count = mask_c.sum(dim=-1, keepdim=True).clamp_min(1)
        return total / count.to(vals.dtype)

    def decoder_chunk_flat(self, latent_feats: torch.Tensor, pos_c: torch.Tensor,
                           src_e: torch.Tensor, dst_e: torch.Tensor,
                           emask_e: torch.Tensor) -> torch.Tensor:
        """Flat-edge form of `decoder_chunk`: packed valid edges [B, E] with
        src LOCAL to the chunk and ascending, so the mean by node is a
        presorted fold over n segments. latent_feats [B, M, C], pos_c
        [B, n, 3] -> [B, n, C]."""
        if self.use_attn:
            raise NotImplementedError("flat edge layout: per-edge GNO attention unsupported")
        B, E = emask_e.shape
        n = pos_c.shape[1]
        lat_pos = self.grid.positions_from_idx(dst_e, dtype=pos_c.dtype)
        pt_pos = torch.gather(pos_c, 1, src_e.long()[..., None].expand(B, E, pos_c.shape[-1]))
        src = torch.stack([gather_table(t, d, m) for t, d, m in zip(latent_feats, dst_e, emask_e)])
        vals = self.edge_values(lat_pos, pt_pos, src)
        outs = []
        for v, s, m in zip(vals, src_e, emask_e):
            ctx = make_segment_fold_presorted(s, n, m)
            cnt = fold_count(ctx, v.dtype).clamp_min(1.0)
            outs.append(fold_sum_sorted(ctx, v) / cnt[:, None])
        return torch.stack(outs)

    # -- encoder ----------------------------------------------------------------
    def _encoder_edges(self, feats_c, pos_c, lat_idx_c):
        """Per-edge values and scores of one chunk, flattened to [B, n*K]."""
        B, n, K = lat_idx_c.shape
        lat_pos, pt_pos = self._slot_geometry(pos_c, lat_idx_c)
        fe = None if feats_c is None else feats_c[:, :, None, :].expand(B, n, K, feats_c.shape[-1])
        vals = self.edge_values(pt_pos, lat_pos, fe).reshape(B, n * K, -1)
        scores = None
        if self.use_attn:
            d = self.coord_dim
            scores = self.edge_scores(lat_pos[..., :d], pt_pos[..., :d]).float().reshape(B, n * K)
        return vals, scores

    def _reduce_sum(self, data, seg, msk, M, folds=None):
        """Per-sample segment sums of data [B, E(, C)] by cell: [B, M(, C)]."""
        if self.segment_impl == "sort":
            return torch.stack([fold_sum_centred(f, d) for f, d in zip(folds, data)])
        return torch.stack([segment_sum(d, g, M, m) for d, g, m in zip(data, seg, msk)])

    def _plain_chunk(self, feats_c, pos_c, lat_idx_c, mask_c):
        """One chunk's (sums [B, M, C], counts [B, M]) by cell."""
        B = lat_idx_c.shape[0]
        M = self.grid.num_tokens
        vals, _ = self._encoder_edges(feats_c, pos_c, lat_idx_c)
        seg, msk = lat_idx_c.reshape(B, -1), mask_c.reshape(B, -1)
        if self.segment_impl == "sort":
            folds = [make_segment_fold(g, M, m) for g, m in zip(seg, msk)]
            cnt = torch.stack([fold_count(fo) for fo in folds])
        else:
            folds = None
            cnt = torch.stack([segment_sum(torch.ones_like(g, dtype=torch.float32), g, M, m)
                               for g, m in zip(seg, msk)])
        return self._reduce_sum(vals, seg, msk, M, folds), cnt

    def _encoder_plain(self, slots: EdgeSlots, point_pos, feats, chunk):
        N = point_pos.shape[1]
        total = count = 0.0
        for c0 in range(0, N, chunk):
            rows = slice(c0, c0 + chunk)
            s, c = run_chunk(self.remat, self._plain_chunk,
                             None if feats is None else feats[:, rows], point_pos[:, rows],
                             slots.lat_idx[:, rows], slots.mask[:, rows])
            total, count = total + s, count + c
        # a node-sharded step sums the ranks' sums and counts (parallel/sharding.py)
        group = node_group()
        total, count = all_reduce_sum(total, group), all_reduce_sum(count, group)
        # mean; an empty cell gives 0 (torch_scatter's 'mean')
        return total / count.clamp_min(1.0)[..., None]

    def _attn_chunk(self, m, l, acc, feats_c, pos_c, lat_idx_c, mask_c):
        """One chunk's step of the online segment softmax: (m, l, acc) ->
        (m', l', acc')."""
        B = lat_idx_c.shape[0]
        M = self.grid.num_tokens
        vals, sc = self._encoder_edges(feats_c, pos_c, lat_idx_c)
        seg, msk = lat_idx_c.reshape(B, -1), mask_c.reshape(B, -1)
        if self.segment_impl == "sort":
            folds = [make_segment_fold(g, M, mm) for g, mm in zip(seg, msk)]
            cmax = torch.stack([fold_max(fo, x, empty_value=float("-inf"))
                                for fo, x in zip(folds, sc)])
        else:
            folds = None
            cmax = torch.stack([segment_max(x, g, M, mm, empty_value=float("-inf"))
                                for x, g, mm in zip(sc, seg, msk)])
        m_new = torch.maximum(m, cmax)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(sc - torch.gather(m_safe, 1, seg.long().clamp(0, M - 1)))
        p = torch.where(msk, p, 0.0)
        alpha = torch.exp(torch.where(torch.isfinite(m), m, m_safe) - m_safe)
        p_sum = self._reduce_sum(p, seg, msk, M, folds)
        pv_sum = self._reduce_sum(p[..., None] * vals, seg, msk, M, folds)
        return m_new, l * alpha + p_sum, acc * alpha[..., None] + pv_sum

    def _encoder_attn(self, slots: EdgeSlots, point_pos, feats, chunk):
        """The segment softmax online across node chunks (the flash-attention
        recurrence on a segment softmax): a running max m, exp-sum l and
        weighted sum acc a cell."""
        B, N, K = slots.mask.shape
        M = self.grid.num_tokens
        C = self.channel_mlp.fcs[-1].weight.shape[0]
        dev = point_pos.device
        m = torch.full((B, M), float("-inf"), device=dev)
        l = torch.zeros((B, M), device=dev)
        acc = torch.zeros((B, M, C), device=dev)
        for c0 in range(0, N, chunk):
            rows = slice(c0, c0 + chunk)
            m, l, acc = run_chunk(self.remat, self._attn_chunk, m, l, acc,
                                  None if feats is None else feats[:, rows], point_pos[:, rows],
                                  slots.lat_idx[:, rows], slots.mask[:, rows])
        group = node_group()
        if group is not None:
            # a node-sharded step joins the ranks' states at the global max; that
            # shift cancels in acc / l, so it takes no gradient, the local m does
            top = all_reduce_(m.detach().clone(), group, torch.distributed.ReduceOp.MAX)
            top = torch.where(torch.isfinite(top), top, 0.0)
            scale = torch.exp(torch.where(torch.isfinite(m), m, top) - top)
            l = all_reduce_sum(l * scale, group)
            acc = all_reduce_sum(acc * scale[..., None], group)
        out = acc / l.clamp_min(torch.finfo(torch.float32).tiny)[..., None]
        # a cell with no edge gives 0, as the segment sum of weighted values
        return torch.where((l > 0)[..., None], out, 0.0).to(point_pos.dtype)

    # -- public forward -----------------------------------------------------------
    def forward(self, slots, point_pos: torch.Tensor, src_feats: Optional[torch.Tensor],
                direction: str = "decoder") -> torch.Tensor:
        """Encoder: point features src_feats [B, N, C] (None for a kernel of
        coordinates only) -> [B, M, C]. Decoder: latent features src_feats
        [B, M, C] -> [B, N, C]. One node chunk of `edge_chunk_size` at a
        time."""
        if direction not in ("encoder", "decoder"):
            raise ValueError(f"direction must be encoder|decoder, got {direction}")
        N = point_pos.shape[1]
        if isinstance(slots, FlatEdgeChunks):
            if direction != "decoder":
                raise ValueError("flat edge layout: encoder direction goes through the fused "
                                 "encoder (FusedEncoderScale), not IntegralTransform")
            nc = slots.num_chunks
            if N % nc != 0:
                raise ValueError(f"flat chunks ({nc}) must divide N ({N})")
            chunk = N // nc
            return torch.cat([
                self.decoder_chunk_flat(src_feats, point_pos[:, c * chunk:(c + 1) * chunk],
                                        slots.src[:, c], slots.dst[:, c], slots.mask[:, c])
                for c in range(nc)], dim=1)
        if not isinstance(slots, EdgeSlots):
            raise NotImplementedError(
                f"edge layout {type(slots).__name__} is not ported for IntegralTransform "
                "(supported: EdgeSlots, FlatEdgeChunks)")
        chunk = effective_chunk(N, self.edge_chunk_size)
        if direction == "encoder":
            run = self._encoder_attn if self.use_attn else self._encoder_plain
            return run(slots, point_pos, src_feats, chunk)
        return torch.cat([run_chunk(self.remat, self.decoder_chunk, src_feats,
                                    point_pos[:, c0:c0 + chunk], slots.lat_idx[:, c0:c0 + chunk],
                                    slots.mask[:, c0:c0 + chunk])
                          for c0 in range(0, N, chunk)], dim=1)
