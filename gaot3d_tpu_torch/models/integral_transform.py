"""Kernel integral transform (GNO), decoder direction (port of
gaot3d_tpu/models/integral_transform.py `effective_chunk`, the decoder chunk
bodies for slots and for flat edge lists, and the decoder branches of
`__call__`; callers slice node chunks directly instead of `reshape_chunks`).

Per edge between a point and a latent cell: kernel = MLP([cell | point])
at `kernel_dtype` (float32 | bfloat16, see models/mlp.py `kernel_mlp_apply`;
a plain product, which the JAX package leaves to XLA too),
value = kernel * latent features of the cell; each point takes the mean over
its valid edges: a masked mean over its K slots, or, for flat edge lists
sorted by node, a presorted fold by node through the prefix-sum kernel K7.
The encoder direction runs through models/fused_encoder.py; this module only
holds its kernel-MLP weights.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.grid_graph import EdgeSlots, FlatEdgeChunks, LatentGrid
from ..ops.segment import fold_count, fold_sum_sorted, make_segment_fold_presorted
from .mlp import ChannelMLP, kernel_mlp_apply


def effective_chunk(N: int, chunk: Optional[int]) -> int:
    """Largest divisor of N that is <= chunk (N when chunk is None or >= N)."""
    if chunk is None or chunk >= N:
        return N
    for d in range(int(chunk), 0, -1):
        if N % d == 0:
            return d
    return N


class IntegralTransform(nn.Module):
    """`transform_type: linear` GNO; its kernel MLP sits in `channel_mlp`."""

    def __init__(self, channel_mlp_layers: Sequence[int], grid: LatentGrid,
                 transform_type: str = "linear", kernel_dtype: str = "float32"):
        super().__init__()
        if transform_type != "linear":
            raise NotImplementedError(
                f"transform_type {transform_type!r} is not ported (only 'linear')")
        self.channel_mlp = ChannelMLP(channel_mlp_layers, "linear")
        self.grid = grid
        self.kernel_dtype = kernel_dtype

    def decoder_chunk(self, latent_feats: torch.Tensor, pos_c: torch.Tensor,
                      lat_idx_c: torch.Tensor, mask_c: torch.Tensor) -> torch.Tensor:
        """latent_feats [B, M, C], pos_c [B, n, 3], slots [B, n, K] ->
        [B, n, C] (query = the point rows)."""
        B, n, K = lat_idx_c.shape
        C = latent_feats.shape[-1]
        # masked slots may hold any index: gather from cell 0 for them
        idx = torch.where(mask_c, lat_idx_c, torch.zeros_like(lat_idx_c)).long()
        lat_pos = self.grid.positions_from_idx(idx, dtype=pos_c.dtype)
        pt_pos = pos_c[:, :, None, :].expand(B, n, K, pos_c.shape[-1])
        src = torch.gather(latent_feats, 1, idx.reshape(B, n * K, 1).expand(B, n * K, C))
        vals = kernel_mlp_apply(torch.cat([lat_pos, pt_pos], dim=-1), self.channel_mlp.fcs,
                                self.kernel_dtype)
        vals = vals * src.reshape(B, n, K, C)
        total = torch.where(mask_c[..., None], vals, torch.zeros((), dtype=vals.dtype,
                                                                  device=vals.device)).sum(2)
        count = mask_c.sum(dim=-1, keepdim=True).clamp_min(1)
        return total / count.to(vals.dtype)

    def decoder_chunk_flat(self, latent_feats: torch.Tensor, pos_c: torch.Tensor,
                           src_e: torch.Tensor, dst_e: torch.Tensor,
                           emask_e: torch.Tensor) -> torch.Tensor:
        """Flat-edge form of `decoder_chunk`: packed valid edges [B, E] with
        src LOCAL to the chunk and ascending, so the mean by node is a
        presorted fold over n segments. latent_feats [B, M, C], pos_c
        [B, n, 3] -> [B, n, C]."""
        B, E = emask_e.shape
        n = pos_c.shape[1]
        C = latent_feats.shape[-1]
        lat_pos = self.grid.positions_from_idx(dst_e, dtype=pos_c.dtype)
        pt_pos = torch.gather(pos_c, 1, src_e.long()[..., None].expand(B, E, pos_c.shape[-1]))
        # padding rows hold cell 0 and are zeroed, as the fold drops them
        cell = dst_e.clamp(0, latent_feats.shape[1] - 1).long()[..., None].expand(B, E, C)
        src = torch.gather(latent_feats, 1, cell) * emask_e[..., None].to(latent_feats.dtype)
        vals = kernel_mlp_apply(torch.cat([lat_pos, pt_pos], dim=-1), self.channel_mlp.fcs,
                                self.kernel_dtype) * src
        outs = []
        for v, s, m in zip(vals, src_e, emask_e):
            ctx = make_segment_fold_presorted(s, n, m)
            cnt = fold_count(ctx, v.dtype).clamp_min(1.0)
            outs.append(fold_sum_sorted(ctx, v) / cnt[:, None])
        return torch.stack(outs)

    def forward(self, slots, point_pos: torch.Tensor, latent_feats: torch.Tensor,
                direction: str = "decoder",
                edge_chunk_size: Optional[int] = None) -> torch.Tensor:
        """Decoder direction over a whole cloud: latent_feats [B, M, C],
        point_pos [B, N, 3] -> [B, N, C], one node chunk at a time."""
        if direction not in ("encoder", "decoder"):
            raise ValueError(f"direction must be encoder|decoder, got {direction}")
        if direction != "decoder":
            raise ValueError("the encoder direction goes through the fused encoder "
                             "(FusedEncoderScale), not IntegralTransform")
        N = point_pos.shape[1]
        if isinstance(slots, FlatEdgeChunks):
            nc = slots.num_chunks
            if N % nc != 0:
                raise ValueError(f"flat chunks ({nc}) must divide N ({N})")
            chunk = N // nc
            outs = [self.decoder_chunk_flat(latent_feats, point_pos[:, c * chunk:(c + 1) * chunk],
                                            slots.src[:, c], slots.dst[:, c], slots.mask[:, c])
                    for c in range(nc)]
        elif isinstance(slots, EdgeSlots):
            chunk = effective_chunk(N, edge_chunk_size)
            outs = [self.decoder_chunk(latent_feats, point_pos[:, c0:c0 + chunk],
                                       slots.lat_idx[:, c0:c0 + chunk],
                                       slots.mask[:, c0:c0 + chunk])
                    for c0 in range(0, N, chunk)]
        else:
            raise NotImplementedError(
                f"edge layout {type(slots).__name__} is not ported for the decoder GNO "
                "(supported: EdgeSlots, FlatEdgeChunks)")
        return torch.cat(outs, dim=1)
