"""The MAGNO decoder's GNO mean in one pass (K9, `csrc/decoder_payload.cu`),
with its plain PyTorch version and the predicate that picks it.

The decoder's GNO with transform_type 'linear' and no per-edge attention is,
for every query point n of every sample b,

    out[b, n] = (1 / max(#valid slots, 1)) * sum over its valid slots k of
                mlp([cell(lat_idx[b, n, k]) | pos[b, n]]) * latent[b, lat_idx[b, n, k]]

(models/integral_transform.py `IntegralTransform.decoder_chunk`, which the
JAX package leaves to XLA). K9 computes it over the whole node range in one
launch, walking the valid slots only through the tile map of the bf16 K5
bodies (kernels/encoder_payload.py `tile_map`, built on the card with no
host sync), with the kernel MLP's products as f32 FMAs and exact GELU; no
slot's intermediates reach device memory, and the result is the same bits
from run to run.

- `decoder_payload` is the mean: the kernel for CUDA tensors, the plain
  version for CPU tensors.
- `decoder_payload_reference` is that plain version, the same tensor
  operations as `decoder_chunk`, so on the CPU it gives its bits.
- `engages` is the one predicate the decoder asks, from its slots and
  degree sections (flat edge lists and the geoembed decoder never ask): an
  eval forward (no gradient) on the card, a linear f32 kernel MLP of built
  widths without attention, at most 128 slots a node (a tile holds whole
  nodes). Everything else keeps the plain path: training, bf16 kernel
  MLPs, attention and nonlinear transforms, the CPU.

MLP weights are passed in torch layout (weight [out, in], bias [out]).
`decoder_payload.launches` counts K9's launches.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..edges import LatentGrid
from ..utils.scatter import gather_table
from .build import load_cuda_library
from .encoder_payload import (SUPPORTED_WIDTHS, TILE_ROWS, _check_shared_memory, _pack_mlp,
                              kernel_mlp, tile_map)


def _library() -> ctypes.CDLL:
    lib = load_cuda_library("decoder_payload", "decoder_payload.cu", ["encoder_tiles.cuh"])
    lib.gaot_decoder_payload.restype = ctypes.c_int
    lib.gaot_decoder_payload.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_float] * 6
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2)
    lib.gaot_decoder_payload_smem.restype = ctypes.c_longlong
    lib.gaot_decoder_payload_smem.argtypes = [ctypes.c_int] * 3
    lib.gaot_decoder_payload_occupancy.restype = ctypes.c_int
    lib.gaot_decoder_payload_occupancy.argtypes = [ctypes.c_int] * 3
    return lib


def widths_built(widths: Sequence[int]) -> bool:
    """Whether K9 is built for a kernel MLP of `widths` [6, hid, ..., hid, C]."""
    if len(widths) < 3 or widths[0] != 6:
        return False
    hidden = set(widths[1:-1])
    return len(hidden) == 1 and (hidden.pop(), widths[-1]) in SUPPORTED_WIDTHS


def engages(device, transform_type: str, use_attn: bool, kernel_dtype: str,
            widths: Sequence[int], slots_per_node: int) -> bool:
    """Whether the decoder's GNO over slots runs K9: tensors on `device` a
    card, no gradient (an eval forward), a 'linear' float32 kernel MLP of
    `widths` without attention, 1 to TILE_ROWS slots a node."""
    return (torch.device(device).type == "cuda" and not torch.is_grad_enabled()
            and transform_type == "linear" and not use_attn and kernel_dtype == "float32"
            and widths_built(widths) and 0 < slots_per_node <= TILE_ROWS)


def decoder_payload_reference(latent_feats: torch.Tensor, pos: torch.Tensor,
                              lat_idx: torch.Tensor, mask: torch.Tensor,
                              weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                              grid: LatentGrid) -> torch.Tensor:
    """Plain version of `decoder_payload`, in the tensor operations of
    `IntegralTransform.decoder_chunk` (linear, no attention): latent_feats
    [B, M, C], pos [B, n, 3], lat_idx and mask [B, n, K] -> [B, n, C]."""
    B, n, K = lat_idx.shape
    lat_pos = grid.positions_from_idx(lat_idx, dtype=pos.dtype)
    pt_pos = pos[:, :, None, :].expand(B, n, K, pos.shape[-1])
    ones = torch.ones(lat_idx[0].numel(), dtype=torch.bool, device=lat_idx.device)
    src = torch.stack([gather_table(t, i.reshape(-1), ones) for t, i in zip(latent_feats, lat_idx)])
    src = src.reshape(B, n, K, latent_feats.shape[-1])
    vals = kernel_mlp(torch.cat([lat_pos, pt_pos], dim=-1), weights, biases) * src
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    total = torch.where(mask[..., None], vals, zero).sum(2)
    count = mask.sum(dim=-1, keepdim=True).clamp_min(1)
    return total / count.to(vals.dtype)


def _check(latent_feats, pos, lat_idx, mask, weights, biases, grid):
    if pos.ndim != 3 or pos.shape[-1] != 3:
        raise ValueError(f"pos must be [B, n, 3], got {tuple(pos.shape)}")
    B, n, _ = pos.shape
    if lat_idx.ndim != 3 or lat_idx.shape[:2] != (B, n) or mask.shape != lat_idx.shape:
        raise ValueError("lat_idx and mask must be [B, n, K] matching pos")
    if not 0 < lat_idx.shape[-1] <= TILE_ROWS:
        raise ValueError(f"K9 takes 1 to {TILE_ROWS} slots a node, got {lat_idx.shape[-1]}")
    C = latent_feats.shape[-1]
    if latent_feats.shape != (B, grid.num_tokens, C):
        raise ValueError(f"latent_feats must be [B, {grid.num_tokens}, C]")
    for name, t, dt in (("latent_feats", latent_feats, torch.float32),
                        ("pos", pos, torch.float32), ("lat_idx", lat_idx, torch.int32),
                        ("mask", mask, torch.bool)):
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != pos.device:
            raise ValueError(f"{name} is on {t.device}, pos on {pos.device}")
    widths = [weights[0].shape[1]] + [w.shape[0] for w in weights]
    shapes_ok = all(tuple(w.shape) == (b, a) for w, a, b in zip(weights, widths, widths[1:]))
    if not (shapes_ok and widths_built(widths) and widths[-1] == C
            and [tuple(b.shape) for b in biases] == [(w,) for w in widths[1:]]):
        raise ValueError(f"kernel MLP must be 6 -> hid ... -> {C} of built widths "
                         f"{SUPPORTED_WIDTHS}, got {[tuple(w.shape) for w in weights]}")


def decoder_payload(latent_feats: torch.Tensor, pos: torch.Tensor, lat_idx: torch.Tensor,
                    mask: torch.Tensor, weights: Sequence[torch.Tensor],
                    biases: Sequence[torch.Tensor], grid: LatentGrid) -> torch.Tensor:
    """The decoder GNO's masked slot mean: latent_feats [B, M, C], pos
    [B, n, 3], lat_idx [B, n, K] int32, mask [B, n, K] bool -> [B, n, C].
    K9 for CUDA tensors (no gradient flows through it), the plain version
    for CPU tensors."""
    if pos.device.type == "cpu":
        return decoder_payload_reference(latent_feats, pos, lat_idx, mask, weights, biases, grid)
    if pos.device.type != "cuda":
        raise ValueError(f"decoder_payload: no kernel for device {pos.device}")
    _check(latent_feats, pos, lat_idx, mask, weights, biases, grid)
    hid, C, n_mid = weights[0].shape[0], latent_feats.shape[-1], len(weights) - 2
    _check_shared_memory(_library().gaot_decoder_payload_smem(n_mid, hid, C),
                         "the decoder payload", hid, C, n_mid)
    params = _pack_mlp([w.detach() for w in weights], [b.detach() for b in biases])
    latent_feats, pos = latent_feats.detach().contiguous(), pos.detach().contiguous()
    lat_idx, mask = lat_idx.contiguous(), mask.contiguous()
    tiles = tile_map(mask)  # before the output, so that its temporaries are freed by then
    out = torch.empty((*lat_idx.shape[:2], C), device=pos.device)  # the kernel writes every node
    launch_payload(latent_feats, pos, lat_idx, mask, params, n_mid, hid, grid, tiles, out)
    decoder_payload.launches += 1
    return out


def launch_payload(latent_feats, pos, lat_idx, mask, params, n_mid, hid, grid, tiles, out):
    """One launch of K9 on checked, contiguous tensors: the MLP packed by
    `_pack_mlp`, `tiles` the mask's `tile_map`, out [B, n, C]."""
    B, n, K = lat_idx.shape
    _, d1, d2 = grid.dims
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().gaot_decoder_payload(
            latent_feats.data_ptr(), pos.data_ptr(), lat_idx.data_ptr(), mask.data_ptr(),
            params.data_ptr(), params.numel(), n_mid, hid, out.shape[-1], B, n, K,
            grid.num_tokens, d1, d2, *grid.lo, *grid.spacing, tiles.node_first.data_ptr(),
            tiles.n_items.data_ptr(), tiles.max_items, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"decoder_payload launch failed: cudaError {err}")


decoder_payload.launches = 0
