"""Flash attention with probability dropout: the forward (K1,
`csrc/flash_attn_fwd.cu`), the fused backward (K2, `csrc/flash_attn_bwd.cu`),
the split backward (K3, `csrc/flash_attn_bwd_split.cu`: a dk/dv kernel, then
a dq kernel), their plain PyTorch versions and the `torch.autograd.Function`
that joins them.

Replaces gaot3d_tpu/ops/pallas_attention.py `_flash_fwd_impl` and both the
fused and the split calls of `_flash_bwd_impl`, reached through
`flash_attention_dropout` (the TPU train and eval path). The kernels' design
notes, and what bounds them on an H100, are in their sources.

Semantics, from the Pallas bodies: q is prescaled by 1/sqrt(D) in f32 and
rounded back; logits and the softmax are f32; the denominator sums the
probabilities BEFORE dropout; a kept probability is multiplied by 1/(1-rate)
and then rounded to the value type for P.V; lse = m + log(max(l, 1e-30)).
The backward recomputes P from lse, replays the mask and rounds pm to dO's
type and ds to the input type before its three products; dq accumulates in
f32 and is rounded once.

The mask comes from a 64-bit `seed` (the kernels draw the bits of
kernels/dropout_bits.py in place) or from explicit `dropout_bits`
[B*H, S, Skv] uint32; a rate above 0 with neither raises. A seeded call
takes `bh_offset`, the global batch*head index of its first (batch, head):
a rank that holds rows b0.. of a larger batch passes b0 * H and draws the
bits those rows draw in one call over the whole batch.

The fused backward adds each tile's f32 dq partial into one buffer with a bulk
reduce-add (atomic in the memory system, in no fixed order), so dq's last bits
change from run to run; the split backward adds nothing across blocks and
repeats bit for bit. Its dk/dv kernel (K2's body without the dq part, so
dk and dv equal K2's bit for bit) runs first and, at a rate above 0, writes
the keep bits it draws into a keep mask, one bit a score (`keep_mask_shape`,
B*H*S*Skv/8 bytes, laid out as `pack_keep_mask_reference` says); the dq
kernel reads that mask and draws no bits. The mask lives for one backward.
`GAOT_ATTN_BWD_FUSED=0` in the environment, read at
every backward as the JAX package reads it, selects the split one; unset or
`1` the fused one.
The JAX package also falls back to the split kernels when a head's dq exceeds
a VMEM budget; that limit belongs to the TPU and is not copied.

- `flash_attention`, `flash_attention_backward`, `flash_attention_backward_split`
  (and its halves `flash_attention_backward_dkv`, which returns the keep mask,
  and `flash_attention_backward_dq`, which takes it): the kernels for CUDA
  tensors, the plain versions for CPU tensors; anything else raises.
- `pack_keep_mask_reference`, `unpack_keep_mask_reference`: the keep mask's
  layout in plain torch.
- `flash_attention_reference`, `flash_attention_backward_reference`: the plain
  versions, a full-row softmax one (batch, head) at a time; they take bits
  only. `flash_attention_plain` and `flash_attention_backward_plain` first turn
  a seed into bits with the plain generator.
- `attention`: the differentiable entry point.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from .build import load_cuda_library
from .dropout_bits import (bits_as_int64, dropout_bits_reference, keep_multiplier,
                           keep_scale, keep_threshold, seed_words)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (8, 16, 32, 64)
_DROPOUT_ARGTYPES = ([ctypes.c_int, ctypes.c_void_p] + [ctypes.c_uint] * 3 + [ctypes.c_float]
                     + [ctypes.c_uint])


def _library() -> ctypes.CDLL:
    lib = load_cuda_library("flash_attn_fwd", "flash_attn_fwd.cu",
                            headers=["philox.cuh", "hopper.cuh"])
    lib.gaot_flash_attn_fwd.restype = ctypes.c_int
    lib.gaot_flash_attn_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float] + _DROPOUT_ARGTYPES
        + [ctypes.c_void_p])
    return lib


def _backward_library() -> ctypes.CDLL:
    lib = load_cuda_library("flash_attn_bwd", "flash_attn_bwd.cu",
                            headers=["philox.cuh", "hopper.cuh", "flash_bwd_wgmma.cuh"])
    lib.gaot_flash_attn_bwd.restype = ctypes.c_int
    lib.gaot_flash_attn_bwd.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float] + _DROPOUT_ARGTYPES
        + [ctypes.c_void_p])
    return lib


def _split_library() -> ctypes.CDLL:
    lib = load_cuda_library("flash_attn_bwd_split", "flash_attn_bwd_split.cu",
                            headers=["philox.cuh", "hopper.cuh", "flash_bwd_wgmma.cuh"])
    lib.gaot_flash_attn_bwd_dkv.restype = ctypes.c_int
    lib.gaot_flash_attn_bwd_dkv.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float] + _DROPOUT_ARGTYPES
        + [ctypes.c_void_p])
    lib.gaot_flash_attn_bwd_dq.restype = ctypes.c_int
    lib.gaot_flash_attn_bwd_dq.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                                       ctypes.c_float, ctypes.c_void_p])
    return lib


def _scaled_q(q: torch.Tensor) -> torch.Tensor:
    """q prescaled in f32 and rounded back to its type, as f32."""
    return (q.float() * (1.0 / q.shape[-1] ** 0.5)).to(q.dtype).float()


def _head_multiplier(bits: Optional[torch.Tensor], rate: float,
                     bh: int) -> Optional[torch.Tensor]:
    """keep ? 1/(1-rate) : 0 for one (batch, head), or None at rate 0."""
    return keep_multiplier(bits[bh], rate) if rate > 0.0 else None


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              dropout_rate: float = 0.0,
                              dropout_bits: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward. q [B,H,S,D], k, v [B,H,Skv,D], bits
    [B*H,S,Skv] uint32 -> (out [B,H,S,D] in q's type, lse [B,H,S] f32)."""
    B, H, S, D = q.shape
    if dropout_rate > 0.0 and dropout_bits is None:
        raise ValueError("dropout needs explicit bits here (the plain version draws none)")
    qs = _scaled_q(q)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    for b in range(B):
        for h in range(H):
            s = qs[b, h] @ k[b, h].float().T
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp(s - m)
            l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
            km = _head_multiplier(dropout_bits, dropout_rate, b * H + h)
            if km is not None:
                p = p * km
            pv = p.to(v.dtype).float() @ v[b, h].float()
            out[b, h] = (pv / l).to(q.dtype)
            lse[b, h] = (m + torch.log(l))[:, 0]
    return out, lse


def _backward_from_multiplier(q, k, v, lse, dout, delta, multiplier
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward's arithmetic, given delta [B,H,S] f32 and
    `multiplier(bh)`, the [S, Skv] f32 keep ? 1/(1-rate) : 0 of one (batch,
    head) or None (no dropout)."""
    B, H, S, D = q.shape
    scale = 1.0 / D ** 0.5
    qs = _scaled_q(q)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for b in range(B):
        for h in range(H):
            kf, do = k[b, h].float(), dout[b, h].float()
            p = torch.exp(qs[b, h] @ kf.T - lse[b, h][:, None])
            dpv = do @ v[b, h].float().T
            km = multiplier(b * H + h)
            pm = p
            if km is not None:
                pm = p * km
                dpv = dpv * km
            ds = p * (dpv - delta[b, h][:, None])
            dv[b, h] = (pm.to(dout.dtype).float().T @ do).to(v.dtype)
            dk[b, h] = (ds.to(q.dtype).float().T @ qs[b, h]).to(k.dtype)
            dq[b, h] = ((ds.to(k.dtype).float() @ kf) * scale).to(q.dtype)
    return dq, dk, dv


def flash_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
        lse: torch.Tensor, dout: torch.Tensor, dropout_rate: float = 0.0,
        dropout_bits: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the fused backward and of the split one: (dq, dk, dv)
    in the types of q, k, v, with the kernels' roundings. The two compute one
    function (the JAX package pins its split kernels to its fused one), so one
    plain version serves both."""
    if dropout_rate > 0.0 and dropout_bits is None:
        raise ValueError("dropout needs explicit bits here (the plain version draws none)")
    delta = (dout.float() * out.float()).sum(dim=-1)
    return _backward_from_multiplier(
        q, k, v, lse, dout, delta,
        lambda bh: _head_multiplier(dropout_bits, dropout_rate, bh))


MASK_TILE = 64  # rows and keys of a keep-mask tile
MASK_WORDS = 128  # uint32 words of a tile: one bit a score


def keep_mask_shape(batch_heads: int, S: int, Skv: int) -> Tuple[int, int, int, int]:
    """Shape of the keep mask K3's dk/dv kernel hands to its dq kernel:
    [batch_heads, key tiles of 64, q tiles of 64, 128] uint32."""
    return (batch_heads, -(-Skv // MASK_TILE), -(-S // MASK_TILE), MASK_WORDS)


def pack_keep_mask_reference(bits: torch.Tensor, rate: float) -> torch.Tensor:
    """Plain version of the keep mask that K3's dk/dv kernel writes, from
    uint32 bits [BH, S, Skv]: keep iff bits >= keep_threshold(rate).

    The layout (`csrc/flash_bwd_wgmma.cuh`): one 128-word tile for each (64-key
    tile, 64-row q tile), key tiles outer. In a tile the 2x2 block of local q
    pair qp (rows 2qp, 2qp + 1) and key pair kp is nibble qp >> 2 of word
    4 kp + (qp & 3), its bits (even row, even key), (even row, odd key), (odd
    row, even key), (odd row, odd key). Rows past S and keys past Skv are 0."""
    BH, S, Skv = bits.shape
    _, nk, nq, _ = keep_mask_shape(BH, S, Skv)
    keep = torch.zeros((BH, nq * MASK_TILE, nk * MASK_TILE), dtype=torch.int64,
                       device=bits.device)
    keep[:, :S, :Skv] = (bits_as_int64(bits) >= keep_threshold(rate)).to(torch.int64)
    # [BH, q tile, qp >> 2, qp & 3, q row bit, key tile, kp, key bit]
    keep = keep.view(BH, nq, 8, 4, 2, nk, 32, 2)
    nibble = (keep[..., 0, :, :, 0] | keep[..., 0, :, :, 1] << 1
              | keep[..., 1, :, :, 0] << 2 | keep[..., 1, :, :, 1] << 3)  # [BH, nq, 8, 4, nk, 32]
    shifts = 4 * torch.arange(8, dtype=torch.int64, device=bits.device).view(1, 1, 8, 1, 1, 1)
    words = (nibble << shifts).sum(dim=2)  # [BH, nq, qp & 3, nk, kp]: disjoint bits
    words = words.permute(0, 3, 1, 4, 2).reshape(BH, nk, nq, MASK_WORDS)  # word 4 kp + (qp & 3)
    return words.to(torch.int32).view(torch.uint32)


def unpack_keep_mask_reference(mask: torch.Tensor, S: int, Skv: int) -> torch.Tensor:
    """The keep bits of a keep mask as bool [BH, S, Skv]."""
    BH, nk, nq, _ = mask.shape
    words = bits_as_int64(mask).view(BH, nk, nq, 32, 4)  # [.., kp, qp & 3]
    nibble = words[..., None] >> (4 * torch.arange(8, device=mask.device)) & 0xF  # [.., qp >> 2]
    bit = torch.stack([nibble & 1, nibble >> 1 & 1, nibble >> 2 & 1, nibble >> 3 & 1], dim=-1)
    # [BH, nk, nq, kp, qp & 3, qp >> 2, (q row bit, key bit)] -> [BH, q, key]
    bit = bit.view(BH, nk, nq, 32, 4, 8, 2, 2).permute(0, 2, 5, 4, 6, 1, 3, 7)
    return bit.reshape(BH, nq * MASK_TILE, nk * MASK_TILE)[:, :S, :Skv].bool()


def _bits_for(q: torch.Tensor, k: torch.Tensor, rate: float, seed: Optional[int],
              bits: Optional[torch.Tensor], bh_offset: int = 0) -> Optional[torch.Tensor]:
    """The bits the plain versions need: the given ones, or those of `seed`
    from batch*head `bh_offset` on."""
    if rate <= 0.0 or bits is not None:
        return bits
    B, H, S, _ = q.shape
    return dropout_bits_reference(seed, B * H, S, k.shape[2], device=q.device,
                                  bh_offset=bh_offset)


def _check_dropout(q: torch.Tensor, k: torch.Tensor, rate: float, seed: Optional[int],
                   bits: Optional[torch.Tensor]) -> None:
    if rate <= 0.0:
        return
    if seed is None and bits is None:
        raise ValueError("dropout needs a seed or explicit bits")
    if bits is not None:
        B, H, S, _ = q.shape
        if bits.dtype != torch.uint32 or tuple(bits.shape) != (B * H, S, k.shape[2]):
            raise ValueError(f"dropout_bits must be uint32 [{B * H}, {S}, {k.shape[2]}], got "
                             f"{bits.dtype} {tuple(bits.shape)}")
        if bits.device != q.device or not bits.is_contiguous():
            raise ValueError("dropout_bits must be contiguous and on q's device")


def flash_attention_plain(q, k, v, dropout_rate=0.0, seed=None, dropout_bits=None,
                          bh_offset=0):
    """`flash_attention` through the plain versions only, on any device."""
    _check_dropout(q, k, dropout_rate, seed, dropout_bits)
    return flash_attention_reference(q, k, v, dropout_rate,
                                     _bits_for(q, k, dropout_rate, seed, dropout_bits, bh_offset))


def flash_attention_backward_plain(q, k, v, out, lse, dout, dropout_rate=0.0, seed=None,
                                   dropout_bits=None, bh_offset=0):
    """`flash_attention_backward` through the plain versions only."""
    _check_dropout(q, k, dropout_rate, seed, dropout_bits)
    return flash_attention_backward_reference(
        q, k, v, out, lse, dout, dropout_rate,
        _bits_for(q, k, dropout_rate, seed, dropout_bits, bh_offset))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be [B, H, S, D]")
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"q, k, v must share one dtype of {list(_DTYPES)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must start on a 16-byte boundary")
    B, H, S, D = q.shape
    if D not in _HEAD_DIMS:
        raise ValueError(f"head dim {D} not built (supported: {_HEAD_DIMS})")
    if B * H > 65535 or S == 0 or k.shape[2] == 0:
        raise ValueError(f"unsupported sizes B*H={B * H}, S={S}, Skv={k.shape[2]}")


def _dropout_args(rate: float, seed: Optional[int], bits: Optional[torch.Tensor],
                  bh_offset: int = 0):
    """The kernels' (drop, bits, seed_lo, seed_hi, thresh, inv_keep, bh0)."""
    if rate <= 0.0:
        return 0, None, 0, 0, 0, 1.0, 0
    if not 0 <= bh_offset < 2 ** 32:
        raise ValueError(f"bh_offset {bh_offset} outside the 32-bit counter")
    lo, hi = seed_words(seed) if bits is None else (0, 0)
    return (1, None if bits is None else bits.data_ptr(), lo, hi, keep_threshold(rate),
            keep_scale(rate), bh_offset)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    dropout_rate: float = 0.0, seed: Optional[int] = None,
                    dropout_bits: Optional[torch.Tensor] = None, bh_offset: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Non-causal softmax(q k^T / sqrt(D)) v with probability dropout.
    q [B,H,S,D], k, v [B,H,Skv,D] -> (out [B,H,S,D], lse [B,H,S] f32)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, dropout_rate, seed, dropout_bits, bh_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    _check(q, k, v)
    _check_dropout(q, k, dropout_rate, seed, dropout_bits)
    B, H, S, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().gaot_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B * H, S, k.shape[2], D, _DTYPES[q.dtype], 1.0 / D ** 0.5,
            *_dropout_args(dropout_rate, seed, dropout_bits, bh_offset), stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0


def _check_backward(q, k, v, out, lse, dout, dropout_rate, seed, dropout_bits) -> None:
    _check(q, k, v)
    _check_dropout(q, k, dropout_rate, seed, dropout_bits)
    B, H, S, D = q.shape
    if out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype \
            or dout.dtype != q.dtype:
        raise ValueError("out and dout must have q's shape and type")
    if tuple(lse.shape) != (B, H, S) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be f32 [{B}, {H}, {S}]")
    if not (out.is_contiguous() and dout.is_contiguous() and lse.is_contiguous()):
        raise ValueError("out, dout and lse must be contiguous")
    if any(t.device != q.device for t in (out, dout, lse)) or dout.data_ptr() % 16:
        raise ValueError("out, dout and lse must be on q's device, dout 16-byte aligned")


def flash_attention_backward(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
        lse: torch.Tensor, dout: torch.Tensor, dropout_rate: float = 0.0,
        seed: Optional[int] = None, dropout_bits: Optional[torch.Tensor] = None,
        bh_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `flash_attention` given its inputs, its outputs (out,
    lse), the cotangent dout [B,H,S,D] and the same rate, seed or bits, and
    offset."""
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, out, lse, dout, dropout_rate, seed,
                                              dropout_bits, bh_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_backward: no kernel for device {q.device}")
    _check_backward(q, k, v, out, lse, dout, dropout_rate, seed, dropout_bits)
    B, H, S, D = q.shape
    delta = (dout.float() * out.float()).sum(dim=-1)
    dq32 = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _backward_library().gaot_flash_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq32.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B * H, S, k.shape[2], D, _DTYPES[q.dtype], 1.0 / D ** 0.5,
            *_dropout_args(dropout_rate, seed, dropout_bits, bh_offset), stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd launch failed: cudaError {err}")
    flash_attention_backward.launches += 1
    return dq32.to(q.dtype), dk, dv


flash_attention_backward.launches = 0


def _launch_split(name: str, pointers, q, k, *dropout) -> None:
    B, H, S, D = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_split_library(), name)(
            *pointers, B * H, S, k.shape[2], D, _DTYPES[q.dtype], 1.0 / D ** 0.5, *dropout,
            stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def flash_attention_backward_dkv(q, k, v, lse, dout, delta, dropout_rate=0.0, seed=None,
                                 dropout_bits=None, bh_offset=0
                                 ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The dk/dv kernel of the split backward, which runs first: (dk, dv, keep
    mask), the mask (`keep_mask_shape`, uint32) only at a rate above 0, else
    None. delta [B,H,S] f32 is rowsum(dout * out). The kernel on checked CUDA
    tensors, the plain version on CPU tensors."""
    B, H, S, _ = q.shape
    if q.device.type == "cpu":
        _check_dropout(q, k, dropout_rate, seed, dropout_bits)
        bits = _bits_for(q, k, dropout_rate, seed, dropout_bits, bh_offset)
        _, dk, dv = _backward_from_multiplier(
            q, k, v, lse, dout, delta, lambda bh: _head_multiplier(bits, dropout_rate, bh))
        mask = pack_keep_mask_reference(bits, dropout_rate) if dropout_rate > 0.0 else None
        return dk, dv, mask
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_backward_dkv: no kernel for device {q.device}")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    mask = None
    if dropout_rate > 0.0:
        mask = torch.empty(keep_mask_shape(B * H, S, k.shape[2]), dtype=torch.uint32,
                           device=q.device)
    _launch_split("gaot_flash_attn_bwd_dkv",
                  [t.data_ptr() for t in (q, k, v, dout, lse, delta, dk, dv)]
                  + [None if mask is None else mask.data_ptr()], q, k,
                  *_dropout_args(dropout_rate, seed, dropout_bits, bh_offset))
    flash_attention_backward_dkv.launches += 1
    return dk, dv, mask


flash_attention_backward_dkv.launches = 0


def _check_keep_mask(q, k, dropout_rate, keep_mask) -> None:
    if dropout_rate <= 0.0:
        return
    if keep_mask is None:
        raise ValueError("the dq kernel needs the keep mask of the dk/dv kernel at a rate "
                         "above 0")
    B, H, S, _ = q.shape
    shape = keep_mask_shape(B * H, S, k.shape[2])
    if keep_mask.dtype != torch.uint32 or tuple(keep_mask.shape) != shape:
        raise ValueError(f"keep_mask must be uint32 {list(shape)}, got {keep_mask.dtype} "
                         f"{tuple(keep_mask.shape)}")
    if keep_mask.device != q.device or not keep_mask.is_contiguous() \
            or keep_mask.data_ptr() % 16:
        raise ValueError("keep_mask must be contiguous, 16-byte aligned and on q's device")


def flash_attention_backward_dq(q, k, v, lse, dout, delta, dropout_rate=0.0,
                                keep_mask=None) -> torch.Tensor:
    """The dq kernel of the split backward: it reads the keep mask that
    `flash_attention_backward_dkv` returned (required at a rate above 0) and
    draws no bits. The kernel on checked CUDA tensors, the plain version on
    CPU tensors."""
    _check_keep_mask(q, k, dropout_rate, keep_mask)
    if q.device.type == "cpu":
        keep = None if keep_mask is None else unpack_keep_mask_reference(
            keep_mask, q.shape[2], k.shape[2])
        scale = torch.tensor(keep_scale(dropout_rate), dtype=torch.float32)
        dq, _, _ = _backward_from_multiplier(
            q, k, v, lse, dout, delta,
            lambda bh: None if keep is None else keep[bh].to(torch.float32) * scale)
        return dq
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_backward_dq: no kernel for device {q.device}")
    dq = torch.empty_like(q)
    drop = int(dropout_rate > 0.0)
    _launch_split("gaot_flash_attn_bwd_dq",
                  [t.data_ptr() for t in (q, k, v, dout, lse, delta, dq)]
                  + [keep_mask.data_ptr() if drop else None], q, k,
                  drop, keep_scale(dropout_rate) if drop else 1.0)
    flash_attention_backward_dq.launches += 1
    return dq


flash_attention_backward_dq.launches = 0


def flash_attention_backward_split(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
        lse: torch.Tensor, dout: torch.Tensor, dropout_rate: float = 0.0,
        seed: Optional[int] = None, dropout_bits: Optional[torch.Tensor] = None,
        bh_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`flash_attention_backward` in two kernels without a shared accumulator:
    the same (dq, dk, dv), bit for bit equal between launches. The dk/dv
    kernel runs first and hands its keep mask to the dq kernel; the mask is
    freed when this returns. Each kernel counts its own launches."""
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, out, lse, dout, dropout_rate, seed,
                                              dropout_bits, bh_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_backward_split: no kernel for device {q.device}")
    _check_backward(q, k, v, out, lse, dout, dropout_rate, seed, dropout_bits)
    delta = (dout.float() * out.float()).sum(dim=-1)
    dk, dv, mask = flash_attention_backward_dkv(q, k, v, lse, dout, delta, dropout_rate, seed,
                                                dropout_bits, bh_offset)
    dq = flash_attention_backward_dq(q, k, v, lse, dout, delta, dropout_rate, mask)
    return dq, dk, dv


def backward_is_split() -> bool:
    """Whether the environment selects the split backward, now."""
    return os.environ.get("GAOT_ATTN_BWD_FUSED", "1") == "0"


class _FlashAttention(torch.autograd.Function):
    """K1 forward; K2 backward, or K3 when `backward_is_split()`. Saves (q, k,
    v, out, lse) and the mask's seed or bits; the wrappers pick kernel or
    plain version by device."""

    @staticmethod
    def forward(ctx, q, k, v, dropout_rate, seed, dropout_bits, bh_offset):
        out, lse = flash_attention(q, k, v, dropout_rate, seed, dropout_bits, bh_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.dropout = (dropout_rate, seed, dropout_bits, bh_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        rate, seed, bits, bh_offset = ctx.dropout
        backward = flash_attention_backward_split if backward_is_split() \
            else flash_attention_backward
        dq, dk, dv = backward(q, k, v, out, lse, dout.contiguous(), rate, seed, bits, bh_offset)
        return dq, dk, dv, None, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dropout_rate: float = 0.0,
              seed: Optional[int] = None, dropout_bits: Optional[torch.Tensor] = None,
              bh_offset: int = 0) -> torch.Tensor:
    """Differentiable flash attention: out [B,H,S,D] for contiguous q
    [B,H,S,D] and k, v [B,H,Skv,D]; a seeded mask from batch*head
    `bh_offset` of its stream on."""
    return _FlashAttention.apply(q, k, v, float(dropout_rate), seed, dropout_bits,
                                 int(bh_offset))

