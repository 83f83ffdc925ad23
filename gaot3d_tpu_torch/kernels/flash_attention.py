"""Flash attention with probability dropout: the forward (K1,
`csrc/flash_attn_fwd.cu`), the fused backward (K2, `csrc/flash_attn_bwd.cu`),
the split backward (K3, `csrc/flash_attn_bwd_split.cu`: a dq kernel and a
dk/dv kernel), their plain PyTorch versions and the `torch.autograd.Function`
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
[B*H, S, Skv] uint32; a rate above 0 with neither raises.

The fused backward adds each tile's f32 dq partial into one buffer with a bulk
reduce-add (atomic in the memory system, in no fixed order), so dq's last bits
change from run to run; the split backward adds nothing across blocks and
repeats bit for bit. `GAOT_ATTN_BWD_FUSED=0` in the environment, read at
every backward as the JAX package reads it, selects the split one; unset or
`1` the fused one.
The JAX package also falls back to the split kernels when a head's dq exceeds
a VMEM budget; that limit belongs to the TPU and is not copied.

- `flash_attention`, `flash_attention_backward`, `flash_attention_backward_split`
  (and its halves `flash_attention_backward_dq`, `flash_attention_backward_dkv`):
  the kernels for CUDA tensors, the plain versions for CPU tensors; anything
  else raises.
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
from .dropout_bits import (dropout_bits_reference, keep_multiplier, keep_scale,
                           keep_threshold, seed_words)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (8, 16, 32, 64)
_DROPOUT_ARGTYPES = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_uint] * 3 + [ctypes.c_float]


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
                            headers=["philox.cuh", "hopper.cuh"])
    lib.gaot_flash_attn_bwd.restype = ctypes.c_int
    lib.gaot_flash_attn_bwd.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float] + _DROPOUT_ARGTYPES
        + [ctypes.c_void_p])
    return lib


def _split_library() -> ctypes.CDLL:
    lib = load_cuda_library("flash_attn_bwd_split", "flash_attn_bwd_split.cu",
                            headers=["philox.cuh"])
    for fn, n_pointers in ((lib.gaot_flash_attn_bwd_dq, 7), (lib.gaot_flash_attn_bwd_dkv, 8)):
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 5 + [ctypes.c_float]
                       + _DROPOUT_ARGTYPES + [ctypes.c_void_p])
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


def flash_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
        lse: torch.Tensor, dout: torch.Tensor, dropout_rate: float = 0.0,
        dropout_bits: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the fused backward and of the split one: (dq, dk, dv)
    in the types of q, k, v, with the kernels' roundings. The two compute one
    function (the JAX package pins its split kernels to its fused one), so one
    plain version serves both."""
    B, H, S, D = q.shape
    if dropout_rate > 0.0 and dropout_bits is None:
        raise ValueError("dropout needs explicit bits here (the plain version draws none)")
    scale = 1.0 / D ** 0.5
    qs = _scaled_q(q)
    delta = (dout.float() * out.float()).sum(dim=-1)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for b in range(B):
        for h in range(H):
            kf, do = k[b, h].float(), dout[b, h].float()
            p = torch.exp(qs[b, h] @ kf.T - lse[b, h][:, None])
            dpv = do @ v[b, h].float().T
            km = _head_multiplier(dropout_bits, dropout_rate, b * H + h)
            pm = p
            if km is not None:
                pm = p * km
                dpv = dpv * km
            ds = p * (dpv - delta[b, h][:, None])
            dv[b, h] = (pm.to(dout.dtype).float().T @ do).to(v.dtype)
            dk[b, h] = (ds.to(q.dtype).float().T @ qs[b, h]).to(k.dtype)
            dq[b, h] = ((ds.to(k.dtype).float() @ kf) * scale).to(q.dtype)
    return dq, dk, dv


def _bits_for(q: torch.Tensor, k: torch.Tensor, rate: float, seed: Optional[int],
              bits: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The bits the plain versions need: the given ones, or those of `seed`."""
    if rate <= 0.0 or bits is not None:
        return bits
    B, H, S, _ = q.shape
    return dropout_bits_reference(seed, B * H, S, k.shape[2], device=q.device)


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


def flash_attention_plain(q, k, v, dropout_rate=0.0, seed=None, dropout_bits=None):
    """`flash_attention` through the plain versions only, on any device."""
    _check_dropout(q, k, dropout_rate, seed, dropout_bits)
    return flash_attention_reference(q, k, v, dropout_rate,
                                     _bits_for(q, k, dropout_rate, seed, dropout_bits))


def flash_attention_backward_plain(q, k, v, out, lse, dout, dropout_rate=0.0, seed=None,
                                   dropout_bits=None):
    """`flash_attention_backward` through the plain versions only."""
    _check_dropout(q, k, dropout_rate, seed, dropout_bits)
    return flash_attention_backward_reference(
        q, k, v, out, lse, dout, dropout_rate,
        _bits_for(q, k, dropout_rate, seed, dropout_bits))


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


def _dropout_args(rate: float, seed: Optional[int], bits: Optional[torch.Tensor]):
    """The kernels' (drop, bits, seed_lo, seed_hi, thresh, inv_keep)."""
    if rate <= 0.0:
        return 0, None, 0, 0, 0, 1.0
    lo, hi = seed_words(seed) if bits is None else (0, 0)
    return (1, None if bits is None else bits.data_ptr(), lo, hi, keep_threshold(rate),
            keep_scale(rate))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    dropout_rate: float = 0.0, seed: Optional[int] = None,
                    dropout_bits: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Non-causal softmax(q k^T / sqrt(D)) v with probability dropout.
    q [B,H,S,D], k, v [B,H,Skv,D] -> (out [B,H,S,D], lse [B,H,S] f32)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, dropout_rate, seed, dropout_bits)
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
            *_dropout_args(dropout_rate, seed, dropout_bits), stream)
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
        seed: Optional[int] = None, dropout_bits: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `flash_attention` given its inputs, its outputs (out,
    lse), the cotangent dout [B,H,S,D] and the same rate and seed or bits."""
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, out, lse, dout, dropout_rate, seed,
                                              dropout_bits)
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
            *_dropout_args(dropout_rate, seed, dropout_bits), stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd launch failed: cudaError {err}")
    flash_attention_backward.launches += 1
    return dq32.to(q.dtype), dk, dv


flash_attention_backward.launches = 0


def _launch_split(name: str, pointers, q, k, dropout_rate, seed, dropout_bits) -> None:
    B, H, S, D = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_split_library(), name)(
            *pointers, B * H, S, k.shape[2], D, _DTYPES[q.dtype], 1.0 / D ** 0.5,
            *_dropout_args(dropout_rate, seed, dropout_bits), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def flash_attention_backward_dq(q, k, v, lse, dout, delta, dropout_rate=0.0, seed=None,
                                dropout_bits=None) -> torch.Tensor:
    """The dq kernel of the split backward on checked CUDA tensors; delta
    [B,H,S] f32 is rowsum(dout * out)."""
    dq = torch.empty_like(q)
    _launch_split("gaot_flash_attn_bwd_dq",
                  [t.data_ptr() for t in (q, k, v, dout, lse, delta, dq)], q, k,
                  dropout_rate, seed, dropout_bits)
    flash_attention_backward_dq.launches += 1
    return dq


flash_attention_backward_dq.launches = 0


def flash_attention_backward_dkv(q, k, v, lse, dout, delta, dropout_rate=0.0, seed=None,
                                 dropout_bits=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel of the split backward on checked CUDA tensors."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_split("gaot_flash_attn_bwd_dkv",
                  [t.data_ptr() for t in (q, k, v, dout, lse, delta, dk, dv)], q, k,
                  dropout_rate, seed, dropout_bits)
    flash_attention_backward_dkv.launches += 1
    return dk, dv


flash_attention_backward_dkv.launches = 0


def flash_attention_backward_split(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
        lse: torch.Tensor, dout: torch.Tensor, dropout_rate: float = 0.0,
        seed: Optional[int] = None, dropout_bits: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`flash_attention_backward` in two kernels without a shared accumulator:
    the same (dq, dk, dv), bit for bit equal between launches. Each kernel
    counts its own launches."""
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, out, lse, dout, dropout_rate, seed,
                                              dropout_bits)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_backward_split: no kernel for device {q.device}")
    _check_backward(q, k, v, out, lse, dout, dropout_rate, seed, dropout_bits)
    delta = (dout.float() * out.float()).sum(dim=-1)
    rest = (lse, dout, delta, dropout_rate, seed, dropout_bits)
    dq = flash_attention_backward_dq(q, k, v, *rest)
    dk, dv = flash_attention_backward_dkv(q, k, v, *rest)
    return dq, dk, dv


def backward_is_split() -> bool:
    """Whether the environment selects the split backward, now."""
    return os.environ.get("GAOT_ATTN_BWD_FUSED", "1") == "0"


class _FlashAttention(torch.autograd.Function):
    """K1 forward; K2 backward, or K3 when `backward_is_split()`. Saves (q, k,
    v, out, lse) and the mask's seed or bits; the wrappers pick kernel or
    plain version by device."""

    @staticmethod
    def forward(ctx, q, k, v, dropout_rate, seed, dropout_bits):
        out, lse = flash_attention(q, k, v, dropout_rate, seed, dropout_bits)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.dropout = (dropout_rate, seed, dropout_bits)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        rate, seed, bits = ctx.dropout
        backward = flash_attention_backward_split if backward_is_split() \
            else flash_attention_backward
        dq, dk, dv = backward(q, k, v, out, lse, dout.contiguous(), rate, seed, bits)
        return dq, dk, dv, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dropout_rate: float = 0.0,
              seed: Optional[int] = None,
              dropout_bits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable flash attention: out [B,H,S,D] for contiguous q
    [B,H,S,D] and k, v [B,H,Skv,D]."""
    return _FlashAttention.apply(q, k, v, float(dropout_rate), seed, dropout_bits)

