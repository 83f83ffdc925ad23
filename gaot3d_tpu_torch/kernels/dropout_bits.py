"""Attention-dropout bits (K4): the CUDA exporter `csrc/dropout_bits.cu`, its
plain PyTorch version, and the keep rule both share with the attention
kernels.

Replaces gaot3d_tpu/ops/pallas_attention.py `export_dropout_bits`. The TPU
seeds its in-core generator per tile, so its mask depends on the block
geometry. The port draws from Philox4x32-10 keyed on (seed, batch*head, q row,
key column) (`csrc/philox.cuh`): the bits depend on no tile shape, and the
flash forward, the flash backward and this exporter regenerate them
identically. The 2x2 block of the probability matrix that holds (row, col)
takes the counter (col >> 1, row >> 1, bh_offset + batch*head, 0) under the
key (seed low word, seed high word); the element reads word
(row & 1) * 2 + (col & 1). `bh_offset` (0 by default) is the global
batch*head of a call's first (batch, head), so that a rank holding rows of
a larger batch draws those rows' bits.

Keep rule (`_bits_to_keep` of the JAX file): keep iff
bits >= uint32(rate * (2^32 - 1)); a rate of 1 or more drops everything.

Bits tensors are `torch.uint32`, row-major [B*H, S, Skv]: the JAX layout
[B*H, nq, nk, bq, bk] with one block. `blocked_to_rowmajor` and
`rowmajor_to_blocked` convert, so one set of bits can feed the Pallas kernel
in interpret mode and the port.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .build import load_cuda_library

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _library() -> ctypes.CDLL:
    lib = load_cuda_library("dropout_bits", "dropout_bits.cu", headers=["philox.cuh"])
    lib.gaot_dropout_bits.restype = ctypes.c_int
    lib.gaot_dropout_bits.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_uint] * 3 + [ctypes.c_void_p])
    return lib


def seed_words(seed: int) -> Tuple[int, int]:
    """(low, high) 32-bit key words of a 64-bit seed."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & _MASK32, seed >> 32


def keep_threshold(rate: float) -> int:
    """uint32(rate * (2^32 - 1)), the JAX keep threshold."""
    return int(min(max(float(rate), 0.0), 1.0) * 4294967295.0)


def keep_scale(rate: float) -> float:
    """The factor of a kept probability: 1/(1-rate), and 0 at rate >= 1."""
    return 0.0 if rate >= 1.0 else 1.0 / (1.0 - float(rate))


def bits_as_int64(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits as non-negative int64 (torch compares no uint32)."""
    return bits.view(torch.int32).to(torch.int64) & _MASK32


def keep_multiplier(bits: torch.Tensor, rate: float) -> torch.Tensor:
    """f32 tensor of keep ? 1/(1-rate) : 0 for uint32 `bits`."""
    if rate >= 1.0:
        return torch.zeros(bits.shape, dtype=torch.float32, device=bits.device)
    keep = bits_as_int64(bits) >= keep_threshold(rate)
    return keep.to(torch.float32) * torch.tensor(keep_scale(rate), dtype=torch.float32)


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) words of m * x for 32-bit values held in int64: the
    product is taken in two 16-bit halves of x so that it never leaves 63
    bits."""
    lo_part = (x & 0xFFFF) * m
    hi = ((x >> 16) * m + (lo_part >> 16)) >> 16
    lo = (lo_part + (((x >> 16) * m & 0xFFFF) << 16)) & _MASK32
    return hi, lo


def philox4x32_10(counter, key) -> Tuple[torch.Tensor, ...]:
    """Philox4x32-10 on int64 tensors holding 32-bit words: four counter
    words and two key words (tensors or ints) -> four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def dropout_bits_reference(seed: int, batch_heads: int, S: int, Skv: int,
                           device="cpu", bh_offset: int = 0) -> torch.Tensor:
    """Plain version of the exporter: uint32 [batch_heads, S, Skv], the
    words of batch*heads bh_offset .. bh_offset + batch_heads - 1."""
    k0, k1 = seed_words(seed)
    out = torch.empty((batch_heads, S, Skv), dtype=torch.uint32, device=device)
    rows = torch.arange((S + 1) // 2, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange((Skv + 1) // 2, dtype=torch.int64, device=device)[None, :]
    c0, c1 = torch.broadcast_tensors(cols, rows)
    zero = torch.zeros_like(c0)
    for bh in range(batch_heads):
        w = philox4x32_10((c0, c1, zero + ((bh_offset + bh) & _MASK32), zero), (k0, k1))
        block = torch.stack([torch.stack([w[0], w[1]], dim=-1),
                             torch.stack([w[2], w[3]], dim=-1)], dim=1)  # [R, 2, C, 2]
        full = block.reshape(2 * c0.shape[0], 2 * c0.shape[1])[:S, :Skv]
        out[bh] = full.to(torch.int32).view(torch.uint32)
    return out


def export_dropout_bits(seed: int, batch_heads: int, S: int, Skv: int,
                        device="cuda", bh_offset: int = 0) -> torch.Tensor:
    """The uint32 bits that the attention kernels draw under `seed` from
    batch*head `bh_offset` on, row-major [batch_heads, S, Skv]: the kernel
    on a CUDA device, the plain version on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return dropout_bits_reference(seed, batch_heads, S, Skv, bh_offset=bh_offset)
    if device.type != "cuda":
        raise ValueError(f"export_dropout_bits: no kernel for device {device}")
    if not (0 < batch_heads <= 65535 and S > 0 and Skv > 0 and (S + 1) // 2 <= 65535):
        raise ValueError(f"unsupported sizes batch_heads={batch_heads}, S={S}, Skv={Skv}")
    out = torch.empty((batch_heads, S, Skv), dtype=torch.uint32, device=device)
    lo, hi = seed_words(seed)
    with torch.cuda.device(device):
        err = _library().gaot_dropout_bits(out.data_ptr(), batch_heads, S, Skv, lo, hi,
                                           bh_offset, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dropout_bits launch failed: cudaError {err}")
    export_dropout_bits.launches += 1
    return out


export_dropout_bits.launches = 0


def blocked_to_rowmajor(bits: torch.Tensor, S: int, Skv: int) -> torch.Tensor:
    """JAX-layout bits [BH, nq, nk, bq, bk] -> row-major [BH, S, Skv] (the
    padding of the last blocks is cut)."""
    BH, nq, nk, bq, bk = bits.shape
    dense = bits.view(torch.int32).permute(0, 1, 3, 2, 4).reshape(BH, nq * bq, nk * bk)
    return dense[:, :S, :Skv].contiguous().view(torch.uint32)


def rowmajor_to_blocked(bits: torch.Tensor, block_q: int, block_k: int) -> torch.Tensor:
    """Row-major bits [BH, S, Skv] -> the JAX layout [BH, nq, nk, bq, bk],
    the last blocks padded with zeros."""
    BH, S, Skv = bits.shape
    nq, nk = -(-S // block_q), -(-Skv // block_k)
    dense = torch.zeros((BH, nq * block_q, nk * block_k), dtype=torch.int32,
                        device=bits.device)
    dense[:, :S, :Skv] = bits.view(torch.int32)
    blocked = dense.reshape(BH, nq, block_q, nk, block_k).permute(0, 1, 3, 2, 4)
    return blocked.contiguous().view(torch.uint32)
