"""Inclusive prefix sum over rows (K7, `csrc/prefix_sum.cu`) with its plain
PyTorch version.

Replaces gaot3d_tpu/ops/pallas_kernels.py `prefix_sum` and `cumsum_fast`, the
cumsum inside the sorted segment folds (ops/segment.py `fold_sum`,
`fold_sum_sorted`) and `_sorted_fold`. The kernel's design and what bounds it
on an H100 are in its source.

- `prefix_sum(x)`: [E, C] float32 -> [E, C], out[r] = x[0] + ... + x[r]; the
  kernel for a CUDA tensor, `prefix_sum_reference` for a CPU tensor.
- `cumsum_fast(x)` is the folds' entry point. The JAX function of that name
  takes the Pallas kernel only above 32,768 rows on a TPU and falls back to
  `jnp.cumsum` when the kernel does not lower; here every call on the card is
  the kernel, and a failed launch raises.

The kernel adds in float32 in a fixed order (32 rows, then the groups' and the
blocks' totals), the plain version in float64, so the two agree to float32
rounding of the running sum, not bit for bit: compare relative to the largest
prefix of a column.
"""
from __future__ import annotations

import ctypes

import torch

from .build import load_cuda_library


def _library() -> ctypes.CDLL:
    lib = load_cuda_library("prefix_sum", "prefix_sum.cu")
    lib.gaot_prefix_sum.restype = ctypes.c_int
    lib.gaot_prefix_sum.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.gaot_prefix_sum_block_rows.restype = ctypes.c_int
    lib.gaot_prefix_sum_block_rows.argtypes = [ctypes.c_int]
    return lib


def prefix_sum_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of `prefix_sum`: the running sum is kept in float64 and
    rounded once, so its error does not grow with the number of rows."""
    return torch.cumsum(x.to(torch.float64), dim=0).to(torch.float32)


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over axis 0 of [E, C] float32."""
    if x.ndim != 2:
        raise ValueError(f"prefix_sum takes [E, C], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return prefix_sum_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"prefix_sum: no kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"prefix_sum takes float32, got {x.dtype}")
    E, C = x.shape
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if E == 0 or C == 0:
        return out
    x = x.contiguous()
    lib = _library()
    blocks = -(-E // lib.gaot_prefix_sum_block_rows(C))
    scratch = torch.empty((blocks, C), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.gaot_prefix_sum(x.data_ptr(), out.data_ptr(), scratch.data_ptr(), E, C,
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"prefix_sum launch failed: cudaError {err}")
    prefix_sum.launches += 1
    return out


prefix_sum.launches = 0


def cumsum_fast(x: torch.Tensor) -> torch.Tensor:
    """x [E, C] -> inclusive float32 cumsum along axis 0, through K7."""
    return prefix_sum(x.to(torch.float32))
