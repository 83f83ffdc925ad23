"""Elementwise-chain probe (T1, `csrc/elementwise_chain.cu`) with its plain
PyTorch version.

Replaces tools/microbench_vpu_bf16.py `make`: one chain (`exp`: acc =
exp(acc * 0.9) - acc, or `select`: acc = where(acc > 0.9, acc * 1.111,
acc + 0.9)) repeated `reps` times on a block of f32 or bf16, `copies` times
over, to time f32 against bf16 packed two to a register. The kernel's design
and its bounds on an H100 are in its source.

- `elementwise_chain(x, chain, reps, copies=1)`: the kernel for a CUDA
  tensor; `chain_plain` for a CPU tensor (every copy writes the same values,
  so the result is one copy's).
- `chain_plain(x, chain, reps)`: the plain version, `torch.exp` and
  `torch.where` in the tensor's own type with the constants rounded to it, so
  bf16 rounds after every operation as the TPU chain does.

The kernel's bf16 exponential is exp2 of a bf16 argument (the packed
special-function op), so in bf16 it agrees with the plain version to about a
bf16 step of the exponent times its size, not bit for bit; its f32
exponential is exp2f, within a few f32 steps.
"""
from __future__ import annotations

import ctypes

import torch

from .build import load_cuda_library

CHAINS = ("exp", "select")
REPS = (1, 2, 4, 8, 16, 32, 64, 128)  # the kernel unrolls each of these
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VEC = 8  # elements a thread


def _library() -> ctypes.CDLL:
    lib = load_cuda_library("elementwise_chain", "elementwise_chain.cu")
    lib.gaot_elementwise_chain.restype = ctypes.c_int
    lib.gaot_elementwise_chain.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                                           + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    return lib


def _check_chain(chain: str, reps: int) -> None:
    if chain not in CHAINS:
        raise ValueError(f"chain must be one of {CHAINS}, got {chain!r}")
    if reps not in REPS:
        raise ValueError(f"reps must be one of {REPS}, got {reps}")


def chain_plain(x: torch.Tensor, chain: str, reps: int) -> torch.Tensor:
    """The chain `reps` times in x's own type."""
    if chain not in CHAINS:
        raise ValueError(f"chain must be one of {CHAINS}, got {chain!r}")
    c = torch.tensor(0.9, dtype=x.dtype, device=x.device)
    s = torch.tensor(1.111, dtype=x.dtype, device=x.device)
    acc = x
    for _ in range(reps):
        if chain == "exp":
            acc = torch.exp(acc * c) - acc
        else:
            acc = torch.where(acc > c, acc * s, acc + c)
    return acc


def elementwise_chain(x: torch.Tensor, chain: str, reps: int, copies: int = 1) -> torch.Tensor:
    """The chain `reps` times on x (f32 or bf16, a multiple of 8 elements),
    the whole block redone `copies` times into one output."""
    _check_chain(chain, reps)
    if x.device.type == "cpu":
        return chain_plain(x, chain, reps)
    if x.device.type != "cuda":
        raise ValueError(f"elementwise_chain: no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"elementwise_chain takes {list(_DTYPES)}, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16 or x.numel() % _VEC or x.numel() == 0:
        raise ValueError("x must be contiguous, 16-byte aligned and a non-zero multiple of "
                         f"{_VEC} elements")
    if copies < 1:
        raise ValueError(f"copies must be at least 1, got {copies}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _library().gaot_elementwise_chain(
            x.data_ptr(), out.data_ptr(), x.numel(), _DTYPES[x.dtype], CHAINS.index(chain),
            reps, copies, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"elementwise_chain launch failed: cudaError {err}")
    elementwise_chain.launches += 1
    return out


elementwise_chain.launches = 0
