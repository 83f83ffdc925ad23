"""Inclusive prefix sum over rows (K7, `csrc/prefix_sum.cu`) with its plain
PyTorch version and its ordered twin.

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

The kernel adds in float32 in a fixed order that depends on E and C only:
each column of a tile of `tile_rows(C)` rows in row order, then a tree over
the tiles' totals in groups of SCAN_RADIX (the kernel takes both as
arguments). `prefix_sum_ordered_reference` repeats those additions with
plain torch ops and gives the kernel's bits. The plain version sums in
float64, so it agrees with the kernel to float32 rounding of the running
sum, not bit for bit: compare relative to the largest prefix of a column.
"""
from __future__ import annotations

import ctypes

import torch

from .build import load_cuda_library

# the kernel a call launches, by the name a profiler shows
DEVICE_KERNELS = ("prefix_sum_kernel",)

SCAN_RADIX = 32  # items of a group at every level of the tree: the kernel's warp width
BLOCK_FLOATS = 22_528  # floats of x a CTA holds at once (a group of SCAN_RADIX tiles), about

# scratch (the tree's totals, each beside its epoch) and the last epoch, per (device, stream)
_scratch: dict = {}


def tile_rows(C: int) -> int:
    """Rows of a tile, over which each column is summed in row order: a
    multiple of 4, so that a group of tiles of 43-float rows starts on a
    16-byte boundary, and sized so that a group holds about BLOCK_FLOATS."""
    return max(4, BLOCK_FLOATS // (SCAN_RADIX * C) // 4 * 4)


def _library() -> ctypes.CDLL:
    lib = load_cuda_library("prefix_sum", "prefix_sum.cu", headers=["hopper.cuh"])
    lib.gaot_prefix_sum.restype = ctypes.c_int
    lib.gaot_prefix_sum.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                                    + [ctypes.c_int] * 3 + [ctypes.c_uint, ctypes.c_void_p])
    lib.gaot_prefix_sum_scratch_bytes.restype = ctypes.c_longlong
    lib.gaot_prefix_sum_scratch_bytes.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    lib.gaot_prefix_sum_ctas_per_sm.restype = ctypes.c_int
    lib.gaot_prefix_sum_ctas_per_sm.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    return lib


def prefix_sum_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of `prefix_sum`: the running sum is kept in float64 and
    rounded once, so its error does not grow with the number of rows."""
    return torch.cumsum(x.to(torch.float64), dim=0).to(torch.float32)


def _scan_groups(items: torch.Tensor) -> tuple:
    """Inclusive Hillis-Steele scan of [n, C] in groups of SCAN_RADIX (lane l
    adds lane l - d for d = 1, 2, 4, ...): (the scan [groups, SCAN_RADIX, C],
    the exclusive scan [n, C] with 0 at each group's first item)."""
    n, C = items.shape
    groups = -(-n // SCAN_RADIX)
    v = torch.zeros((groups * SCAN_RADIX, C), dtype=torch.float32, device=items.device)
    v[:n] = items
    v = v.view(groups, SCAN_RADIX, C)
    d = 1
    while d < SCAN_RADIX:
        v = torch.cat([v[:, :d], v[:, d:] + v[:, :-d]], dim=1)
        d *= 2
    excl = torch.cat([torch.zeros_like(v[:, :1]), v[:, :-1]], dim=1).reshape(-1, C)[:n]
    return v, excl


def prefix_sum_ordered_reference(x: torch.Tensor) -> torch.Tensor:
    """`prefix_sum` by the kernel's own association, in float32 additions:
    each column of each tile of `tile_rows(C)` rows in row order, then the
    tree over the tiles' totals; an item's offset is its parent's plus the
    scan of the items before it in its group. The same bits as the kernel."""
    if x.ndim != 2:
        raise ValueError(f"prefix_sum takes [E, C], got {tuple(x.shape)}")
    E, C = x.shape
    if E == 0 or C == 0:
        return torch.zeros((E, C), dtype=torch.float32, device=x.device)
    R = tile_rows(C)
    tiles = -(-E // R)
    xt = torch.zeros((tiles * R, C), dtype=torch.float32, device=x.device)
    xt[:E] = x
    xt = xt.view(tiles, R, C)
    runs = [xt[:, 0]]
    for i in range(1, R):
        runs.append(runs[-1] + xt[:, i])
    runs = torch.stack(runs, dim=1)
    excls, items = [], runs[:, -1]
    while True:
        scan, excl = _scan_groups(items)
        excls.append(excl)
        if scan.shape[0] == 1:
            break
        items = scan[:, -1]
    offset = torch.zeros((1, C), dtype=torch.float32, device=x.device)
    for excl in reversed(excls):
        offset = offset.repeat_interleave(SCAN_RADIX, dim=0)[:excl.shape[0]] + excl
    return (offset[:, None, :] + runs).reshape(-1, C)[:E]


def _scratch_and_epoch(device: torch.device, stream: int, nbytes: int):
    """The scratch of this device and stream, grown (and zeroed) to `nbytes`,
    and the launch's epoch: one more than the last, never 0."""
    key = (device.index, stream)
    entry = _scratch.get(key)
    if entry is None or entry[0].numel() < nbytes:
        entry = _scratch[key] = [torch.zeros(max(nbytes, 16), dtype=torch.uint8, device=device),
                                 0 if entry is None else entry[1]]
    entry[1] = entry[1] % 0xFFFFFFFF + 1
    return entry[0], entry[1]


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
    R = tile_rows(C)
    nbytes = lib.gaot_prefix_sum_scratch_bytes(E, C, R)
    if nbytes < 0:
        raise ValueError(f"prefix_sum: no kernel for [{E}, {C}]")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        scratch, epoch = _scratch_and_epoch(x.device, stream, nbytes)
        err = lib.gaot_prefix_sum(x.data_ptr(), out.data_ptr(), scratch.data_ptr(), E, C, R,
                                  SCAN_RADIX, epoch, stream)
    if err != 0:
        raise RuntimeError(f"prefix_sum launch failed: cudaError {err}")
    prefix_sum.launches += 1
    return out


prefix_sum.launches = 0


def cumsum_fast(x: torch.Tensor) -> torch.Tensor:
    """x [E, C] -> inclusive float32 cumsum along axis 0, through K7."""
    return prefix_sum(x.to(torch.float32))
