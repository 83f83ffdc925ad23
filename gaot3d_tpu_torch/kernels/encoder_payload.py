"""Fused encoder payload + scatter, forward (K5, `csrc/encoder_payload.cu`)
and backward (K5b, `csrc/encoder_payload_bwd.cu`), with their plain PyTorch
versions and the `torch.autograd.Function` that joins them.

Replaces gaot3d_tpu/ops/pallas_encoder.py `_payload_fwd_call` and
`_payload_bwd_call` (reached through `encoder_payload` and its custom VJP)
fused with the masked segment sum that consumed the payload
(models/fused_encoder.py `_pass_chunk` + `_reduce`) and that sum's gather
backward. The kernels' design notes, and what bounds them on an H100, are in
their sources.

The per-row payload is [ mlp([point | cell]) * feats | 1 | d | y | yy^T sym ]
with y = point - cell centre, d = |y| and the symmetric second moments in the
order 00, 01, 02, 11, 12, 22. Masked slots may carry any cell index; a valid
slot whose cell lies outside the grid is dropped, as XLA's scatter drops it.

- `encoder_accumulate` adds the payload of every valid row into acc
  [B, M, C+11]: the kernel for CUDA tensors, the twin for CPU tensors.
- `payload_rows` is the payload of given (point, cell) rows, and
  `encoder_payload_reference`, over [n, K] slots, is exactly the JAX
  `encoder_payload` output.
- `encoder_accumulate_reference` is that payload plus a masked `index_add_`.
- `encoder_accumulate_backward` gives (dfeats, dW, db) from the accumulator's
  cotangent: the kernel for CUDA tensors, for CPU tensors
  `encoder_accumulate_backward_reference`, which is autograd through the
  payload reference. Positions get no gradient, as in the JAX code.
- `accumulate` is the differentiable entry point. It adds into `acc` in
  place; the gradient with respect to `acc` is the identity. It packs the
  MLP once, in the forward, and hands the packed tensor to the backward.
- `launch_accumulate` and `launch_backward` are one launch each, on CUDA
  tensors the wrappers have checked and the MLP packed by `_pack_mlp`.

MLP weights are passed in torch layout (weight [out, in], bias [out]).

`kernel_dtype` picks the kernel MLP's arithmetic, as the JAX package's
`kernel_dtype` does (gaot3d_tpu/models/mlp.py `kernel_mlp_apply`):
'float32', or 'bfloat16', where each layer's input (the positions
[point | cell] included) and weight are rounded to bf16, to nearest even,
and their product has an f32 result; bias and GELU stay f32, and so do the
last layer's output and the rest of the payload. Each kernel has a body for
each (`csrc/encoder_payload.cu` and `encoder_payload_bf16.cu`, K5b's
likewise). Under 'bfloat16' the backward rounds where jax.grad does: d(in_l)
and dW_l to bf16, db and the cotangent never; dW once for each node chunk of
`chunk` nodes, summed over the chunks in f32. The plain versions get those
points from autograd through `kernel_mlp`; on the card K5b is launched once
a call and adds each chunk's f32 gradient into its own slice, and the
wrapper rounds and sums the slices (`sum_chunk_slices`).

The bf16 bodies take valid rows only, from a tile map that `tile_map` builds
on the device from the masks (no host sync): items of whole nodes of one
node chunk with at most TILE_ROWS valid rows each. The forward builds it
once and `accumulate` hands it to the backward.

`encoder_accumulate.launches` counts every K5 launch and
`encoder_accumulate.launches_bf16` those of the bf16 body; the same two
counts sit on `encoder_accumulate_backward` for K5b.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..edges import LatentGrid
from ..utils.scatter import segment_sum
from .build import load_cuda_library

SUPPORTED_WIDTHS = ((64, 32), (64, 16), (32, 32), (32, 16), (16, 16), (16, 8))  # (hidden, C)
MAX_SHARED_BYTES = 232448  # per-block shared memory limit of sm_90
KERNEL_DTYPES = ("float32", "bfloat16")


def check_kernel_dtype(kernel_dtype: str) -> str:
    if kernel_dtype not in KERNEL_DTYPES:
        raise ValueError(f"kernel_dtype must be one of {KERNEL_DTYPES}, got {kernel_dtype!r}")
    return kernel_dtype


def _built(name: str, kernel_dtype: str) -> str:
    """The library (and csrc/ source) of a kernel's body for kernel_dtype."""
    return f"{name}_bf16" if check_kernel_dtype(kernel_dtype) == "bfloat16" else name


# the bf16 bodies' extra arguments: the tile map (node_first, n_items, max_items) and chunk
_MAP_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2


def _library(kernel_dtype: str = "float32") -> ctypes.CDLL:
    name = _built("encoder_payload", kernel_dtype)
    lib = load_cuda_library(name, f"{name}.cu", ["encoder_tiles.cuh"])
    lib.gaot_encoder_accumulate.restype = ctypes.c_int
    lib.gaot_encoder_accumulate.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_float] * 6
        + (_MAP_ARGS if kernel_dtype == "bfloat16" else []) + [ctypes.c_void_p] * 2)
    lib.gaot_encoder_accumulate_smem.restype = ctypes.c_longlong
    lib.gaot_encoder_accumulate_smem.argtypes = [ctypes.c_int] * 3
    lib.gaot_encoder_accumulate_occupancy.restype = ctypes.c_int
    lib.gaot_encoder_accumulate_occupancy.argtypes = [ctypes.c_int] * 3
    return lib


def _backward_library(kernel_dtype: str = "float32") -> ctypes.CDLL:
    name = _built("encoder_payload_bwd", kernel_dtype)
    lib = load_cuda_library(name, f"{name}.cu", ["encoder_tiles.cuh"])
    lib.gaot_encoder_backward.restype = ctypes.c_int
    lib.gaot_encoder_backward.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_float] * 6
        + (_MAP_ARGS if kernel_dtype == "bfloat16" else []) + [ctypes.c_void_p] * 4)
    lib.gaot_encoder_backward_smem.restype = ctypes.c_longlong
    lib.gaot_encoder_backward_smem.argtypes = [ctypes.c_int] * 3
    lib.gaot_encoder_backward_occupancy.restype = ctypes.c_int
    lib.gaot_encoder_backward_occupancy.argtypes = [ctypes.c_int] * 3
    return lib


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even) and held in f32. Under autograd
    the gradient takes the same rounding on its way back."""
    return x.to(torch.bfloat16).to(torch.float32)


def kernel_mlp(x: torch.Tensor, weights: Sequence[torch.Tensor],
               biases: Sequence[torch.Tensor], kernel_dtype: str = "float32") -> torch.Tensor:
    """The kernel MLP on rows x [..., in]: dense layers in torch layout with
    exact GELU between them and none after the last. 'bfloat16' rounds each
    layer's input and weight to bf16 and takes their product with an f32
    result (the products of bf16 values are exact in f32), bias and GELU in
    f32. Through autograd, d(input) and dW come back rounded to bf16 (dW once
    a call) and db in f32, as from jax.grad of the JAX package's bf16 MLP."""
    bf16 = check_kernel_dtype(kernel_dtype) == "bfloat16"
    last = len(weights) - 1
    for i, (w, b) in enumerate(zip(weights, biases)):
        x = F.linear(round_bf16(x), round_bf16(w), b) if bf16 else F.linear(x, w, b)
        if i < last:
            x = F.gelu(x)
    return x


def payload_rows(pt: torch.Tensor, fe: torch.Tensor, idx: torch.Tensor,
                 weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                 grid: LatentGrid, kernel_dtype: str = "float32") -> torch.Tensor:
    """The payload of one edge per row: points pt [..., 3], their lifted
    features fe [..., C] and latent cells idx [...] -> [..., C+11]. Plain
    tensor code under autograd: the unfused encoder (sorted reductions, flat
    edge lists) computes its rows here."""
    cell = grid.positions_from_idx(idx, dtype=pt.dtype)
    x = kernel_mlp(torch.cat([pt, cell], dim=-1), weights, biases, kernel_dtype)
    return torch.cat([x * fe, moment_rows(pt, cell)], dim=-1)


def moment_rows(pt: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
    """The payload's 11 geometry columns [1 | d | y | yy^T sym] of points pt
    [..., 3] and their cell centres [..., 3]: [..., 11]."""
    y = pt - cell
    d = torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True))
    y0, y1, y2 = y[..., 0:1], y[..., 1:2], y[..., 2:3]
    return torch.cat([torch.ones_like(d), d, y,
                      y0 * y0, y0 * y1, y0 * y2, y1 * y1, y1 * y2, y2 * y2], dim=-1)


def encoder_payload_reference(pos: torch.Tensor, feats: torch.Tensor,
                              lat_idx: torch.Tensor, weights: Sequence[torch.Tensor],
                              biases: Sequence[torch.Tensor], grid: LatentGrid,
                              kernel_dtype: str = "float32") -> torch.Tensor:
    """pos [..., n, 3], feats [..., n, C], lat_idx [..., n, K] ->
    payload [..., n*K, C+11]."""
    *lead, n, K = lat_idx.shape
    C = feats.shape[-1]
    pt = pos[..., :, None, :].expand(*lead, n, K, 3)
    fe = feats[..., :, None, :].expand(*lead, n, K, C)
    return payload_rows(pt, fe, lat_idx, weights, biases, grid,
                        kernel_dtype).reshape(*lead, n * K, C + 11)


def encoder_accumulate_reference(pos, feats, lat_idx, mask, weights, biases,
                                 grid: LatentGrid, acc: torch.Tensor,
                                 chunk: Optional[int] = None,
                                 kernel_dtype: str = "float32") -> torch.Tensor:
    """Plain twin of `encoder_accumulate`: payload chunk by chunk (`chunk`
    nodes at a time bounds the [chunk*K, hidden] intermediates), each summed
    into acc with a masked index_add_. Returns acc, updated in place."""
    B, n, K = lat_idx.shape
    M = acc.shape[1]
    keep = mask & (lat_idx >= 0) & (lat_idx < M)  # out-of-grid cells are dropped
    step = n if chunk is None else chunk
    for c0 in range(0, n, step):
        c1 = min(c0 + step, n)
        payload = encoder_payload_reference(
            pos[:, c0:c1], feats[:, c0:c1], lat_idx[:, c0:c1], weights, biases, grid,
            kernel_dtype)
        for b in range(B):
            acc[b] += segment_sum(payload[b], lat_idx[b, c0:c1].reshape(-1), M,
                                  keep[b, c0:c1].reshape(-1))
    return acc


def encoder_accumulate_backward_reference(
        g: torch.Tensor, pos, feats, lat_idx, mask, weights, biases, grid: LatentGrid,
        chunk: Optional[int] = None, kernel_dtype: str = "float32"
) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """Plain version of `encoder_accumulate_backward`: autograd through the
    payload reference, `chunk` nodes at a time, each row's cotangent gathered
    from g [B, M, C+11] at its cell (zero for rows the forward skipped).

    Under 'bfloat16' that autograd keeps jax.grad's rounding points (see
    `kernel_mlp`): with d_l the f32 cotangent of layer l's output,
    d(in_l) = bf16(d_l W_bf16^T), then times gelu'(z) in f32;
    dW_l = bf16(sum over the chunk's rows of bf16(in_l)^T d_l), summed over
    the chunks in f32; db_l = sum of d_l in f32. The chunks are JAX's: all
    B samples of `chunk` nodes each."""
    B, n, K = lat_idx.shape
    M, P = g.shape[1], g.shape[2]
    keep = mask & (lat_idx >= 0) & (lat_idx < M)
    idx = torch.where(keep, lat_idx, torch.zeros_like(lat_idx)).long()
    ws = [w.detach().requires_grad_() for w in weights]
    bs = [b.detach().requires_grad_() for b in biases]
    dfeats = torch.zeros_like(feats)
    dws = [torch.zeros_like(w) for w in ws]
    dbs = [torch.zeros_like(b) for b in bs]
    step = n if chunk is None else chunk
    for c0 in range(0, n, step):
        c1 = min(c0 + step, n)
        f = feats[:, c0:c1].detach().requires_grad_()
        with torch.enable_grad():
            payload = encoder_payload_reference(pos[:, c0:c1], f, lat_idx[:, c0:c1], ws, bs,
                                                grid, kernel_dtype)
        rows = torch.gather(g, 1, idx[:, c0:c1].reshape(B, -1, 1).expand(B, (c1 - c0) * K, P))
        rows = rows * keep[:, c0:c1].reshape(B, -1, 1)
        grads = torch.autograd.grad(payload, [f, *ws, *bs], rows)
        dfeats[:, c0:c1] = grads[0]
        for acc_w, gw in zip(dws, grads[1:1 + len(ws)]):
            acc_w += gw
        for acc_b, gb in zip(dbs, grads[1 + len(ws):]):
            acc_b += gb
    return dfeats, dws, dbs


def _pack_mlp(weights, biases) -> torch.Tensor:
    """The kernels' parameter layout: per layer W [in][out] row-major, then b."""
    parts = []
    for w, b in zip(weights, biases):
        parts += [w.t().reshape(-1), b.reshape(-1)]
    return torch.cat(parts).to(torch.float32).contiguous()


def _unpack_mlp(packed: torch.Tensor, shapes):
    """Inverse of `_pack_mlp` for weights of torch shapes [(out, in), ...]:
    views of `packed` (the weights transposed views, not copies)."""
    ws, bs, off = [], [], 0
    for out, inp in shapes:
        ws.append(packed[off:off + inp * out].view(inp, out).t())
        off += inp * out
        bs.append(packed[off:off + out])
        off += out
    return ws, bs


TILE_ROWS = 128  # rows of a tile of the kernels (csrc/encoder_tiles.cuh R)


class TileMap(NamedTuple):
    """The valid-row tiles of one [B, n, K] mask (`tile_map`): item t holds
    the nodes node_first[t] up to node_first[t + 1] (flat indices b * n +
    node) for t < n_items[0]; both tensors lie on the mask's device."""
    node_first: torch.Tensor  # int32 [max_items + 1]
    n_items: torch.Tensor     # int32 [1]
    max_items: int            # a bound on n_items known without a sync
    chunk: int                # nodes a node chunk
    n_chunks: int             # node chunks a sample


def tile_map(mask: torch.Tensor, chunk: Optional[int] = None) -> TileMap:
    """The bf16 kernels' tiles of valid rows, by plain tensor operations on
    the mask's device, with no host sync. In node-major order (sample, node)
    the valid rows of each segment (one sample's node chunk of `chunk` nodes;
    the whole sample when None) are numbered from a start that is a multiple
    of S = TILE_ROWS - K + 1 (1 when K > TILE_ROWS), at least one window past
    the previous segment's last row; item t holds the nodes whose first row
    lies in [t * S, (t + 1) * S). An item so holds whole nodes of one segment
    and at most TILE_ROWS rows (when K > TILE_ROWS, at most one node with
    rows, whose rows take several passes). Masked slots take no row, wherever
    they lie among a node's slots."""
    B, n, K = mask.shape
    step = n if chunk is None else min(int(chunk), n)
    n_chunks = -(-n // step)
    S = TILE_ROWS - K + 1 if K <= TILE_ROWS else 1
    count = F.pad(mask.sum(-1, dtype=torch.int32), (0, n_chunks * step - n))
    count = count.view(B, n_chunks, step)
    within = torch.cumsum(count, -1, dtype=torch.int32) - count  # rows before, in the segment
    windows = (within[..., -1] + count[..., -1]) // S + 1  # [B, n_chunks]
    flat = windows.reshape(-1)
    before = torch.cumsum(flat, 0) - flat
    start = (before.view(B, n_chunks, 1).long() * S + within).reshape(B, -1)[:, :n]
    # a bound on the items without reading the counts: every row valid
    sizes = [step] * (n // step) + ([n % step] if n % step else [])
    max_items = B * sum(size * K // S + 1 for size in sizes)
    edges = torch.arange(max_items + 1, device=mask.device, dtype=torch.int64) * S
    node_first = torch.searchsorted(start.reshape(-1), edges).to(torch.int32)
    return TileMap(node_first, flat.sum().to(torch.int32).view(1), max_items, step, n_chunks)


def _weight_entries(shapes) -> List[Tuple[int, int]]:
    """[start, end) of each layer's weights in the packed layout of
    `_pack_mlp` for torch shapes [(out, in), ...] (the biases lie between)."""
    spans, off = [], 0
    for out, inp in shapes:
        spans.append((off, off + inp * out))
        off += inp * out + out
    return spans


def sum_chunk_slices(slices: torch.Tensor, shapes) -> torch.Tensor:
    """The bf16 backward's packed gradient from K5b's [n_chunks, P] f32
    slices: each chunk's weights rounded to bf16 (the biases not), then the
    chunks summed in f32 in order, as jax.grad sums its chunks."""
    is_weight = torch.zeros(slices.shape[1], dtype=torch.bool, device=slices.device)
    for a, b in _weight_entries(shapes):
        is_weight[a:b] = True
    rounded = torch.where(is_weight, round_bf16(slices), slices)
    total = rounded[0].clone()
    for part in rounded[1:]:
        total += part
    return total


def _check(pos, feats, lat_idx, mask, weights, biases, grid, acc, kernel_dtype="float32"):
    check_kernel_dtype(kernel_dtype)
    if pos.ndim != 3 or pos.shape[-1] != 3:
        raise ValueError(f"pos must be [B, n, 3], got {tuple(pos.shape)}")
    B, n, _ = pos.shape
    if lat_idx.ndim != 3 or lat_idx.shape[:2] != (B, n) or mask.shape != lat_idx.shape:
        raise ValueError("lat_idx and mask must be [B, n, K] matching pos")
    C = feats.shape[-1]
    if feats.shape != (B, n, C) or acc.shape != (B, grid.num_tokens, C + 11):
        raise ValueError(f"feats must be [B, n, C] and acc [B, {grid.num_tokens}, C+11]")
    for name, t, dt in (("pos", pos, torch.float32), ("feats", feats, torch.float32),
                        ("lat_idx", lat_idx, torch.int32), ("mask", mask, torch.bool),
                        ("acc", acc, torch.float32)):
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != pos.device:
            raise ValueError(f"{name} is on {t.device}, pos on {pos.device}")
    hid = weights[0].shape[0]
    shapes = [tuple(w.shape) for w in weights]
    want = [(hid, 6)] + [(hid, hid)] * (len(weights) - 2) + [(C, hid)]
    if len(weights) < 2 or shapes != want or [tuple(b.shape) for b in biases] != [
            (s[0],) for s in want]:
        raise ValueError(f"kernel MLP must be 6 -> {hid} ... -> {C}, got {shapes}")
    if (hid, C) not in SUPPORTED_WIDTHS:
        raise ValueError(f"kernel MLP widths (hidden {hid}, C {C}) not built; "
                         f"supported: {SUPPORTED_WIDTHS}")


def _map_args(kernel_dtype: str, tiles: Optional[TileMap]) -> list:
    if kernel_dtype != "bfloat16":
        return []
    if tiles is None:
        raise ValueError("the bf16 bodies need the tile map (`tile_map`)")
    return [tiles.node_first.data_ptr(), tiles.n_items.data_ptr(), tiles.max_items, tiles.chunk]


def launch_accumulate(pos: torch.Tensor, feats: torch.Tensor, lat_idx: torch.Tensor,
                      mask: torch.Tensor, params: torch.Tensor, n_mid: int, hid: int,
                      grid: LatentGrid, acc: torch.Tensor, kernel_dtype: str = "float32",
                      tiles: Optional[TileMap] = None) -> None:
    """K5 alone: one launch of the body for `kernel_dtype` on CUDA tensors
    that `_check` accepted, with the MLP packed by `_pack_mlp` (n_mid
    hidden-to-hidden layers of width hid); the bf16 body over `tiles`, the
    mask's `tile_map`."""
    B, n, K = lat_idx.shape
    C = feats.shape[-1]
    _, d1, d2 = grid.dims
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library(kernel_dtype).gaot_encoder_accumulate(
            pos.data_ptr(), feats.data_ptr(), lat_idx.data_ptr(), mask.data_ptr(),
            params.data_ptr(), params.numel(), n_mid, hid, C, B, n, K, grid.num_tokens, d1,
            d2, *grid.lo, *grid.spacing, *_map_args(kernel_dtype, tiles), acc.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"encoder_payload launch failed: cudaError {err}")
    encoder_accumulate.launches += 1
    encoder_accumulate.launches_bf16 += kernel_dtype == "bfloat16"


def launch_backward(g: torch.Tensor, pos: torch.Tensor, feats: torch.Tensor,
                    lat_idx: torch.Tensor, mask: torch.Tensor, params: torch.Tensor, n_mid: int,
                    hid: int, grid: LatentGrid, dfeats: torch.Tensor,
                    dparams: torch.Tensor, kernel_dtype: str = "float32",
                    tiles: Optional[TileMap] = None) -> None:
    """K5b alone: one launch of the body for `kernel_dtype`. The f32 body
    writes every row of dfeats and adds into dparams (packed like params,
    zeroed by the caller) in f32. The bf16 body, over `tiles`, writes the
    rows of nodes with a valid slot (the caller zeroes dfeats) and adds each
    node chunk's gradient into its row of dparams [tiles.n_chunks, P]."""
    B, n, K = lat_idx.shape
    C = feats.shape[-1]
    _, d1, d2 = grid.dims
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _backward_library(kernel_dtype).gaot_encoder_backward(
            pos.data_ptr(), feats.data_ptr(), lat_idx.data_ptr(), mask.data_ptr(),
            params.data_ptr(), params.numel(), n_mid, hid, C, B, n, K, grid.num_tokens, d1,
            d2, *grid.lo, *grid.spacing, *_map_args(kernel_dtype, tiles), g.data_ptr(),
            dfeats.data_ptr(), dparams.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"encoder_payload_bwd launch failed: cudaError {err}")
    encoder_accumulate_backward.launches += 1
    encoder_accumulate_backward.launches_bf16 += kernel_dtype == "bfloat16"


def _check_shared_memory(need: int, what: str, hid: int, C: int, n_mid: int) -> None:
    if need == 0:
        raise ValueError(f"{what} for kernel MLP widths (hidden {hid}, C {C}) with {n_mid} "
                         "hidden-to-hidden layers is not built")
    if need > MAX_SHARED_BYTES:
        raise ValueError(f"{what} needs {need} bytes of shared memory for this kernel MLP, "
                         f"more than the {MAX_SHARED_BYTES} a block has")


def encoder_accumulate(pos: torch.Tensor, feats: torch.Tensor, lat_idx: torch.Tensor,
                       mask: torch.Tensor, weights: Sequence[torch.Tensor],
                       biases: Sequence[torch.Tensor], grid: LatentGrid,
                       acc: torch.Tensor, chunk: Optional[int] = None, *,
                       params: Optional[torch.Tensor] = None,
                       kernel_dtype: str = "float32",
                       tiles: Optional[TileMap] = None) -> torch.Tensor:
    """Add the payload of every valid (node, slot) row into acc[b, cell]:
    pos [B,n,3], feats [B,n,C], lat_idx/mask [B,n,K], acc [B,M,C+11]
    (updated in place and returned). `chunk` only bounds the twin's memory;
    `params`, the MLP already packed by `_pack_mlp`, and `tiles`, the mask's
    `tile_map` (the bf16 body), save building them again."""
    if pos.device.type == "cpu":
        return encoder_accumulate_reference(pos, feats, lat_idx, mask, weights,
                                            biases, grid, acc, chunk, kernel_dtype)
    if pos.device.type != "cuda":
        raise ValueError(f"encoder_accumulate: no kernel for device {pos.device}")
    _check(pos, feats, lat_idx, mask, weights, biases, grid, acc, kernel_dtype)
    hid, C, n_mid = weights[0].shape[0], feats.shape[-1], len(weights) - 2
    _check_shared_memory(_library(kernel_dtype).gaot_encoder_accumulate_smem(n_mid, hid, C),
                         "the forward", hid, C, n_mid)
    if params is None:
        params = _pack_mlp(weights, biases)
    if kernel_dtype == "bfloat16" and tiles is None:
        tiles = tile_map(mask, chunk)
    launch_accumulate(pos, feats, lat_idx, mask, params, n_mid, hid, grid, acc, kernel_dtype,
                      tiles)
    return acc


encoder_accumulate.launches = 0
encoder_accumulate.launches_bf16 = 0


def encoder_accumulate_backward(
        g: torch.Tensor, pos: torch.Tensor, feats: torch.Tensor, lat_idx: torch.Tensor,
        mask: torch.Tensor, weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
        grid: LatentGrid, chunk: Optional[int] = None, *,
        params: Optional[torch.Tensor] = None, kernel_dtype: str = "float32",
        tiles: Optional[TileMap] = None
) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """Gradients of `encoder_accumulate` given the accumulator's cotangent g
    [B, M, C+11]: (dfeats [B,n,C], dW per layer in torch layout, db per
    layer; on CUDA, views of one packed gradient). `params` and `tiles` as
    for `encoder_accumulate`. Under 'float32' `chunk` only bounds the plain
    version's memory; under 'bfloat16' dW is rounded once a chunk of `chunk`
    nodes: K5b's one launch keeps a slice for each chunk."""
    if pos.device.type == "cpu":
        return encoder_accumulate_backward_reference(g, pos, feats, lat_idx, mask, weights,
                                                     biases, grid, chunk, kernel_dtype)
    if pos.device.type != "cuda":
        raise ValueError(f"encoder_accumulate_backward: no kernel for device {pos.device}")
    _check(pos, feats, lat_idx, mask, weights, biases, grid, g, kernel_dtype)
    hid, C, n_mid = weights[0].shape[0], feats.shape[-1], len(weights) - 2
    _check_shared_memory(
        _backward_library(kernel_dtype).gaot_encoder_backward_smem(n_mid, hid, C),
        "the backward", hid, C, n_mid)
    if params is None:
        params = _pack_mlp(weights, biases)
    shapes = [tuple(w.shape) for w in weights]
    if kernel_dtype == "bfloat16":
        if tiles is None:
            tiles = tile_map(mask, chunk)
        dfeats = torch.zeros_like(feats)  # nodes without a valid slot are not written
        slices = torch.zeros((tiles.n_chunks, params.numel()), device=params.device)
        launch_backward(g, pos, feats, lat_idx, mask, params, n_mid, hid, grid, dfeats, slices,
                        kernel_dtype, tiles)
        dparams = sum_chunk_slices(slices, shapes)
    else:
        dfeats = torch.empty_like(feats)  # the kernel writes every node
        dparams = torch.zeros_like(params)
        launch_backward(g, pos, feats, lat_idx, mask, params, n_mid, hid, grid, dfeats,
                        dparams)
    dws, dbs = _unpack_mlp(dparams, shapes)
    return dfeats, dws, dbs


encoder_accumulate_backward.launches = 0
encoder_accumulate_backward.launches_bf16 = 0


class _EncoderAccumulate(torch.autograd.Function):
    """K5 forward, K5b backward. `acc` is updated in place and returned; its
    gradient is the identity, so one accumulator can be threaded through the
    degree sections. On CUDA the MLP is packed once, in the forward, and the
    packed tensor (and the bf16 bodies' tile map) kept for the backward."""

    @staticmethod
    def forward(ctx, acc, pos, feats, lat_idx, mask, grid, chunk, kernel_dtype, *mlp):
        n_layers = len(mlp) // 2
        weights = [w.detach() for w in mlp[:n_layers]]
        biases = [b.detach() for b in mlp[n_layers:]]
        cuda = pos.device.type == "cuda"
        params = _pack_mlp(weights, biases) if cuda else None
        tiles = tile_map(mask, chunk) if cuda and kernel_dtype == "bfloat16" else None
        encoder_accumulate(pos, feats, lat_idx, mask, weights, biases, grid, acc, chunk,
                           params=params, kernel_dtype=kernel_dtype, tiles=tiles)
        ctx.mark_dirty(acc)
        ctx.save_for_backward(pos, feats, lat_idx, mask, params, *mlp)
        ctx.static = (grid, chunk, kernel_dtype, n_layers, tiles)
        return acc

    @staticmethod
    def backward(ctx, g):
        pos, feats, lat_idx, mask, params, *mlp = ctx.saved_tensors
        grid, chunk, kernel_dtype, n_layers, tiles = ctx.static
        dfeats, dws, dbs = encoder_accumulate_backward(
            g.contiguous(), pos, feats, lat_idx, mask, [w.detach() for w in mlp[:n_layers]],
            [b.detach() for b in mlp[n_layers:]], grid, chunk, params=params,
            kernel_dtype=kernel_dtype, tiles=tiles)
        return (g, None, dfeats, None, None, None, None, None, *dws, *dbs)


def accumulate(pos: torch.Tensor, feats: torch.Tensor, lat_idx: torch.Tensor,
               mask: torch.Tensor, weights: Sequence[torch.Tensor],
               biases: Sequence[torch.Tensor], grid: LatentGrid, acc: torch.Tensor,
               chunk: Optional[int] = None, kernel_dtype: str = "float32") -> torch.Tensor:
    """Differentiable `encoder_accumulate` (with respect to feats, weights,
    biases and acc): adds into `acc` in place and returns it. Under
    'bfloat16', `chunk` is JAX's node chunk, at whose boundaries dW is
    rounded."""
    return _EncoderAccumulate.apply(acc, pos, feats, lat_idx, mask, grid, chunk, kernel_dtype,
                                    *weights, *biases)
