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
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops.grid_graph import LatentGrid
from ..ops.segment import segment_sum
from .build import load_cuda_library

SUPPORTED_WIDTHS = ((64, 32), (64, 16), (32, 32), (32, 16), (16, 16), (16, 8))  # (hidden, C)
MAX_SHARED_BYTES = 232448  # per-block shared memory limit of sm_90


def _library() -> ctypes.CDLL:
    lib = load_cuda_library("encoder_payload", "encoder_payload.cu", ["encoder_tiles.cuh"])
    lib.gaot_encoder_accumulate.restype = ctypes.c_int
    lib.gaot_encoder_accumulate.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_float] * 6
        + [ctypes.c_void_p] * 2)
    lib.gaot_encoder_accumulate_smem.restype = ctypes.c_longlong
    lib.gaot_encoder_accumulate_smem.argtypes = [ctypes.c_int] * 3
    lib.gaot_encoder_accumulate_occupancy.restype = ctypes.c_int
    lib.gaot_encoder_accumulate_occupancy.argtypes = [ctypes.c_int] * 3
    return lib


def _backward_library() -> ctypes.CDLL:
    lib = load_cuda_library("encoder_payload_bwd", "encoder_payload_bwd.cu",
                            ["encoder_tiles.cuh"])
    lib.gaot_encoder_backward.restype = ctypes.c_int
    lib.gaot_encoder_backward.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_float] * 6
        + [ctypes.c_void_p] * 4)
    lib.gaot_encoder_backward_smem.restype = ctypes.c_longlong
    lib.gaot_encoder_backward_smem.argtypes = [ctypes.c_int] * 3
    lib.gaot_encoder_backward_occupancy.restype = ctypes.c_int
    lib.gaot_encoder_backward_occupancy.argtypes = [ctypes.c_int] * 3
    return lib


def payload_rows(pt: torch.Tensor, fe: torch.Tensor, idx: torch.Tensor,
                 weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                 grid: LatentGrid) -> torch.Tensor:
    """The payload of one edge per row: points pt [..., 3], their lifted
    features fe [..., C] and latent cells idx [...] -> [..., C+11]. Plain
    tensor code under autograd: the unfused encoder (sorted reductions, flat
    edge lists) computes its rows here."""
    cell = grid.positions_from_idx(idx, dtype=pt.dtype)
    y = pt - cell
    d = torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True))
    x = torch.cat([pt, cell], dim=-1)
    for i, (w, b) in enumerate(zip(weights, biases)):
        x = F.linear(x, w, b)
        if i < len(weights) - 1:
            x = F.gelu(x)
    y0, y1, y2 = y[..., 0:1], y[..., 1:2], y[..., 2:3]
    return torch.cat([x * fe, torch.ones_like(d), d, y,
                      y0 * y0, y0 * y1, y0 * y2, y1 * y1, y1 * y2, y2 * y2], dim=-1)


def encoder_payload_reference(pos: torch.Tensor, feats: torch.Tensor,
                              lat_idx: torch.Tensor, weights: Sequence[torch.Tensor],
                              biases: Sequence[torch.Tensor],
                              grid: LatentGrid) -> torch.Tensor:
    """pos [..., n, 3], feats [..., n, C], lat_idx [..., n, K] ->
    payload [..., n*K, C+11]."""
    *lead, n, K = lat_idx.shape
    C = feats.shape[-1]
    pt = pos[..., :, None, :].expand(*lead, n, K, 3)
    fe = feats[..., :, None, :].expand(*lead, n, K, C)
    return payload_rows(pt, fe, lat_idx, weights, biases, grid).reshape(*lead, n * K, C + 11)


def encoder_accumulate_reference(pos, feats, lat_idx, mask, weights, biases,
                                 grid: LatentGrid, acc: torch.Tensor,
                                 chunk: Optional[int] = None) -> torch.Tensor:
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
            pos[:, c0:c1], feats[:, c0:c1], lat_idx[:, c0:c1], weights, biases, grid)
        for b in range(B):
            acc[b] += segment_sum(payload[b], lat_idx[b, c0:c1].reshape(-1), M,
                                  keep[b, c0:c1].reshape(-1))
    return acc


def encoder_accumulate_backward_reference(
        g: torch.Tensor, pos, feats, lat_idx, mask, weights, biases, grid: LatentGrid,
        chunk: Optional[int] = None
) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """Plain version of `encoder_accumulate_backward`: autograd through the
    payload reference, `chunk` nodes at a time, each row's cotangent gathered
    from g [B, M, C+11] at its cell (zero for rows the forward skipped)."""
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
                                                grid)
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


def _check(pos, feats, lat_idx, mask, weights, biases, grid, acc):
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


def launch_accumulate(pos: torch.Tensor, feats: torch.Tensor, lat_idx: torch.Tensor,
                      mask: torch.Tensor, params: torch.Tensor, n_mid: int, hid: int,
                      grid: LatentGrid, acc: torch.Tensor) -> None:
    """K5 alone: one launch on CUDA tensors that `_check` accepted, with the
    MLP packed by `_pack_mlp` (n_mid hidden-to-hidden layers of width hid)."""
    B, n, K = lat_idx.shape
    C = feats.shape[-1]
    _, d1, d2 = grid.dims
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().gaot_encoder_accumulate(
            pos.data_ptr(), feats.data_ptr(), lat_idx.data_ptr(), mask.data_ptr(),
            params.data_ptr(), params.numel(), n_mid, hid, C, B, n, K, grid.num_tokens, d1,
            d2, *grid.lo, *grid.spacing, acc.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"encoder_payload launch failed: cudaError {err}")
    encoder_accumulate.launches += 1


def launch_backward(g: torch.Tensor, pos: torch.Tensor, feats: torch.Tensor,
                    lat_idx: torch.Tensor, mask: torch.Tensor, params: torch.Tensor, n_mid: int,
                    hid: int, grid: LatentGrid, dfeats: torch.Tensor,
                    dparams: torch.Tensor) -> None:
    """K5b alone: one launch that writes every row of dfeats and adds into
    dparams (packed like params, zeroed by the caller)."""
    B, n, K = lat_idx.shape
    C = feats.shape[-1]
    _, d1, d2 = grid.dims
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _backward_library().gaot_encoder_backward(
            pos.data_ptr(), feats.data_ptr(), lat_idx.data_ptr(), mask.data_ptr(),
            params.data_ptr(), params.numel(), n_mid, hid, C, B, n, K, grid.num_tokens, d1,
            d2, *grid.lo, *grid.spacing, g.data_ptr(), dfeats.data_ptr(), dparams.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"encoder_payload_bwd launch failed: cudaError {err}")
    encoder_accumulate_backward.launches += 1


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
                       params: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Add the payload of every valid (node, slot) row into acc[b, cell]:
    pos [B,n,3], feats [B,n,C], lat_idx/mask [B,n,K], acc [B,M,C+11]
    (updated in place and returned). `chunk` only bounds the twin's memory;
    `params`, the MLP already packed by `_pack_mlp`, saves packing it again."""
    if pos.device.type == "cpu":
        return encoder_accumulate_reference(pos, feats, lat_idx, mask, weights,
                                            biases, grid, acc, chunk)
    if pos.device.type != "cuda":
        raise ValueError(f"encoder_accumulate: no kernel for device {pos.device}")
    _check(pos, feats, lat_idx, mask, weights, biases, grid, acc)
    hid, C, n_mid = weights[0].shape[0], feats.shape[-1], len(weights) - 2
    _check_shared_memory(_library().gaot_encoder_accumulate_smem(n_mid, hid, C),
                         "the forward", hid, C, n_mid)
    if params is None:
        params = _pack_mlp(weights, biases)
    launch_accumulate(pos, feats, lat_idx, mask, params, n_mid, hid, grid, acc)
    return acc


encoder_accumulate.launches = 0


def encoder_accumulate_backward(
        g: torch.Tensor, pos: torch.Tensor, feats: torch.Tensor, lat_idx: torch.Tensor,
        mask: torch.Tensor, weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
        grid: LatentGrid, chunk: Optional[int] = None, *,
        params: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """Gradients of `encoder_accumulate` given the accumulator's cotangent g
    [B, M, C+11]: (dfeats [B,n,C], dW per layer in torch layout, db per
    layer; on CUDA, views of one packed gradient). `chunk` only bounds the
    plain version's memory; `params` as for `encoder_accumulate`."""
    if pos.device.type == "cpu":
        return encoder_accumulate_backward_reference(g, pos, feats, lat_idx, mask, weights,
                                                     biases, grid, chunk)
    if pos.device.type != "cuda":
        raise ValueError(f"encoder_accumulate_backward: no kernel for device {pos.device}")
    _check(pos, feats, lat_idx, mask, weights, biases, grid, g)
    hid, C, n_mid = weights[0].shape[0], feats.shape[-1], len(weights) - 2
    _check_shared_memory(_backward_library().gaot_encoder_backward_smem(n_mid, hid, C),
                         "the backward", hid, C, n_mid)
    if params is None:
        params = _pack_mlp(weights, biases)
    dfeats = torch.empty_like(feats)  # the kernel writes every node
    dparams = torch.zeros_like(params)
    launch_backward(g, pos, feats, lat_idx, mask, params, n_mid, hid, grid, dfeats, dparams)
    dws, dbs = _unpack_mlp(dparams, [tuple(w.shape) for w in weights])
    return dfeats, dws, dbs


encoder_accumulate_backward.launches = 0


class _EncoderAccumulate(torch.autograd.Function):
    """K5 forward, K5b backward. `acc` is updated in place and returned; its
    gradient is the identity, so one accumulator can be threaded through the
    degree sections. On CUDA the MLP is packed once, in the forward, and the
    packed tensor is saved for the backward."""

    @staticmethod
    def forward(ctx, acc, pos, feats, lat_idx, mask, grid, chunk, *mlp):
        n_layers = len(mlp) // 2
        weights = [w.detach() for w in mlp[:n_layers]]
        biases = [b.detach() for b in mlp[n_layers:]]
        params = _pack_mlp(weights, biases) if pos.device.type == "cuda" else None
        encoder_accumulate(pos, feats, lat_idx, mask, weights, biases, grid, acc, chunk,
                           params=params)
        ctx.mark_dirty(acc)
        ctx.save_for_backward(pos, feats, lat_idx, mask, params, *mlp)
        ctx.static = (grid, chunk, n_layers)
        return acc

    @staticmethod
    def backward(ctx, g):
        pos, feats, lat_idx, mask, params, *mlp = ctx.saved_tensors
        grid, chunk, n_layers = ctx.static
        dfeats, dws, dbs = encoder_accumulate_backward(
            g.contiguous(), pos, feats, lat_idx, mask, [w.detach() for w in mlp[:n_layers]],
            [b.detach() for b in mlp[n_layers:]], grid, chunk, params=params)
        return (g, None, dfeats, None, None, None, None, *dws, *dbs)


def accumulate(pos: torch.Tensor, feats: torch.Tensor, lat_idx: torch.Tensor,
               mask: torch.Tensor, weights: Sequence[torch.Tensor],
               biases: Sequence[torch.Tensor], grid: LatentGrid, acc: torch.Tensor,
               chunk: Optional[int] = None) -> torch.Tensor:
    """Differentiable `encoder_accumulate` (with respect to feats, weights,
    biases and acc): adds into `acc` in place and returns it."""
    return _EncoderAccumulate.apply(acc, pos, feats, lat_idx, mask, grid, chunk, *weights,
                                    *biases)
