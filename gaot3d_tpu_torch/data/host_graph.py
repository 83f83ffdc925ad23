"""Host-side edge-slot building, degree sectioning and flattening, in numpy
(port of the host-side functions of gaot3d_tpu/ops/grid_graph.py:
`compact_slots_np`, `build_edge_slots_host`,
`section_slots_by_degree_np`, `section_slots_shared`, `flatten_slots_host`,
`flatten_slots_host_batched`).

The stencil search and the flattening run in the native
`native/gaot_graph.cpp`, compiled with g++ at first use into
`.build/gaot3d_tpu_torch/`. A failed build raises: there is no numpy fallback,
so the edges a server sees are always the ones the native code makes.
"""
from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..kernels.build import REPO_ROOT, load_library
from ..ops.grid_graph import (DECODER_STRATEGIES, FlatEdgeChunks, LatentGrid,
                              SectionedEdgeSlots, stencil_widths)

_GRAPH_SRC = os.path.join(REPO_ROOT, "native", "gaot_graph.cpp")


def _graph_library() -> ctypes.CDLL:
    lib = load_library(
        "gaot_graph", [_GRAPH_SRC],
        lambda out: ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                     "-std=c++17", "-o", out, _GRAPH_SRC, "-lpthread"])
    lib.gaot_build_slots.restype = ctypes.c_int
    lib.gaot_build_slots.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,                       # pts, n
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,     # lo, h, dims
        ctypes.c_float, ctypes.c_int, ctypes.c_int,            # radius, k, flags
        ctypes.c_int, ctypes.c_int, ctypes.c_int,              # w0..w2
        ctypes.c_int,                                          # budget
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,        # out idx/mask/k
        ctypes.c_int,                                          # n_threads
    ]
    lib.gaot_flatten_slots.restype = ctypes.c_int64
    lib.gaot_flatten_slots.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,                      # lat_idx, mask
        ctypes.c_int64, ctypes.c_int,                          # n, k
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int,          # chunk, E, order
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,     # src, dst, mask
        ctypes.c_int,                                          # n_threads
    ]
    return lib


def compact_slots_np(lat_idx: np.ndarray, mask: np.ndarray, budget: int):
    """Pack valid slots to the front of each row (window order kept) and
    truncate to `budget` columns."""
    N, _ = mask.shape
    order = np.argsort(~mask, axis=1, kind="stable")[:, :budget]
    rows = np.arange(N)[:, None]
    return lat_idx[rows, order].astype(np.int32), mask[rows, order]


def build_edge_slots_host(points: np.ndarray, grid: LatentGrid, radius: float,
                          k_neighbors: int = 1, strategy: str = "radius",
                          budget: int = 0, n_threads: int = 0):
    """Stencil edge slots of one point cloud [N, 3] -> (lat_idx [N, K] int32,
    mask [N, K] bool). budget > 0 packs valid slots to the front and keeps
    `budget` columns; a row with more valid slots than that loses the excess,
    so callers size the budget to the max degree."""
    if strategy not in DECODER_STRATEGIES:
        raise ValueError(f"unknown neighbor strategy: {strategy}")
    eff = "bidirectional" if strategy == "reverse" else strategy
    lib = _graph_library()
    widths = stencil_widths(grid, radius, k_neighbors, eff)
    pts = np.ascontiguousarray(points, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points must be [N, 3], got {pts.shape}")
    N = pts.shape[0]
    K = widths[0] * widths[1] * widths[2]
    compact = bool(budget) and budget < K
    out_k = budget if compact else K
    lo = np.asarray(grid.lo, np.float32)
    h = np.asarray(grid.spacing, np.float32)
    dims = np.asarray(grid.dims, np.int64)
    flags = {"radius": 1, "knn": 2, "bidirectional": 3}[eff]
    out_idx = np.empty((N, out_k), np.int32)
    out_mask = np.empty((N, out_k), np.uint8)
    if n_threads <= 0:
        n_threads = max(1, os.cpu_count() or 1)
    rc = lib.gaot_build_slots(
        pts.ctypes.data_as(ctypes.c_void_p), N,
        lo.ctypes.data_as(ctypes.c_void_p), h.ctypes.data_as(ctypes.c_void_p),
        dims.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_float(radius), k_neighbors, flags,
        widths[0], widths[1], widths[2],
        out_k if compact else 0,
        out_idx.ctypes.data_as(ctypes.c_void_p),
        out_mask.ctypes.data_as(ctypes.c_void_p), out_k, n_threads,
    )
    if rc != 0:
        raise RuntimeError(f"gaot_build_slots failed rc={rc}")
    return out_idx, out_mask.astype(bool)


def section_slots_by_degree_np(lat_idx: np.ndarray, mask: np.ndarray,
                               chunk: int) -> Tuple[np.ndarray, List[Tuple[np.ndarray, np.ndarray]]]:
    """[N, K] valid-first slots -> (perm [N], [(lat [Ns, Ks], msk), ...]).

    Nodes are sorted ascending by degree (stable); each `chunk`-node group
    gets K = its max degree (at least 1), and neighbouring groups with equal K
    merge into one section. Apply `perm` to the point arrays: the model's
    outputs then come back in that permuted node order."""
    N, _ = mask.shape
    if N % chunk != 0:
        raise ValueError(f"chunk {chunk} must divide N {N}")
    deg = mask.sum(axis=1)
    perm = np.argsort(deg, kind="stable").astype(np.int64)
    lat_p, msk_p, deg_p = lat_idx[perm], mask[perm], deg[perm]
    nc = N // chunk
    ks = np.maximum(deg_p.reshape(nc, chunk).max(axis=1), 1).astype(np.int64)
    sections = []
    i = 0
    while i < nc:
        j = i
        while j < nc and ks[j] == ks[i]:
            j += 1
        ksec = int(ks[i])
        lo, hi = i * chunk, j * chunk
        if bool(msk_p[lo:hi, ksec:].any()):
            raise ValueError(
                "slots are not valid-first packed: a row has a valid slot "
                f"beyond its section width K={ksec} (compact first)")
        sections.append((np.ascontiguousarray(lat_p[lo:hi, :ksec]),
                         np.ascontiguousarray(msk_p[lo:hi, :ksec])))
        i = j
    return perm, sections


def section_slots_shared(pairs: Sequence[Tuple[np.ndarray, np.ndarray]], chunk: int,
                         node_mask: Optional[np.ndarray] = None,
                         profile: Optional[Sequence[int]] = None, shards: int = 1,
                         device=None) -> Tuple[np.ndarray, List[SectionedEdgeSlots]]:
    """Batched degree sectioning with ONE shared node permutation a sample.

    pairs: (lat_idx [B, N, K], mask [B, N, K]) numpy arrays that ride the same
    permutation (the encoder and decoder slots of one batch). Returns (perms
    [B, N] int64, one SectionedEdgeSlots a pair on `device`, all sharing one
    section structure).

    - Each sample gets its own permutation (apply perms[b] to its pos, feats,
      targets and mask), ascending by the degree COMBINED over the pairs;
      padded nodes (`node_mask` false) sort last, so the valid nodes stay a
      prefix.
    - Section boundaries and widths are shared across the batch and the
      pairs: per chunk, K = the max degree over all samples and pairs.
      `profile` (one K per chunk) pins the structure; it must cover the
      observed degrees or the call raises, since edges would be dropped.
    - Pairs that are the same two objects give the same SectionedEdgeSlots
      object, so aliased directions stay one set of tensors downstream.
    - shards=S > 1 builds the shard-aligned layout of node sharding (see
      `SectionedEdgeSlots`): the degree-sorted nodes are dealt round-robin to
      S equal shard ranges (sorted position j to shard j % S, local row
      j // S), the per-chunk K profile (one K per chunk of a shard, N/S/chunk
      of them) is the max over the shards, and each section comes out
      shard-major, [B, S * ns_i, K_i]."""
    B, N, _ = pairs[0][1].shape
    if N % (chunk * shards) != 0:
        raise ValueError(f"chunk {chunk} x shards {shards} must divide N {N}")
    n_local = N // shards
    nc = n_local // chunk
    uniq: List[Tuple[np.ndarray, np.ndarray]] = []  # pairs without repeats (by identity)
    pair_slot = []
    for lat, msk in pairs:
        if lat.shape != (B, N, msk.shape[-1]) or msk.shape[:2] != (B, N):
            raise ValueError("all pairs must share [B, N] leading dims")
        found = next((u for u, (ul, um) in enumerate(uniq) if lat is ul and msk is um), None)
        if found is None:
            uniq.append((lat, msk))
            found = len(uniq) - 1
        pair_slot.append(found)
    deg_all = sum(msk.sum(axis=2) for _, msk in uniq)
    kmax_all = sum(msk.shape[-1] for _, msk in uniq)
    key = deg_all if node_mask is None else np.where(node_mask, deg_all, kmax_all + 1)
    order = np.argsort(key, axis=1, kind="stable").astype(np.int64)
    # perm[b, s * n_local + l] = order[b, l * shards + s]: every shard gets the
    # same slice of the degree distribution and of the padded tail
    perms = np.ascontiguousarray(
        order.reshape(B, n_local, shards).transpose(0, 2, 1)).reshape(B, N)
    rows = np.arange(B)[:, None]
    permuted = [(lat[rows, perms], msk[rows, perms]) for lat, msk in uniq]
    ks_need = np.maximum.reduce([
        np.maximum(m.sum(axis=2).reshape(B, shards, nc, chunk).max(axis=(0, 1, 3)), 1)
        for _, m in permuted])
    if profile is not None:
        ks = np.asarray(profile, np.int64)
        if ks.shape != (nc,):
            raise ValueError(f"sectioned profile has {ks.shape} entries, need {nc} "
                             f"(one per {chunk}-node chunk)")
        if (ks_need > ks).any():
            raise ValueError(f"pinned sectioned profile {ks.tolist()} is below the observed "
                             f"per-chunk max degree {ks_need.tolist()} — edges would be dropped")
    else:
        ks = ks_need

    outs = []
    for lat_p, msk_p in permuted:
        # shard-major view [B, S, n_local, K]: a local row range is taken from
        # every shard (S = 1: the plain [B, N, K] slice)
        kp = lat_p.shape[-1]
        lat_v = lat_p.reshape(B, shards, n_local, kp)
        msk_v = msk_p.reshape(B, shards, n_local, kp)
        sections = []
        i = 0
        while i < nc:
            j = i
            while j < nc and ks[j] == ks[i]:
                j += 1
            ksec = int(ks[i])
            lo, hi = i * chunk, j * chunk
            kw = min(ksec, kp)
            if bool(msk_v[:, :, lo:hi, kw:].any()):
                raise ValueError("slots are not valid-first packed: a row has a valid slot "
                                 f"beyond its section width K={ksec} (compact first)")
            rows_s = shards * (hi - lo)
            li = np.ascontiguousarray(lat_v[:, :, lo:hi, :kw]).reshape(B, rows_s, kw)
            mi = np.ascontiguousarray(msk_v[:, :, lo:hi, :kw]).reshape(B, rows_s, kw)
            if kw < ksec:  # pinned profile wider than this pair's K: pad
                padw = ((0, 0), (0, 0), (0, ksec - kw))
                li, mi = np.pad(li, padw), np.pad(mi, padw)
            sections.append((li, mi))
            i = j
        outs.append(SectionedEdgeSlots.from_numpy(sections, device=device, shards=shards))
    return perms, [outs[u] for u in pair_slot]


def flatten_slots_host(lat_idx: np.ndarray, mask: np.ndarray, chunk: int,
                       pad_multiple: int = 8192, edges_per_chunk: int = 0,
                       order: str = "src"):
    """[N, K] slots -> per-chunk flat (src [nc, E] int32 local to the chunk,
    dst [nc, E] int32, mask [nc, E] bool).

    E is the largest per-chunk valid count rounded up to `pad_multiple`, or
    the caller's `edges_per_chunk`, which must cover that count: the native
    code cuts a chunk's list at E, so too small an E raises instead of
    dropping edges. order 'src' keeps the (node, slot) order, ascending by
    node; 'dst' stable-sorts each chunk's valid rows by latent cell. Padding
    is packed at the tail either way, with src = dst = 0."""
    if order not in ("src", "dst"):
        raise ValueError(f"unknown flat edge order: {order}")
    N, K = lat_idx.shape
    if N % chunk != 0:
        raise ValueError(f"chunk {chunk} must divide N {N}")
    nc = N // chunk
    counts = mask.reshape(nc, chunk * K).sum(axis=1)
    max_valid = int(counts.max()) if nc else 0
    E = edges_per_chunk or -(-max(max_valid, 1) // pad_multiple) * pad_multiple
    if max_valid > E:
        raise ValueError(f"edges_per_chunk {E} < max per-chunk valid count {max_valid}: "
                         "edges would be dropped")
    lat_c = np.ascontiguousarray(lat_idx, np.int32)
    msk_c = np.ascontiguousarray(mask, np.uint8)
    src = np.empty((nc, E), np.int32)
    dst = np.empty((nc, E), np.int32)
    out_m = np.empty((nc, E), np.uint8)
    got = _graph_library().gaot_flatten_slots(
        lat_c.ctypes.data_as(ctypes.c_void_p), msk_c.ctypes.data_as(ctypes.c_void_p),
        N, K, chunk, E, 1 if order == "dst" else 0,
        src.ctypes.data_as(ctypes.c_void_p), dst.ctypes.data_as(ctypes.c_void_p),
        out_m.ctypes.data_as(ctypes.c_void_p), max(1, os.cpu_count() or 1))
    if got < 0:
        raise RuntimeError(f"gaot_flatten_slots failed rc={got}")
    if got > E:
        raise ValueError(f"edges_per_chunk {E} < max per-chunk valid count {got}: "
                         "edges would be dropped")
    return src, dst, out_m.astype(bool)


def flatten_slots_host_batched(lat_idx: np.ndarray, mask: np.ndarray, chunk: int,
                               pad_multiple: int = 8192, order: str = "src",
                               edges_per_chunk: int = 0, device=None) -> FlatEdgeChunks:
    """[B, N, K] slots -> FlatEdgeChunks [B, nc, E] on `device`, with one E
    for the batch: the largest over the samples, or the caller's
    `edges_per_chunk` (`MAGNOConfig.flat_edges_per_chunk`)."""
    per = [flatten_slots_host(np.asarray(lat_idx[b]), np.asarray(mask[b]), chunk,
                              pad_multiple=pad_multiple, order=order,
                              edges_per_chunk=edges_per_chunk)
           for b in range(lat_idx.shape[0])]
    E = max(p[0].shape[1] for p in per)
    # padding is already packed at the tail, so growing E is a zero pad
    per = [tuple(np.pad(a, ((0, 0), (0, E - a.shape[1]))) for a in p) for p in per]
    return FlatEdgeChunks.from_numpy(*(np.stack([p[i] for p in per]) for i in range(3)),
                                     device=device)
