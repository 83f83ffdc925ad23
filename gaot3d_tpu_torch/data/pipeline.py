"""Host-side input pipeline: transforms, padding, batching, prefetch (port of
gaot3d_tpu/data/pipeline.py).

  - Ragged point clouds become fixed-shape padded [B, N, ...] arrays with node
    masks.
  - Three graph-building modes:
      * 'precomputed' ('update_pt_files_with_edges'): slots stored beside the
        samples by the sweep of `graph_precompute.py`;
      * 'async' ('asynchronous_graph_building'): slots built on the host while
        batching;
      * 'device' (neither): batches carry no edges (enc_slots and dec_slots
        None) and the model builds uniform slots on the device inside its
        forward. The flat and sectioned layouts need host-built slots.
  - Batches are assembled on the host: pos, feats, target and masks as numpy,
    the edge structures as the port's containers over CPU tensors that share
    the numpy memory. `prefetch_to_device` overlaps that assembly and the
    pinned upload with the device's step.
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, NamedTuple, Optional

import numpy as np
import torch

from ..metadata import Metadata
from .dataset import DatasetConfig, MeshDataset
from .transforms import normalize, rescale, rescale_new

logger = logging.getLogger(__name__)


class PointBatch(NamedTuple):
    """Static-shape batch of point clouds on the host (numpy).

    enc_slots / dec_slots carry the precomputed edge structures, one per
    scale: EdgeSlots ([B,N,K]), SectionedEdgeSlots or FlatEdgeChunks over CPU
    tensors."""

    pos: np.ndarray  # [B, N, 3] rescaled coordinates
    feats: np.ndarray  # [B, N, C_in] encoder input features (normalized)
    target: np.ndarray  # [B, N, C_out] normalized targets
    node_mask: np.ndarray  # [B, N] valid-node mask
    num_nodes: np.ndarray  # [B] true node counts
    enc_slots: Optional[tuple] = None  # one edge structure per scale
    dec_slots: Optional[tuple] = None


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@dataclass
class SamplePreprocessor:
    """Per-sample transform chain: coordinate rescale + feature normalization +
    encoder feature assembly (parity: stat.py:277-304 composed transforms and
    magno.py:485-499 feature_attr gathering)."""

    stats: Dict[str, np.ndarray]
    metadata: Metadata
    use_rescale_new: bool = False
    encoder_feature_attr: object = "x"  # str or list, e.g. ["pos", "c"]

    def __call__(self, sample: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        if self.use_rescale_new:
            pos = rescale_new(sample["pos"].astype(np.float32), (-1, 1), self.metadata.domain_x)
        else:
            pos = rescale(sample["pos"].astype(np.float32), (-1, 1))
        pos = pos.astype(np.float32)
        x = normalize(sample["x"], self.stats["mean"], self.stats["std"]).astype(np.float32)
        out = {"pos": pos, "x": x}
        if "c" in sample and "c_mean" in self.stats:
            out["c"] = normalize(sample["c"], self.stats["c_mean"], self.stats["c_std"]).astype(np.float32)
        elif "c" in sample:
            out["c"] = sample["c"].astype(np.float32)

        attrs = (
            self.encoder_feature_attr
            if isinstance(self.encoder_feature_attr, (list, tuple))
            else [self.encoder_feature_attr]
        )
        feats = []
        for a in attrs:
            if a not in out:
                raise AttributeError(
                    f"encoder requires feature attribute '{a}' but it was not found in the sample"
                )
            feats.append(out[a])
        out["enc_feats"] = np.concatenate(feats, axis=-1)
        return out


class BatchLoader:
    """Iterates padded PointBatches over a MeshDataset split.

    Supports per-process sharding for multi-host data parallelism (the
    DistributedSampler replacement, stat.py:367-397): each process sees
    indices[shard_index::num_shards].
    """

    def __init__(
        self,
        dataset: MeshDataset,
        preprocessor: SamplePreprocessor,
        batch_size: int,
        pad_num_nodes: Optional[int] = None,
        pad_multiple: int = 1024,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        num_shards: int = 1,
        shard_index: int = 0,
        num_workers: int = 0,
        slot_mode: str = "device",  # 'device' | 'async' | 'precomputed'
        build_slots=None,  # callable(rescaled_pos)->dict for 'async'
        num_scales: int = 1,
        edge_layout="slots",  # 'slots' | 'flat' | 'sectioned' | [enc, dec] pair
        edge_chunk_size: Optional[int] = None,  # the model's node chunking
        flat_order: str = "src",  # encoder flat ordering (MAGNOConfig.flat_order)
        flat_edges_per_chunk: int = 0,  # pinned E (MAGNOConfig.flat_edges_per_chunk)
        sectioned_profile=None,  # pinned per-chunk K list for 'sectioned'
        section_shards: int = 1,  # shard-aligned sectioning (node sharding): node_shards
        device_cache: bool = False,  # keep built batches resident across epochs
        cache_put=None,  # callable(PointBatch) applied before caching: the trainer's
        # upload, so cached entries live in device memory
    ):
        self.dataset = dataset
        self.preprocessor = preprocessor
        self.batch_size = batch_size
        self.pad_multiple = pad_multiple
        self.pad_num_nodes = pad_num_nodes
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.num_workers = num_workers
        self.slot_mode = slot_mode
        self.build_slots = build_slots
        self.num_scales = num_scales
        from ..models.magno import parse_edge_layout

        self.edge_layout = parse_edge_layout(edge_layout)  # (enc, dec)
        self.edge_chunk_size = edge_chunk_size
        self.flat_order = flat_order
        self.flat_edges_per_chunk = flat_edges_per_chunk
        self.sectioned_profile = sectioned_profile
        self.section_shards = section_shards
        if "flat" in self.edge_layout and slot_mode == "device":
            raise ValueError("edge_layout 'flat' needs host-built slots "
                             "(slot_mode 'async' or 'precomputed')")
        if "sectioned" in self.edge_layout and slot_mode == "device":
            raise ValueError("edge_layout 'sectioned' needs host-built slots "
                             "(slot_mode 'async' or 'precomputed')")
        self._warned_chunk = False
        self.device_cache = device_cache
        self.cache_put = cache_put
        self._dcache: Dict[tuple, PointBatch] = {}

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle per epoch (parity: DistributedSampler.set_epoch,
        optimizers.py:137-139)."""
        self.epoch = epoch

    def __len__(self) -> int:
        n = self._per_shard_len()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _per_shard_len(self) -> int:
        # EQUAL per shard (ceil), like torch DistributedSampler — see _indices
        return -(-len(self.dataset) // self.num_shards)

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng([self.seed, self.epoch]).shuffle(idx)
        if self.num_shards > 1:
            # pad by wrapping around so EVERY shard gets the same count
            # (torch DistributedSampler semantics, reference stat.py:367-397).
            # Unequal shards would make multi-host processes dispatch a
            # different number of collective SPMD steps -> deadlock at the
            # gradient psum, and desynchronize steps_per_epoch/LR schedules.
            total = self._per_shard_len() * self.num_shards
            if total > idx.shape[0]:
                idx = np.resize(idx, total)  # cyclic tiling (handles n < shards)
        return idx[self.shard_index :: self.num_shards]

    def _make_batch(self, samples: List[Dict[str, np.ndarray]]) -> PointBatch:
        n_max = max(s["pos"].shape[0] for s in samples)
        n_pad = self.pad_num_nodes or round_up(n_max, self.pad_multiple)
        B = self.batch_size  # always pad batch dim too (static shapes)
        cin = samples[0]["enc_feats"].shape[-1]
        cout = samples[0]["x"].shape[-1]
        counts = np.zeros((B,), np.int32)
        counts[: len(samples)] = [min(s["pos"].shape[0], n_pad) for s in samples]

        def padded(key: str, C: int):
            # threaded native memcpy+memset (native/gaot_io.cpp pad_batch_f32)
            from .native_io import pad_batch_native

            arrs = [np.ascontiguousarray(s[key][:n_pad], np.float32) for s in samples]
            arrs += [np.zeros((0, C), np.float32)] * (B - len(samples))
            return pad_batch_native(arrs, counts, n_pad)

        pos, mask = padded("pos", 3)
        feats, _ = padded("enc_feats", cin)
        target, _ = padded("x", cout)
        enc_slots = dec_slots = None
        if self.slot_mode != "device" and "slots" in samples[0]:
            from ..ops.grid_graph import EdgeSlots

            def pad_slots_np(direction):
                """Padded host arrays [B, n_pad, K] of one direction, a pair a
                scale."""
                per_scale = []
                for sidx in range(self.num_scales):
                    K = samples[0]["slots"][direction][sidx][0].shape[-1]
                    idx = np.zeros((B, n_pad, K), np.int32)
                    msk = np.zeros((B, n_pad, K), bool)
                    for i, s in enumerate(samples):
                        si, sm = s["slots"][direction][sidx]
                        n = min(si.shape[0], n_pad)
                        idx[i, :n] = si[:n]
                        msk[i, :n] = sm[:n]
                    per_scale.append((idx, msk))
                return per_scale

            enc_np = pad_slots_np("encoder")
            dec_np = pad_slots_np("decoder")
            # alias bitwise-identical directions: for symmetric recipes
            # (same strategy/radius/grid both ways — e.g. the DrivAerNet
            # bidirectional r=0.033 recipe) the encoder and decoder slots are
            # the SAME (point, cell) pairs stored twice by the precompute.
            # Sharing the array halves the slots' device memory: the
            # conversion memo below and the upload both keep the aliasing.
            # np.array_equal is a host memcmp, overlapped by the prefetch
            # producer.
            dec_np = [
                e if (d[0] is e[0] or np.array_equal(d[0], e[0]))
                and (d[1] is e[1] or np.array_equal(d[1], e[1])) else d
                for e, d in zip(enc_np, dec_np)
            ]

            def to_flat(pairs, order):
                # per-chunk compacted edge lists (FlatEdgeChunks): chunking
                # must match the model's edge scan (effective_chunk)
                from .host_graph import flatten_slots_host_batched

                chunk = self._chunk(n_pad)
                return tuple(
                    flatten_slots_host_batched(
                        idx, msk, chunk, order=order,
                        edges_per_chunk=self.flat_edges_per_chunk,
                    )
                    for idx, msk in pairs
                )

            slot_memo: Dict[tuple, "EdgeSlots"] = {}

            def to_slots(pairs):
                # memo keyed by source-array identity: aliased enc/dec
                # directions convert to ONE pair of tensors, not two copies
                out = []
                for i, m in pairs:
                    key = (id(i), id(m))
                    if key not in slot_memo:
                        slot_memo[key] = EdgeSlots.from_numpy(i, m)
                    out.append(slot_memo[key])
                return tuple(out)

            # layout per side (MAGNOConfig.edge_layout scalar-or-pair)
            enc_layout, dec_layout = self.edge_layout
            if enc_layout == "sectioned":  # parse guarantees both sides
                # degree-sectioned layout: ONE shared node permutation per
                # sample (ascending combined degree, pads last). Consumers
                # select valid rows by node_mask, not by an [:n] prefix
                # (trainer.test() does). One shared section structure for
                # enc/dec (keeps the aliasing). The sample arrays are
                # permuted to match.
                from .host_graph import section_slots_shared

                if self.num_scales != 1:
                    raise ValueError(
                        "edge_layout 'sectioned' supports a single scale")
                S = self.section_shards
                if n_pad % S != 0:
                    raise ValueError(
                        f"section_shards {S} must divide the padded node "
                        f"count {n_pad} (set pad_multiple to a multiple of "
                        "section_shards x edge_chunk_size)")
                chunkn = self._chunk(n_pad // S)
                perms, (enc_sect, dec_sect) = section_slots_shared(
                    [enc_np[0], dec_np[0]], chunkn, node_mask=mask,
                    profile=self.sectioned_profile, shards=S,
                )
                rows = np.arange(B)[:, None]
                pos = np.ascontiguousarray(pos[rows, perms])
                feats = np.ascontiguousarray(feats[rows, perms])
                target = np.ascontiguousarray(target[rows, perms])
                mask = np.ascontiguousarray(mask[rows, perms])
                enc_slots = (enc_sect,)
                dec_slots = (dec_sect,)
            else:
                enc_slots = (
                    to_flat(enc_np, self.flat_order)
                    if enc_layout == "flat" else to_slots(enc_np)
                )
                dec_slots = (
                    to_flat(dec_np, "src")  # decoder fold invariant
                    if dec_layout == "flat" else to_slots(dec_np)
                )
        return PointBatch(
            pos=pos, feats=feats, target=target, node_mask=mask,
            num_nodes=counts, enc_slots=enc_slots, dec_slots=dec_slots,
        )

    def _chunk(self, n: int) -> int:
        """The model's node chunk for n padded nodes. `effective_chunk` falls
        back to a divisor of n when `edge_chunk_size` does not divide it; far
        below the configured size that means many small chunks a step, so say
        so once."""
        from ..models.integral_transform import effective_chunk

        chunk = effective_chunk(n, self.edge_chunk_size)
        want = self.edge_chunk_size
        if want and chunk < min(want, n) // 2 and not self._warned_chunk:
            self._warned_chunk = True
            logger.warning(
                "edge_chunk_size %d does not divide the padded node count %d: the model "
                "runs %d chunks of %d nodes; set dataset.pad_multiple to a multiple of "
                "edge_chunk_size", want, n, n // chunk, chunk)
        return chunk

    def _load_one(self, i: int) -> Dict[str, np.ndarray]:
        raw = self.dataset[int(i)]
        out = self.preprocessor(raw)
        if self.slot_mode == "precomputed":
            from .graph_precompute import extract_precomputed_slots

            slots = extract_precomputed_slots(raw, self.num_scales)
            if slots is None:
                raise AttributeError(
                    "sample is missing precomputed edge slots; run the "
                    "update_pt_files_with_edges precompute sweep first"
                )
            out["slots"] = slots
        elif self.slot_mode == "async":
            # online graph building while batching (reference
            # collate_functions.py:73-131, in a loader thread here)
            out["slots"] = self.build_slots(out["pos"])
        return out

    def __iter__(self) -> Iterator[PointBatch]:
        idx = self._indices()
        nb = len(idx) // self.batch_size if self.drop_last else -(-len(idx) // self.batch_size)
        if self.drop_last:
            idx = idx[: nb * self.batch_size]
        if self.device_cache:
            # device-resident batch cache keyed by the batch's sample ids:
            # after the first epoch every same-composition batch is yielded
            # as it lies (DatasetConfig.device_cache). Worker threads are
            # skipped: warm epochs never touch host IO.
            for b in range(nb):
                chunk = idx[b * self.batch_size : (b + 1) * self.batch_size]
                key = tuple(int(i) for i in chunk)
                batch = self._dcache.get(key)
                if batch is None:
                    batch = self._make_batch([self._load_one(i) for i in chunk])
                    if self.cache_put is not None:
                        batch = self.cache_put(batch)
                    self._dcache[key] = batch
                yield batch
            return
        if self.num_workers > 0:
            # async host-side loading, preprocessing and (slot_mode 'async')
            # graph building in worker threads. Lookahead is BOUNDED: at
            # most ~2 batches of samples are in flight, so a slow consumer
            # never accumulates the whole epoch in host memory (at DrivAerNet
            # scale one epoch is tens of GB).
            from collections import deque
            from concurrent.futures import ThreadPoolExecutor

            depth = max(self.num_workers, 2 * self.batch_size)
            with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
                futures = deque(ex.submit(self._load_one, i) for i in idx[:depth])
                submitted = min(depth, len(idx))
                buf: List[Dict[str, np.ndarray]] = []
                while futures:
                    buf.append(futures.popleft().result())
                    if submitted < len(idx):
                        futures.append(ex.submit(self._load_one, idx[submitted]))
                        submitted += 1
                    if len(buf) == self.batch_size or (not futures and buf):
                        yield self._make_batch(buf)
                        buf = []
        else:
            for b in range(nb):
                chunk = idx[b * self.batch_size : (b + 1) * self.batch_size]
                yield self._make_batch([self._load_one(i) for i in chunk])


def pinned_to_device(array, device, memo: Optional[dict] = None) -> torch.Tensor:
    """Upload one numpy array or CPU tensor: through pinned memory and
    without blocking when `device` is a CUDA device. `memo` (keyed by the
    source's identity) makes aliased sources one device tensor."""
    if memo is not None and id(array) in memo:
        return memo[id(array)]
    t = array if isinstance(array, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(array))
    if torch.device(device).type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    if memo is not None:
        memo[id(array)] = t
    return t


def prefetch_to_device(iterator: Iterator[PointBatch], put_fn, size: int = 2,
                       stats: Optional[dict] = None) -> Iterator:
    """Double-buffered background prefetch: overlaps host batch assembly and
    the upload (`put_fn`, the trainer's PointBatch -> TrainBatch placement)
    with the device's compute.

    stats (optional dict) accumulates consumer-side stall accounting:
    'wait_s' = total time the consumer blocked on the queue, 'first_wait_s'
    = the warm-up wait for batch 1 (unavoidable cold load), 'gets' = batches
    yielded. Steady-state loader stall = wait_s - first_wait_s; about 0 means
    the loader and the upload sustain the device's step rate. The producer
    adds 'host_load_s' (disk + batch assembly) and 'put_s' (the upload)."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    put = put_fn
    iterator = iter(iterator)

    class _PrefetchError:
        def __init__(self, exc):
            self.exc = exc

    def producer():
        # propagate loader/placement errors to the consumer — a swallowed
        # exception here would read as a clean (short or empty) epoch, and a
        # zero-batch epoch trains on nothing while reporting loss 0.0
        try:
            while True:
                t0 = time.time()
                try:
                    item = next(iterator)
                except StopIteration:
                    break
                t1 = time.time()
                placed = put(item)
                t2 = time.time()
                if stats is not None:
                    # producer-side breakdown (distinct keys from the
                    # consumer's wait_s, so no cross-thread races matter)
                    stats["host_load_s"] = stats.get("host_load_s", 0.0) + (t1 - t0)
                    stats["put_s"] = stats.get("put_s", 0.0) + (t2 - t1)
                q.put(placed)
            q.put(sentinel)
        except BaseException as e:  # noqa: BLE001 — re-raised on the consumer
            q.put(_PrefetchError(e))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        t0 = time.time()
        item = q.get()
        if stats is not None:
            w = time.time() - t0
            stats["wait_s"] = stats.get("wait_s", 0.0) + w
            if stats.get("gets", 0) == 0:
                stats["first_wait_s"] = w
            stats["gets"] = stats.get("gets", 0) + 1
        if item is sentinel:
            return
        if isinstance(item, _PrefetchError):
            raise item.exc
        yield item
