"""Offline graph building for the input pipeline (port of
gaot3d_tpu/data/graph_precompute.py).

The precompute sweep (`dataset.update_pt_files_with_edges`) builds the edge
slots of every sample once, per direction and scale, and stores them next to
the data with atomic tmp+replace writes: `lat_idx` as int32 and the mask
bit-packed (np.packbits), about 4.1 bytes a slot. Keys and bytes are those
the JAX package writes, so a sweep by either package is read by the other.
With a `slot_budget` both packages build through the same native code; without
one this package still builds on the host (the JAX package builds on its
device): the valid edges agree, the index a masked slot carries may not.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, List, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def _slot_keys(direction: str, scale_idx: int) -> Tuple[str, str]:
    return (
        f"{direction}_slot_idx_s{scale_idx}",
        f"{direction}_slot_mask_s{scale_idx}",
    )


def compute_sample_edge_slots(
    pos: np.ndarray,
    grid,
    magno_config,
    use_rescale_new: bool,
    domain_x,
) -> Dict[str, np.ndarray]:
    """Edge slots for one sample (both directions, all scales), from RAW
    positions (applies the same rescale the training pipeline uses —
    stat.py:168-171 does the rescale before the neighbor search too)."""
    from ..models.magno import parse_neighbor_strategy
    from .host_graph import build_edge_slots_host
    from .transforms import rescale, rescale_new

    if use_rescale_new:
        p = rescale_new(pos.astype(np.float32), (-1, 1), domain_x)
    else:
        p = rescale(pos.astype(np.float32), (-1, 1))
    enc_strategy, dec_strategy = parse_neighbor_strategy(magno_config.neighbor_strategy)
    out: Dict[str, np.ndarray] = {}
    budget = magno_config.slot_budget
    p_np = np.asarray(p, np.float32)
    for scale_idx, scale in enumerate(magno_config.scales):
        radius = magno_config.gno_radius * scale
        for direction, strategy in (("encoder", enc_strategy), ("decoder", dec_strategy)):
            if budget:
                # store budget-compacted slots (compact_slots order) via the
                # host-side build — at full DrivAerML resolution the uncompacted
                # stencil window is [8.4M, 144] int32 = 4.8 GB PER DIRECTION
                # per sample; budget-5 storage is 0.17 GB. The native code
                # silently drops overflow beyond the budget, so build ONE
                # extra probe slot and refuse if it is ever valid (the same
                # honesty contract as the trainer's slot_budget guard).
                lat, msk = build_edge_slots_host(
                    p_np, grid, radius, k_neighbors=magno_config.k_neighbors,
                    strategy=strategy, budget=budget + 1,
                )
                if lat.shape[1] > budget:  # window K may already be <= budget
                    if msk[:, budget].any():
                        deg = int(msk[:, budget].sum())
                        raise ValueError(
                            f"slot_budget={budget} drops edges for {deg} points "
                            f"({direction}, scale {scale_idx}): raise slot_budget"
                        )
                    lat, msk = lat[:, :budget], msk[:, :budget]
                lat_idx, mask = lat, msk
            else:
                lat_idx, mask = build_edge_slots_host(
                    p_np, grid, radius, k_neighbors=magno_config.k_neighbors,
                    strategy=strategy)
            ikey, mkey = _slot_keys(direction, scale_idx)
            out[ikey] = np.ascontiguousarray(lat_idx, np.int32)
            out[mkey] = np.packbits(mask, axis=-1)
            out[mkey + "_K"] = np.asarray(mask.shape[-1], np.int32)
    return out


def unpack_slot_mask(packed: np.ndarray, K: int) -> np.ndarray:
    return np.unpackbits(packed, axis=-1)[..., :K].astype(bool)


def update_sample_files_with_edges(dataset_config, magno_config, grid, metadata) -> None:
    """Offline precompute sweep over all split files (reference:
    stat.py:126-224 _update_pt_files_with_edges). Runs on rank 0 of a
    running torch.distributed group only (the trainer's other ranks wait at
    a barrier); per-file failures are logged and skipped, writes are
    atomic."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_rank() != 0:
        return
    from .dataset import MeshDataset, load_sample, save_sample
    from .host_graph import _graph_library

    _graph_library()  # a failed build raises here, not inside the per-file handler
    names = []
    for split in ("train", "val", "test"):
        ds = MeshDataset(dataset_config, split)
        names.extend(ds.filenames)
    seen = set()
    processed_dir = os.path.join(dataset_config.base_path, dataset_config.processed_folder)
    logger.info("Precomputing edge slots for %d sample files in %s", len(names), processed_dir)
    for name in names:
        if name in seen:
            continue
        seen.add(name)
        npz_path = os.path.join(processed_dir, name + ".npz")
        try:
            src = npz_path
            if not os.path.exists(src):
                # same extension preference as the loader (.gsb mmap first)
                for ext in (".gsb", ".pt"):
                    alt = os.path.join(processed_dir, name + ext)
                    if os.path.exists(alt):
                        src = alt
                        break
            sample = load_sample(src)
            need = [k for d in ("encoder", "decoder")
                    for s in range(len(magno_config.scales))
                    for k in _slot_keys(d, s)]
            have = all(k in sample for k in need)
            if have and magno_config.slot_budget:
                # stored K must match the current budget, else recompute (a
                # changed radius is NOT detectable from the stored arrays —
                # wipe the processed dir when changing it, like re-running
                # the reference's precompute after a config change)
                have = all(
                    sample[_slot_keys(d, s)[0]].shape[-1]
                    <= magno_config.slot_budget
                    for d in ("encoder", "decoder")
                    for s in range(len(magno_config.scales))
                )
            if have:
                continue  # idempotent sweep: slots already stored (e.g. the
                # offline tools/gen_synthetic.py ran; at 8M nodes recomputing
                # costs ~2 min/sample on this host)
            slots = compute_sample_edge_slots(
                sample["pos"], grid, magno_config,
                dataset_config.use_rescale_new, metadata.domain_x,
            )
            sample.update(slots)
            save_sample(npz_path, sample)  # atomic tmp+replace
        except FileNotFoundError:
            logger.warning("File not found during edge precompute: %s", name)
        except Exception as e:  # pragma: no cover
            logger.error("Error precomputing edges for %s: %s", name, e)
    logger.info("Finished edge-slot precompute sweep.")


def extract_precomputed_slots(
    sample: Dict[str, np.ndarray], num_scales: int
) -> Dict[str, List[Tuple[np.ndarray, np.ndarray]]]:
    """Pull (lat_idx, mask) pairs per scale out of a loaded sample dict, or
    return None if absent."""
    out = {"encoder": [], "decoder": []}
    for direction in ("encoder", "decoder"):
        for s in range(num_scales):
            ikey, mkey = _slot_keys(direction, s)
            if ikey not in sample:
                return None
            K = int(sample[mkey + "_K"])
            out[direction].append((sample[ikey], unpack_slot_mask(sample[mkey], K)))
    return out
