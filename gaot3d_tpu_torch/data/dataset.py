"""Mesh sample store: order-file splits, per-sample loading, stats caching
(port of gaot3d_tpu/data/dataset.py: the same files, splits, statistics and
synthetic draws, so both packages read and write one dataset directory).

Replaces the reference's VTKMeshDataset + normalization-stats machinery
(src/data/pyg_datasets.py:33-141, src/trainer/stat.py:56-124) without PyG:
samples are dicts of numpy arrays {pos [N,3], x [N,C], optional c [N,Cc]}.

Storage formats supported:
  - .npz (native format of this framework; also written by the converter)
  - .pt  (reference-compatible: read via torch CPU if available)

Split semantics match the reference exactly: order file lists base names;
train = first train_size, val = next val_size, test = LAST test_size
(pyg_datasets.py:95-123), optional seeded shuffle (`rand_dataset`, seed 42).
"""
from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


@dataclass
class DatasetConfig:
    """Field names mirror the reference DatasetConfig
    (src/trainer/utils/default_set.py:62-86)."""

    name: str = "drivaernet_fullpressure"
    metaname: str = "incompressible_fluids/drivaernet_pressure"
    base_path: str = ""
    processed_folder: str = "processed_pyg"
    active_variables: Optional[List[int]] = None
    force_recompute_stats: bool = False
    use_metadata_stats: bool = False
    sample_rate: float = 0.1
    train_size: int = 5817
    val_size: int = 1148
    test_size: int = 1154
    rand_dataset: bool = False
    batch_size: int = 64
    num_workers: int = 4
    shuffle: bool = True
    metric_suite: str = "drivaernet"  # ['drivaernet', 'general', 'poseidon']
    update_pt_files_with_edges: bool = False
    use_rescale_new: bool = False
    training_strategy: str = "full_grid"  # ['full_grid', 'neural_field']
    neural_field_input_nodes: Optional[int] = 40000
    neural_field_query_nodes_train: Optional[int] = 40000
    # pad point clouds to multiples of this bucket size (static shapes: the
    # model's node chunking must divide the padded count)
    pad_multiple: int = 1024
    # keep device-placed batches resident in device memory across epochs
    # (keyed by the batch's sample ids): no per-epoch host->device upload when
    # the dataset fits beside the train state. Epoch-varying batch
    # COMPOSITIONS (shuffle with batch_size > 1) defeat the cache; with
    # batch_size == 1 (the DrivAerNet recipe) shuffle order is irrelevant.
    device_cache: bool = False
    # synthetic dataset knobs (dataset name 'synthetic')
    synthetic_num_samples: int = 16
    synthetic_num_nodes: int = 2048
    synthetic_seed: int = 0


def load_sample(path: str) -> Dict[str, np.ndarray]:
    """Load one mesh sample (.gsb native mmap, .npz, or reference .pt via
    torch CPU)."""
    if path.endswith(".gsb"):
        from .native_io import GsbReader

        with GsbReader(path) as r:
            return r.read(copy=True)
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: np.asarray(z[k]) for k in z.files}
    if path.endswith(".pt"):
        import torch

        data = torch.load(path, map_location="cpu", weights_only=False)
        out = {}
        for key in ("pos", "x", "c"):
            val = getattr(data, key, None) if not isinstance(data, dict) else data.get(key)
            if val is not None:
                out[key] = np.asarray(val.detach().cpu().numpy() if hasattr(val, "detach") else val)
        return out
    raise ValueError(f"unsupported sample format: {path}")


def save_sample(path: str, sample: Dict[str, np.ndarray]) -> None:
    tmp = path + ".tmp.npz"
    np.savez(tmp, **sample)
    os.replace(tmp, path)  # atomic, like the reference's tmp+os.replace (stat.py:216-217)


class MeshDataset:
    """Order-file-driven split over per-sample files."""

    def __init__(self, config: DatasetConfig, split: str = "train"):
        self.config = config
        self.split = split
        order_file = os.path.join(
            config.base_path, f"order_{config.processed_folder}.txt"
        )
        self.processed_dir = os.path.join(config.base_path, config.processed_folder)
        if not os.path.isdir(self.processed_dir):
            raise FileNotFoundError(f"Processed data directory does not exist: {self.processed_dir}")
        if not os.path.exists(order_file):
            raise FileNotFoundError(f"Order file does not exist: {order_file}")
        with open(order_file) as f:
            names = [line.strip() for line in f if line.strip()]
        indices = np.arange(len(names))
        if config.rand_dataset:
            np.random.default_rng(seed=42).shuffle(indices)  # parity: pyg_datasets.py:106-108
        if split == "train":
            sel = indices[: config.train_size]
        elif split == "val":
            sel = indices[config.train_size : config.train_size + config.val_size]
        elif split == "test":
            sel = indices[-config.test_size :]
        else:
            raise ValueError(f"Invalid split: {split}")
        self.filenames = [names[i] for i in sel]
        logger.info("Loaded %d samples for split '%s'.", len(self.filenames), split)

    def __len__(self) -> int:
        return len(self.filenames)

    def _resolve(self, name: str) -> str:
        for ext in (".gsb", ".npz", ".pt"):
            p = os.path.join(self.processed_dir, name + ext)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"sample not found: {name}(.gsb|.npz|.pt) in {self.processed_dir}")

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        sample = load_sample(self._resolve(self.filenames[idx]))
        x = sample.get("x")
        if x is not None:
            if x.ndim == 3:  # squeeze trailing singleton (pyg_datasets.py:134)
                x = x.squeeze(-1)
            if self.config.active_variables is not None:
                x = x[:, self.config.active_variables]
            sample["x"] = x
        return sample


def compute_or_load_stats(
    config: DatasetConfig, dataset: Optional[MeshDataset] = None
) -> Dict[str, np.ndarray]:
    """Normalization statistics from the train split, cached to disk
    (parity: stat.py:56-124 _calculate_or_load_stats; uses per-variable
    mean/std over all train nodes; torch.std is unbiased -> ddof=1)."""
    # the computed values are in active-variable space (the dataset slices x
    # at load) — key the cache by the selection so a full-width cache from an
    # av=None run is never silently reused for a sliced one (the reference's
    # cache file is ambiguous this way, stat.py:58)
    av = config.active_variables
    av_tag = "" if av is None else "_av" + "-".join(str(i) for i in av)
    stats_file = os.path.join(
        config.base_path, f"{config.name}_norm_stats{av_tag}.json")
    if os.path.exists(stats_file) and not config.force_recompute_stats:
        with open(stats_file) as f:
            raw = json.load(f)
        return {k: np.asarray(v, dtype=np.float32) for k, v in raw.items()}

    if dataset is None:
        dataset = MeshDataset(config, split="train")
    # streaming two-pass-free accumulation (sum / sumsq) over all train nodes
    n = 0
    s = None
    ss = None
    cn, cs, css = 0, None, None
    for i in range(len(dataset)):
        sample = dataset[i]
        x = np.asarray(sample["x"], dtype=np.float64)
        if s is None:
            s = np.zeros(x.shape[1])
            ss = np.zeros(x.shape[1])
        n += x.shape[0]
        s += x.sum(axis=0)
        ss += (x * x).sum(axis=0)
        c = sample.get("c")
        if c is not None:
            c = np.asarray(c, dtype=np.float64)
            if cs is None:
                cs = np.zeros(c.shape[1])
                css = np.zeros(c.shape[1])
            cn += c.shape[0]
            cs += c.sum(axis=0)
            css += (c * c).sum(axis=0)
    if n == 0:
        raise ValueError("No data found in training set to calculate statistics.")
    mean = s / n
    var = (ss - n * mean * mean) / max(n - 1, 1)  # unbiased, parity with torch.std
    stats = {"mean": mean.astype(np.float32), "std": np.sqrt(np.maximum(var, 0)).astype(np.float32)}
    if cs is not None:
        cmean = cs / cn
        cvar = (css - cn * cmean * cmean) / max(cn - 1, 1)
        stats["c_mean"] = cmean.astype(np.float32)
        stats["c_std"] = np.sqrt(np.maximum(cvar, 0)).astype(np.float32)
    os.makedirs(os.path.dirname(stats_file) or ".", exist_ok=True)
    with open(stats_file, "w") as f:
        json.dump({k: v.tolist() for k, v in stats.items()}, f)
    logger.info("Saved normalization stats to %s", stats_file)
    return stats


def generate_synthetic_dataset(config: DatasetConfig, root: str) -> None:
    """Write a synthetic point-cloud dataset (smooth field over random clouds)
    in the on-disk layout the loader expects. Used by tests/bench/smoke runs."""
    processed = os.path.join(root, config.processed_folder)
    os.makedirs(processed, exist_ok=True)
    rng = np.random.default_rng(config.synthetic_seed)
    names = []
    for i in range(config.synthetic_num_samples):
        n = config.synthetic_num_nodes
        # random smooth geometry: points on a deformed sphere
        u = rng.normal(size=(n, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        bump = 1.0 + 0.3 * np.sin(3 * u[:, 0]) * np.cos(2 * u[:, 1]) + 0.1 * rng.normal()
        pos = (u * bump[:, None]).astype(np.float32)
        # smooth target field (pressure-like)
        x = (
            np.sin(2.0 * pos[:, 0]) * np.cos(1.5 * pos[:, 1])
            + 0.5 * pos[:, 2] ** 2
        ).astype(np.float32)[:, None]
        name = f"sample_{i:05d}"
        save_sample(os.path.join(processed, name + ".npz"), {"pos": pos, "x": x})
        names.append(name)
    with open(os.path.join(root, f"order_{config.processed_folder}.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
