"""Generate a run config's synthetic dataset and precompute its edge slots,
then optionally repack every sample to the mmap .gsb format (the port's twin
of tools/gen_synthetic.py): the offline half of the precompute-then-train
workflow, run once on the host before training.

    python -m gaot3d_tpu_torch.tools.gen_synthetic --config run.toml [--gsb]

Everything runs on the CPU (numpy and the native stencil build); nothing is
computed on the card. The files are those the JAX tool writes.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--gsb", action="store_true",
                    help="repack each .npz to .gsb (mmap loader) and remove the .npz")
    args = ap.parse_args(argv)

    from ..config import load_run_config
    from ..data.dataset import generate_synthetic_dataset
    from ..data.graph_precompute import update_sample_files_with_edges
    from ..edges import LatentGrid
    from ..metadata import DATASET_METADATA
    from .repack_gsb import repack

    cfg = load_run_config(args.config)
    ds = cfg.dataset
    root = ds.base_path
    processed = os.path.join(root, ds.processed_folder)
    t0 = time.time()
    if not os.path.isdir(processed) or not os.listdir(processed):
        print(f"[gen] generating {ds.synthetic_num_samples} x {ds.synthetic_num_nodes} nodes "
              f"-> {processed}", flush=True)
        generate_synthetic_dataset(ds, root)
        print(f"[gen] done in {time.time() - t0:.1f}s", flush=True)
    else:
        print(f"[gen] {processed} already populated, skipping generation", flush=True)

    grid = LatentGrid(tuple(cfg.model.args.latent_tokens))
    t1 = time.time()
    update_sample_files_with_edges(ds, cfg.model.args.magno, grid,
                                   DATASET_METADATA[ds.metaname])
    print(f"[slots] precompute sweep done in {time.time() - t1:.1f}s", flush=True)

    if args.gsb:
        t2 = time.time()
        names = repack(root, ds.processed_folder, remove_source=True)
        print(f"[gsb] repacked {len(names)} samples in {time.time() - t2:.1f}s", flush=True)


if __name__ == "__main__":
    main()
