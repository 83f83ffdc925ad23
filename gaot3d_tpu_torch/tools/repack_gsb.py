"""Repack a sample store (.npz or reference .pt) into the native .gsb format,
read through mmap by native/gaot_io.cpp (the port's twin of
tools/repack_gsb.py).

    python -m gaot3d_tpu_torch.tools.repack_gsb --root DATASET_ROOT --folder processed
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import List, Optional, Sequence

from ..data.dataset import load_sample
from ..data.native_io import write_gsb

logger = logging.getLogger("repack_gsb")


def repack(root: str, folder: str, remove_source: bool = False) -> List[str]:
    """Write `<name>.gsb` beside each sample the order file lists, from its
    `.npz` (or else its `.pt`), removing the source with `remove_source`;
    returns the names repacked."""
    processed = os.path.join(root, folder)
    with open(os.path.join(root, f"order_{folder}.txt")) as f:
        names = [line.strip() for line in f if line.strip()]
    done = []
    for name in names:
        for ext in (".npz", ".pt"):
            src = os.path.join(processed, name + ext)
            if os.path.exists(src):
                write_gsb(os.path.join(processed, name + ".gsb"), load_sample(src))
                if remove_source:
                    os.remove(src)  # the loader prefers .gsb; keeping both doubles disk
                logger.info("repacked %s%s -> .gsb", name, ext)
                done.append(name)
                break
        else:
            logger.warning("no source for %s", name)
    return done


def main(argv: Optional[Sequence[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--folder", default="processed")
    args = ap.parse_args(argv)
    repack(args.root, args.folder)


if __name__ == "__main__":
    main()
