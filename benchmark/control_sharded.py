"""Control readings for the limits of a node-sharded training cell
(drivers/train_sharded.py), which control.py's controls do not reach: they
take a training cell from the one-process reference over the whole mesh.
Here both sides are the reference over the union of the held shards, its
loss in node blocks (reference/blocked.py), and the stage numbers read the
decoder over rank 0's rows, as the driver compares them.

    python3 benchmark/control_sharded.py --workload drivaerml-train-4chip \
        --control-seeds 101-103 --controls tf32,fp8

For each control seed the reference at a precision below the one the
configuration states (control.py's `tf32`, `fp8`, `bf16_kernel`) is put in
the program's place and judged against the reference at the stated
precision, on the cell's own meshes, by the cell's limits; one line of JSON
a reading. It needs one card. The program's readings come from control.py
(`--program-seeds`, which runs any cell through the harness), the fault of
a rank that keeps its own encoder accumulator from
benchmark/tests/test_sharded_cell.py.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import control, correctness, harness, traffic  # noqa: E402
from benchmark.reference import blocked  # noqa: E402
from benchmark.reference import model as ref  # noqa: E402


def driver():
    return harness.load_module(os.path.join(harness.HERE, "drivers", "train_sharded.py"),
                               "benchmark_driver_train_sharded")


def control_checks(cell: str, seed: int, kind: str, device="cuda",
                   config_over: Optional[dict] = None,
                   traffic_over: Optional[dict] = None) -> Dict[str, float]:
    """The numbers of the reference at precision `kind` in the program's
    place, against the reference at the stated precision."""
    shard_driver = driver()
    cfg, tr, w0 = control._inputs(cell, seed, device, config_over, traffic_over)
    _, shard, _ = shard_driver.sizes(cfg)
    stated = ref.Spec.from_config(cfg)
    lower = ref.Spec.from_config(cfg)
    lower.control = kind
    checked = int(tr["checked_steps"])
    fed = []
    for i in range(checked):
        m = shard_driver.held_rows(cfg, seed, i, tr["surface"], device)
        fed.append((m.pos, m.feats, m.target, *ref.graph(stated, m.pos)))
    spe = int(cfg["dataset"]["train_size"]) // int(cfg["dataset"]["batch_size"])
    gen = torch.Generator().manual_seed(traffic.stream_seed(seed, 3))
    seeds = [ref.layer_seeds(gen, stated.layers) for _ in range(checked)]
    (want_l, want_g, want_w), (got_l, got_g, got_w) = (
        blocked.train_steps(w0, spec, fed, seeds, cfg["optimizer"]["args"], spe)
        for spec in (stated, lower))
    with torch.no_grad():
        first = ref.forward_parts(w0, lower, *fed[0][:2], *fed[0][3:], seeds[0])
    first["pred"] = first["pred"][:shard]
    return {**correctness.train_gaps(got_l, want_l, got_g, want_g, got_w, want_w, w0),
            **shard_driver.stage_gaps(w0, stated, *fed[0][:2], *fed[0][3:], first, shard)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="control readings of a node-sharded cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--control-seeds", required=True)
    p.add_argument("--controls", default="tf32,fp8")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for kind in filter(None, args.controls.split(",")):
        for seed in control._seeds(args.control_seeds):
            t0 = time.perf_counter()
            c = control_checks(args.workload, seed, kind)
            print(json.dumps({"reading": f"control {kind}", "seed": seed,
                              "s": time.perf_counter() - t0, "checks": c,
                              "judged_correct": control.judged_correct(args.workload, c)}),
                  flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
