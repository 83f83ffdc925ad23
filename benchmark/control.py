"""Readings that the limits of `correct` are set from (benchmark/limits/):
the program's numbers over many seeds, and the controls'. The benchmark's
own runs do not run this.

    python3 benchmark/control.py --workload drivaernet-train --program-seeds 1-12 \
        --control-seeds 101-103 --seconds 2 [--controls fp8,tf32,bf16_kernel,half_batch]

For each program seed the cell runs once in this process, with a window of
`--seconds`, and its numbers are printed. For each control seed the
reference is put in the program's place at a precision below the one the
configuration states and judged by the same numbers (correctness.py)
against the reference at the stated precision, on the cell's own meshes
and sizes:
  fp8          every operand the configuration states in bf16 (attention's
               q, k, v and probabilities; bf16 kernel MLPs) in float8 e4m3;
  tf32         every f32 product on TF32 operands;
  bf16_kernel  the kernel MLPs' operands in bf16 where the configuration
               states f32;
and, for a training cell, the fault
  half_batch   half of the batch's nodes left out of the loss, the mean
               taken over the rest.
A served cell compares `compare_requests` meshes of its ring, a training
cell the first `checked_steps` steps. One line of JSON a reading; a
control's line says whether the cell's limits would judge it correct.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import correctness, harness, program, traffic  # noqa: E402
from benchmark.reference import model as ref  # noqa: E402
from benchmark.reference import optim as ref_optim  # noqa: E402

# every number a run can give, whether or not a cell's limits hold it yet
NUMBERS = ("loss_gap", "grad_gap", "change_gap", "gno_gap", "enc_gap", "dec_gap", "pred_gap",
           "over_budget", "launches_off")


def _seeds(text: str) -> List[int]:
    out = []
    for part in filter(None, text.split(",")):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def _inputs(cell: str, seed: int, device, config_over=None, traffic_over=None):
    _, cfg, tr = harness.cell_parts(harness.load_benchmark(), cell)
    cfg, tr = harness.merge(cfg, config_over), harness.merge(tr, traffic_over)
    model = program.build_model(cfg, seed, device)
    w0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    return cfg, tr, w0


def control_checks(cell: str, seed: int, kind: str, device="cuda",
                   config_over: Optional[dict] = None,
                   traffic_over: Optional[dict] = None) -> Dict[str, float]:
    """The numbers of the reference at precision `kind` ('fp8', 'tf32' or
    'bf16_kernel'), or with the fault `kind` ('half_batch'), in the
    program's place, against the reference at the stated precision."""
    cfg, tr, w0 = _inputs(cell, seed, device, config_over, traffic_over)
    stated = ref.Spec.from_config(cfg)
    lower = ref.Spec.from_config(cfg)
    lower.control = kind
    nodes = int(cfg["nodes"])
    if tr["driver"] == "train_loop":
        checked = int(tr["checked_steps"])
        meshes = [traffic.make_mesh(nodes, seed, i, tr["surface"], device)
                  for i in range(checked)]
        fed = [(m.pos, m.feats, m.target, *ref.graph(stated, m.pos)) for m in meshes]
        spe = int(cfg["dataset"]["train_size"]) // int(cfg["dataset"]["batch_size"])
        gen = torch.Generator().manual_seed(traffic.stream_seed(seed, 3))
        seeds = [ref.layer_seeds(gen, stated.layers) for _ in range(checked)]
        (want_l, want_g, want_w), (got_l, got_g, got_w) = (
            ref_optim.train_steps(w0, spec, fed, seeds, cfg["optimizer"]["args"], spe)
            for spec in (stated, lower))
        with torch.no_grad():
            first = ref.forward_parts(w0, lower, *fed[0][:2], *fed[0][3:], seeds[0])
        return {**correctness.train_gaps(got_l, want_l, got_g, want_g, got_w, want_w, w0),
                **correctness.stage_gaps(w0, stated, *fed[0][:2], first, end_to_end=False)}
    readings = []
    for i in range(int(tr["compare_requests"])):
        m = traffic.make_mesh(nodes, seed, i % int(tr["meshes"]), tr["surface"], device)
        with torch.no_grad():
            got = ref.forward_parts(w0, lower, m.pos, m.feats, *ref.graph(stated, m.pos))
        readings.append(correctness.stage_gaps(w0, stated, m.pos, m.feats, got))
    return correctness.worst(readings)


def judged_correct(cell: str, checks: Dict[str, float]) -> bool:
    """Whether the cell's limits would pass these numbers; the numbers a
    control does not give (launches, the slot budget) count as met."""
    limits = correctness.load_limits(cell)
    return correctness.judge({**dict.fromkeys(limits, 0.0), **checks}, limits)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="readings for the limits of `correct`")
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--controls", default="fp8")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inf = dict.fromkeys(NUMBERS, float("inf"))
    for seed in _seeds(args.program_seeds):
        t0 = time.perf_counter()
        r = harness.run_cell(args.workload, seed, args.seconds, False, "cuda", limits=inf)
        print(json.dumps({"reading": "program", "seed": seed, "s": time.perf_counter() - t0,
                          "checks": {k: v["value"] for k, v in r["checks"].items()},
                          "metrics": {k: v["value"] for k, v in r["metrics"].items()}}),
              flush=True)
    for kind in filter(None, args.controls.split(",")):
        for seed in _seeds(args.control_seeds):
            t0 = time.perf_counter()
            c = control_checks(args.workload, seed, kind)
            print(json.dumps({"reading": f"control {kind}", "seed": seed,
                              "s": time.perf_counter() - t0, "checks": c,
                              "judged_correct": judged_correct(args.workload, c)}),
                  flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
