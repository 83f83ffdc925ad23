"""Runs one cell: finds its configuration, traffic, driver, limits and
metric readers by the names in BENCHMARK.json, runs the driver, and builds
the result line.

Files, each found by a name in BENCHMARK.json:
  configs/<config>.json      the configuration as it is run (the `file` of
                             its entry);
  traffic/<traffic>.json     the traffic mix: its driver and parameters;
  drivers/<driver>.py        `run(ctx) -> Outcome`, one per kind of loop;
  limits/<cell>.json         the limit of each number that decides `correct`;
  metrics/<metric>.py        `read(record) -> float | None`, one per
                             per-layer metric (`reader` lets one file read
                             as another does).

A driver returns each end-to-end quantity under its own name; a metric
`<name>.<group>` of BENCHMARK.json, which gives a group of cells bounds of
its own, reports the quantity `<name>`.
"""
from __future__ import annotations

import copy
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from . import correctness
from .trace import DeviceTimer, Spans, Trace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class RunRecord:
    """What a run leaves for the per-layer metric readers."""
    cell: str
    config: dict
    device: str
    items: int = 0             # steps or requests completed in the window
    window_s: float = 0.0      # seconds of the measured window
    spans: Spans = field(default_factory=Spans)
    forward: Optional[DeviceTimer] = None
    trace: Optional[Trace] = None
    counts: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Context:
    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float             # process start, seconds since the epoch
    setup_s: Optional[float] = None

    def setup_done(self) -> None:
        """Call right before the first timed step or request."""
        self.setup_s = time.time() - self.t_start
        log(f"set-up done: {self.setup_s:.2f} s since the process started")


@dataclass
class Outcome:
    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, float]
    record: RunRecord
    memory_peak_bytes: int


def log(msg: str) -> None:
    """A progress line on standard error, with the seconds since import."""
    print(f"[bench {time.perf_counter() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


_T0 = time.perf_counter()


def merge(base: dict, over: Optional[dict]) -> dict:
    """`base` with the keys of `over` put in, nested dicts merged."""
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        out[k] = merge(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The `read` of metrics/<metric>.py."""
    return load_module(os.path.join(HERE, "metrics", f"{metric}.py"),
                       "benchmark_metric_" + metric.replace(".", "_")).read


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_parts(bench: dict, cell: str, root: str = ROOT):
    """(workload entry, configuration dict, traffic dict) of a cell."""
    work = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if work is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", f"{work['traffic']}.json")) as f:
        traffic = json.load(f)
    return work, config, traffic


def _per_layer_applies(metric: dict, cell: str, reported: set) -> bool:
    """A per-layer metric reads in the cells it lists, or without a list in
    every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in reported


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, root: str = ROOT,
             config_over: Optional[dict] = None, traffic_over: Optional[dict] = None,
             limits: Optional[Dict[str, float]] = None) -> dict:
    """Run `cell` once and return its result dict (the last line's object)."""
    bench = load_benchmark(root)
    work, config, traffic = cell_parts(bench, cell, root)
    config, traffic = merge(config, config_over), merge(traffic, traffic_over)
    limits = correctness.load_limits(cell) if limits is None else limits
    ctx = Context(cell, config, traffic, int(seed), float(seconds), bool(trace), device,
                  time.time() if t_start is None else t_start)
    driver = load_module(os.path.join(HERE, "drivers", f"{traffic['driver']}.py"),
                         f"benchmark_driver_{traffic['driver']}")
    out: Outcome = driver.run(ctx)

    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    reported = {m["name"] for m in e2e}
    if not trace:
        values = {m["name"]: (ctx.setup_s if m["name"] == "setup_s"
                              else out.e2e[m["name"].split(".")[0]]) for m in e2e}
        units = {m["name"]: m["unit"] for m in e2e}
    else:
        values, units = {}, {}
        for m in bench["per_layer"]:
            if not _per_layer_applies(m, cell, reported):
                continue
            v = reader(m["name"])(out.record)
            if v is not None:
                values[m["name"]], units[m["name"]] = float(v), m["unit"]
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(work["chips"]), "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": bool(correctness.judge(out.checks, limits) and out.failed == 0),
              "attempted": int(out.attempted), "failed": int(out.failed),
              "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()},
              "device": dev}
    tr = out.record.trace
    if trace and tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    checks = {k: out.checks.get(k, float("nan")) for k in limits}
    result["checks"] = {k: {"value": v if math.isfinite(v) else None, "limit": limits[k]}
                        for k, v in checks.items()}
    return result
