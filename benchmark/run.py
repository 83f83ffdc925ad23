"""Run one cell of the benchmark of gaot3d_tpu_torch once, on the machine it
is started on, and print its result as the last line of standard output.

    python3 benchmark/run.py --workload drivaernet-train --seed 7 --seconds 30 --trace 0

`--trace 0` prints the cell's end-to-end metrics, `--trace 1` its per-layer
metrics (the window's spans, and a torch.profiler session over the traffic's
`trace_items` steps or requests after the window). The numbers that decide
`correct` are printed beside their limits as the last lines of standard
error and under "checks" in the result line. The run needs CUDA and as many
cards as the cell asks for; without them, or if jax, jaxlib, flax, optax or
gaot3d_tpu were loaded by the time the window closed, it exits with a
non-zero code and prints no result.
"""
import argparse
import json
import os
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gaot3d_tpu")


def process_start() -> float:
    """This process's start, in seconds since the epoch (Linux /proc)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    t_start = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch

    from benchmark import harness

    chips = next((w["chips"] for w in harness.load_benchmark(root)["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              "cuda", t_start=t_start, root=root)
    found = forbidden_modules()
    if found:
        print(f"modules that the benchmark may not load were loaded: {found}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
