"""Elementwise bf16 probe: does bf16, packed two to a register, run the
softmax/dropout kind of elementwise chain at twice the f32 rate on this card?

The port of tools/microbench_vpu_bf16.py (T1). It times the same chains on a
[512, 1024] block in f32 and in bf16 through the hand-written kernel
`csrc/elementwise_chain.cu`:

  - 'exp chain'    : acc = exp(acc * 0.9) - acc
  - 'select chain' : acc = where(acc > 0.9, acc * 1.111, acc + 0.9)

`reps` unrolled repetitions a launch, the block redone `grid` times, so a
launch is 524,288 * reps * grid element-steps. Runs on an NVIDIA GPU only:

    python -m gaot3d_tpu_torch.tools.microbench_vpu_bf16 [reps_in_kernel] [grid]
"""
from __future__ import annotations

import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from gaot3d_tpu_torch.kernels.elementwise_chain import CHAINS, elementwise_chain

BLOCK = (512, 1024)
STEPS = 6


def run(reps: int = 64, grid: int = 64, steps: int = STEPS) -> Dict[str, Dict[str, float]]:
    """Time every chain in f32 and bf16 on card 0 and print T1's lines;
    returns {"<chain> <dtype>": {"ms", "gelem_s"}} with "speedup" (f32 time
    over bf16 time) on the bf16 entries. Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("microbench_vpu_bf16 needs an NVIDIA GPU: its kernel has no CPU mode")
    elems = BLOCK[0] * BLOCK[1] * reps * grid
    x32 = torch.from_numpy(np.random.default_rng(0).standard_normal(BLOCK, dtype=np.float32))
    results = {}
    for chain in CHAINS:
        base = None
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to("cuda", dtype)
            float(elementwise_chain(x, chain, reps, grid).float().sum())  # build + warm
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(steps):
                elementwise_chain(x, chain, reps, grid)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / steps / 1e3
            rate = elems / dt / 1e9
            name = str(dtype).split(".")[1]
            tag = f"{chain:6s} {name:8s}"
            entry = {"ms": dt * 1e3, "gelem_s": rate}
            if base is None:
                base = dt
                print(f"{tag} {dt*1e3:8.2f} ms  {rate:7.1f} Gelem/s")
            else:
                entry["speedup"] = base / dt
                print(f"{tag} {dt*1e3:8.2f} ms  {rate:7.1f} Gelem/s "
                      f"({base/dt:.2f}x vs f32)")
            results[f"{chain} {name}"] = entry
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    reps = int(argv[0]) if len(argv) > 0 else 64
    grid = int(argv[1]) if len(argv) > 1 else 64
    run(reps, grid)
    return 0


if __name__ == "__main__":
    sys.exit(main())
