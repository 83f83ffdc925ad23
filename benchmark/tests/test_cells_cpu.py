"""Each cell through the harness, as run.py drives it, at a tiny size on the
CPU with the port's plain versions."""
import math
import os
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import SEED, TINY, TRAFFIC

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(cell, trace):
    torch.set_num_threads(4)
    r = harness.run_cell(cell, SEED, 1.0, trace, "cpu", config_over=TINY,
                         traffic_over=TRAFFIC[cell])
    assert list(r)[-1] == "checks"
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    bench = harness.load_benchmark()
    if trace:
        # on the CPU no device metric is reported
        assert not r["metrics"]
        assert r["device"]["busy_s"] == 0.0 and r["device"]["window_s"] > 0
        assert len(r["breakdown"]["device_ops"]) <= 10
    else:
        want = {m["name"] for m in bench["end_to_end"]
                if cell in m.get("workloads", [cell])}
        assert set(r["metrics"]) == want
        assert all(math.isfinite(m["value"]) and m["value"] > 0 for m in r["metrics"].values())
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]


def test_same_seed_same_inputs():
    from benchmark import traffic
    a = traffic.make_mesh(1000, SEED, 3, {"bump": 0.3, "frequencies": [3, 2], "jitter": 0.1},
                          "cpu")
    b = traffic.make_mesh(1000, SEED, 3, {"bump": 0.3, "frequencies": [3, 2], "jitter": 0.1},
                          "cpu")
    c = traffic.make_mesh(1000, SEED + 1, 3, {"bump": 0.3, "frequencies": [3, 2], "jitter": 0.1},
                          "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a.pos, c.pos)
    assert float(a.pos.min()) == -1.0 and float(a.pos.max()) == 1.0


def test_run_py_refuses_without_cuda(tmp_path):
    """Without a card run.py exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
                           CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert not proc.stdout.strip()


def test_run_py_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, run.py exits non-zero and prints no result."""
    import shutil
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode != 0
    assert not proc.stdout.strip() or not proc.stdout.strip().splitlines()[-1].startswith("{")
