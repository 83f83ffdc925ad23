"""A cell added as files in a copy of the benchmark is found by its names,
with no edit to a file that is there: here drivaernet-pressure served over
host-built sections, from the traffic and limits that the set-aside
drivaernet-serve cell left."""
import json
import os
import shutil
import subprocess
import sys

from benchmark import harness


def test_a_new_workload_is_found_without_an_edit(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "drivaernet-serve-ring2", "config": "drivaernet-pressure",
                               "traffic": "serve-ring2", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if "drivaerml-serve" in m.get("workloads", []):
            m["workloads"].append("drivaernet-serve-ring2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((tmp_path / "benchmark/traffic/serve-ring16.json").read_text())
    traffic.update(meshes=2, compare_requests=1)
    (tmp_path / "benchmark/traffic/serve-ring2.json").write_text(json.dumps(traffic))
    shutil.copy(tmp_path / "benchmark/limits/drivaernet-serve.json",
                tmp_path / "benchmark/limits/drivaernet-serve-ring2.json")
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); sys.path.append(sys.argv[2])\n"
            "import torch; torch.set_num_threads(2)\n"
            "from benchmark import harness\n"
            "from benchmark.tests.tiny import TINY\n"
            "assert harness.HERE.startswith(sys.argv[1])\n"
            "r = harness.run_cell('drivaernet-serve-ring2', 5, 0.5, False, 'cpu', "
            "root=sys.argv[1], config_over=TINY)\n"
            "print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path), harness.ROOT],
                         capture_output=True, text=True, timeout=600, check=True)
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and set(r["metrics"]) == {"setup_s", "requests_per_s",
                                                   "request_ms_p90"}
