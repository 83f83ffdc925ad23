"""The import check: run.py's comparison of top-level module names, and what
the harness and the reference load."""
import os
import subprocess
import sys
import types

from benchmark import harness
from benchmark import run as run_py


def test_top_level_names_compared_whole(monkeypatch):
    base = run_py.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gaot3d_tpu_torch_like", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping_like", types.ModuleType("x"))
    assert run_py.forbidden_modules() == base
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert "jax" in run_py.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gaot3d_tpu.models", types.ModuleType("x"))
    assert "gaot3d_tpu" in run_py.forbidden_modules()


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         capture_output=True, text=True, timeout=600, cwd=harness.ROOT,
                         check=True).stdout.strip().splitlines()[-1]
    return set(eval(out))


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "import torch; torch.set_num_threads(2)\n"
            "from benchmark import harness\n"
            "from benchmark.tests.tiny import TINY\n"
            "harness.run_cell('drivaerml-serve', 3, 0.5, True, 'cpu', config_over=TINY)\n")
    loaded = _loaded(code)
    assert "gaot3d_tpu_torch" in loaded
    assert not loaded & set(run_py.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from benchmark.reference import graph, model, optim, philox\n"
            "from benchmark import correctness, counting, peaks, traffic\n")
    loaded = _loaded(code)
    assert "gaot3d_tpu_torch" not in loaded and not loaded & set(run_py.FORBIDDEN)
    src = os.path.join(harness.HERE, "reference")
    for name in os.listdir(src):
        if name.endswith(".py"):
            with open(os.path.join(src, name)) as f:
                assert "gaot3d_tpu" not in f.read(), name
