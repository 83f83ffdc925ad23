"""Build the port's native libraries from the sources in the checkout, at
first use, and load them with ctypes.

A library goes to `.build/gaot3d_tpu_torch/` and is rebuilt when any of its
sources is newer than it. The compiler writes to a temporary name that is
renamed into place, so concurrent processes never load a half-written file.
A failed build raises with the compiler's output: nothing falls back.
Libraries build independently of each other, so `build_together` can run one
compiler per source at the same time.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Sequence

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(REPO_ROOT, ".build", "gaot3d_tpu_torch")
CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")

# Hopper only: `sm_90a` keeps wgmma/setmaxnreg available to later kernels.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()  # guards the two dicts; each library has its own lock
_name_locks: Dict[str, threading.Lock] = {}
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH); the CUDA "
            "kernels are compiled from csrc/ at first use")
    return found


def _stale(lib_path: str, sources: Sequence[str]) -> bool:
    if not os.path.exists(lib_path):
        return True
    built = os.path.getmtime(lib_path)
    return any(os.path.getmtime(s) > built for s in sources)


def load_library(name: str, sources: Sequence[str],
                 command: Callable[[str], List[str]]) -> ctypes.CDLL:
    """Compile `sources` with `command(out_path)` into BUILD_DIR/lib{name}.so
    when stale, load it and cache the handle for the process."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name in _loaded:
            return _loaded[name]
        os.makedirs(BUILD_DIR, exist_ok=True)
        lib_path = os.path.join(BUILD_DIR, f"lib{name}.so")
        if _stale(lib_path, sources):
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(command(tmp), capture_output=True, text=True)
                with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
                    f.write(proc.stdout + proc.stderr)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"building {name} failed (rc {proc.returncode}):\n"
                        f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, lib_path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        lib = ctypes.CDLL(lib_path)
        _loaded[name] = lib
        return lib


def build_log(name: str) -> str:
    """The compiler output of the last build of `name` ('' if none)."""
    path = os.path.join(BUILD_DIR, f"{name}.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def load_cuda_library(name: str, source: str, headers: Sequence[str] = (),
                      defines: Sequence[str] = ()) -> ctypes.CDLL:
    """nvcc one csrc/ file with a plain C interface into a shared library;
    `headers` are the csrc/ files it includes (a newer one rebuilds it) and
    `defines` macros set on the command line (one source can build several
    libraries, each under its own name)."""
    src = os.path.join(CSRC_DIR, source)
    deps = [src] + [os.path.join(CSRC_DIR, h) for h in headers]
    flags = [f"-D{d}" for d in defines]
    return load_library(
        name, deps, lambda out: [find_nvcc(), *NVCC_FLAGS, *flags, "-o", out, src])


def build_together(loaders: Sequence[Callable[[], ctypes.CDLL]]) -> None:
    """Run the given library loaders at the same time, one thread (and so one
    compiler process) each; raises the first failure."""
    with ThreadPoolExecutor(max_workers=max(1, len(loaders))) as pool:
        for fut in [pool.submit(fn) for fn in loaders]:
            fut.result()
