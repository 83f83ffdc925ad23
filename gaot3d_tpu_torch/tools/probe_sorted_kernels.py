"""Where the time of K6 (sorted segment sum), K7 (prefix sum) and K8 (tile
segment sum) goes on the card, and the settings their design set aside.

- Timelines: each kernel is built once more from the source in the checkout
  with a stamp of `%globaltimer`, taken by thread 0 of every CTA (K6, K8) or
  of every block of rows (K7) where each of the steps named in the source's
  comments begins and where the last ends, and run at the main path's shapes
  (`chip_smoke.py` `[k6]`, `[k7]`, `[k8]`; K6's ids drawn like chunk 0 of the
  recipe's 'dst' list: 155,765 of 163,840 rows onto 131,072 cells). Printed:
  when each step ends, in us from the first CTA's start, as percentiles 0 /
  50 / 100 over the CTAs or blocks, and each step's length.
- Settings: K7 with tiles of 8 and of 16 rows (the rows of a tile are an
  argument of the kernel; only `tile_rows(C)` gives the ordered twin's
  bits), K8 with parts of other sizes (a copy with other constants), K6 with
  other shares (an argument of the kernel) and other CTA sizes (a copy);
  each as 20 launches between two CUDA events, in turns (A B ... B A).

    python -m gaot3d_tpu_torch.tools.probe_sorted_kernels

NVIDIA GPU only. A patch that no longer matches its source raises.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gaot3d_tpu_torch.kernels import prefix_sum as k7
from gaot3d_tpu_torch.kernels import segment_sum_sorted as k6
from gaot3d_tpu_torch.kernels import tile_segment_sum as k8
from gaot3d_tpu_torch.kernels.build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, find_nvcc
from gaot3d_tpu_torch.ops.segment import make_tile_fold

K7_SHAPES = [(163_840, 43), (327_680, 43), (163_840, 32)]
# the [k8] chunk: 327,680 slots, about 156,000 of them valid, onto 131,072 cells
K8_SLOTS, K8_CELLS, K8_VALID = 327_680, 131_072, 0.475
# the [k6] chunk: 163,840 rows of the 'dst' list, 155,765 of them valid
K6_ROWS, K6_VALID = 163_840, 155_765
LAUNCHES = 20

_STAMP = ("{ if (threadIdx.x == 0) { unsigned long long g; "
          "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g)); tl[(IDX) * 8 + (k)] = g; } }")
_GLOBAL = ("unsigned long long* g_timeline = nullptr;\n"
           "extern \"C\" void gaot_set_timeline(void* p) {\n"
           "  g_timeline = static_cast<unsigned long long*>(p);\n}\n\nextern \"C\" {")

# kernel: (source, index of a stamp's row, [(old, new)], the steps' names)
TIMELINES: Dict[str, Tuple[str, str, List[Tuple[str, str]], List[str]]] = {
    "prefix_sum": ("prefix_sum.cu", "w", [
        ("int aligned) {", "int aligned, unsigned long long* tl) {"),
        ("    // 1. the block's rows into shared memory", "    TL(0);\n    // 1. the block's"
         " rows into shared memory"),
        ("    // 2. each column of each tile", "    TL(1);\n    // 2. each column of each tile"),
        ("    // 3. level 1:", "    TL(2);\n    // 3. level 1:"),
        ("    // levels 2..K:", "    TL(3);\n    // levels 2..K:"),
        ("    // 4. the block's offset", "    TL(4);\n    // 4. the block's offset"),
        ("    // 5. the block's rows written once", "    TL(5);\n    // 5. the block's rows"
         " written once"),
        ("        out[(row0 + r) * p.C + c0 + c] = tile[e];\n      }\n    }\n",
         "        out[(row0 + r) * p.C + c0 + c] = tile[e];\n      }\n    }\n    TL(6);\n"),
        ("&aligned};", "&aligned, &g_timeline};"),
        ("\nextern \"C\" {", "\n" + _GLOBAL),
    ], ["load", "totals", "level 1", "levels 2..K", "offsets, rows", "store issued"]),
    "tile_segment_sum": ("tile_segment_sum.cu", "blockIdx.x", [
        ("const Shape sh) {", "const Shape sh, unsigned long long* tl) {\n  TL(0);"),
        ("  // 2-3. the part's rows", "  TL(1);\n  // 2-3. the part's rows"),
        ("  // 4. the empty segments' zeros", "  TL(2);\n  // 4. the empty segments' zeros"),
        ("    if (start[k] == start[k + 1]) dst[f] = 0.f;\n  }\n}",
         "    if (start[k] == start[k + 1]) dst[f] = 0.f;\n  }\n  TL(3);\n}"),
        ("      sh);\n  return (int)cudaGetLastError();",
         "      sh, g_timeline);\n  return (int)cudaGetLastError();"),
        ("\nextern \"C\" {", "\n" + _GLOBAL),
    ], ["first rows", "rows staged and added", "zeros"]),
    "segment_sum_sorted": ("segment_sum_sorted.cu", "blockIdx.x", [
        ("const Shape sh) {", "const Shape sh, unsigned long long* tl) {\n  TL(0);"),
        ("  // 2. the window's ids", "  TL(1);\n  // 2. the window's ids"),
        ("  // 3. the rows [a, a + n)", "  TL(2);\n  // 3. the rows [a, a + n)"),
        ("  // 4. thread f adds output", "  TL(3);\n  // 4. thread f adds output"),
        ("      dst[(size_t)(nseg - 1) * P + c] = sum;\n    }\n  }\n}",
         "      dst[(size_t)(nseg - 1) * P + c] = sum;\n    }\n  }\n  TL(4);\n}"),
        ("      sh);\n  return (int)cudaGetLastError();",
         "      sh, g_timeline);\n  return (int)cudaGetLastError();"),
        ("\nextern \"C\" {", "\n" + _GLOBAL),
    ], ["search", "ids window, split", "rows landed", "adds and stores"]),
}

# K8 settings: name -> constants of csrc/tile_segment_sum.cu that differ
K8_SETTINGS: Dict[str, Dict[str, int]] = {
    "parts of 47 segments (shipped)": {},
    "parts of 128 segments": {"PART_OUTPUTS": 5504, "CHUNK_FLOATS": 8192},
    "parts of 23 segments": {"PART_OUTPUTS": 1024, "CHUNK_FLOATS": 2048},
    "128-thread CTAs": {"THREADS": 128, "CTAS_PER_SM": 13, "CHUNK_FLOATS": 3072,
                        "IDS_PER_THREAD": 8},
}


def _read(name: str) -> str:
    with open(os.path.join(CSRC_DIR, name)) as f:
        return f.read()


def _patch(src: str, subs: List[Tuple[str, str]], what: str) -> str:
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"{what}: {old[:50]!r} no longer matches the source once")
        src = src.replace(old, new)
    return src


def timeline_source(kernel: str) -> str:
    """The kernel's source with a stamp at each step, a timeline pointer
    argument and `gaot_set_timeline` to set it."""
    source, index, subs, _ = TIMELINES[kernel]
    stamp = "#define TL(k) " + _STAMP.replace("IDX", index) + "\n"
    src = _patch(_read(source), subs, kernel)
    return src.replace("namespace {", stamp + "namespace {", 1)


# K6 settings: name -> (constants of csrc/segment_sum_sorted.cu that differ,
# items a share, None for the wrapper's share_items(43))
K6_SETTINGS: Dict[str, Tuple[Dict[str, int], Optional[int]]] = {
    "shares of 190 items, 6 CTAs an SM (shipped)": ({}, None),
    "shares of 142 items, 8 CTAs an SM at 32 registers": ({"CTAS_PER_SM": 8}, 142),
    "shares of 142 items, 6 CTAs an SM": ({}, 142),
    "shares of 285 items, 4 CTAs an SM": ({"CTAS_PER_SM": 4}, 285),
    "128-thread CTAs, 12 an SM, shares of 95 items": ({"THREADS": 128, "CTAS_PER_SM": 12}, 95),
}


def setting_source(source: str, constants: Dict[str, int]) -> str:
    """The kernel source `source` (a file of csrc/) with other constants."""
    src = _read(source)
    for name, value in constants.items():
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"{source} has no constant {name}")
    return src


def variant_sources() -> Dict[str, str]:
    """Every source the probe builds, by name."""
    out = {f"{k}_timeline": timeline_source(k) for k in TIMELINES}
    for i, constants in enumerate(K8_SETTINGS.values()):
        out[f"k8_setting_{i}"] = setting_source("tile_segment_sum.cu", constants)
    for i, (constants, _) in enumerate(K6_SETTINGS.values()):
        out[f"k6_setting_{i}"] = setting_source("segment_sum_sorted.cu", constants)
    return out


def _build(name: str, src: str) -> ctypes.CDLL:
    folder = os.path.join(BUILD_DIR, "probe_sorted")
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib_path = os.path.join(folder, f"lib{name}.so")
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", lib_path, path],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {name} failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    if hasattr(lib, "gaot_segment_sum_sorted"):
        lib.gaot_segment_sum_sorted.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                                                + [ctypes.c_void_p])
    elif hasattr(lib, "gaot_prefix_sum"):
        lib.gaot_prefix_sum.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                                        + [ctypes.c_int] * 3 + [ctypes.c_uint, ctypes.c_void_p])
        lib.gaot_prefix_sum_scratch_bytes.restype = ctypes.c_longlong
        lib.gaot_prefix_sum_scratch_bytes.argtypes = [ctypes.c_longlong, ctypes.c_int,
                                                      ctypes.c_int]
    else:
        lib.gaot_tile_segment_sum.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
    return lib


def _events_ms(fn) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(LAUNCHES):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / LAUNCHES


def _k7_launcher(lib, x: torch.Tensor, out: torch.Tensor, R: int):
    E, C = x.shape
    scratch = torch.zeros(lib.gaot_prefix_sum_scratch_bytes(E, C, R) + 16, dtype=torch.uint8,
                          device="cuda")
    stream, epoch = torch.cuda.current_stream().cuda_stream, [0]

    def launch():
        epoch[0] += 1
        if lib.gaot_prefix_sum(x.data_ptr(), out.data_ptr(), scratch.data_ptr(), E, C, R,
                               k7.SCAN_RADIX, epoch[0], stream):
            raise RuntimeError("K7 launch failed")
    return launch


def _k8_launcher(lib, rows: torch.Tensor, fold, out: torch.Tensor):
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        if lib.gaot_tile_segment_sum(rows.data_ptr(), fold.sorted_seg.data_ptr(),
                                     fold.perm.data_ptr(), fold.ts.data_ptr(), out.data_ptr(),
                                     rows.shape[1], out.shape[0], 512, stream):
            raise RuntimeError("K8 launch failed")
    return launch


def _k6_launcher(lib, data: torch.Tensor, ids: torch.Tensor, out: torch.Tensor, share: int):
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        if lib.gaot_segment_sum_sorted(data.data_ptr(), ids.data_ptr(), out.data_ptr(), 1,
                                       data.shape[0], data.shape[1], out.shape[0], share,
                                       stream):
            raise RuntimeError("K6 launch failed")
    return launch


def _print_timeline(label: str, stamps: np.ndarray, steps: List[str]) -> None:
    t = (stamps.astype(np.float64) - stamps[:, 0].min()) / 1e3
    print(f"[probe] {label}: {t.shape[0]} rows of stamps; us from the first start, "
          f"p0 / p50 / p100, and each step's median / max")
    for k, name in enumerate(steps):
        d = t[:, k + 1] - t[:, k]
        print(f"[probe]   {name:24s} ends {np.percentile(t[:, k + 1], 0):7.2f} "
              f"{np.median(t[:, k + 1]):7.2f} {t[:, k + 1].max():7.2f}; takes "
              f"{np.median(d):6.2f} / {d.max():6.2f}")


def _k6_input():
    rng = np.random.default_rng(1)
    ids = np.full(K6_ROWS, K8_CELLS, np.int32)
    ids[:K6_VALID] = np.sort(rng.integers(0, K8_CELLS, K6_VALID))
    return torch.randn(K6_ROWS, 43, device="cuda"), torch.from_numpy(ids).cuda()


def _k8_input():
    rng = np.random.default_rng(0)
    lat = torch.from_numpy(rng.integers(0, K8_CELLS, K8_SLOTS).astype(np.int32)).cuda()
    mask = torch.from_numpy(rng.random(K8_SLOTS) < K8_VALID).cuda()
    fold = make_tile_fold(lat, K8_CELLS, mask)
    rows = torch.randn(K8_SLOTS, 43, device="cuda")
    return rows, fold


def run() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("probe_sorted_kernels needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[probe] {card.strip()}")
    libs = {name: _build(name, src) for name, src in variant_sources().items()}

    # timelines
    lib = libs["prefix_sum_timeline"]
    for E, C in K7_SHAPES:
        x = torch.randn(E, C, device="cuda")
        R = k7.tile_rows(C)
        out = torch.empty_like(x)
        blocks = -(-E // (R * k7.SCAN_RADIX))
        tl = torch.zeros((blocks, 8), dtype=torch.int64, device="cuda")
        lib.gaot_set_timeline(ctypes.c_void_p(tl.data_ptr()))
        launch = _k7_launcher(lib, x, out, R)
        for _ in range(3):
            launch()
        torch.cuda.synchronize()
        if not torch.equal(out, k7.prefix_sum_ordered_reference(x)):
            raise RuntimeError("the stamped K7 lost its twin's bits")
        _print_timeline(f"K7 [{E}, {C}], tiles of {R} rows, {blocks} blocks",
                        tl[:, :7].cpu().numpy(), TIMELINES["prefix_sum"][3])
    rows, fold = _k8_input()
    twin = k8.tile_segment_sum_ordered_reference(rows, fold.sorted_seg, fold.ts, K8_CELLS,
                                                 fold.perm)
    lib = libs["tile_segment_sum_timeline"]
    out = torch.empty((K8_CELLS, 43), device="cuda")
    tl = torch.zeros((1 << 16, 8), dtype=torch.int64, device="cuda")
    lib.gaot_set_timeline(ctypes.c_void_p(tl.data_ptr()))
    _k8_launcher(lib, rows, fold, out)()
    torch.cuda.synchronize()
    if not torch.equal(out, twin):
        raise RuntimeError("the stamped K8 lost its twin's bits")
    used = tl[:, 3] > 0  # the CTAs that owned segments
    _print_timeline(f"K8 {K8_SLOTS} slots onto [{K8_CELLS}, 43]", tl[used][:, :4].cpu().numpy(),
                    TIMELINES["tile_segment_sum"][3])
    data, ids = _k6_input()
    k6_twin = {share: k6.segment_sum_sorted_ordered_reference(data, ids, K8_CELLS, share)
               for share in {s or k6.share_items(43) for _, s in K6_SETTINGS.values()}}
    share = k6.share_items(43)
    out = torch.empty((K8_CELLS, 43), device="cuda")
    tl = torch.zeros((-(-(K6_ROWS + K8_CELLS) // share), 8), dtype=torch.int64, device="cuda")
    lib = libs["segment_sum_sorted_timeline"]
    lib.gaot_set_timeline(ctypes.c_void_p(tl.data_ptr()))
    _k6_launcher(lib, data, ids, out, share)()
    torch.cuda.synchronize()
    if not torch.equal(out, k6_twin[share]):
        raise RuntimeError("the stamped K6 lost its twin's bits")
    used = tl[:, 4] > 0  # the CTAs that owned segments
    _print_timeline(f"K6 [{K6_ROWS}, 43] ({K6_VALID} valid rows) onto [{K8_CELLS}, 43], "
                    f"shares of {share} items", tl[used][:, :5].cpu().numpy(),
                    TIMELINES["segment_sum_sorted"][3])

    # settings, in turns
    for E, C in K7_SHAPES:
        x = torch.randn(E, C, device="cuda")
        out = torch.empty_like(x)
        runs = [(f"tiles of {R} rows", _k7_launcher(k7._library(), x, out, R)) for R in (8, 16)]
        times = {name: [] for name, _ in runs}
        for name, launch in runs + runs[::-1]:
            times[name].append(_events_ms(launch))
        print(f"[probe] K7 [{E}, {C}], ms a launch (tile_rows gives {k7.tile_rows(C)}): "
              + "; ".join(f"{n} {a:.4f} {b:.4f}" for n, (a, b) in times.items()))
    out = torch.empty((K8_CELLS, 43), device="cuda")
    runs = []
    for i, name in enumerate(K8_SETTINGS):
        runs.append((name, _k8_launcher(libs[f"k8_setting_{i}"], rows, fold, out)))
    times = {name: [] for name, _ in runs}
    for name, launch in runs + runs[::-1]:
        times[name].append(_events_ms(launch))
        torch.cuda.synchronize()
        if not torch.equal(out, twin):
            raise RuntimeError(f"K8 with {name} lost its twin's bits")
    print("[probe] K8 at the [k8] shape, ms a launch: "
          + "; ".join(f"{n} {a:.4f} {b:.4f}" for n, (a, b) in times.items()))
    out = torch.empty((K8_CELLS, 43), device="cuda")
    runs = []
    for i, (name, (_, share)) in enumerate(K6_SETTINGS.items()):
        share = share or k6.share_items(43)
        runs.append((name, share, _k6_launcher(libs[f"k6_setting_{i}"], data, ids, out, share)))
    times = {name: [] for name, _, _ in runs}
    for name, share, launch in runs + runs[::-1]:
        times[name].append(_events_ms(launch))
        torch.cuda.synchronize()
        if not torch.equal(out, k6_twin[share]):
            raise RuntimeError(f"K6 with {name} lost its twin's bits")
    print("[probe] K6 at the [k6] shape, ms a launch: "
          + "; ".join(f"{n} {a:.4f} {b:.4f}" for n, (a, b) in times.items()))


if __name__ == "__main__":
    run()
