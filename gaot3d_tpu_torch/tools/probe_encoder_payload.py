"""Where the encoder payload kernels' time goes, and the alternatives their
design set aside, measured on the card.

Builds variants of K5 (`csrc/encoder_payload.cu`) and K5b
(`csrc/encoder_payload_bwd.cu`) from the sources in the checkout: each is a
copy of the kernel and of `csrc/encoder_tiles.cuh` with one text
substitution (the table below), built for the recipe's widths only. Each is
timed on the five degree sections of a 524,288-point cloud, the recipe of
`chip_smoke.py` `[k5]` (uniform points, 64x64x32 grid, radius 0.033, slot
budget 5, sections at chunk 65,536, the 6-64-64-64-32 kernel MLP), as the
five launches between two CUDA events, median of 7, and held against the
shipped kernel. A probe of back-to-back TF32 `mma.sync` gives the rate the
kernels' product instruction reaches on this card.

    python -m gaot3d_tpu_torch.tools.probe_encoder_payload

NVIDIA GPU only. A variant that no longer matches its source raises.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np
import torch

from gaot3d_tpu_torch.data.host_graph import build_edge_slots_host, section_slots_by_degree_np
from gaot3d_tpu_torch.kernels import encoder_payload as k5
from gaot3d_tpu_torch.kernels.build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, find_nvcc
from gaot3d_tpu_torch.ops.grid_graph import LatentGrid

N_POINTS, LATENT, RADIUS, BUDGET, CHUNK, C = 524_288, (64, 64, 32), 0.033, 5, 65_536, 32
REPS = 7

_SPLIT = ("  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
          "  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;")
_CVT = ('  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));\n'
        '  const float rest = x - __uint_as_float(hi);\n'
        '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));')
_ONE_PASS = ("  mma_tf32(d, al, bh[0], bh[1]);\n  mma_tf32(d, ah, bl[0], bl[1]);\n", "")
_DST = "float* dst = acc + (long long)arow * (C + 11);"
_VEC = "const bool vec = (reinterpret_cast<uintptr_t>(dst) & 7) == 0;"

# name: (kernel, [(old, new) in the kernel source], [(old, new) in encoder_tiles.cuh], what)
VARIANTS: Dict[str, Tuple[str, List[Tuple[str, str]], List[Tuple[str, str]], str]] = {
    "k5": ("fwd", [], [], "as shipped"),
    "k5_scalar_red": ("fwd", [(_VEC, "const bool vec = false;")], [],
                      "every column a scalar red, no v2"),
    "k5_padded_48": ("fwd", [(_DST, "float* dst = acc + (long long)arow * 48;"),
                             (_VEC, "const bool vec = true;")], [],
                     "into a zeroed [B, M, 48] scratch, all pairs v2, then added into acc, "
                     "each launch"),
    "k5_no_scatter": ("fwd", [("if (arow < 0) continue;",
                               "if (arow >= -1 && o[0][0] != 1.2345e30f) continue;")], [],
                      "the MLP without the scatter"),
    "k5_cvt_split": ("fwd", [], [(_SPLIT, _CVT)], "the split by cvt.rna.tf32.f32"),
    "k5_one_pass": ("fwd", [], [_ONE_PASS], "hi*hi only (wrong numerics: cost of 3 passes)"),
    "k5b": ("bwd", [], [], "as shipped"),
    "k5b_cvt_split": ("bwd", [], [(_SPLIT, _CVT)], "the split by cvt.rna.tf32.f32"),
    "k5b_no_weight_products": ("bwd", [
        ("wgrad<Mat<HID>, Mat<C>, HID / 16, C / 8, true>(z_of(NMID), F, dwl, dbl, warp, lane);", ";"),
        ("wgrad<Mat<HID>, Mat<HID>, HID / 16, HID / 8, true>(z_of(l - 1), z_of(l), dwm[l - 1],\n"
         "                                                         dbm[l - 1], warp, lane);", ";"),
        ("wgrad<Mat<HID>, X0, HID / 16, 1, false>(z_of(0), x0_of(s), dw0, db0, warp, lane);", ";")],
        [], "no dW, db products"),
    "k5b_no_gelu_grad": ("bwd", [("      gelu_and_grad(z.x, h0, gp0);\n      gelu_and_grad(z.y, h1, gp1);",
                                  "      h0 = z.x; gp0 = 1.f; h1 = z.y; gp1 = 1.f;")], [],
                         "gelu and gelu' in the backward replaced by z and 1"),
    "k5b_one_pass": ("bwd", [], [_ONE_PASS], "hi*hi only (wrong numerics: cost of 3 passes)"),
}

MMA_PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
extern "C" __global__ void probe(float* out, int iters) {
  float d[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u}, b0 = threadIdx.x * 3u, b1 = 7u;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                   "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                   : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run_probe(float* out, int blocks, int threads, int iters) {
  probe<<<blocks, threads>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def _recipe_only(kind: str, src: str) -> str:
    """Keep the recipe's instantiation only: the build takes seconds, not a minute."""
    if kind == "fwd":
        out = re.sub(r"#define GAOT_K5_WIDTHS\(X\)[^\n]*\n", "#define GAOT_K5_WIDTHS(X) X(64, 32)\n",
                     src)
    else:
        out = re.sub(r"#define GAOT_K5B_VARIANTS\(X\)(?:[^\n]*\\\n)*[^\n]*\n",
                     "#define GAOT_K5B_VARIANTS(X) X(64, 32, 2)\n", src)
    if out == src:
        raise RuntimeError(f"the {kind} source no longer has its width list")
    return out


def _build(name: str, source: str, tiles: str, file: str) -> ctypes.CDLL:
    d = os.path.join(BUILD_DIR, "probe_encoder_payload", name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "encoder_tiles.cuh"), "w") as f:
        f.write(tiles)
    with open(os.path.join(d, file), "w") as f:
        f.write(source)
    so = os.path.join(d, f"lib{name}.so")
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", so, os.path.join(d, file)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {name} failed:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(so)


def _read(name: str) -> str:
    with open(os.path.join(CSRC_DIR, name)) as f:
        return f.read()


def variant_sources() -> Dict[str, Tuple[str, str]]:
    """{variant: (kernel source, encoder_tiles.cuh)} with its substitutions
    made; raises if one no longer matches the checkout's sources."""
    tiles, sources = _read("encoder_tiles.cuh"), {"fwd": _read("encoder_payload.cu"),
                                                  "bwd": _read("encoder_payload_bwd.cu")}
    out = {}
    for name, (kind, patches, tile_patches, _) in VARIANTS.items():
        src, tls = _recipe_only(kind, sources[kind]), tiles
        for old, new in patches:
            if old not in src:
                raise RuntimeError(f"variant {name}: its text is no longer in the source")
            src = src.replace(old, new)
        for old, new in tile_patches:
            if old not in tls:
                raise RuntimeError(f"variant {name}: its text is no longer in encoder_tiles.cuh")
            tls = tls.replace(old, new)
        out[name] = (src, tls)
    return out


def build_variants() -> Dict[str, ctypes.CDLL]:
    """Every variant and the mma probe, one nvcc each, all at once."""
    jobs = {name: (src, tls, "k.cu") for name, (src, tls) in variant_sources().items()}
    jobs["mma_probe"] = (MMA_PROBE, "", "probe.cu")
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = {name: pool.submit(_build, name, *job) for name, job in jobs.items()}
        return {name: fut.result() for name, fut in futures.items()}


def _ms(fn) -> float:
    fn()
    times = []
    for _ in range(REPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def run() -> Dict[str, float]:
    """Build, time and print every variant; returns {name: ms} and the mma
    probe's TFLOP/s under 'mma_tflops_<warps an SM>'. Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("probe_encoder_payload needs an NVIDIA GPU: its kernels have no CPU mode")
    libs = build_variants()
    results = {}
    probe = libs["mma_probe"]
    probe.run_probe.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3
    probe.run_probe.restype = ctypes.c_int
    out = torch.empty(132 * 2 * 1024, device="cuda")
    blocks, iters = torch.cuda.get_device_properties(0).multi_processor_count * 2, 4096
    for warps in (4, 8, 16):
        ms = _ms(lambda: probe.run_probe(out.data_ptr(), blocks, 32 * warps, iters))
        tflops = blocks * warps * iters * 8 * 2 * 16 * 8 * 8 / ms / 1e9
        results[f"mma_tflops_{2 * warps}"] = tflops
        print(f"[probe] TF32 mma.sync m16n8k8, 8 independent accumulators a warp, {2 * warps} "
              f"warps an SM: {tflops:.1f} TFLOP/s")

    grid = LatentGrid(dims=LATENT)
    rng = np.random.default_rng(1)
    pos = rng.uniform(-1, 1, (N_POINTS, 3)).astype(np.float32)
    lat, msk = build_edge_slots_host(pos, grid, RADIUS, strategy="bidirectional", budget=BUDGET)
    perm, secs = section_slots_by_degree_np(lat, msk, CHUNK)
    sizes = [6, 64, 64, 64, C]
    ws = [torch.from_numpy(rng.uniform(-1, 1, (o, i)).astype(np.float32) / i ** 0.5).cuda()
          for i, o in zip(sizes[:-1], sizes[1:])]
    bs = [torch.from_numpy(rng.uniform(-1, 1, o).astype(np.float32) / i ** 0.5).cuda()
          for i, o in zip(sizes[:-1], sizes[1:])]
    params = k5._pack_mlp(ws, bs)
    pos_t = torch.from_numpy(pos[perm][None]).cuda()
    feats = torch.from_numpy(rng.standard_normal((1, N_POINTS, C), dtype=np.float32)).cuda()
    sections, off = [], 0
    for lat_s, msk_s in secs:
        n = lat_s.shape[0]
        sections.append((pos_t[:, off:off + n], feats[:, off:off + n].contiguous(),
                         torch.from_numpy(lat_s[None]).cuda(), torch.from_numpy(msk_s[None]).cuda()))
        off += n
    M = grid.num_tokens
    acc = torch.zeros((1, M, C + 11), device="cuda")
    scratch = torch.zeros((1, M, 48), device="cuda")
    g = torch.from_numpy(rng.standard_normal((1, M, C + 11), dtype=np.float32)).cuda()
    outs = [(torch.empty_like(f), torch.zeros_like(params)) for _, f, _, _ in sections]
    _, d1, d2 = grid.dims
    geometry = (M, d1, d2, *grid.lo, *grid.spacing)
    stream = torch.cuda.current_stream().cuda_stream
    shipped = {}
    for name, (kind, _, _, what) in VARIANTS.items():
        lib = libs[name]
        if kind == "fwd":
            fn = lib.gaot_encoder_accumulate
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_float] * 6
                           + [ctypes.c_void_p] * 2)
            padded = name == "k5_padded_48"

            def launches():
                for p, f, lat_s, msk_s in sections:
                    if padded:
                        scratch.zero_()
                    err = fn(p.data_ptr(), f.data_ptr(), lat_s.data_ptr(), msk_s.data_ptr(),
                             params.data_ptr(), params.numel(), 2, 64, C, 1, lat_s.shape[1],
                             lat_s.shape[2], *geometry, (scratch if padded else acc).data_ptr(),
                             stream)
                    if err:
                        raise RuntimeError(f"{name}: cudaError {err}")
                    if padded:
                        acc.add_(scratch[..., :C + 11])

            acc.zero_()
            launches()
            result = acc.clone()
        else:
            fn = lib.gaot_encoder_backward
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_float] * 6
                           + [ctypes.c_void_p] * 4)

            def launches():
                for (p, f, lat_s, msk_s), (df, dp) in zip(sections, outs):
                    err = fn(p.data_ptr(), f.data_ptr(), lat_s.data_ptr(), msk_s.data_ptr(),
                             params.data_ptr(), params.numel(), 2, 64, C, 1, lat_s.shape[1],
                             lat_s.shape[2], *geometry, g.data_ptr(), df.data_ptr(),
                             dp.data_ptr(), stream)
                    if err:
                        raise RuntimeError(f"{name}: cudaError {err}")

            for _, dp in outs:
                dp.zero_()
            launches()
            result = torch.cat([df.flatten() for df, _ in outs] + [sum(dp for _, dp in outs)])
        torch.cuda.synchronize()
        ms = _ms(launches)
        results[name] = ms
        ref = shipped.setdefault(kind, result)
        rel = ((result - ref).abs().max() / ref.abs().max()).item()
        print(f"[{name}] {ms:.3f} ms, relative to the shipped kernel's result {rel:.2e}: {what}")
    return results


if __name__ == "__main__":
    run()
