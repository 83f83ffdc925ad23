"""Where the encoder payload kernels' time goes, and the alternatives their
design set aside, measured on the card.

Builds variants of K5 and K5b, f32 bodies (`csrc/encoder_payload.cu`,
`encoder_payload_bwd.cu`) and bf16 bodies (`encoder_payload_bf16.cu`,
`encoder_payload_bwd_bf16.cu`), from the sources in the checkout: each is a
copy of the kernel and of `csrc/encoder_tiles.cuh` with one or a few text
substitutions (the table below), built for the recipe's widths only. Each is
timed on the five degree sections of a 524,288-point cloud, the recipe of
`chip_smoke.py` `[k5]` (uniform points, 64x64x32 grid, radius 0.033, slot
budget 5, sections at chunk 65,536, the 6-64-64-64-32 kernel MLP), as the
five launches between two CUDA events, median of 7, and held against the
shipped kernel; the bf16 variants also on the neural-field step's uniform
[1, 40,000, 5] slots, where four slots in five are masked, and on the slots
the card builds for the whole cloud ([1, 524,288, 5], about half masked). Each
bf16 variant's registers and spills are printed. A probe of back-to-back TF32
`mma.sync` gives the rate the kernels' product instruction reaches on this
card, and one of `red.global.add` (`red_rates`) the rate of K5's scatter into
the accumulator.

    python -m gaot3d_tpu_torch.tools.probe_encoder_payload

NVIDIA GPU only. A variant that no longer matches its source raises.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np
import torch

from gaot3d_tpu_torch.data.host_graph import build_edge_slots_host, section_slots_by_degree_np
from gaot3d_tpu_torch.edges import LatentGrid
from gaot3d_tpu_torch.kernels import encoder_payload as k5
from gaot3d_tpu_torch.kernels.build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, find_nvcc
from gaot3d_tpu_torch.ops.grid_graph import build_budgeted_slots

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
_NO_SCATTER = ("if (arow < 0) continue;", "if (arow >= -1 && o[0][0] != 1.2345e30f) continue;")
_NO_BIAS_GELU = [(f"z[nt][{e}] = gelu(z[nt][{e}] + b{e % 2});",
                  f"z[nt][{e}] = z[nt][{e}] + b{e % 2};") for e in range(4)]
_ONE_CTA = ("__launch_bounds__(THREADS, 2)", "__launch_bounds__(THREADS, 1)")
_V4_CALL = ("scatter_rows_v4<C, L::ROW>(o, sb + HID * (n_mid + 1), f_of(s), x0, arows_of(s),\n"
            "                               staged + wrow * L::ROW, acc, wrow, lane);")
_V2_CALL = "scatter_rows<C>(o, sb + HID * (n_mid + 1), f_of(s), x0, arows_of(s), acc, wrow, lane);"
# every slot a row again (masked ones invalid), over a tile map of an all-true mask
_ALL_SLOTS_TILES = ("const bool v = s < s1 && mask[s] != 0;", "const bool v = s < s1;")
_ALL_SLOTS_KERNEL = ("load_slot_row(in, T, row_i, rows, slots, pos, lat_idx);",
                     "load_slot_row(in, T, row_i, rows, slots, pos, lat_idx);\n"
                     "        in.valid = in.present && mask[slots[row_i]] != 0;")
_ALL_SLOTS_FWD = ("load_slot_row(in, T, row_i, rows, slots_of(s), pos, lat_idx);",
                  "load_slot_row(in, T, row_i, rows, slots_of(s), pos, lat_idx);\n"
                  "    in.valid = in.present && mask[slots_of(s)[row_i]] != 0;")
_BWD_WGRADS = [
    ("wgrad<Mat<HID>, Mat<C>, HID / 16, C / 8, true>(z_of(NMID), F, dwl, dbl, warp, lane);", ";"),
    ("wgrad<Mat<HID>, Mat<HID>, HID / 16, HID / 8, true>(z_of(l - 1), z_of(l), dwm[l - 1],\n"
     "                                                         dbm[l - 1], warp, lane);", ";"),
    ("wgrad<Mat<HID>, X0, HID / 16, 1, false>(z_of(0), x0_of(s), dw0, db0, warp, lane);", ";")]
_BF16_WGRADS = [
    ("wgrad<BMat<HID>, Mat<C>, HID / 16, C / 8, true, Operands::BF16_X, uint16_t>(X, F, dwl, dbl,\n"
     "                                                                                 warp, lane);",
     ";"),
    ("wgrad<Mat<HID>, BMat<HID>, HID / 16, HID / 8, false, Operands::BF16_Y, float, uint16_t>(\n"
     "              Y, X, acc, dbm[l - 1], warp, lane);", ";"),
    ("wgrad<Mat<HID>, X0, HID / 16, 1, false, Operands::BF16_Y>(Y, x0, dw0, db0, warp, lane);", ";")]
_CHAIN_ROLLED = "#pragma unroll 1  // rolled: its registers stay within two CTAs' budget"
_UNROLL_1 = ("#pragma unroll 2\n  for (int kk = 0; kk < S::KT; ++kk) {",
             "#pragma unroll 1\n  for (int kk = 0; kk < S::KT; ++kk) {")
_BF16_NO_GELU = [
    ("for (int e = 0; e < 4; ++e) gelu_and_grad(z[nt][e], z[nt][e], gp[nt][e]);",
     "for (int e = 0; e < 4; ++e) gp[nt][e] = 1.f;"),
    ("        for (int e = 0; e < 4; ++e) z[nt][e] = gelu(z[nt][e]);",
     "        for (int e = 0; e < 4; ++e) z[nt][e] = z[nt][e];")]
_BF16_NO_CHAIN = ("      mma_tf32(acc[nt], al, b[0], b[1]);\n      mma_tf32(acc[nt], ah, b[0], b[1]);\n",
                  "")
_BF16_NO_FLUSH = [("if (cur_chunk >= 0) flush_slices(cur_chunk);",
                   "if (cur_chunk >= 0 && n_params < 0) flush_slices(cur_chunk);")]

# The hidden layers' products as one warpgroup's bf16 wgmma (m64n64k16, A from the warp's
# registers as mma.sync's m16n8k16 A fragment, B the [64][64] bf16 weights in shared memory,
# MN-major with the 128-byte swizzle that BMat<64> stores, from a 1024-byte aligned address):
# each 128-row tile is two warpgroups of 64 rows, every warp's 16 rows its part of the A
# operand and of the result, which keeps mma.sync's accumulator layout.
_WGMMA_REGS = ", ".join(f"%{i}" for i in range(32))
_WGMMA_OUTS = ", ".join(f'"+f"(d[{i}])' for i in range(32))
_WGMMA_HELPERS = r"""
template <class T>
__device__ __forceinline__ T* wg_align(T* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return reinterpret_cast<T*>(reinterpret_cast<char*>(p) + ((1024u - (a & 1023u)) & 1023u));
}

// the staged weights, written by the generic proxy, made visible to wgmma
__device__ __forceinline__ void wg_fence_proxy() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wg_mma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{REGS}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : OUTS
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <int HID>
__device__ __forceinline__ void dense_bf16_wgmma(const float (&act)[HID / 8][4],
                                                 const uint16_t* w, float (&acc)[HID / 8][4]) {
  static_assert(HID == 64, "N is one 128-byte swizzled row");
  uint32_t a[HID / 16][4];
#pragma unroll
  for (int ks = 0; ks < HID / 16; ++ks) {
    a[ks][0] = pack_bf16(act[2 * ks][0], act[2 * ks][1]);
    a[ks][1] = pack_bf16(act[2 * ks][2], act[2 * ks][3]);
    a[ks][2] = pack_bf16(act[2 * ks + 1][0], act[2 * ks + 1][1]);
    a[ks][3] = pack_bf16(act[2 * ks + 1][2], act[2 * ks + 1][3]);
  }
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(w);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < HID / 16; ++ks) {
    const uint32_t at = base + ks * 16 * 128;  // 16 rows of K, 128 bytes each
    const uint64_t desc = (uint64_t)((at & 0x3FFFF) >> 4) | (64ull << 16) | (64ull << 32) |
                          (1ull << 62);
    wg_mma(d, a[ks], desc, ks > 0);
  }
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
#pragma unroll
  for (int ks = 0; ks < HID / 16; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[ks][i])::"memory");
#pragma unroll
  for (int nt = 0; nt < HID / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = d[4 * nt + e];
}

}  // namespace enc""".replace("REGS", _WGMMA_REGS).replace("OUTS", _WGMMA_OUTS)
_WGMMA_TILES = ("\n}  // namespace enc", _WGMMA_HELPERS)
_K5_WGMMA = [
    ("    return (size_t)(weight_floats(n_mid) + STAGES) * sizeof(float);",
     "    return (size_t)(weight_floats(n_mid) + STAGES) * sizeof(float) +\n"
     "           (size_t)n_mid * HID * HID * 2 + 1024;"),
    ("  int* scratch = reinterpret_cast<int*>(staged + R * L::ROW);",
     "  int* scratch = reinterpret_cast<int*>(staged + R * L::ROW);\n"
     "  uint16_t* swg = wg_align(reinterpret_cast<uint16_t*>(scratch + WARPS));"),
    ("      stage_bf16_fragments<HID>(reinterpret_cast<uint2*>(swm + l * L::WM), p, HID, HID);",
     "      stage_bf16_fragments<HID>(reinterpret_cast<uint2*>(swm + l * L::WM), p, HID, HID);\n"
     "      stage_bf16_mat<HID>(swg + l * HID * HID, p, HID, HID);"),
    ("    for (int i = threadIdx.x; i < C; i += THREADS) sb[HID * (n_mid + 1) + i] = p[i];",
     "    for (int i = threadIdx.x; i < C; i += THREADS) sb[HID * (n_mid + 1) + i] = p[i];\n"
     "    wg_fence_proxy();"),
    ("      dense_bf16_packed<HID, HID>(\n"
     "          h, Bf16Fragments<HID>{reinterpret_cast<const uint2*>(swm + l * L::WM)}, z, lane);",
     "      dense_bf16_wgmma<HID>(h, swg + l * HID * HID, z);")]
_K5B_WGMMA = [
    ("(size_t)HALVES * 2 + (size_t)INTS * 4;", "(size_t)HALVES * 2 + (size_t)INTS * 4 + 1024;"),
    ("  float* Y = reinterpret_cast<float*>(smem4);",
     "  static_assert(((size_t)L::FLOATS * 4 + L::W0 * 2) % 1024 == 0 && L::WM * 2 % 1024 == 0,\n"
     "                \"the hidden layers' weights start 1024-byte aligned\");\n"
     "  float* Y = reinterpret_cast<float*>(wg_align(smem4));"),
    ("    for (int i = threadIdx.x; i < L::DWM; i += THREADS) smid[i] = 0.f;",
     "    for (int i = threadIdx.x; i < L::DWM; i += THREADS) smid[i] = 0.f;\n"
     "    wg_fence_proxy();"),
    ("      dense_bf16_packed<HID, HID>(z, w_mid(l), nz, lane);",
     "      dense_bf16_wgmma<HID>(z, swm + l * L::WM, nz);")]

# name: (kernel, [(old, new) in the kernel source], [(old, new) in encoder_tiles.cuh], what);
# the kernels: fwd, bwd (f32 bodies), fwd_bf16, bwd_bf16
VARIANTS: Dict[str, Tuple[str, List[Tuple[str, str]], List[Tuple[str, str]], str]] = {
    "k5": ("fwd", [], [], "as shipped"),
    "k5_scalar_red": ("fwd", [], [(_VEC, "const bool vec = false;")],
                      "every column a scalar red, no v2"),
    "k5_padded_48": ("fwd", [], [(_DST, "float* dst = acc + (long long)arow * 48;"),
                                 (_VEC, "const bool vec = true;")],
                     "into a zeroed [B, M, 48] scratch, all pairs v2, then added into acc, "
                     "each launch"),
    "k5_no_scatter": ("fwd", [], [_NO_SCATTER], "the MLP without the scatter"),
    "k5_cvt_split": ("fwd", [], [(_SPLIT, _CVT)], "the split by cvt.rna.tf32.f32"),
    "k5_one_pass": ("fwd", [], [_ONE_PASS], "hi*hi only (wrong numerics: cost of 3 passes)"),
    "k5b": ("bwd", [], [], "as shipped"),
    "k5b_cvt_split": ("bwd", [], [(_SPLIT, _CVT)], "the split by cvt.rna.tf32.f32"),
    "k5b_no_weight_products": ("bwd", _BWD_WGRADS, [], "no dW, db products"),
    "k5b_no_gelu_grad": ("bwd", [("      gelu_and_grad(z.x, h0, gp0);\n      gelu_and_grad(z.y, h1, gp1);",
                                  "      h0 = z.x; gp0 = 1.f; h1 = z.y; gp1 = 1.f;")], [],
                         "gelu and gelu' in the backward replaced by z and 1"),
    "k5b_one_pass": ("bwd", [], [_ONE_PASS], "hi*hi only (wrong numerics: cost of 3 passes)"),
    "k5_bf16": ("fwd_bf16", [], [], "as shipped"),
    "k5_bf16_no_scatter": ("fwd_bf16", [(_V4_CALL, "if (n_mid < 0) " + _V4_CALL)], [],
                           "the MLP without the scatter"),
    "k5_bf16_v2_scatter": ("fwd_bf16", [(_V4_CALL, _V2_CALL)], [],
                           "K5's v2 and scalar scatter (scatter_rows) in place of the v4 one"),
    "k5_bf16_no_gelu": ("fwd_bf16", [], _NO_BIAS_GELU, "bias without GELU (wrong numerics)"),
    "k5_bf16_all_slots": ("fwd_bf16", [_ALL_SLOTS_FWD], [_ALL_SLOTS_TILES],
                          "every slot a row, masked ones invalid (the earlier node-major tiles)"),
    "k5_bf16_one_cta": ("fwd_bf16", [_ONE_CTA], [], "launch bounds of one CTA an SM"),
    "k5_bf16_wgmma": ("fwd_bf16", _K5_WGMMA, [_WGMMA_TILES],
                      "the hidden layers as bf16 wgmma m64n64k16 (two warpgroups a tile)"),
    "k5b_bf16": ("bwd_bf16", [], [], "as shipped"),
    "k5b_bf16_no_weight_products": ("bwd_bf16", _BF16_WGRADS, [], "no dW, db products"),
    "k5b_bf16_no_gelu": ("bwd_bf16", _BF16_NO_GELU, [],
                         "gelu and gelu' replaced by z and 1 (wrong numerics)"),
    "k5b_bf16_no_chain": ("bwd_bf16", [_BF16_NO_CHAIN], [],
                          "the chain's d W^T products left out (wrong numerics)"),
    "k5b_bf16_no_flush": ("bwd_bf16", _BF16_NO_FLUSH, [], "dW kept, never flushed"),
    "k5b_bf16_all_slots": ("bwd_bf16", [_ALL_SLOTS_KERNEL], [_ALL_SLOTS_TILES],
                           "every slot a row, masked ones invalid (the earlier node-major tiles)"),
    "k5b_bf16_one_cta": ("bwd_bf16", [_ONE_CTA], [], "launch bounds of one CTA an SM"),
    "k5b_bf16_wgmma": ("bwd_bf16", _K5B_WGMMA, [_WGMMA_TILES],
                       "the recompute's hidden layers as bf16 wgmma m64n64k16 (two warpgroups "
                       "a tile)"),
    "k5b_bf16_unroll_1": ("bwd_bf16", [], [_UNROLL_1], "the weight products' row loop not unrolled"),
    "k5b_bf16_chain_unrolled": ("bwd_bf16", [(_CHAIN_ROLLED, "#pragma unroll")], [],
                                "the chain's k loop unrolled"),
}
SOURCES = {"fwd": "encoder_payload.cu", "bwd": "encoder_payload_bwd.cu",
           "fwd_bf16": "encoder_payload_bf16.cu", "bwd_bf16": "encoder_payload_bwd_bf16.cu"}

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

# K5's scatter alone: four threads a row, each adding its columns 8 nt + 2 t (+1) for
# nt < C / 8 as K5's lane t does, then the moment columns C + t, C + t + 4, C + t + 8 (< 11).
# mode 0: v2 where the row is 8-byte aligned, scalar elsewhere (K5); 1: every column scalar;
# 2: every pair v2 (the row stride `stride` must be even); 3: v4 on every 16-byte aligned group
# of four columns of the row's c + 11, scalar before and after them
RED_PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void red_replay(float* acc, const int* arow, int rows, int c, int stride, int mode) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 4LL * rows) return;
  const int r = (int)(i >> 2), t = (int)(i & 3);
  float* dst = acc + (long long)arow[r] * stride;
  if (mode == 3) {
    const int n = c + 11, a0 = (4 - (int)((reinterpret_cast<uintptr_t>(dst) >> 2) & 3)) & 3;
    const int a1 = a0 + ((n - a0) & ~3);
    for (int col = t; col < a0; col += 4) atomicAdd(dst + col, 1.f);
    for (int col = a0 + 4 * t; col < a1; col += 16)
      atomicAdd(reinterpret_cast<float4*>(dst + col), make_float4(1.f, 1.f, 1.f, 1.f));
    for (int col = a1 + t; col < n; col += 4) atomicAdd(dst + col, 1.f);
    return;
  }
  const bool vec = mode == 2 || (mode == 0 && (reinterpret_cast<uintptr_t>(dst) & 7) == 0);
  for (int nt = 0; nt < c / 8; ++nt) {
    float* p = dst + 8 * nt + 2 * t;
    if (vec) {
      atomicAdd(reinterpret_cast<float2*>(p), make_float2(1.f, 1.f));
    } else {
      atomicAdd(p, 1.f);
      atomicAdd(p + 1, 1.f);
    }
  }
  for (int q = 0; q < 3; ++q)
    if (t + 4 * q < 11) atomicAdd(dst + c + t + 4 * q, 1.f);
}
extern "C" int run_red(float* acc, const int* arow, int rows, int c, int stride, int mode,
                       void* stream) {
  const long long n = 4LL * rows;
  red_replay<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(acc, arow, rows, c,
                                                                             stride, mode);
  return (int)cudaGetLastError();
}
"""


def _recipe_only(kind: str, src: str) -> str:
    """Keep the recipe's instantiation only: the build takes seconds, not a minute."""
    if kind.startswith("fwd"):
        out = re.sub(r"#define GAOT_K5_WIDTHS\(X\)[^\n]*\n", "#define GAOT_K5_WIDTHS(X) X(64, 32)\n",
                     src)
    else:
        out = re.sub(r"#define GAOT_K5B_VARIANTS\(X\)(?:[^\n]*\\\n)*[^\n]*\n",
                     "#define GAOT_K5B_VARIANTS(X) X(64, 32, 2)\n", src)
    if out == src:
        raise RuntimeError(f"the {kind} source no longer has its width list")
    return out


LOGS: Dict[str, str] = {}  # each variant's -Xptxas -v output


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
    LOGS[name] = proc.stdout + proc.stderr
    return ctypes.CDLL(so)


def ptxas_summary(log: str) -> str:
    """Registers and the spill line of the kernel in a variant's ptxas log."""
    regs = re.findall(r"Used (\d+) registers", log)
    spills = [line.strip() for line in log.splitlines() if "spill" in line]
    return f"{'/'.join(regs) or '?'} registers, {'; '.join(spills) or 'no spill line'}"


def _read(name: str) -> str:
    with open(os.path.join(CSRC_DIR, name)) as f:
        return f.read()


def variant_sources() -> Dict[str, Tuple[str, str]]:
    """{variant: (kernel source, encoder_tiles.cuh)} with its substitutions
    made; raises if one no longer matches the checkout's sources."""
    tiles = _read("encoder_tiles.cuh")
    sources = {kind: _read(file) for kind, file in SOURCES.items()}
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
    """Every variant and the two probes, one nvcc each, all at once."""
    jobs = {name: (src, tls, "k.cu") for name, (src, tls) in variant_sources().items()}
    jobs["mma_probe"] = (MMA_PROBE, "", "probe.cu")
    jobs["red_probe"] = (RED_PROBE, "", "probe.cu")
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


def reduction_counts(arows: torch.Tensor, c: int) -> Dict[str, int]:
    """The reductions (instructions) each mode of `red_rates` issues to add
    one payload of c + 11 floats a row into the accumulator rows `arows`:
    {'k5': a v2 a pair on 8-byte aligned rows, a scalar a column elsewhere,
    and 11 scalar moments; 'scalar': every column; 'v2': every pair and the
    moments, into rows of 48 floats; 'v4': a v4 a 16-byte aligned group of
    four columns, a scalar each column around them}."""
    rows = int(arows.numel())
    start = arows.long() * (c + 11)
    aligned = int((start % 2 == 0).sum())  # 8-byte aligned rows
    a0 = (4 - start % 4) % 4  # columns before the first 16-byte aligned group
    groups = (c + 11 - a0) // 4
    return {"k5": aligned * (c // 2) + (rows - aligned) * c + 11 * rows,
            "scalar": rows * (c + 11), "v2": rows * (c // 2 + 11),
            "v4": int((groups + (c + 11 - 4 * groups)).sum())}


def red_rates(lib: ctypes.CDLL, arows: torch.Tensor, c: int, m_rows: int) -> Dict[str, float]:
    """K5's scatter alone for the accumulator rows `arows` (int32 on the card,
    one a valid row, in K5's order), c value columns and an accumulator of
    m_rows rows: {'k5_ms': K5's mix of v2 and scalar reductions into rows of
    c + 11 floats, 'scalar_ms': every column scalar, 'v2_ms': every pair v2
    into rows of 48 floats, 'v4_ms': v4 on the 16-byte aligned groups of a
    row of c + 11, scalar around them, and each mode's reductions
    (instructions) a second under '<mode>_per_s'}; CUDA events, median of
    REPS."""
    fn = lib.run_red
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rows = int(arows.numel())
    stream = torch.cuda.current_stream().cuda_stream
    acc = torch.zeros((m_rows, c + 11), device="cuda")
    wide = torch.zeros((m_rows, 48), device="cuda")
    counts = reduction_counts(arows, c)
    out = {}
    for mode, (name, buf, stride) in enumerate((("k5", acc, c + 11), ("scalar", acc, c + 11),
                                                ("v2", wide, 48), ("v4", acc, c + 11))):
        def launch():
            err = fn(buf.data_ptr(), arows.data_ptr(), rows, c, stride, mode, stream)
            if err:
                raise RuntimeError(f"red probe: cudaError {err}")
        ms = _ms(launch)
        out[f"{name}_ms"] = ms
        out[f"{name}_per_s"] = counts[name] / (ms * 1e-3)
    return out


def build_red_probe() -> ctypes.CDLL:
    """The `red.global.add` probe alone (for `red_rates`), built in seconds."""
    return _build("red_probe", RED_PROBE, "", "probe.cu")


def _slots(pos: np.ndarray, grid: LatentGrid):
    """The recipe's degree sections of `pos` and the neural-field step's
    uniform slots of its first 40,000 points."""
    lat, msk = build_edge_slots_host(pos, grid, RADIUS, strategy="bidirectional", budget=BUDGET)
    perm, secs = section_slots_by_degree_np(lat, msk, CHUNK)
    nf = build_edge_slots_host(pos[perm][:40_000], grid, RADIUS, strategy="bidirectional",
                               budget=BUDGET)
    return perm, secs, nf


def run() -> Dict[str, float]:
    """Build, time and print every variant; returns {name: ms} (bf16 ones
    also '<name>@nf' at [1, 40,000, 5] and '<name>@device' at the
    device-built [1, 524,288, 5]), the mma probe's TFLOP/s under
    'mma_tflops_<warps an SM>' and the red probe's readings under 'red_*'.
    Raises without a card."""
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
    perm, secs, (lat_nf, msk_nf) = _slots(pos, grid)
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
    nf = [(pos_t[:, :40_000], feats[:, :40_000].contiguous(), torch.from_numpy(lat_nf[None]).cuda(),
           torch.from_numpy(msk_nf[None]).cuda())]
    built = build_budgeted_slots(torch.from_numpy(pos[None]).cuda(), grid, RADIUS, 1,
                                 "bidirectional", None, BUDGET, CHUNK)
    device = [(torch.from_numpy(pos[None]).cuda(), feats, built.lat_idx.contiguous(),
               built.mask.contiguous())]
    M = grid.num_tokens
    acc = torch.zeros((1, M, C + 11), device="cuda")
    scratch = torch.zeros((1, M, 48), device="cuda")
    g = torch.from_numpy(rng.standard_normal((1, M, C + 11), dtype=np.float32)).cuda()
    _, d1, d2 = grid.dims
    geometry = (M, d1, d2, *grid.lo, *grid.spacing)
    stream = torch.cuda.current_stream().cuda_stream

    arows = torch.cat([lat[msk] for _, _, lat, msk in sections]).to(torch.int32)
    red = red_rates(libs["red_probe"], arows, C, M)
    results.update({f"red_{k}": v for k, v in red.items()})
    print(f"[probe] red.global.add, K5's scatter alone for the {arows.numel()} valid rows of the "
          f"recipe's sections: K5's mix {red['k5_ms']:.3f} ms ({red['k5_per_s']:.3e} reductions "
          f"a second), every column scalar {red['scalar_ms']:.3f} ms ({red['scalar_per_s']:.3e}), "
          f"every pair v2 into rows of 48 {red['v2_ms']:.3f} ms ({red['v2_per_s']:.3e}), v4 where "
          f"16-byte aligned {red['v4_ms']:.3f} ms ({red['v4_per_s']:.3e})")

    def maps(case, all_slots):
        return [k5.tile_map(torch.ones_like(msk) if all_slots else msk, CHUNK)
                for _, _, _, msk in case]

    def launcher(name, kind, case):
        lib = libs[name]
        all_slots = name.endswith("all_slots")
        if kind == "fwd":
            fn = lib.gaot_encoder_accumulate
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_float] * 6
                           + [ctypes.c_void_p] * 2)
            padded = name == "k5_padded_48"

            def launches():
                for p, f, lat_s, msk_s in case:
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

            def result():
                acc.zero_()
                launches()
                return acc.clone()
        elif kind == "fwd_bf16":
            fn = lib.gaot_encoder_accumulate
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_float] * 6
                           + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)
            tms = maps(case, all_slots)

            def launches():
                for (p, f, lat_s, msk_s), tm in zip(case, tms):
                    err = fn(p.data_ptr(), f.data_ptr(), lat_s.data_ptr(), msk_s.data_ptr(),
                             params.data_ptr(), params.numel(), 2, 64, C, 1, lat_s.shape[1],
                             lat_s.shape[2], *geometry, tm.node_first.data_ptr(),
                             tm.n_items.data_ptr(), tm.max_items, tm.chunk, acc.data_ptr(),
                             stream)
                    if err:
                        raise RuntimeError(f"{name}: cudaError {err}")

            def result():
                acc.zero_()
                launches()
                return acc.clone()
        else:
            bf16 = kind == "bwd_bf16"
            fn = lib.gaot_encoder_backward
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_float] * 6
                           + ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 if bf16 else [])
                           + [ctypes.c_void_p] * 4)
            tms = maps(case, all_slots) if bf16 else [None] * len(case)
            outs = [(torch.zeros_like(f),
                     torch.zeros(((tm.n_chunks if bf16 else 1), params.numel()), device="cuda"))
                    for (_, f, _, _), tm in zip(case, tms)]

            def launches():
                for (p, f, lat_s, msk_s), tm, (df, dp) in zip(case, tms, outs):
                    extra = ([tm.node_first.data_ptr(), tm.n_items.data_ptr(), tm.max_items,
                              tm.chunk] if bf16 else [])
                    err = fn(p.data_ptr(), f.data_ptr(), lat_s.data_ptr(), msk_s.data_ptr(),
                             params.data_ptr(), params.numel(), 2, 64, C, 1, lat_s.shape[1],
                             lat_s.shape[2], *geometry, *extra, g.data_ptr(), df.data_ptr(),
                             dp.data_ptr(), stream)
                    if err:
                        raise RuntimeError(f"{name}: cudaError {err}")

            def result():
                for df, dp in outs:
                    df.zero_()
                    dp.zero_()
                launches()
                return torch.cat([df.flatten() for df, _ in outs]
                                 + [sum(dp.sum(0) for _, dp in outs)])
        return launches, result

    where = {"": "the recipe's sections", "@nf": "[1, 40,000, 5] uniform slots",
             "@device": "the device-built [1, 524,288, 5]"}
    shipped = {}
    for name, (kind, _, _, what) in VARIANTS.items():
        bf16 = kind.endswith("bf16")
        cases = [("", sections)] + ([("@nf", nf), ("@device", device)] if bf16 else [])
        extra = f"; {ptxas_summary(LOGS[name])}" if bf16 else ""
        for tag, case in cases:
            launches, result = launcher(name, kind, case)
            got = result()
            torch.cuda.synchronize()
            ms = _ms(launches)
            results[name + tag] = ms
            ref = shipped.setdefault(kind + tag, got)
            rel = ((got - ref).abs().max() / ref.abs().max()).item()
            print(f"[{name}] {where[tag]}: {ms:.3f} ms, relative to the shipped kernel's result "
                  f"{rel:.2e}: {what}{extra}")
    return results


if __name__ == "__main__":
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    run()
