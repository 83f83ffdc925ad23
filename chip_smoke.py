"""Smoke run of the PyTorch port (gaot3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--flat-seed N] [--only k1,attention-train,k3,k5,t1,...]

`--flat-seed` (31) seeds the cloud of phases 13 and 14, for a second reading
of their limits. `--only` runs just the named phases (k1, attention-train,
k3, k5, trainer, trainer-split, t1), builds each kernel at its first use and
prints no record: for work on one phase.

Phases, each of which raises (exit code 1) on failure:
  1. device: needs CUDA (exits 1 without it), prints the card's name and
     power limit, turns TF32 off;
  2. build: compiles the ten CUDA sources of gaot3d_tpu_torch/csrc with
     nvcc, all at the same time, and prints each library's registers and
     spills from `-Xptxas -v`; for K5 and K5b at the recipe's widths also
     the CTAs an SM holds and the TF32 tensor-core (HMMA...TF32) and FFMA
     instructions `cuobjdump -sass` finds (none of the first fails);
  3. [k1] flash-attention forward vs its plain version at B1 H8 S16384 D32
     bf16 and at a ragged S=1000;
  4. [k5] encoder payload + scatter vs its plain version on the degree
     sections of a 524,288-point cloud (radius 0.033, slot budget 5, 64x64x32
     grid), the accumulator and its value columns each to 1e-5 relative, and
     [k5b] its backward (dfeats, dW, db) vs autograd through the plain
     version on the same sections, dfeats the same bits in two launches; both
     timed as the five launches alone and through their wrappers, with the
     bound from the 3xTF32 products, the GELU's instructions (counted in the
     SASS of its formula built alone) and the bytes;
  5. [serve] the DrivAerNet++ recipe model (random weights from a seed) is
     exported, loaded on the card and answers 2 requests of 524,288 points;
     the second is answered once more for the warm forward time, the first
     once more with every kernel replaced by its plain version;
  6. [k4] the dropout-bits exporter vs the plain Philox, bit for bit;
  7. [k1d] the forward at dropout rate 0.1 drawing from a seed vs its plain
     version fed the exported bits; keep rate; determinism;
  8. [k2] the fused backward at rates 0 and 0.1 vs the plain backward with
     the same bits, at the recipe shape and at ragged S=1000, Skv=130;
  9. [replay] the seeded forward and backward reproduce, from the bits the
     exporter writes for their seed, the same results (the path K4 serves);
 10. [k3] the split backward (a dq kernel and a dk/dv kernel) at rates 0 and
     0.1 at the recipe shape, and at six small shapes (f32, bf16, every head
     dim, S and Skv no tile multiples): against the plain backward with the
     same bits, against the fused kernel, and two launches bit for bit;
 11. [train] the recipe model takes 2 AdamW steps (mix schedule, dropout 0.1)
     on one 524,288-point cloud; launches per step must be exactly K1 10,
     K2 10, K5 5, K5b 5; then one forward-and-backward on a 32x32x16 grid
     with 65,536 points is repeated with every kernel replaced by its plain
     version at the same seed; then a breakdown of one step, with K5's and
     K5b's device time in its profile.
 12. [trainer] `gaot3d_tpu_torch.cli.run_config_file` on
     configs/examples/synthetic/h100_500k.toml with its data and outputs
     under .data/chip_smoke_trainer: the synthetic set (10 clouds of 500,000
     points) is generated and swept, 3 epochs of 6 steps, validation after
     epoch 2, test on 2 clouds; finite losses, the checkpoint, both .npz
     files and the CSV row with the JAX trainer's columns; a new trainer that
     reloads the checkpoint tests to the same metrics; every step launched
     K1 10, K2 10, K3 0 and K5, K5b once a section. Then [trainer-split]: one
     epoch of the same config with GAOT_ATTN_BWD_FUSED=0 in the environment:
     every step K3's two kernels 10 times each and K2 never, finite losses,
     every parameter tensor moved.
 13. [k7] the prefix sum, [k6] the sorted segment sum and [k8] the tile
     segment sum vs their plain versions at a ragged small shape and at the
     shapes one 65,536-node chunk of a 524,288-point cloud gives them (its
     flat list, and for K7 under `sort` and K8 its 327,680 slots), each column
     held to its own size, two launches compared bit for bit;
 14. [flat] the recipe over flat edge lists and the sorted reductions: config
     A (flat 'dst' lists, K6 for the encoder, K7 folds by node for the
     decoder) is exported, loaded and serves the cloud twice (accumulator bit
     for bit), then takes 2 AdamW steps with dropout; config B (K7 folds on
     both sides) and config C (slots sorted on the card, K8 or K7) serve it
     too; all against the uniform-slot forward through K5, every column of the
     encoder's accumulator to a stated limit and the output in relative L2;
     then config A's
     gradient through the kernels vs through the plain versions on a 32x32x16
     grid;
 15. [t1] the elementwise-chain probe: its kernel vs its plain version for
     both chains in f32 (reps 1 and 2) and bf16 (reps 1), each element held
     to a limit relative to its value and the non-finite positions compared
     as sets; then the probe's entry point
     (`gaot3d_tpu_torch.tools.microbench_vpu_bf16.run`) at reps 64, grid 64,
     and each case's plain time.
Yardsticks off the main path (`library_ms`): torch's
scaled_dot_product_attention forward and backward at the recipe shape,
`torch.cumsum` and `index_add_`.
The last two lines are a JSON record of the kernels and
{"ok": true, "device": {...}}.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np

N_POINTS = 524_288
LATENT = (64, 64, 32)
RADIUS = 0.033
BUDGET = 5
CHUNK = 65_536
K1_BOUND = 2e-2   # out: max abs over the plain output's max abs (two bf16 steps at the top)
K2_BOUND = 2e-2   # dq, dk, dv: max abs over the plain gradient's max abs, bf16 roundings
K3_FUSED_BOUND = 2.0 ** -7  # split against fused, of the plain gradient's max abs: one bf16
#                             step, for sums taken in another order before the one rounding
K5_BOUND = 1e-5   # relative, f32 accumulator summed with float atomics
K5B_BOUND = 1e-4  # relative to each gradient's max abs: per-CTA sums, then float atomics
K7_BOUND = 2e-6   # of the column's largest prefix |Z|, against the plain version (a float64
#                   running sum): the kernel adds 32 rows in f32, then groups' and blocks' totals
K6_BOUND = 1e-6   # of each column's max abs in the plain result: the same few f32 additions in
#                   another order
K8_BOUND = 1e-6   # as K6
# T1, kernel against plain, of each finite element's magnitude (x the input, a1
# the plain value after one step): select takes the same correctly rounded
# operations on both sides, one step of the type; f32 exp: ex2.approx (2 ulp)
# and three roundings, the exponent's error times 0.9 |a1| at the second step;
# bf16 exp: the exponential's output (one bf16 step, 2^-7, for ex2.approx)
# and the plain one's rounding, times up to 1.7 where exp(0.9 x) - x cancels
# (x near 1), plus the two results' roundings: 2^-5, and the rounding of the
# exponential's bf16 argument, 2^-9 of |0.9 x log2(e)| in the exponent
T1_SELECT_STEP = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -8}
T1_EXP_F32 = 2e-6
T1_EXP_BF16 = 2.0 ** -5
ACC_BOUND = 2e-6  # encoder accumulator of configs A and C (tile) against K5's, of each column's
#                   max abs: the same rows summed cell by cell, the kernel MLP through cuBLAS
#                   here and in K5's own order there
FOLD_BOUND = 5e-7  # accumulator of the folds (config B, C sort), of each column's absolute sum
#                   over the cells. A cell is Z[end] - Z[start] in each chunk; each prefix is
#                   within K7_BOUND of the chunk's largest, which the chunk's share of that
#                   absolute sum bounds for the columns that do not change sign (1, d, the
#                   squares) and far exceeds for the others. The worst case is 2 * K7_BOUND;
#                   the errors of the 2 * nc prefixes do not line up, and the limit is a
#                   quarter of K7_BOUND
E2E_BOUND = 1e-3  # relative L2 (and loss), kernels vs plain through 10 bf16-attention layers
RATE = 0.1
SHAPE = (1, 8, 16384, 32)  # B, H, S, D of the recipe's attention

# Peak rates of one H100 SXM (NVIDIA's data sheet, dense). The last two are not
# on the data sheet: an SM has 128 f32 lanes, 64 int32 lanes and 16
# special-function lanes, so they are the f32 FMA rate (67e12 / 2) times 1/2
# and 1/8.
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
FP32_OPS = F32_FLOPS / 2  # instructions a second on the FP32 pipe
INT32_OPS = F32_FLOPS / 2 / 2
SFU_OPS = F32_FLOPS / 2 / 8
# integer operations of one Philox4x32-10 call that depend on the element: 10
# rounds of two 32x32->64 multiplies and two three-input xors (the key
# schedule is the same for every element)
PHILOX_OPS = 40


def bound(n_bytes, **ops_over_rate):
    """The least time the card could take, in ms, and what sets it: bytes
    over the memory rate, or the slowest kind of operation over its peak."""
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = max(ops_over_rate.values())
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def attention_bound(B, H, S, Skv, D, products, n_tensors, dropout, itemsize=2, passes=1):
    """Bound of an attention kernel: `products` tile products of 2*S*Skv*D
    flops a head, one exponential a score, one Philox call per four scores
    under dropout, the last two `passes` times over (a pair of kernels that
    each recompute the probabilities and the mask); `n_tensors` [B,H,S,D]
    tensors moved."""
    scores = B * H * S * Skv
    ops = {"tensor": products * 2 * scores * D / BF16_FLOPS, "exp": passes * scores / SFU_OPS}
    if dropout:
        ops["philox"] = passes * scores / 4 * PHILOX_OPS / INT32_OPS
    return bound(n_tensors * B * H * max(S, Skv) * D * itemsize + 2 * B * H * S * 4, **ops)


def cuda_ms(fn, reps=5):
    """Median device time of fn over `reps` runs (after one warm-up), in ms."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def card_name_and_power():
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def host_sections(pos, grid, radius=RADIUS, budget=BUDGET):
    """Budgeted bidirectional slots of one cloud, degree-sectioned."""
    from gaot3d_tpu_torch.data.host_graph import (build_edge_slots_host,
                                                  section_slots_by_degree_np)

    lat, msk = build_edge_slots_host(pos, grid, radius, strategy="bidirectional",
                                     budget=budget)
    return section_slots_by_degree_np(lat, msk, CHUNK)


def max_degree(pos, grid, radius):
    from gaot3d_tpu_torch.data.host_graph import build_edge_slots_host

    _, full_mask = build_edge_slots_host(pos, grid, radius, strategy="bidirectional")
    return int(full_mask.sum(axis=1).max())


def qkv(rng, shape, skv=None):
    import torch

    B, H, S, D = shape
    return [torch.from_numpy(rng.standard_normal((B, H, s, D), dtype=np.float32))
            .to("cuda", torch.bfloat16) for s in (S, skv or S, skv or S)]


def phase_build():
    from gaot3d_tpu_torch.kernels import (build, dropout_bits, elementwise_chain,
                                          encoder_payload, flash_attention, prefix_sum,
                                          segment_sum_sorted, tile_segment_sum)

    t0 = time.perf_counter()
    build.build_together([dropout_bits._library, flash_attention._library,
                          flash_attention._backward_library, flash_attention._split_library,
                          encoder_payload._library,
                          encoder_payload._backward_library, prefix_sum._library,
                          segment_sum_sorted._library, tile_segment_sum._library,
                          elementwise_chain._library])
    print(f"[build] ten kernel libraries built together in {time.perf_counter() - t0:.1f} s")
    for name in ("dropout_bits", "flash_attn_fwd", "flash_attn_bwd", "flash_attn_bwd_split",
                 "encoder_payload",
                 "encoder_payload_bwd", "prefix_sum", "segment_sum_sorted",
                 "tile_segment_sum", "elementwise_chain"):
        regs, spills, serialized, entry = [], [], 0, "?"
        for line in build.build_log(name).splitlines():
            if "Compiling entry function" in line:  # the mangled name keeps the template arguments
                entry = line.split("'")[1]
            elif "Used " in line and " registers" in line:
                regs.append(int(line.split("Used ")[1].split(" registers")[0]))
            elif "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
                spills.append(f"{entry}: {line.strip()}")
            elif "wgmma.mma_async instructions are serialized" in line:
                serialized += 1
        print(f"[build] {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
              f"spills: {spills or 'none'}"
              + (f"; ptxas serialized the wgmmas of {serialized} kernels" if serialized else ""))
    encoder_build_facts()


def phase_k1():
    import torch

    from gaot3d_tpu_torch.kernels.flash_attention import (flash_attention,
                                                          flash_attention_reference)

    rng = np.random.default_rng(0)
    rec = {}
    for S in (16384, 1000):
        q, k, v = qkv(rng, (1, 8, S, 32))
        out, lse = flash_attention(q, k, v)
        ref, ref_lse = flash_attention_reference(q, k, v)
        torch.cuda.synchronize()
        if not (torch.isfinite(out.float()).all() and torch.isfinite(lse).all()):
            raise RuntimeError(f"K1 S={S}: non-finite output")
        err = (out.float() - ref.float()).abs().max().item()
        top = ref.float().abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        print(f"[k1] S={S} max_abs_err out {err:.3e} (plain max-abs {top:.3e}, limit "
              f"{K1_BOUND * top:.3e}) lse {err_lse:.3e}")
        if err > K1_BOUND * top or err_lse > 1e-3:
            raise RuntimeError(f"K1 S={S} disagrees with its twin: {err} / {err_lse}")
        if S == 16384:
            rec = {"max_abs_err": err, "ms": cuda_ms(lambda: flash_attention(q, k, v)),
                   "plain_ms": cuda_ms(lambda: flash_attention_reference(q, k, v)),
                   **attention_bound(1, 8, S, S, 32, products=2, n_tensors=4, dropout=False),
                   "library_ms": cuda_ms(
                       lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))}
            print(f"[k1] B1 H8 S16384 D32 bf16: kernel {rec['ms']:.3f} ms, "
                  f"plain {rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.3f} ms "
                  f"({rec['bound_by']}), library {rec['library_ms']:.3f} ms (median of 5)")
    return rec


GELU_PROBE = r"""
__device__ __forceinline__ float phi(float z) { return 0.5f * (1.f + erff(z * 0.70710678118654752f)); }
extern "C" __global__ void copy(const float* x, float* y) { y[threadIdx.x] = x[threadIdx.x]; }
extern "C" __global__ void gelu(const float* x, float* y) {
  const float z = x[threadIdx.x];
  y[threadIdx.x] = z * phi(z);
}
extern "C" __global__ void gelu_and_grad(const float* x, float* y) {
  const float z = x[threadIdx.x], p = phi(z);
  y[threadIdx.x] = z * p;
  y[threadIdx.x + 32] = p + z * expf(-0.5f * z * z) * 0.3989422804014327f;
}
"""


def sass(path, *args):
    """The SASS of a shared library or cubin, by cuobjdump."""
    from gaot3d_tpu_torch.kernels.build import find_nvcc

    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", *args, path], capture_output=True, text=True,
                          check=True, timeout=300).stdout


def sass_ops(text):
    """Counts of FP32-pipe instructions (F* opcodes) and special-function
    instructions (MUFU) in SASS text."""
    fp32 = mufu = 0
    for line in text.splitlines():
        if "/*" not in line or ";" not in line:
            continue
        op = line.split("*/", 1)[1].strip().split(" ")[0].lstrip("@!P0123456789T ")
        if op.startswith("MUFU"):
            mufu += 1
        elif op[:1] == "F" and op.split(".")[0] in ("FFMA", "FADD", "FMUL", "FMNMX", "FSETP",
                                                     "FSEL", "FSET", "FRND", "FCHK",
                                                     "FFMA32I", "FADD32I", "FMUL32I"):
            fp32 += 1
    return fp32, mufu


def gelu_instructions():
    """FP32-pipe and MUFU instructions of one exact-erf GELU (the forward's)
    and of one GELU with its derivative (the backward's), counted in the
    SASS of the kernels' own formulas built alone, less a plain copy."""
    from gaot3d_tpu_torch.kernels.build import NVCC_FLAGS, find_nvcc

    arch = NVCC_FLAGS[NVCC_FLAGS.index("-gencode") + 1]
    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "gelu_probe.cu"), os.path.join(tmp, "gelu_probe.cubin")
        with open(src, "w") as f:
            f.write(GELU_PROBE)
        subprocess.run([find_nvcc(), "-cubin", "-O3", "-gencode", arch, "-o", out, src],
                       check=True, capture_output=True, timeout=300)
        counts = {name: sass_ops(sass(out, "-fun", name))
                  for name in ("copy", "gelu", "gelu_and_grad")}
    base = counts["copy"]
    return {name: (c[0] - base[0], c[1] - base[1]) for name, c in counts.items() if name != "copy"}


def ptxas_entries(name):
    """{mangled kernel name: (registers, its stack/spill line)} from the
    `-Xptxas -v` log of a library's build."""
    from gaot3d_tpu_torch.kernels import build

    out, entry, spill = {}, "?", "?"
    for line in build.build_log(name).splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "bytes stack frame" in line:
            spill = line.strip()
        elif "Used " in line and " registers" in line:
            out[entry] = (int(line.split("Used ")[1].split(" registers")[0]), spill)
    return out


def encoder_build_facts():
    """Registers, spills and CTAs an SM of K5 and K5b at the recipe's widths
    (64, 32, two hidden-to-hidden layers), and the TF32 tensor-core and FFMA
    instructions in each library's SASS. Raises when a library has no TF32
    tensor-core instruction."""
    from gaot3d_tpu_torch.kernels import build, encoder_payload

    for name, lib, occupancy in (
            ("encoder_payload", encoder_payload._library(), "gaot_encoder_accumulate_occupancy"),
            ("encoder_payload_bwd", encoder_payload._backward_library(),
             "gaot_encoder_backward_occupancy")):
        text = sass(os.path.join(build.BUILD_DIR, f"lib{name}.so"))
        hmma = sum(1 for line in text.splitlines() if "HMMA" in line and "TF32" in line)
        ffma = sum(1 for line in text.splitlines() if "FFMA" in line)
        ctas = getattr(lib, occupancy)(2, 64, 32)
        kernel = ("encoder_accumulate_kernelILi64ELi32E" if name == "encoder_payload"
                  else "encoder_backward_kernelILi64ELi32ELi2E")
        regs, spill = next(((r, sp) for entry, (r, sp) in ptxas_entries(name).items()
                            if kernel in entry), ("?", "?"))
        print(f"[build] {name} at the recipe's widths: {regs} registers, {spill}; {ctas} CTA(s) "
              f"of 8 warps an SM; SASS of the library: {hmma} HMMA...TF32, {ffma} FFMA")
        if hmma == 0:
            raise RuntimeError(f"{name}: no TF32 tensor-core instruction in its SASS")


def phase_k5():
    import torch

    from gaot3d_tpu_torch.kernels import encoder_payload as k5
    from gaot3d_tpu_torch.models.mlp import ChannelMLP, reset_linear_
    from gaot3d_tpu_torch.ops.grid_graph import LatentGrid

    grid = LatentGrid(dims=LATENT)
    rng = np.random.default_rng(1)
    pos = rng.uniform(-1, 1, (N_POINTS, 3)).astype(np.float32)
    # the budget must cover the max degree, or compaction drops edges
    degree = max_degree(pos, grid, RADIUS)
    if degree > BUDGET:
        raise RuntimeError(f"slot budget {BUDGET} < max degree {degree}")
    perm, secs = host_sections(pos, grid)
    valid_edges = int(sum(s[1].sum() for s in secs))
    print(f"[k5] sections K={[int(s[0].shape[1]) for s in secs]} "
          f"rows={[int(s[0].shape[0]) for s in secs]} "
          f"valid_edges={valid_edges} max_degree={degree}")
    C = 32
    mlp = ChannelMLP([6, 64, 64, 64, C])
    gen = torch.Generator().manual_seed(1)
    for fc in mlp.fcs:
        reset_linear_(fc, gen)
    mlp.cuda()
    ws, bs = [fc.weight.detach() for fc in mlp.fcs], [fc.bias.detach() for fc in mlp.fcs]
    pos_t = torch.from_numpy(pos[perm][None]).cuda()
    feats = torch.from_numpy(rng.standard_normal((1, N_POINTS, C), dtype=np.float32)).cuda()
    sec_t = [(torch.from_numpy(lat[None]).cuda(), torch.from_numpy(msk[None]).cuda())
             for lat, msk in secs]
    acc = torch.zeros((1, grid.num_tokens, C + 11), device="cuda")
    offsets = np.cumsum([0] + [lat.shape[1] for lat, _ in sec_t])
    sections = [(pos_t[:, o:o + lat.shape[1]], feats[:, o:o + lat.shape[1]].contiguous(), lat,
                 msk) for o, (lat, msk) in zip(offsets, sec_t)]
    params, n_mid, hid = k5._pack_mlp(ws, bs), len(ws) - 2, ws[0].shape[0]

    def run(fn):
        acc.zero_()
        for p, f, lat, msk in sections:
            fn(p, f, lat, msk, ws, bs, grid, acc, chunk=CHUNK)
        return acc

    def launches_alone():
        for p, f, lat, msk in sections:
            k5.launch_accumulate(p, f, lat, msk, params, n_mid, hid, grid, acc)

    got = run(k5.encoder_accumulate).clone()
    ref = run(k5.encoder_accumulate_reference).clone()
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise RuntimeError("K5: non-finite accumulator")
    err = (got - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    # the C value columns alone, the only ones the MLP's products touch
    rel_vals = ((got[..., :C] - ref[..., :C]).abs().max() / ref[..., :C].abs().max()).item()
    print(f"[k5] accumulator max_abs_err {err:.3e} relative {rel:.3e}; its value columns "
          f"relative {rel_vals:.3e}")
    if rel > K5_BOUND or rel_vals > K5_BOUND:
        raise RuntimeError(f"K5 disagrees with its twin: relative {rel}, values {rel_vals}")
    # bytes: points, features, slots, masks and weights read once, the
    # accumulator read and written. Operations, for the valid rows of this
    # cloud: the MLP's products as 3xTF32 on the tensor cores (forward once;
    # backward recompute, chain and dW: 3x), and the GELU's instructions as
    # the SASS of its formula counts them (one a hidden unit forward; the
    # backward recomputes it, then takes it with its derivative again)
    n_weights = sum(w.numel() for w in ws)
    hidden = valid_edges * sum(w.shape[0] for w in ws[:-1])
    gelu = gelu_instructions()
    print(f"[k5] SASS of one GELU: {gelu['gelu'][0]} FP32-pipe + {gelu['gelu'][1]} MUFU "
          f"instructions; with its derivative: {gelu['gelu_and_grad'][0]} + "
          f"{gelu['gelu_and_grad'][1]}")
    slot_bytes = sum(lat.numel() * 5 for lat, _ in sec_t)
    moved = pos_t.numel() * 4 + feats.numel() * 4 + slot_bytes + n_weights * 4
    flops = valid_edges * 2 * n_weights
    fwd_ops = {"tensor": 3 * flops / TF32_FLOPS, "fp32": hidden * gelu["gelu"][0] / FP32_OPS,
               "sfu": hidden * gelu["gelu"][1] / SFU_OPS}
    bwd_ops = {"tensor": 3 * 3 * flops / TF32_FLOPS,
               "fp32": hidden * (gelu["gelu"][0] + gelu["gelu_and_grad"][0]) / FP32_OPS,
               "sfu": hidden * (gelu["gelu"][1] + gelu["gelu_and_grad"][1]) / SFU_OPS}
    rec = {"max_abs_err": err, "ms": cuda_ms(launches_alone),
           "plain_ms": cuda_ms(lambda: run(k5.encoder_accumulate_reference)),
           **bound(moved + 2 * acc.numel() * 4, **fwd_ops), "library_ms": None}
    # the wrapper's five calls (checks, packing, launch), the accumulator's zeroing outside
    wrapper_ms = cuda_ms(lambda: [k5.encoder_accumulate(p, f, lat, msk, ws, bs, grid, acc)
                                  for p, f, lat, msk in sections])
    print(f"[k5] all sections of 524,288 points: the five launches {rec['ms']:.3f} ms "
          f"(through the wrapper {wrapper_ms:.3f} ms: its share {wrapper_ms - rec['ms']:.3f} "
          f"ms), plain {rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.3f} ms "
          f"({rec['bound_by']}: tensor {1e3 * fwd_ops['tensor']:.3f}, GELU FP32 "
          f"{1e3 * fwd_ops['fp32']:.3f}, MUFU {1e3 * fwd_ops['sfu']:.3f}, bytes "
          f"{1e3 * (moved + 2 * acc.numel() * 4) / HBM_BYTES_S:.3f}; as f32 FMAs "
          f"{1e3 * flops / F32_FLOPS:.3f}) (median of 5)")

    # K5b: gradients of the five sections from one accumulator cotangent
    g = torch.from_numpy(rng.standard_normal((1, grid.num_tokens, C + 11),
                                             dtype=np.float32)).cuda()

    def run_backward(fn):
        dfeats, dws, dbs = [], None, None
        for p, f, lat, msk in sections:
            df, dw, db = fn(g, p, f, lat, msk, ws, bs, grid, chunk=CHUNK)
            dfeats.append(df)
            dws = dw if dws is None else [a + b for a, b in zip(dws, dw)]
            dbs = db if dbs is None else [a + b for a, b in zip(dbs, db)]
        return [torch.cat(dfeats, dim=1)] + dws + dbs

    got_b = run_backward(k5.encoder_accumulate_backward)
    again = run_backward(k5.encoder_accumulate_backward)
    ref_b = run_backward(k5.encoder_accumulate_backward_reference)
    torch.cuda.synchronize()
    if not torch.equal(got_b[0], again[0]):
        raise RuntimeError("K5b: dfeats differs between two launches")
    names = ["dfeats"] + [f"dW{i}" for i in range(len(ws))] + [f"db{i}" for i in range(len(ws))]
    worst, worst_abs = 0.0, 0.0
    for name, a, b in zip(names, got_b, ref_b):
        if not torch.isfinite(a).all():
            raise RuntimeError(f"K5b: non-finite {name}")
        abs_err = (a - b).abs().max().item()
        rel_b = abs_err / b.abs().max().item()
        worst, worst_abs = max(worst, rel_b), max(worst_abs, abs_err)
        if rel_b > K5B_BOUND:
            raise RuntimeError(f"K5b {name} disagrees with autograd through the plain "
                               f"version: relative {rel_b}")
    # the five launches alone: outputs allocated and zeroed outside the events
    outs = [(torch.empty_like(f), torch.zeros_like(params)) for _, f, _, _ in sections]

    def backward_launches():
        for (p, f, lat, msk), (df, dp) in zip(sections, outs):
            k5.launch_backward(g, p, f, lat, msk, params, n_mid, hid, grid, df, dp)

    rec_b = {"max_abs_err": worst_abs, "ms": cuda_ms(backward_launches),
             "plain_ms": cuda_ms(lambda: run_backward(k5.encoder_accumulate_backward_reference)),
             **bound(moved + g.numel() * 4 + feats.numel() * 4, **bwd_ops),
             "library_ms": None}
    # the wrapper's five calls (checks, packing, allocation, launch, unpacking)
    wrapper_b = cuda_ms(lambda: [k5.encoder_accumulate_backward(g, p, f, lat, msk, ws, bs, grid)
                                 for p, f, lat, msk in sections])
    print(f"[k5b] dfeats, dW, db of all sections: worst relative {worst:.3e}, dfeats the same "
          f"bits in two launches; the five launches {rec_b['ms']:.3f} ms (through the wrapper "
          f"{wrapper_b:.3f} ms: its share {wrapper_b - rec_b['ms']:.3f} ms), plain "
          f"{rec_b['plain_ms']:.3f} ms, bound {rec_b['bound_ms']:.3f} ms ({rec_b['bound_by']}: "
          f"tensor {1e3 * bwd_ops['tensor']:.3f}, GELU FP32 {1e3 * bwd_ops['fp32']:.3f}, MUFU "
          f"{1e3 * bwd_ops['sfu']:.3f}; as f32 FMAs {3e3 * flops / F32_FLOPS:.3f}) (median of 5)")
    rec["wrapper_ms"], rec_b["wrapper_ms"] = wrapper_ms, wrapper_b
    return rec, rec_b


def recipe_model(latent=LATENT, radius=RADIUS, budget=BUDGET, **magno_overrides):
    """The DrivAerNet++ pressure recipe at full width and depth, on the card,
    with random weights from seed 0; `magno_overrides` replace fields of its
    MAGNOConfig (the edge layout and the reductions)."""
    import torch

    from gaot3d_tpu_torch.models import (AttentionConfig, FFNConfig, MAGNOConfig,
                                         TransformerConfig, init_model)

    magno = MAGNOConfig(**{**dict(
        lifting_channels=32, gno_radius=radius, neighbor_strategy="bidirectional",
        use_geoembed=[True, False], in_gno_channel_mlp_hidden_layers=[64, 64, 64],
        out_gno_channel_mlp_hidden_layers=[64, 64], projection_channels=256,
        mlp_type="linear", edge_chunk_size=CHUNK, slot_budget=budget,
        kernel_dtype="float32", edge_layout="sectioned"), **magno_overrides})
    attn = TransformerConfig(
        patch_size=2, hidden_size=256, num_layers=10, positional_embedding="rope",
        attn_config=AttentionConfig(hidden_size=256, num_heads=8, num_kv_heads=8,
                                    atten_dropout=RATE, attention_dtype="bfloat16"),
        ffn_config=FFNConfig(hidden_size=1024))
    return init_model(3, 1, "gaot_3d", magno, attn, latent_tokens=latent,
                      generator=torch.Generator().manual_seed(0))


def cloud(seed, n_points, grid, radius=RADIUS, budget=BUDGET):
    """One random cloud with features and a target, uploaded in its degree
    sections' node order: (pos, feats, target, mask, slots, n_sections, host
    seconds of graph build and upload)."""
    import torch

    from gaot3d_tpu_torch.ops.grid_graph import SectionedEdgeSlots

    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (n_points, 3)).astype(np.float32)
    feats = rng.standard_normal((n_points, 3), dtype=np.float32)
    target = rng.standard_normal((n_points, 1), dtype=np.float32)
    t0 = time.perf_counter()
    perm, secs = host_sections(pos, grid, radius, budget)
    t1 = time.perf_counter()
    tensors = [torch.from_numpy(x[perm][None]).cuda() for x in (pos, feats, target)]
    mask = torch.ones((1, n_points), dtype=torch.bool, device="cuda")
    slots = SectionedEdgeSlots.from_numpy([(l[None], m[None]) for l, m in secs], device="cuda")
    torch.cuda.synchronize()
    return (*tensors, mask, slots, len(secs), (t1 - t0, time.perf_counter() - t1))


def phase_serve():
    import torch

    from gaot3d_tpu_torch.kernels import encoder_payload as k5
    from gaot3d_tpu_torch.kernels import flash_attention as k1
    from gaot3d_tpu_torch.ops.grid_graph import LatentGrid
    from gaot3d_tpu_torch.serve import export_inference, load_inference

    grid = LatentGrid(dims=LATENT)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "recipe.pt")
        export_inference(recipe_model(), path)
        infer = load_inference(path)

    fwd, acc = k1.flash_attention, k5.encoder_accumulate
    fwd.launches = acc.launches = 0
    outs = []
    for i, seed in enumerate((11, 12)):
        pos, feats, _, mask, slots, nsec, (t_graph, t_upload) = cloud(seed, N_POINTS, grid)
        n1, n5 = fwd.launches, acc.launches
        t0 = time.perf_counter()
        out = infer(pos, feats, mask, slots, slots)
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
        d1, d5 = fwd.launches - n1, acc.launches - n5
        ok = tuple(out.shape) == (1, N_POINTS, 1) and bool(torch.isfinite(out).all())
        print(f"[serve] request {i + 1}: graph build {t_graph * 1e3:.1f} ms, upload "
              f"{t_upload * 1e3:.1f} ms, forward {t_fwd * 1e3:.1f} ms; out "
              f"{tuple(out.shape)} finite={ok}; K1 launches {d1}, K5 launches {d5} "
              f"({nsec} sections)")
        if not ok or d1 != 10 or d5 != nsec:
            raise RuntimeError(f"request {i + 1}: bad output or kernel launch counts")
        outs.append(((pos, feats, mask), slots, out))
    # the warm forward: the last request's cloud, already on the card, again
    args, slots, out = outs[-1]
    t0 = time.perf_counter()
    warm = infer(*args, slots, slots)
    torch.cuda.synchronize()
    print(f"[serve] request 2 answered again (warm): forward "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    if not torch.isfinite(warm).all():
        raise RuntimeError("the warm forward gave a non-finite output")
    launches = {"k1": fwd.launches, "k5": acc.launches}

    args, slots, out = outs[0]
    with plain_versions():
        plain = infer(*args, slots, slots)
    torch.cuda.synchronize()
    if (fwd.launches, acc.launches) != (launches["k1"], launches["k5"]):
        raise RuntimeError("the plain run launched a kernel")
    rel = ((out - plain).norm() / plain.norm()).item()
    print(f"[serve] request 1 with every kernel replaced by its plain version: relative L2 "
          f"difference {rel:.3e}")
    if not rel <= E2E_BOUND:
        raise RuntimeError(f"kernels and plain versions disagree end to end: {rel}")
    return launches


def plain_versions():
    """Context in which the model calls the plain version of every kernel
    instead of launching it."""
    import contextlib

    from gaot3d_tpu_torch.kernels import encoder_payload as k5
    from gaot3d_tpu_torch.kernels import flash_attention as k1
    from gaot3d_tpu_torch.kernels import prefix_sum as k7
    from gaot3d_tpu_torch.kernels import segment_sum_sorted as k6
    from gaot3d_tpu_torch.kernels import tile_segment_sum as k8
    from gaot3d_tpu_torch.ops import segment

    def plain_tile(rows, sorted_seg, *, ts, num_segments, seg_tile, perm):
        return k8.tile_segment_sum_reference(rows, sorted_seg, ts, num_segments, perm)

    stack = contextlib.ExitStack()
    for mod, name, plain in (
            (k1, "flash_attention", k1.flash_attention_plain),
            (k1, "flash_attention_backward", k1.flash_attention_backward_plain),
            (k5, "encoder_accumulate",
             lambda *a, params=None, **kw: k5.encoder_accumulate_reference(*a, **kw)),
            (k5, "encoder_accumulate_backward",
             lambda *a, params=None, **kw: k5.encoder_accumulate_backward_reference(*a, **kw)),
            (k7, "prefix_sum", k7.prefix_sum_reference),
            (segment, "segment_sum_sorted",
             lambda data, ids, num_segments, passes=1:
             k6.segment_sum_sorted_reference(data, ids, num_segments)),
            (segment, "tile_segment_sum", plain_tile)):
        stack.enter_context(mock.patch.object(mod, name, plain))
    return stack


def phase_k4():
    import torch

    from gaot3d_tpu_torch.kernels.dropout_bits import (bits_as_int64, dropout_bits_reference,
                                                       export_dropout_bits)

    seed = 0x5EED_0123_4567_89AB
    rec = {}
    for BH, S, Skv in ((8, 4096, 4096), (3, 1000, 130)):
        got = export_dropout_bits(seed, BH, S, Skv)
        ref = dropout_bits_reference(seed, BH, S, Skv, device="cuda")
        torch.cuda.synchronize()
        wrong = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
        word_err = max(float((bits_as_int64(got[bh]) - bits_as_int64(ref[bh])).abs().max())
                       for bh in range(BH))
        print(f"[k4] BH={BH} S={S} Skv={Skv}: {wrong} of {got.numel()} words differ from the "
              f"plain Philox, by {word_err:.0f} at most")
        if wrong:
            raise RuntimeError("K4 disagrees with the plain Philox")
        if S == 4096:
            n = got.numel()
            rec = {"max_abs_err": word_err,
                   "ms": cuda_ms(lambda: export_dropout_bits(seed, BH, S, Skv)),
                   "plain_ms": cuda_ms(
                       lambda: dropout_bits_reference(seed, BH, S, Skv, device="cuda")),
                   **bound(4 * n, philox=n / 4 * PHILOX_OPS / INT32_OPS), "library_ms": None}
            print(f"[k4] BH8 S4096: kernel {rec['ms']:.3f} ms, plain {rec['plain_ms']:.3f} ms, "
                  f"bound {rec['bound_ms']:.3f} ms ({rec['bound_by']}) (median of 5)")
    return rec


def dropout_replay(q, k, v, dout, rate, seed):
    """The replay check that the JAX package's bench runs on its chip: run
    forward and backward drawing from `seed`, export the bits of that seed
    (K4), run both again reading the bits, and raise unless out, lse, dk and
    dv agree bit for bit and dq to one bf16 rounding step of its max-abs (its
    float atomics land in a run-dependent order)."""
    import torch

    from gaot3d_tpu_torch.kernels import dropout_bits as k4
    from gaot3d_tpu_torch.kernels import flash_attention as k1

    B, H, S, _ = q.shape
    out, lse = k1.flash_attention(q, k, v, rate, seed=seed)
    grads = k1.flash_attention_backward(q, k, v, out, lse, dout, rate, seed=seed)
    bits = k4.export_dropout_bits(seed, B * H, S, k.shape[2])
    out_b, lse_b = k1.flash_attention(q, k, v, rate, dropout_bits=bits)
    grads_b = k1.flash_attention_backward(q, k, v, out_b, lse_b, dout, rate, dropout_bits=bits)
    for name, a, b in (("out", out, out_b), ("lse", lse, lse_b), ("dk", grads[1], grads_b[1]),
                       ("dv", grads[2], grads_b[2])):
        if not torch.equal(a, b):
            raise RuntimeError(f"dropout replay: {name} from the seed and from its exported "
                               "bits differ")
    dq_diff = (grads[0].float() - grads_b[0].float()).abs().max().item()
    dq_max = grads[0].float().abs().max().item()
    if dq_diff > 2.0 ** -7 * dq_max:
        raise RuntimeError(f"dropout replay: dq differs by {dq_diff} of {dq_max}")
    kept = sum(int((k4.bits_as_int64(bits[bh]) >= k4.keep_threshold(rate)).sum())
               for bh in range(B * H))
    return {"keep_rate": kept / bits.numel(), "dq_max_abs_diff": dq_diff}


def phase_attention_train():
    """[k1d], [k2] and [replay]: the forward with dropout, the fused backward
    and the replay path at the recipe's attention shape, bits for all 8 heads
    (8.6 GB) exported once by K4."""
    import torch
    import torch.nn.functional as F

    from gaot3d_tpu_torch.kernels import dropout_bits as k4
    from gaot3d_tpu_torch.kernels import flash_attention as k1

    rng = np.random.default_rng(2)
    B, H, S, D = SHAPE
    q, k, v = qkv(rng, SHAPE)
    dout = qkv(rng, SHAPE)[0]
    seed = 0x0DD5_EED5_0000_0001
    bits = k4.export_dropout_bits(seed, B * H, S, S)

    # [k1d]
    out, lse = k1.flash_attention(q, k, v, RATE, seed=seed)
    again, _ = k1.flash_attention(q, k, v, RATE, seed=seed)
    ref, ref_lse = k1.flash_attention_reference(q, k, v, RATE, bits)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise RuntimeError("K1 with dropout: two runs with one seed differ")
    err = (out.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    kept = sum(int((k4.bits_as_int64(bits[bh]) >= k4.keep_threshold(RATE)).sum())
               for bh in range(B * H)) / bits.numel()
    print(f"[k1d] rate {RATE} S={S}: max_abs_err out {err:.3e} (plain max-abs {top:.3e}, limit "
          f"{K1_BOUND * top:.3e}) lse {err_lse:.3e}; keep rate {kept:.6f}; two seeded runs "
          f"identical")
    if not (torch.isfinite(out.float()).all() and err <= K1_BOUND * top and err_lse <= 1e-3):
        raise RuntimeError(f"K1 with dropout disagrees with its plain version: {err} / {err_lse}")
    if abs(kept - (1 - RATE)) > 1e-3:
        raise RuntimeError(f"keep rate {kept} is not within 1e-3 of {1 - RATE}")
    rec_k1d = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: k1.flash_attention(q, k, v, RATE, seed=seed)),
        "plain_ms": cuda_ms(lambda: k1.flash_attention_reference(q, k, v, RATE, bits), reps=3),
        **attention_bound(B, H, S, S, D, products=2, n_tensors=4, dropout=True),
        "library_ms": cuda_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, dropout_p=RATE))}
    print(f"[k1d] B1 H8 S16384 D32 bf16 rate {RATE}: kernel {rec_k1d['ms']:.3f} ms, plain "
          f"{rec_k1d['plain_ms']:.3f} ms, bound {rec_k1d['bound_ms']:.3f} ms "
          f"({rec_k1d['bound_by']}), library {rec_k1d['library_ms']:.3f} ms")

    # [k2]
    def check_backward(q, k, v, dout, rate, seed, bits, label):
        out, lse = k1.flash_attention(q, k, v, rate, seed=seed)
        got = k1.flash_attention_backward(q, k, v, out, lse, dout, rate, seed=seed)
        want = k1.flash_attention_backward_reference(q, k, v, out, lse, dout, rate, bits)
        torch.cuda.synchronize()
        worst = 0.0
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            if not torch.isfinite(a.float()).all():
                raise RuntimeError(f"K2 {label}: non-finite {name}")
            abs_err = (a.float() - b.float()).abs().max().item()
            rel = abs_err / b.float().abs().max().item()
            print(f"[k2] {label} {name}: max_abs_err {abs_err:.3e}, over the plain max-abs "
                  f"{rel:.3e}")
            if rel > K2_BOUND:
                raise RuntimeError(f"K2 {label}: {name} disagrees with the plain backward")
            worst = max(worst, abs_err)
        return out, lse, worst

    check_backward(q, k, v, dout, 0.0, None, None, f"rate 0 S={S}")
    out, lse, worst = check_backward(q, k, v, dout, RATE, seed, bits, f"rate {RATE} S={S}")
    rq, rk, rv = qkv(rng, (1, 8, 1000, 32), skv=130)
    rdo = qkv(rng, (1, 8, 1000, 32))[0]
    rbits = k4.export_dropout_bits(seed, 8, 1000, 130)
    check_backward(rq, rk, rv, rdo, RATE, seed, rbits, f"rate {RATE} ragged S=1000 Skv=130")
    ms0 = cuda_ms(lambda: k1.flash_attention_backward(q, k, v, out, lse, dout))
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, dropout_p=RATE)
    rec_k2 = {
        "max_abs_err": worst,
        "ms": cuda_ms(lambda: k1.flash_attention_backward(q, k, v, out, lse, dout, RATE,
                                                          seed=seed)),
        "plain_ms": cuda_ms(lambda: k1.flash_attention_backward_reference(
            q, k, v, out, lse, dout, RATE, bits), reps=3),
        **attention_bound(B, H, S, S, D, products=5, n_tensors=8, dropout=True),
        "library_ms": cuda_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), dout,
                                                          retain_graph=True))}
    print(f"[k2] B1 H8 S16384 D32 bf16: kernel {rec_k2['ms']:.3f} ms at rate {RATE}, "
          f"{ms0:.3f} ms at rate 0, plain {rec_k2['plain_ms']:.3f} ms, bound "
          f"{rec_k2['bound_ms']:.3f} ms ({rec_k2['bound_by']}), library backward "
          f"{rec_k2['library_ms']:.3f} ms")
    del lib_out, ql, kl, vl, bits

    # [replay]: the path that K4 serves, counted on its own
    k4.export_dropout_bits.launches = 0
    info = dropout_replay(q, k, v, dout, RATE, seed)
    torch.cuda.synchronize()
    replay_launches = k4.export_dropout_bits.launches
    print(f"[replay] seeded forward and backward reproduced from the exported bits: keep "
          f"rate {info['keep_rate']:.6f}, dq max_abs_diff {info['dq_max_abs_diff']:.3e}; K4 "
          f"launches {replay_launches}")
    if replay_launches < 1:
        raise RuntimeError("the replay path did not launch K4")
    return rec_k1d, rec_k2, replay_launches


def phase_k3():
    """[k3]: the split backward (a dq kernel and a dk/dv kernel) against the
    plain backward, against the fused kernel and against itself."""
    import torch
    import torch.nn.functional as F

    from gaot3d_tpu_torch.kernels import dropout_bits as k4
    from gaot3d_tpu_torch.kernels import flash_attention as k1

    rng = np.random.default_rng(4)
    seed = 0x0DD5_EED5_0000_0003

    def inputs(shape, skv, dtype):
        B, H, S, D = shape
        return [torch.from_numpy(rng.standard_normal((B, H, s, D), dtype=np.float32))
                .to("cuda", dtype) for s in (S, skv, skv, S)]

    def check(q, k, v, dout, rate, label):
        B, H, S, _ = q.shape
        bits = k4.export_dropout_bits(seed, B * H, S, k.shape[2]) if rate > 0 else None
        out, lse = k1.flash_attention(q, k, v, rate, seed=seed)
        got = k1.flash_attention_backward_split(q, k, v, out, lse, dout, rate, seed=seed)
        again = k1.flash_attention_backward_split(q, k, v, out, lse, dout, rate, seed=seed)
        fused = k1.flash_attention_backward(q, k, v, out, lse, dout, rate, seed=seed)
        want = k1.flash_attention_backward_reference(q, k, v, out, lse, dout, rate, bits)
        torch.cuda.synchronize()
        worst = 0.0
        for name, a, a2, f, b in zip(("dq", "dk", "dv"), got, again, fused, want):
            if not torch.isfinite(a.float()).all():
                raise RuntimeError(f"K3 {label}: non-finite {name}")
            top = b.float().abs().max().item()
            abs_err = (a.float() - b.float()).abs().max().item()
            vs_fused = (a.float() - f.float()).abs().max().item()
            same = torch.equal(a, a2)
            print(f"[k3] {label} {name}: max_abs_err {abs_err:.3e}, over the plain max-abs "
                  f"{abs_err / top:.3e} (limit {K2_BOUND:.0e}); against the fused kernel "
                  f"{vs_fused / top:.3e} (limit {K3_FUSED_BOUND:.1e}); two launches identical: "
                  f"{same}")
            if abs_err > K2_BOUND * top:
                raise RuntimeError(f"K3 {label}: {name} disagrees with the plain backward")
            if vs_fused > K3_FUSED_BOUND * top:
                raise RuntimeError(f"K3 {label}: {name} disagrees with the fused kernel")
            if not same:
                raise RuntimeError(f"K3 {label}: {name} differs between two launches")
            worst = max(worst, abs_err)
        return out, lse, bits, worst

    bf16, f32 = torch.bfloat16, torch.float32
    for shape, skv, dtype, rate in (((1, 2, 200, 32), 130, f32, RATE),
                                    ((1, 2, 100, 64), 70, f32, 0.0),
                                    ((1, 8, 1000, 32), 130, bf16, RATE),
                                    ((2, 2, 130, 64), 200, bf16, RATE),
                                    ((1, 3, 77, 16), 90, bf16, 0.0),
                                    ((1, 2, 70, 8), 100, bf16, RATE)):
        check(*inputs(shape, skv, dtype), rate,
              f"{str(dtype).split('.')[1]} rate {rate} B{shape[0]} H{shape[1]} S={shape[2]} "
              f"Skv={skv} D{shape[3]}")

    B, H, S, D = SHAPE
    q, k, v, dout = inputs(SHAPE, S, bf16)
    recs = {}
    for rate in (0.0, RATE):
        out, lse, bits, worst = check(q, k, v, dout, rate, f"bf16 rate {rate} S={S}")
        delta = (dout.float() * out.float()).sum(dim=-1)
        args = (q, k, v, lse, dout, delta, rate, seed)
        ms_dq = cuda_ms(lambda: k1.flash_attention_backward_dq(*args))
        ms_dkv = cuda_ms(lambda: k1.flash_attention_backward_dkv(*args))
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, dropout_p=rate)
        rec = {"max_abs_err": worst,
               "ms": cuda_ms(lambda: k1.flash_attention_backward_split(
                   q, k, v, out, lse, dout, rate, seed=seed)),
               "ms_dq": ms_dq, "ms_dkv": ms_dkv,
               "fused_ms": cuda_ms(lambda: k1.flash_attention_backward(
                   q, k, v, out, lse, dout, rate, seed=seed)),
               "plain_ms": cuda_ms(lambda: k1.flash_attention_backward_reference(
                   q, k, v, out, lse, dout, rate, bits), reps=3),
               **attention_bound(B, H, S, S, D, products=7, n_tensors=11, dropout=rate > 0,
                                 passes=2),
               "library_ms": cuda_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), dout,
                                                                 retain_graph=True))}
        print(f"[k3] B1 H8 S16384 D32 bf16 rate {rate}: dq kernel {ms_dq:.3f} ms, dk/dv kernel "
              f"{ms_dkv:.3f} ms, both with delta {rec['ms']:.3f} ms; fused kernel "
              f"{rec['fused_ms']:.3f} ms, plain {rec['plain_ms']:.3f} ms, bound "
              f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}), library backward "
              f"{rec['library_ms']:.3f} ms (median of 5)")
        recs[rate] = rec
        del lib_out, ql, kl, vl, bits
    # the recorded entry is the train path's: rate 0.1; rate 0 rides along
    return {**recs[RATE], "rate0": {n: recs[0.0][n] for n in
                                    ("ms", "ms_dq", "ms_dkv", "fused_ms", "bound_ms")}}


def grad_vector(model):
    import torch

    return torch.cat([p.grad.detach().float().flatten() for p in model.parameters()])


def phase_train(k5b_ms=None):
    import torch

    from gaot3d_tpu_torch.kernels import encoder_payload as k5
    from gaot3d_tpu_torch.kernels import flash_attention as k1
    from gaot3d_tpu_torch.ops.grid_graph import LatentGrid
    from gaot3d_tpu_torch.train import (OptimizerargsConfig, TrainBatch, make_optimizer,
                                        masked_mse, train_step)

    counters = {"k1": k1.flash_attention, "k2": k1.flash_attention_backward,
                "k5": k5.encoder_accumulate, "k5b": k5.encoder_accumulate_backward}
    grid = LatentGrid(dims=LATENT)
    model = recipe_model()
    pos, feats, target, mask, slots, nsec, _ = cloud(21, N_POINTS, grid)
    batch = TrainBatch(pos, feats, target, mask, slots, slots)
    optimizer = make_optimizer("adamw", model.parameters(),
                               OptimizerargsConfig(scheduler="mix"), steps_per_epoch=1)
    generator = torch.Generator().manual_seed(5)
    before = [p.detach().clone() for p in model.parameters()]
    total = dict.fromkeys(counters, 0)
    for step in range(2):
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        lr = optimizer.learning_rate
        t0 = time.perf_counter()
        loss, grad_norm = train_step(model, optimizer, batch, generator)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {name: fn.launches for name, fn in counters.items()}
        finite = bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(p.grad).all()) for p in model.parameters())
        print(f"[train] step {step}: loss {loss.item():.6f} grad_norm {grad_norm.item():.6f} "
              f"lr {lr:.3e} step {ms:.1f} ms peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches K1 {got['k1']} "
              f"K2 {got['k2']} K5 {got['k5']} K5b {got['k5b']}; finite={finite}")
        if not finite:
            raise RuntimeError(f"step {step}: non-finite loss or gradient")
        if got != {"k1": 10, "k2": 10, "k5": nsec, "k5b": nsec} or nsec != 5:
            raise RuntimeError(f"step {step}: launches {got}, expected 10 / 10 / 5 / 5")
        for name in total:
            total[name] += got[name]
    still = [n for (n, p), b in zip(model.named_parameters(), before) if torch.equal(p, b)]
    if still:
        raise RuntimeError(f"parameters that did not move in 2 steps: {still}")
    print(f"[train] every one of {len(before)} parameter tensors moved")

    # breakdown of one more step: device time of each part, then a profile
    model.train()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    optimizer.zero_grad()
    marks[0].record()
    loss = masked_mse(model(pos, feats, mask, encoder_slots=[slots], decoder_slots=[slots],
                            generator=generator), target, mask)
    marks[1].record()
    loss.backward()
    marks[2].record()
    optimizer.step()
    marks[3].record()
    torch.cuda.synchronize()
    parts = [marks[i].elapsed_time(marks[i + 1]) for i in range(3)]
    print(f"[train] one step by CUDA events: forward+loss {parts[0]:.1f} ms, backward "
          f"{parts[1]:.1f} ms, optimizer {parts[2]:.1f} ms")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(model, optimizer, batch, generator)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    busy = sum(r[1] for r in rows)
    if busy > 0:
        print(f"[train] profiled step: wall {wall:.1f} ms, device busy {busy:.1f} ms, idle "
              f"share {100 * (1 - busy / wall):.1f}%")
        for key, ms, count in sorted(rows, key=lambda r: -r[1])[:8]:
            print(f"[train]   {ms:8.2f} ms {count:4d}x {key[:90]}")
        for label, kernel in (("K5", "encoder_accumulate_kernel"),
                              ("K5b", "encoder_backward_kernel")):
            mine = [r for r in rows if kernel in r[0]]
            print(f"[train] {label} in the profiled step: {sum(r[1] for r in mine):.3f} ms for "
                  f"{sum(r[2] for r in mine)} launches"
                  + (f" ([k5b]'s five launches alone: {k5b_ms:.3f} ms)"
                     if label == "K5b" and k5b_ms is not None else ""))
    else:
        print("[train] torch.profiler recorded no device time here: idle share not measured")
    del model, optimizer, batch, before

    # kernels against their plain versions through one forward and backward:
    # same widths and depth on a 32x32x16 grid with 65,536 points, where the
    # plain [S, S] logits under autograd fit the run's time (2,048 tokens)
    small = LatentGrid(dims=(32, 32, 16))
    radius = 2 * RADIUS
    # the budget is the max degree of the cloud that cloud(22, ...) draws first
    budget = max_degree(np.random.default_rng(22).uniform(-1, 1, (65_536, 3)).astype(np.float32),
                        small, radius)
    pos, feats, target, mask, slots, nsec, _ = cloud(22, 65_536, small, radius, budget)
    model = recipe_model(small.dims, radius, budget).train()

    def forward_backward():
        model.zero_grad(set_to_none=True)
        pred = model(pos, feats, mask, encoder_slots=[slots], decoder_slots=[slots],
                     generator=torch.Generator().manual_seed(9))
        loss = masked_mse(pred, target, mask)
        loss.backward()
        return loss.item(), grad_vector(model)

    for fn in counters.values():
        fn.launches = 0
    loss_k, grad_k = forward_backward()
    launched = {name: fn.launches for name, fn in counters.items()}
    with plain_versions():
        loss_p, grad_p = forward_backward()
    torch.cuda.synchronize()
    if {name: fn.launches for name, fn in counters.items()} != launched:
        raise RuntimeError("the plain run launched a kernel")
    rel = ((grad_k - grad_p).norm() / grad_p.norm()).item()
    print(f"[train] 32x32x16 grid, 65,536 points, {nsec} sections (budget {budget}), rate "
          f"{RATE}, one seed: loss {loss_k:.6f} with kernels, {loss_p:.6f} with plain versions; "
          f"relative L2 of the gradient ({grad_p.numel()} values) {rel:.3e}")
    if not (rel <= E2E_BOUND and abs(loss_k - loss_p) <= E2E_BOUND * abs(loss_p)):
        raise RuntimeError(f"kernels and plain versions disagree through the train step: {rel}")
    return total


def flat_cloud(seed, n_points, grid, radius=RADIUS, budget=BUDGET, chunk=CHUNK):
    """One random cloud in the caller's node order with its uniform slots and
    both flat edge lists on the card, and the host seconds of each build."""
    import torch

    from gaot3d_tpu_torch.data.host_graph import (build_edge_slots_host,
                                                  flatten_slots_host_batched)
    from gaot3d_tpu_torch.ops.grid_graph import EdgeSlots

    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (n_points, 3)).astype(np.float32)
    feats = rng.standard_normal((n_points, 3), dtype=np.float32)
    target = rng.standard_normal((n_points, 1), dtype=np.float32)
    t0 = time.perf_counter()
    lat, msk = build_edge_slots_host(pos, grid, radius, strategy="bidirectional", budget=budget)
    t1 = time.perf_counter()
    by_src = flatten_slots_host_batched(lat[None], msk[None], chunk, device="cuda")
    t2 = time.perf_counter()
    by_dst = flatten_slots_host_batched(lat[None], msk[None], chunk, order="dst", device="cuda")
    t3 = time.perf_counter()
    return {"pos": torch.from_numpy(pos[None]).cuda(),
            "feats": torch.from_numpy(feats[None]).cuda(),
            "target": torch.from_numpy(target[None]).cuda(),
            "mask": torch.ones((1, n_points), dtype=torch.bool, device="cuda"),
            "slots": EdgeSlots.from_numpy(lat[None], msk[None], device="cuda"),
            "by_src": by_src, "by_dst": by_dst, "valid_edges": int(msk.sum()),
            "seconds": {"graph": t1 - t0, "flatten_src": t2 - t1, "flatten_dst": t3 - t2}}


def payload_like(rng, E, C=32):
    """[E, C+11] float32 with the magnitudes of the encoder's payload rows:
    C kernel-times-feature columns, a column of ones, a distance, an offset y
    of the radius' size and its six products."""
    import torch

    y = rng.uniform(-RADIUS, RADIUS, (E, 3)).astype(np.float32)
    cols = [rng.standard_normal((E, C), dtype=np.float32), np.ones((E, 1), np.float32),
            np.linalg.norm(y, axis=1, keepdims=True), y,
            np.stack([y[:, 0] * y[:, 0], y[:, 0] * y[:, 1], y[:, 0] * y[:, 2],
                      y[:, 1] * y[:, 1], y[:, 1] * y[:, 2], y[:, 2] * y[:, 2]], axis=1)]
    return torch.from_numpy(np.concatenate(cols, axis=1)).cuda()


def phase_sorted_kernels(cloud_):
    """[k7], [k6], [k8] on chunk 0 of the cloud's edges."""
    import torch

    from gaot3d_tpu_torch.kernels import prefix_sum as k7
    from gaot3d_tpu_torch.kernels import segment_sum_sorted as k6
    from gaot3d_tpu_torch.kernels import tile_segment_sum as k8
    from gaot3d_tpu_torch.ops.segment import make_tile_fold

    rng = np.random.default_rng(3)
    M = LATENT[0] * LATENT[1] * LATENT[2]
    add_rate = F32_FLOPS / 2  # one addition a cycle a lane: half the FMA flop rate

    # [k7]: inclusive prefix sum, limit relative to the column's largest prefix
    E = cloud_["by_dst"].edges_per_chunk
    rec7 = {}
    for rows, C in ((1003, 43), (E, 32), (CHUNK * BUDGET, 43), (E, 43)):
        x = payload_like(rng, rows)[:, :C].contiguous()
        got, again, plain = k7.prefix_sum(x), k7.prefix_sum(x), k7.prefix_sum_reference(x)
        library = torch.cumsum(x, dim=0)
        torch.cuda.synchronize()
        top = plain.abs().amax(dim=0)
        rel = ((got - plain).abs() / top).max().item()
        rel_library = ((library - plain).abs() / top).max().item()
        print(f"[k7] [{rows}, {C}]: kernel vs plain {rel:.3e} of the column's largest prefix "
              f"(limit {K7_BOUND:.0e}; torch.cumsum in float32 reads {rel_library:.3e}); two "
              f"launches identical: {torch.equal(got, again)}")
        if not (torch.isfinite(got).all() and rel <= K7_BOUND and torch.equal(got, again)):
            raise RuntimeError(f"K7 [{rows}, {C}] disagrees with its plain version or itself")
        if rows >= E:  # the main path's shapes: the flat lists' and, for `sort`, the slots'
            rec = {"max_abs_err": (got - plain).abs().max().item(),
                   "ms": cuda_ms(lambda: k7.prefix_sum(x)),
                   "plain_ms": cuda_ms(lambda: k7.prefix_sum_reference(x)),
                   **bound(2 * x.numel() * 4, add=x.numel() / add_rate),
                   "library_ms": cuda_ms(lambda: torch.cumsum(x, 0))}
            print(f"[k7] [{rows}, {C}] f32: kernel {rec['ms']:.3f} ms, plain "
                  f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.3f} ms "
                  f"({rec['bound_by']}), library torch.cumsum {rec['library_ms']:.3f} ms "
                  f"(median of 5)")
            rec7 = rec  # the [E, 43] shape, the last of the loop, is the one recorded

    def library_index_add(ids, data):
        return torch.zeros((M + 1, data.shape[1]), device="cuda").index_add_(0, ids, data)

    # [k6]: rows that arrive sorted (chunk 0 of the 'dst' list), padding at the tail
    def check_segments(name, limit, got, again, plain):
        torch.cuda.synchronize()
        width = got.shape[-1]
        err = (got - plain).abs().reshape(-1, width).amax(dim=0)
        top = plain.abs().reshape(-1, width).amax(dim=0)
        rel = (err / top).max().item()
        print(f"[{name}] max_abs_err {err.max().item():.3e}; over the column's max-abs in the "
              f"plain result (from {top.min().item():.3e} to {top.max().item():.3e}) at most "
              f"{rel:.3e} (limit {limit:.0e}); two launches identical: {torch.equal(got, again)}")
        if not (torch.isfinite(got).all() and rel <= limit and torch.equal(got, again)):
            raise RuntimeError(f"{name} disagrees with its plain version or itself")
        return err.max().item()

    ids_small = torch.from_numpy(np.sort(np.where(
        rng.random(1003) < 0.9, rng.integers(0, 517, 1003), 517)).astype(np.int32)).cuda()
    data_small = payload_like(rng, 1003)
    check_segments("k6 ragged [1003, 43] -> [517, 43]", K6_BOUND,
                   k6.segment_sum_sorted(data_small, ids_small, 517),
                   k6.segment_sum_sorted(data_small, ids_small, 517),
                   k6.segment_sum_sorted_reference(data_small, ids_small, 517))
    mask = cloud_["by_dst"].mask[:, 0]
    ids = torch.where(mask, cloud_["by_dst"].dst[:, 0], torch.full_like(mask, M, dtype=torch.int32))
    data = payload_like(rng, E)[None]
    n_valid = int(mask.sum())
    err = check_segments(f"k6 [1, {E}, 43] ({n_valid} valid rows) -> [1, {M}, 43]", K6_BOUND,
                         k6.segment_sum_sorted(data, ids, M), k6.segment_sum_sorted(data, ids, M),
                         k6.segment_sum_sorted_reference(data, ids, M))
    ids_long = ids[0].long()
    rec6 = {"max_abs_err": err, "ms": cuda_ms(lambda: k6.segment_sum_sorted(data, ids, M)),
            "plain_ms": cuda_ms(lambda: k6.segment_sum_sorted_reference(data, ids, M)),
            **bound(n_valid * 43 * 4 + E * 4 + M * 43 * 4, add=n_valid * 43 / add_rate),
            "library_ms": cuda_ms(lambda: library_index_add(ids_long, data[0]))}
    print(f"[k6] one chunk: kernel {rec6['ms']:.3f} ms, plain {rec6['plain_ms']:.3f} ms, bound "
          f"{rec6['bound_ms']:.3f} ms ({rec6['bound_by']}), library index_add_ "
          f"{rec6['library_ms']:.3f} ms (median of 5)")

    # [k8]: the slots of chunk 0, masked ones included, sorted on the card
    fold_small = make_tile_fold(ids_small[torch.from_numpy(rng.permutation(1003)).cuda()], 517,
                                seg_tile=100)
    shuffled = payload_like(rng, 1003)

    def tile(fold, rows, S, seg_tile=512):
        return k8.tile_segment_sum(rows, fold.sorted_seg, ts=fold.ts, num_segments=S,
                                   seg_tile=seg_tile, perm=fold.perm)

    check_segments("k8 ragged [1003, 43] -> [517, 43], seg_tile 100", K8_BOUND,
                   tile(fold_small, shuffled, 517, 100), tile(fold_small, shuffled, 517, 100),
                   k8.tile_segment_sum_reference(shuffled, fold_small.sorted_seg, fold_small.ts,
                                                 517, fold_small.perm))
    lat = cloud_["slots"].lat_idx[0, :CHUNK].reshape(-1)
    msk = cloud_["slots"].mask[0, :CHUNK].reshape(-1)
    rows = payload_like(rng, lat.shape[0])
    t_fold = cuda_ms(lambda: make_tile_fold(lat, M, msk))
    fold = make_tile_fold(lat, M, msk)
    n_valid8 = int(msk.sum())
    err = check_segments(f"k8 [{lat.shape[0]}, 43] ({n_valid8} valid rows) -> [{M}, 43]",
                         K8_BOUND, tile(fold, rows, M), tile(fold, rows, M),
                         k8.tile_segment_sum_reference(rows, fold.sorted_seg, fold.ts, M,
                                                       fold.perm))
    sorted_ids = fold.sorted_seg.long()
    rec8 = {"max_abs_err": err, "ms": cuda_ms(lambda: tile(fold, rows, M)),
            "plain_ms": cuda_ms(lambda: k8.tile_segment_sum_reference(
                rows, fold.sorted_seg, fold.ts, M, fold.perm)),
            **bound(n_valid8 * 43 * 4 + 2 * lat.shape[0] * 4 + M * 43 * 4,
                    add=n_valid8 * 43 / add_rate),
            "library_ms": cuda_ms(lambda: library_index_add(sorted_ids, rows[fold.perm.long()]))}
    print(f"[k8] one chunk: kernel {rec8['ms']:.3f} ms (the sort and tile boundaries before it "
          f"{t_fold:.3f} ms), plain {rec8['plain_ms']:.3f} ms, bound {rec8['bound_ms']:.3f} ms "
          f"({rec8['bound_by']}), library gather + index_add_ {rec8['library_ms']:.3f} ms "
          f"(median of 5)")
    return rec7, rec6, rec8


def phase_flat(cloud_):
    import torch

    from gaot3d_tpu_torch.kernels import encoder_payload as k5
    from gaot3d_tpu_torch.kernels import flash_attention as k1
    from gaot3d_tpu_torch.kernels import prefix_sum as k7
    from gaot3d_tpu_torch.kernels import segment_sum_sorted as k6
    from gaot3d_tpu_torch.kernels import tile_segment_sum as k8
    from gaot3d_tpu_torch.ops.grid_graph import LatentGrid
    from gaot3d_tpu_torch.serve import (export_inference, load_inference,
                                        make_edge_arg_model)
    from gaot3d_tpu_torch.train import (OptimizerargsConfig, TrainBatch, make_optimizer,
                                        masked_mse, train_step)

    counters = {"k1": k1.flash_attention, "k2": k1.flash_attention_backward,
                "k5": k5.encoder_accumulate, "k5b": k5.encoder_accumulate_backward,
                "k6": k6.segment_sum_sorted, "k7": k7.prefix_sum, "k8": k8.tile_segment_sum}
    total = dict.fromkeys(counters, 0)
    secs = cloud_["seconds"]
    nc = cloud_["by_dst"].num_chunks
    print(f"[flat] host: graph build {secs['graph'] * 1e3:.1f} ms, flatten by node "
          f"{secs['flatten_src'] * 1e3:.1f} ms, flatten by cell {secs['flatten_dst'] * 1e3:.1f} "
          f"ms (with upload); {cloud_['valid_edges']} valid edges in {nc} chunks of "
          f"{cloud_['by_dst'].edges_per_chunk}")
    pos, feats, mask = cloud_["pos"], cloud_["feats"], cloud_["mask"]
    C = 32

    def serve(infer, model, enc, dec, label, expect):
        """Answer the cloud twice; return (output, the encoder's accumulator,
        warm forward ms), with the launches of one request checked."""
        fused = model.encoder.fused
        finalize, seen = fused._finalize, []

        def spy(acc):
            seen.append(acc.detach().clone())
            return finalize(acc)

        outs, times = [], []
        with mock.patch.object(fused, "_finalize", spy):
            for _ in range(2):
                for fn in counters.values():
                    fn.launches = 0
                t0 = time.perf_counter()
                outs.append(infer(pos, feats, mask, enc, dec))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                got = {n: fn.launches for n, fn in counters.items() if fn.launches}
                for n, v in got.items():
                    total[n] += v
        same = torch.equal(seen[0], seen[1])
        ok = tuple(outs[1].shape) == (1, N_POINTS, 1) and bool(torch.isfinite(outs[1]).all())
        print(f"[flat] {label}: forward {times[0]:.1f} ms, again {times[1]:.1f} ms; launches a "
              f"request {got}; finite={ok}; accumulator of two requests identical: {same}")
        if not ok or got != expect:
            raise RuntimeError(f"{label}: bad output, or launches {got} where {expect} expected")
        return outs[1], seen[1], same, times[1]

    def against(label, out, acc, ref_out, ref_acc, fold):
        """Hold a config to the K5 forward: every accumulator column to its
        limit (ACC_BOUND of its max-abs, or for a fold FOLD_BOUND of its
        absolute sum over the cells), then the output's relative L2."""
        rel = ((out - ref_out).norm() / ref_out.norm()).item()
        diff = (acc - ref_acc).abs().amax(dim=(0, 1))
        top = ref_acc.abs().amax(dim=(0, 1))
        limit = FOLD_BOUND * ref_acc.abs().sum(dim=(0, 1)) if fold else ACC_BOUND * top
        used = diff / limit
        moments = " ".join(f"{d / t:.1e}" for d, t in zip(diff[C:].tolist(), top[C:].tolist()))
        print(f"[flat] {label} against the uniform-slot forward through K5: relative L2 "
              f"{rel:.3e}; accumulator max_abs_err over the column's max-abs: gno columns "
              f"{(diff[:C] / top[:C]).max().item():.1e}, the 11 moment columns (1, d, y, yy^T) "
              f"{moments}; of each column's limit "
              f"({'FOLD_BOUND of its absolute sum' if fold else 'ACC_BOUND of its max-abs'}) at "
              f"most {used[:C].max().item():.2f} (gno) and {used[C:].max().item():.2f} (moments)")
        if not (used <= 1).all():
            raise RuntimeError(f"{label}: accumulator columns {(used > 1).nonzero().flatten().tolist()} "
                               f"are beyond their limit against K5's")
        if not rel <= E2E_BOUND:
            raise RuntimeError(f"{label} disagrees with the K5 forward: {rel}")

    # the reference: uniform slots through K5
    ref_model = recipe_model(edge_layout="slots").eval()
    ref_out, ref_acc, _, _ = serve(make_edge_arg_model(ref_model), ref_model, cloud_["slots"],
                                   cloud_["slots"], "uniform slots, segment_impl scatter (K5)",
                                   {"k1": 10, "k5": 1})
    del ref_model

    # config A through the entry points a server calls
    config_a = dict(edge_layout="flat", flat_order="dst", flat_reduce_impl="pallas")
    model_a = recipe_model(**config_a)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flat.pt")
        export_inference(model_a, path)
        loaded = load_inference(path)
    infer_a = make_edge_arg_model(model_a.eval())
    out_l = loaded(pos, feats, mask, cloud_["by_dst"], cloud_["by_src"])
    out_a, acc_a, same_a, warm_a = serve(
        infer_a, model_a, cloud_["by_dst"], cloud_["by_src"],
        "config A (flat dst, flat_reduce_impl pallas)", {"k1": 10, "k6": nc, "k7": nc})
    if not same_a:
        raise RuntimeError("config A: the encoder accumulator differs between two requests")
    if not torch.equal(out_l, out_a):
        raise RuntimeError("config A: the exported and reloaded model answers differently")
    against("config A", out_a, acc_a, ref_out, ref_acc, fold=False)

    # config A: two train steps with dropout
    batch = TrainBatch(pos, feats, cloud_["target"], mask, cloud_["by_dst"], cloud_["by_src"])
    optimizer = make_optimizer("adamw", model_a.parameters(),
                               OptimizerargsConfig(scheduler="mix"), steps_per_epoch=1)
    generator = torch.Generator().manual_seed(6)
    before = [p.detach().clone() for p in model_a.parameters()]
    for step in range(2):
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, grad_norm = train_step(model_a, optimizer, batch, generator)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {n: fn.launches for n, fn in counters.items() if fn.launches}
        finite = bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(p.grad).all()) for p in model_a.parameters())
        print(f"[flat] config A train step {step}: loss {loss.item():.6f} grad_norm "
              f"{grad_norm.item():.6f} step {ms:.1f} ms peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches {got}; "
              f"finite={finite}")
        if not finite:
            raise RuntimeError(f"config A step {step}: non-finite loss or gradient")
        if got != {"k1": 10, "k2": 10, "k6": nc, "k7": nc}:
            raise RuntimeError(f"config A step {step}: launches {got}")
        for n, v in got.items():
            total[n] += v
    still = [n for (n, p), b in zip(model_a.named_parameters(), before) if torch.equal(p, b)]
    if still:
        raise RuntimeError(f"config A: parameters that did not move in 2 steps: {still}")
    print(f"[flat] config A: every one of {len(before)} parameter tensors moved")
    del model_a, optimizer, batch, before, loaded

    # configs B and C, forward only
    warm = {"A": warm_a}
    for name, label, overrides, enc, dec, expect, fold in (
            ("B", "config B (flat dst, flat_reduce_impl fold)",
             dict(edge_layout="flat", flat_order="dst"), cloud_["by_dst"], cloud_["by_src"],
             {"k1": 10, "k7": 2 * nc}, True),
            ("C", "config C (slots, segment_impl tile)",
             dict(edge_layout="slots", segment_impl="tile"), cloud_["slots"], cloud_["slots"],
             {"k1": 10, "k8": nc}, False),
            ("C sort", "config C (slots, segment_impl sort)",
             dict(edge_layout="slots", segment_impl="sort"), cloud_["slots"], cloud_["slots"],
             {"k1": 10, "k7": nc}, True)):
        model = recipe_model(**overrides).eval()
        out, acc, same, warm[name] = serve(make_edge_arg_model(model), model, enc, dec, label,
                                           expect)
        if not same:
            raise RuntimeError(f"{label}: the encoder accumulator differs between two requests")
        against(label, out, acc, ref_out, ref_acc, fold)
        del model
    print("[flat] forward answered again, ms: " + ", ".join(f"{k} {v:.1f}" for k, v in warm.items()))

    # config A's gradient through the kernels against the plain versions
    small = LatentGrid(dims=(32, 32, 16))
    radius = 2 * RADIUS
    budget = max_degree(np.random.default_rng(23).uniform(-1, 1, (65_536, 3)).astype(np.float32),
                        small, radius)
    sc = flat_cloud(23, 65_536, small, radius, budget, chunk=8192)
    model = recipe_model(small.dims, radius, budget, edge_chunk_size=8192, **config_a).train()

    def forward_backward():
        model.zero_grad(set_to_none=True)
        pred = model(sc["pos"], sc["feats"], sc["mask"], encoder_slots=[sc["by_dst"]],
                     decoder_slots=[sc["by_src"]], generator=torch.Generator().manual_seed(9))
        loss = masked_mse(pred, sc["target"], sc["mask"])
        loss.backward()
        return loss.item(), grad_vector(model)

    for fn in counters.values():
        fn.launches = 0
    loss_k, grad_k = forward_backward()
    launched = {n: fn.launches for n, fn in counters.items()}
    with plain_versions():
        loss_p, grad_p = forward_backward()
    torch.cuda.synchronize()
    if {n: fn.launches for n, fn in counters.items()} != launched:
        raise RuntimeError("the plain run launched a kernel")
    rel = ((grad_k - grad_p).norm() / grad_p.norm()).item()
    print(f"[flat] config A, 32x32x16 grid, 65,536 points in 8 chunks (budget {budget}), rate "
          f"{RATE}, one seed: launches {({n: v for n, v in launched.items() if v})}; loss "
          f"{loss_k:.6f} with kernels, {loss_p:.6f} with plain versions; relative L2 of the "
          f"gradient ({grad_p.numel()} values) {rel:.3e}")
    if not (rel <= E2E_BOUND and abs(loss_k - loss_p) <= E2E_BOUND * abs(loss_p)):
        raise RuntimeError(f"config A: kernels and plain versions disagree in training: {rel}")
    if launched["k6"] != 8 or launched["k7"] != 8:
        raise RuntimeError(f"config A on the small grid: launches {launched}")
    return total


def phase_t1():
    """[t1]: the elementwise-chain probe against its plain version, then
    through its entry point at the defaults, counted."""
    import torch

    from gaot3d_tpu_torch.kernels import elementwise_chain as t1
    from gaot3d_tpu_torch.tools import microbench_vpu_bf16 as probe

    x32 = torch.from_numpy(np.random.default_rng(5).standard_normal(probe.BLOCK,
                                                                    dtype=np.float32))
    worst = 0.0
    for chain in t1.CHAINS:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            x = x32.to("cuda", dtype)
            for reps in ((1, 2) if dtype == torch.float32 else (1,)):
                got = t1.elementwise_chain(x, chain, reps, copies=3).float()
                want = t1.chain_plain(x, chain, reps).float()
                torch.cuda.synchronize()
                if not torch.equal(torch.isfinite(got), torch.isfinite(want)):
                    raise RuntimeError(f"T1 {chain} {name} reps {reps}: non-finite positions "
                                       "differ")
                fin = torch.isfinite(want)
                err = (got - want).abs()[fin]
                if chain == "select":
                    limit = T1_SELECT_STEP[name] * want.abs()[fin]
                elif dtype == torch.float32:
                    after_one = t1.chain_plain(x, chain, 1).float().abs()[fin]
                    grow = 1.0 + 0.9 * after_one if reps == 2 else torch.ones_like(after_one)
                    limit = T1_EXP_F32 * grow * want.abs()[fin]
                else:
                    limit = (T1_EXP_BF16 + 2.0 ** -8 * x.float().abs()[fin]) * want.abs()[fin]
                used = (err / limit.clamp_min(torch.finfo(torch.float32).tiny)).max().item()
                rel = (err / want.abs()[fin].clamp_min(1e-30)).max().item()
                print(f"[t1] {chain} {name} reps {reps}: max relative error {rel:.3e}, at most "
                      f"{used:.2f} of its limit; {int((~fin).sum())} non-finite at the same "
                      f"places")
                if used > 1.0:
                    raise RuntimeError(f"T1 {chain} {name} reps {reps} disagrees with its plain "
                                       "version")
                worst = max(worst, err.max().item())

    reps, grid = 64, 64
    t1.elementwise_chain.launches = 0
    cases = probe.run(reps, grid)
    launches = t1.elementwise_chain.launches
    if launches != 2 * 2 * (1 + probe.STEPS):
        raise RuntimeError(f"[t1] the probe launched the kernel {launches} times")
    steps = probe.BLOCK[0] * probe.BLOCK[1] * reps * grid
    # one special-function op an exp step; a select step's multiply and add on
    # the FP32 pipe (its compare and select issue beside them); bf16 counts a
    # packed op for two elements, as if it issued at f32's rate
    pipe = {"exp": SFU_OPS, "select": F32_FLOPS / 2 / 2}
    for key, case in cases.items():
        chain, name = key.split()
        dtype = getattr(torch, name)
        x = x32.to("cuda", dtype)
        per_op = 2 if dtype == torch.bfloat16 else 1
        case.update(bound(2 * x.numel() * x.element_size(),
                          **{chain: steps / per_op / pipe[chain]}))
        case["plain_ms"] = cuda_ms(lambda: [t1.chain_plain(x, chain, reps) for _ in range(grid)],
                                   reps=3)
        print(f"[t1] {key} reps {reps} grid {grid}: kernel {case['ms']:.3f} ms "
              f"({case['gelem_s']:.1f} Gelem/s), bound {case['bound_ms']:.3f} ms "
              f"({case['bound_by']}), plain {case['plain_ms']:.3f} ms")
    head = cases["exp float32"]
    return {"max_abs_err": worst, "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"], "library_ms": None,
            "bf16_speedup": {c: cases[f"{c} bfloat16"]["speedup"] for c in t1.CHAINS},
            "cases": cases, "launches": launches}


HERE = os.path.dirname(os.path.abspath(__file__))
TRAINER_CONFIG = os.path.join(HERE, "configs", "examples", "synthetic", "h100_500k.toml")
TRAINER_DIR = os.path.join(HERE, ".data", "chip_smoke_trainer")  # .gitignore lists .data/
RELOAD_BOUND = 1e-4  # relative, test metrics after reloading the checkpoint: the same
#                      weights and samples, K5's float atomics in another order


def trainer_overrides(root, **optimizer_args):
    """The recipe's config with its dataset and every output under `root`."""
    out = os.path.join(root, "out")
    return {"dataset": {"base_path": os.path.join(root, "synthetic_500k")},
            "optimizer": {"args": optimizer_args},
            "path": {"ckpt_path": os.path.join(out, "h100_500k.pt"),
                     "loss_path": os.path.join(out, "loss.png"),
                     "result_path": os.path.join(out, "result.png"),
                     "database_path": os.path.join(out, "db.csv")}}


class TrainerSpy:
    """Context that records, for every train step the trainer takes, each
    kernel's launches, the batch's number of sections and the device time
    between two CUDA events (read after the run: nothing here waits for the
    card), and the host seconds of every validate() call."""

    def __init__(self, counters):
        self.counters = counters
        self.steps, self.events, self.validate_s = [], [], []
        self.before = None

    def __enter__(self):
        import torch

        from gaot3d_tpu_torch.train import trainer as trainer_module

        step, validate = trainer_module.train_step, trainer_module.StaticTrainer3D.validate

        def spy_step(model, optimizer, batch, generator=None):
            if self.before is None:
                self.before = [p.detach().clone() for p in model.parameters()]
            was = {n: fn.launches for n, fn in self.counters.items()}
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = step(model, optimizer, batch, generator)
            end.record()
            self.events.append((start, end))
            self.steps.append({**{n: fn.launches - was[n] for n, fn in self.counters.items()},
                               "sections": len(batch.enc_slots.sections)})
            return out

        def spy_validate(trainer, loader):
            t0 = time.perf_counter()
            out = validate(trainer, loader)
            self.validate_s.append((time.perf_counter() - t0, len(loader.dataset)))
            return out

        self.patches = [mock.patch.object(trainer_module, "train_step", spy_step),
                        mock.patch.object(trainer_module.StaticTrainer3D, "validate",
                                          spy_validate)]
        for patch in self.patches:
            patch.start()
        return self

    def __exit__(self, *exc):
        for patch in self.patches:
            patch.stop()

    def step_ms(self):
        """Device ms of every step but the first (which warms up)."""
        return [a.elapsed_time(b) for a, b in self.events[1:]]


def attention_counters():
    from gaot3d_tpu_torch.kernels import encoder_payload as k5
    from gaot3d_tpu_torch.kernels import flash_attention as k1

    return {"k1": k1.flash_attention, "k2": k1.flash_attention_backward,
            "k3_dq": k1.flash_attention_backward_dq, "k3_dkv": k1.flash_attention_backward_dkv,
            "k5": k5.encoder_accumulate, "k5b": k5.encoder_accumulate_backward}


def check_steps(label, spy, expect_per_step):
    """Every recorded step launched what `expect_per_step` says (K5 and K5b:
    one launch a section of the step's batch)."""
    for i, step in enumerate(spy.steps):
        want = {**expect_per_step, "k5": step["sections"], "k5b": step["sections"]}
        got = {n: step[n] for n in want}
        if got != want:
            raise RuntimeError(f"{label} step {i}: launches {got}, expected {want}")


def phase_trainer(card):
    """[trainer]: the recipe's config through the CLI's entry point."""
    import csv

    import torch

    from gaot3d_tpu_torch import cli
    from gaot3d_tpu_torch.config import load_run_config
    from gaot3d_tpu_torch.train.trainer import init_trainer
    from gaot3d_tpu_torch.utils.dataclass_utils import merge_config

    root = TRAINER_DIR
    shutil.rmtree(root, ignore_errors=True)
    overrides = trainer_overrides(root)
    counters = attention_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with TrainerSpy(counters) as spy:
        row, trainer = cli.run_config_file(TRAINER_CONFIG, overrides, return_trainer=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    total = {n: fn.launches for n, fn in counters.items()}

    args = trainer.optimizer_config.args
    steps_per_epoch = len(trainer.train_loader)
    if len(spy.steps) != args.epoch * steps_per_epoch:
        raise RuntimeError(f"[trainer] {len(spy.steps)} steps, expected "
                           f"{args.epoch} x {steps_per_epoch}")
    check_steps("[trainer]", spy, {"k1": 10, "k2": 10, "k3_dq": 0, "k3_dkv": 0})
    sections = sorted({s["sections"] for s in spy.steps})

    out = overrides["path"]
    losses = np.load(out["loss_path"].rsplit(".", 1)[0] + ".npz")
    want_epochs = [e for e in range(args.epoch) if (e + 1) % args.eval_every_eps == 0]
    if losses["val_epoch"].tolist() != want_epochs or len(spy.validate_s) != len(want_epochs):
        raise RuntimeError(f"[trainer] validated at epochs {losses['val_epoch'].tolist()}, "
                           f"expected {want_epochs}")
    if not (np.isfinite(losses["train_loss"]).all() and np.isfinite(losses["val_loss"]).all()):
        raise RuntimeError("[trainer] non-finite loss")
    result_npz = out["result_path"].rsplit(".", 1)[0] + ".npz"
    for path in (out["ckpt_path"], result_npz, out["database_path"]):
        if not os.path.exists(path):
            raise RuntimeError(f"[trainer] {path} was not written")
    with open(out["database_path"], newline="") as f:
        rows = list(csv.DictReader(f))
    columns = ("nparams", "p2r edges", "r2p edges", "training time", "inference time",
               "MSE (x10^-2)", "MAE (x10^-1)")
    missing = [c for c in columns if c not in rows[-1] or rows[-1][c] == ""]
    if len(rows) != 1 or missing:
        raise RuntimeError(f"[trainer] CSV has {len(rows)} rows, missing columns {missing}")
    pred = np.load(result_npz)["prd"]
    n_nodes = trainer.dataset_config.synthetic_num_nodes
    if pred.shape != (n_nodes, 1) or not np.isfinite(pred).all():
        raise RuntimeError(f"[trainer] result npz: prediction {pred.shape} or non-finite")

    # a new trainer from the same config reloads the checkpoint and tests again
    config = merge_config(load_run_config(TRAINER_CONFIG),
                          {**overrides, "setup": {"train": False}})
    again = init_trainer(config)
    again.load_ckpt()
    again.test()
    for column in ("MSE (x10^-2)", "MAE (x10^-1)"):
        a, b = float(row[column]), float(again.datarow[column])
        if not abs(a - b) <= RELOAD_BOUND * abs(a):
            raise RuntimeError(f"[trainer] {column} {a} after fit, {b} from the reloaded "
                               "checkpoint")

    stats = trainer.last_loader_stats
    val_s, val_n = spy.validate_s[-1]
    ms = spy.step_ms()
    print(f"[trainer] {card}: {args.epoch} epochs of {steps_per_epoch} steps, validation at "
          f"epochs {want_epochs}, test on {len(trainer.test_loader.dataset)} samples in "
          f"{wall:.1f} s; dataset generated in {trainer.dataset_seconds:.1f} s, precompute "
          f"sweep of {trainer.dataset_config.synthetic_num_samples} samples "
          f"{trainer.precompute_seconds:.1f} s")
    print(f"[trainer] {card}: train loss {losses['train_loss'].tolist()}, val loss "
          f"{losses['val_loss'].tolist()}; MSE (x10^-2) {float(row['MSE (x10^-2)']):.4f}, "
          f"reloaded {float(again.datarow['MSE (x10^-2)']):.4f}; nparams {row['nparams']}, "
          f"p2r edges {row['p2r edges']}")
    print(f"[trainer] {card}: step device time median {np.median(ms):.1f} ms (min "
          f"{min(ms):.1f}, max {max(ms):.1f}); last epoch: wall "
          f"{1e3 * stats['epoch_wall_s'] / stats['steps']:.1f} ms a step, loader stall "
          f"{trainer.last_loader_stall_s:.3f} s (first wait "
          f"{trainer.last_loader_first_wait_s:.3f} s), host_load_s "
          f"{stats.get('host_load_s', 0.0):.3f}, put_s {stats.get('put_s', 0.0):.3f} for "
          f"{stats['steps']} batches; validate {1e3 * val_s / val_n:.1f} ms a sample, test "
          f"inference {1e3 * float(row['inference time']):.1f} ms a sample; peak memory "
          f"{peak:.2f} GiB")
    print(f"[trainer] launches a step: K1 10, K2 10, K3 0, K5 and K5b one a section "
          f"(sections a batch: {sections}); in all {total}")
    return total, float(np.median(ms))


def phase_trainer_split(card, fused_ms):
    """[trainer-split]: one epoch of the same config with the split backward
    selected by GAOT_ATTN_BWD_FUSED=0 in the environment."""
    import torch

    from gaot3d_tpu_torch import cli

    root = TRAINER_DIR
    overrides = trainer_overrides(root, epoch=1, eval_every_eps=1)
    overrides["setup"] = {"test": False}
    counters = attention_counters()
    for fn in counters.values():
        fn.launches = 0
    with mock.patch.dict(os.environ, {"GAOT_ATTN_BWD_FUSED": "0"}), \
            TrainerSpy(counters) as spy:
        _, trainer = cli.run_config_file(TRAINER_CONFIG, overrides, return_trainer=True)
    torch.cuda.synchronize()
    if os.environ.get("GAOT_ATTN_BWD_FUSED") == "0":
        raise RuntimeError("[trainer-split] the environment was not restored")
    total = {n: fn.launches for n, fn in counters.items()}
    if len(spy.steps) != len(trainer.train_loader):
        raise RuntimeError(f"[trainer-split] {len(spy.steps)} steps")
    check_steps("[trainer-split]", spy, {"k1": 10, "k2": 0, "k3_dq": 10, "k3_dkv": 10})
    losses = np.load(overrides["path"]["loss_path"].rsplit(".", 1)[0] + ".npz")
    if not (np.isfinite(losses["train_loss"]).all() and np.isfinite(losses["val_loss"]).all()):
        raise RuntimeError("[trainer-split] non-finite loss")
    still = [n for (n, p), b in zip(trainer.model.named_parameters(), spy.before)
             if torch.equal(p, b)]
    if still:
        raise RuntimeError(f"[trainer-split] parameters that did not move: {still}")
    ms = spy.step_ms()
    print(f"[trainer-split] {card}: {len(spy.steps)} steps with GAOT_ATTN_BWD_FUSED=0: train "
          f"loss {losses['train_loss'].tolist()}, val loss {losses['val_loss'].tolist()}; every "
          f"one of {len(spy.before)} parameter tensors moved; launches a step K1 10, K2 0, K3 dq "
          f"10, K3 dk/dv 10; step device time median {np.median(ms):.1f} ms against "
          f"{fused_ms:.1f} ms with the fused backward")
    return total


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--flat-seed", type=int, default=31,
                        help="seed of the cloud of the [k6], [k7], [k8] and [flat] phases")
    parser.add_argument("--only", default="",
                        help="comma-separated subset of k1, attention-train, k3, k5, trainer, "
                             "trainer-split, t1: run just these phases (kernels build at first "
                             "use) and print no record")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA GPU",
              file=sys.stderr)
        return 1
    import gaot3d_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from gaot3d_tpu_torch.ops.grid_graph import LatentGrid

    card = card_name_and_power()
    print(f"[device] {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.only:
        fused_ms = float("nan")
        for name in args.only.split(","):
            if name == "k1":
                phase_k1()
            elif name == "attention-train":
                phase_attention_train()
            elif name == "t1":
                phase_t1()
            elif name == "k5":
                from gaot3d_tpu_torch.kernels import build, encoder_payload
                build.build_together([encoder_payload._library,
                                      encoder_payload._backward_library])
                encoder_build_facts()
                phase_k5()
            elif name == "k3":
                phase_k3()
            elif name == "trainer":
                _, fused_ms = phase_trainer(card)
            elif name == "trainer-split":
                phase_trainer_split(card, fused_ms)
            else:
                parser.error(f"unknown phase {name!r}")
        return 0
    phase_build()
    k1 = phase_k1()
    k5, k5b = phase_k5()
    serve = phase_serve()
    k4 = phase_k4()
    k1d, k2, replay_launches = phase_attention_train()
    k3 = phase_k3()
    train = phase_train(k5b["ms"])
    torch.cuda.empty_cache()
    fit, fused_ms = phase_trainer(card)
    split = phase_trainer_split(card, fused_ms)
    shutil.rmtree(TRAINER_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    flat_input = flat_cloud(args.flat_seed, N_POINTS, LatentGrid(dims=LATENT))
    k7, k6, k8 = phase_sorted_kernels(flat_input)
    flat = phase_flat(flat_input)
    del flat_input
    t1 = phase_t1()
    pallas = "gaot3d_tpu/ops/pallas_attention.py"
    kernels = [
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": "gaot3d_tpu_torch/csrc/flash_attn_fwd.cu", "replaces": f"{pallas}:394",
         "launches": serve["k1"] + fit["k1"] - fit["k2"], **k1},  # the trainer's eval forwards
        {"name": "flash_attn_fwd_dropout", "route": "cuda",
         "source": "gaot3d_tpu_torch/csrc/flash_attn_fwd.cu", "replaces": f"{pallas}:144",
         "launches": train["k1"] + fit["k2"], **k1d},  # one train forward a fused backward
        {"name": "flash_attn_bwd", "route": "cuda",
         "source": "gaot3d_tpu_torch/csrc/flash_attn_bwd.cu", "replaces": f"{pallas}:502",
         "launches": train["k2"] + fit["k2"], **k2},
        # the two kernels of the pair launch together: `launches` is the dq kernel's count,
        # held equal to the dk/dv kernel's by [trainer-split]
        {"name": "flash_attn_bwd_split", "route": "cuda",
         "source": "gaot3d_tpu_torch/csrc/flash_attn_bwd_split.cu", "replaces": f"{pallas}:544",
         "launches": split["k3_dq"], "launches_dkv": split["k3_dkv"], **k3},
        {"name": "dropout_bits", "route": "cuda",
         "source": "gaot3d_tpu_torch/csrc/dropout_bits.cu", "replaces": f"{pallas}:709",
         "launches": replay_launches, **k4},
        {"name": "encoder_payload", "route": "cuda",
         "source": "gaot3d_tpu_torch/csrc/encoder_payload.cu",
         "replaces": "gaot3d_tpu/ops/pallas_encoder.py:203",
         "launches": serve["k5"] + train["k5"] + fit["k5"], **k5},
        {"name": "encoder_payload_bwd", "route": "cuda",
         "source": "gaot3d_tpu_torch/csrc/encoder_payload_bwd.cu",
         "replaces": "gaot3d_tpu/ops/pallas_encoder.py:246",
         "launches": train["k5b"] + fit["k5b"], **k5b},
        {"name": "segment_sum_sorted", "route": "cuda",
         "source": "gaot3d_tpu_torch/csrc/segment_sum_sorted.cu",
         "replaces": "gaot3d_tpu/ops/pallas_segment.py:103", "launches": flat["k6"], **k6},
        {"name": "prefix_sum", "route": "cuda",
         "source": "gaot3d_tpu_torch/csrc/prefix_sum.cu",
         "replaces": "gaot3d_tpu/ops/pallas_kernels.py:49", "launches": flat["k7"], **k7},
        {"name": "tile_segment_sum", "route": "cuda",
         "source": "gaot3d_tpu_torch/csrc/tile_segment_sum.cu",
         "replaces": "gaot3d_tpu/ops/pallas_kernels.py:138", "launches": flat["k8"], **k8},
        # the probe's own entry point is its main path
        {"name": "elementwise_chain", "route": "cuda",
         "source": "gaot3d_tpu_torch/csrc/elementwise_chain.cu",
         "replaces": "tools/microbench_vpu_bf16.py:28", **t1},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
