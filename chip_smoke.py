"""Smoke run of the PyTorch port (gaot3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--flat-seed N] [--only k1,attention-train,k3,k5,t1,...]

`--flat-seed` (31) seeds the cloud of phases 13 and 14, for a second reading
of their limits. `--only` runs just the named phases (k1, attention-train,
k3, k5, k9, k10, serve-device, serve-buckets, nf, trainer, export (after trainer),
trainer-split, trainer-nf, variants, trainer-variants, processor, dist (its
part (a) after trainer), t1, k7, k6, k8, flat; the last four share one
cloud), builds each kernel at its first use and prints no record: for work
on one phase. `--dist-worker` is one rank of [dist], which the script starts
itself.

Phases, each of which raises (exit code 1) on failure:
  1. device: needs CUDA (exits 1 without it), prints the card's name and
     power limit, turns TF32 off;
  2. build: compiles the fourteen CUDA libraries of gaot3d_tpu_torch/csrc
     with nvcc (K5 and K5b each an f32 and a bf16 body),
     all at the same time, and prints each library's registers and spills
     from `-Xptxas -v`; for each body of K5 and K5b at the recipe's widths
     also its shared memory, the CTAs an SM holds and the TF32
     (HMMA...TF32) and bf16 (HMMA...BF16) tensor-core and FFMA instructions
     `cuobjdump -sass` finds (a body without the tensor-core instructions of
     its products fails); for
     every body of K2 and K3 its registers and spills, and for K3's its
     wgmma (HGMMA) and mma.sync (HMMA) instructions (a bf16 body at head dim
     16-64 without wgmma, or any mma.sync, fails);
  3. [k1] flash-attention forward vs its plain version at B1 H8 S16384 D32
     bf16 and at a ragged S=1000;
  4. [k5] encoder payload + scatter vs its plain version on the degree
     sections of a 524,288-point cloud (radius 0.033, slot budget 5, 64x64x32
     grid), the accumulator and its value columns each to 1e-5 relative, and
     [k5b] its backward (dfeats, dW, db) vs autograd through the plain
     version on the same sections, dfeats the same bits in two launches; both
     timed as the five launches alone and through their wrappers, with the
     bound from the 3xTF32 products, the GELU's instructions (counted in the
     SASS of its formula built alone), the L2 reductions (K5's scatter the
     least time of the ways of adding these rows' payloads that
     tools/probe_encoder_payload.py `red_rates` measures here, K5b's dW one
     reduction a parameter an output at the fastest rate) and the bytes;
     then [k5-bf16] and [k5b-bf16], the bf16 bodies (`kernel_dtype:
     bfloat16`, valid-row tiles) vs their bf16 plain versions on the same
     sections, on the neural-field step's [1, 40,000, 5] slots and on the
     slots the card builds for the whole cloud ([1, 524,288, 5]), in
     relative L2 (K5_BF16_BOUND over the value columns, K5B_BF16_BOUND for
     each of dfeats, dW, db), K5b launched once a call (a dW slice a node
     chunk), dfeats the same bits twice; the share of tile rows that are
     valid in the earlier node-major tiles of every slot and in the tile
     map; each timed as its launches alone beside the f32 body's time, the
     earlier design's (NODE_MAJOR_MS) and its bound (one bf16 pass forward;
     the backward's recompute one bf16 pass, its chain and dW two TF32
     passes each; the L2 terms as above, K5b's a dW slice a node chunk);
  4b. [k9] the decoder payload (K9) at the main path's shape, the request
     of configs/examples/drivaerml/pressure.yaml: 8,388,608 points of a
     closed surface, uniform slots the card builds at budget 8, the decoder
     of that config's model (kernel_dtype float32). The decoder must pick K9
     (`MAGNODecoder._payload_means`, one launch); its mean against the plain
     `decoder_chunk` over node chunks of 65,536 in relative L2 (K9_BOUND);
     a second launch the same bits; `decoder_payload.launches` reset to 0
     before, 2 after; K9's device time (`kernel_ms`), the plain chunks'
     time and the bound: the FP32 pipe's FMAs of the kernel MLP and its
     exact GELUs on the valid slots, the MUFU's, and the bytes;
  4c. [k10] the slot build (K10) at drivaerml's grid, radius and budget 8
     (bidirectional, k 1) over the closed surfaces of [k9] at 8,388,608 and
     1,048,576 points (a request, and a rank's shard of the four-chip
     training): `build_budgeted_slots` must take K10 (one launch a build,
     `slot_build.launches`); its slots against the plain build on the card
     (node chunks of 65,536) bit for bit, two launches the same bits; K10's
     device time (`kernel_ms`), the plain build's and the bound (bytes: the
     points and the [N, 8] slots; the FP32 pipe: the per-axis offsets once a
     point, a sum and a compare a candidate);
  5. [serve] the DrivAerNet++ recipe model (random weights from a seed,
     `kernel_dtype: bfloat16` as tpu_500k.yaml sets it) is exported, loaded
     on the card and answers 2 requests of 524,288 points through K5's bf16
     body;
     the second is answered once more for the warm forward time, the first
     once more with every kernel replaced by its plain version;
  6. [k4] the dropout-bits exporter vs the plain Philox, bit for bit;
  7. [k1d] the forward at dropout rate 0.1 drawing from a seed vs its plain
     version fed the exported bits; keep rate; determinism;
  8. [k2] the fused backward at rates 0 and 0.1 vs the plain backward with
     the same bits, at the recipe shape and at ragged S=1000, Skv=130;
  9. [replay] the seeded forward and backward reproduce, from the bits the
     exporter writes for their seed, the same results (the path K4 serves);
     then [offset]: K4, K1, K2 and K3's dk/dv kernel drawing at a batch
     offset (bh_offset, a rank's rows of a larger batch) against their plain
     versions at that offset and against the same rows of one launch over
     the whole batch;
 10. [k3] the split backward (its dk/dv kernel, then its dq kernel on the
     keep mask the first writes) at rates 0 and 0.1 at the recipe shape, and
     at six small shapes (f32, bf16, every head dim, S and Skv no tile
     multiples): against the plain backward with the same bits, against the
     fused kernel (dk and dv bit for bit), two launches and the seed against
     its exported bits bit for bit, the keep mask against the plain packing
     of those bits; each kernel timed alone beside its own bound, the mask's
     bytes and the pair's peak memory;
 11. [train] the recipe model takes 2 AdamW steps (mix schedule, dropout 0.1)
     on one 524,288-point cloud at `kernel_dtype: bfloat16`; launches per
     step must be exactly K1 10, K2 10, K5 5 and K5b 5 (a section each),
     all of K5 and K5b through their bf16 bodies; then a breakdown of one
     step, with K5's, K5b's and the GEMMs' device time and launches in its
     profile; the decoder's bf16 kernel MLP on one chunk's rows timed as
     the port takes it (f32 GEMMs of bf16-rounded operands) and as torch.mm
     of bf16 operands with an f32 result; then one forward-and-backward on a
     32x32x16 grid with 65,536 points, at f32 and at bf16, is repeated with
     every kernel replaced by its plain version at the same seed.
 12. [trainer] `gaot3d_tpu_torch.cli.run_config_file` on
     configs/examples/synthetic/h100_500k.toml with its data and outputs
     under .data/chip_smoke_trainer (`kernel_dtype: bfloat16`): the
     synthetic set (10 clouds of 500,000 points) is generated and swept, 3
     epochs of 6 steps, validation after
     epoch 2, test on 2 clouds; finite losses, the checkpoint, both .npz
     files and the CSV row with the JAX trainer's columns; a new trainer that
     reloads the checkpoint tests to the same metrics; every step launched
     K1 10, K2 10, K3 0, K5's and K5b's bf16 bodies once a section. Then
     [trainer-split]: one
     epoch of the same config with GAOT_ATTN_BWD_FUSED=0 in the environment:
     every step K3's two kernels 10 times each and K2 never, finite losses,
     every parameter tensor moved.
 13. [k7] the prefix sum, [k6] the sorted segment sum and [k8] the tile
     segment sum (run right after [build], before any phase profiles) vs
     their plain versions at a ragged small shape and at the shapes one
     65,536-node chunk of a 524,288-point cloud gives them (its flat list,
     and for K7 under `sort` and K8 its 327,680 slots), each column held to
     its own size, two launches and each kernel's ordered twin compared bit
     for bit, K8 against K6 on the same sorted rows bit for bit, K7 and K6
     one launch a call, K6 also at three batches; each timed by the device
     time of its own launches under torch.profiler (`device_ms`, warm and
     with a cold L2) and as one wrapper call between two CUDA events
     (`call_ms`);
 14. [flat] the recipe (at `kernel_dtype: float32`, so that the sorted
     reductions meet f32 limits) over flat edge lists and the sorted reductions: config
     A (flat 'dst' lists, K6 for the encoder, K7 folds by node for the
     decoder) is exported, loaded and serves the cloud twice (accumulator bit
     for bit), then takes 2 AdamW steps with dropout; config B (K7 folds on
     both sides) and config C (slots sorted on the card, K8 or K7) serve it
     too, and each configuration's warm forward is profiled once (device
     busy and idle share, its five largest kernels, K6-K8's share); all
     against the uniform-slot forward through K5, every column of the
     encoder's accumulator to a stated limit and the output in relative L2;
     then config A's
     gradient through the kernels vs through the plain versions on a 32x32x16
     grid;
 15. [t1] the elementwise-chain probe: its kernel vs its plain version for
     both chains in f32 (reps 1 and 2) and bf16 (reps 1), each element held
     to a limit relative to its value and the non-finite positions compared
     as sets; then the probe's entry point
     (`gaot3d_tpu_torch.tools.microbench_vpu_bf16.run`) at reps 64, grid 64,
     and each case's plain time; each case's bound from the instructions an
     element-step of the kernel's own SASS, by pipe and in issue slots.
 16. [serve-device] (run after [serve]) the recipe over uniform slots (slot
     budget 5), exported and loaded with edges="device", answers 2 requests
     of 524,288 points whose slots the card builds in the forward: each
     build's time by CUDA events and its peak memory, the forward's time, K1
     10 and K5 1 (its bf16 body) launches a request, that launch against its
     plain version; request 1's slots against the port's
     build on the CPU bit for bit, against the native host build
     (native/gaot_graph.cpp) with every differing edge within BAND of the
     radius, and its prediction against the same model's forward on the
     host-built slots in relative L2; request 2 once more warm;
 17. [nf] (run after [train]) the recipe over uniform slots, at
     `kernel_dtype: float32` (the f32 bodies on a path at full width), takes 2 AdamW
     steps (mix schedule, dropout 0.1) by neural field, 40,000 input and
     query nodes of a 524,288-point cloud: K1 10, K2 10, K5 1, K5b 1 a step,
     finite loss and gradients, every parameter moves; the sampler's time;
     a full-grid eval forward with its slots built on the card (K1 10, K5 1,
     K9 1); then one
     neural-field loss and backward on a 32x32x16 grid with 65,536 points
     against the plain versions on the same indices;
 18. [trainer-nf] (run after [trainer-split], on its data) the trainer on
     h100_500k.toml (`kernel_dtype: bfloat16`) by neural field (40,000
     nodes, uniform slots built on the card, no precompute; K5b's bf16 body
     once a step, the nodes being one chunk), 2 epochs, validation and test on the full
     500,000-point clouds: launches a step, finite losses, every parameter
     moved, the epoch wall a step, the loader's stall, validate and test ms
     a sample;
 19. [serve-buckets] (run after [serve-device]) the recipe over uniform slots
     in a bucket bundle of {262,144, 524,288} nodes that builds its slots on
     the card (`export_inference_buckets`, `load_inference_buckets`):
     requests of 400,000 points (padded to 524,288), 262,144, 524,288, and
     524,288 with host-built sections passed at call time, each of shape
     [1, n, 1] and finite, with K1 10 and K5's bf16 body 1 (device-built
     slots) or once a section; the dispatcher's pad, forward and slice by
     CUDA events, the request's wall and peak memory; request 1 within
     RERUN_BOUND of the model's forward on the same padded inputs and within
     1e-3 relative L2 of the plain versions, its K5 launch against its plain
     version at the padded shape, once more warm; a request of 600,000
     points raises and launches nothing;
 20. [export] (run after [trainer], on its checkpoint) the port's
     `tools/export_model.py` writes a serving artifact that builds its
     slots, `load_inference` serves one request of 524,288 points within
     RERUN_BOUND of the trainer's model's own eval forward (K1 10, K5 1);
     then `tools/export_torch_ckpt.py` and `tools/import_torch_ckpt.py` take
     the checkpoint to the reference's layout and back, the same bits.
 21. [variants] (run after [trainer-nf]) twelve MAGNO variants of the recipe
     (`kernel_dtype: bfloat16`) over uniform slots built on the card from one
     524,288-point cloud, each one change: (a) the unfused encoder under
     'sort' and 'scatter', (b) nonlinear and nonlinear_kernelonly GNOs with
     cosine attention (at `kernel_dtype: float32`: its kernel MLPs take the
     latent features, whose bf16 rounding would flip where K1 and its plain
     version differ), (c) dot-product attention, (d) the PointNet geoembed
     on both sides, max and mean pooling, (e) the decoder's statistical
     geoembed (FusedDecoderScale), (f) two scales with scale weights at the
     slot budget of twice the radius (printed), (g) 'ratio' 0.5 and
     'max_neighbors' 3 sampling and the radius cap 4, (h) `use_gno: false`.
     Each: an eval forward, finite and within E2E_BOUND of the plain
     versions, timed warm by CUDA events with its peak; one AdamW step
     (dropout, edge sampling from a generator on the card), finite, every
     parameter moved, timed with its peak; K1, K2, K5 and K5b launches as
     the configuration gives them (K5 once a scale on the fused linear
     encoder under 'scatter', K5b once a scale too), K7 only and
     at least once under 'sort';
 22. [trainer-variants] (run after [variants], on [trainer]'s data) the
     trainer through the CLI's entry point on h100_500k.toml with (f), (d)
     and (b) combined and 'ratio' sampling, host-built slots of both scales
     through the loader, one epoch of 2 samples, validation and test on 1:
     its losses, step times, loader stall, peak; K1 10 and K2 10 a step.
 23. [rope3d] and [cond] (run after [trainer-variants]) the recipe at full
     width over 5 degree sections with the processor's `positional_embedding:
     rope3d`, then also a ConditionedNorm in every block's attention and FFN
     under c = [[0.7]]: an eval forward against the plain versions
     (E2E_BOUND), timed warm, K1 10; two AdamW steps, K1 10, K2 10, K5 a
     section and K5b a section (bf16 bodies), every parameter moving (the
     ConditionedNorm maps' moves printed); two steps on a 32x32x16 grid with
     the kernels and with the plain versions, losses and the second step's
     gradient to E2E_BOUND.
 24. [dist] (a) the trainer on [trainer]'s data (2 steps) with
     `distributed: true` in one process over NCCL against the undistributed
     trainer, the step losses to DIST_LOSS_BOUND; (b) node_shards 2 on one
     synthetic cloud of 1,048,576 points and (c) data_parallel 2 on two of
     524,288, the model of configs/examples/drivaerml/pressure.yaml at full
     width (slot budget 8, slots built on the card), two ranks on the one
     card over gloo (this script with --dist-worker): two steps and an eval,
     against one process on the same global batch: losses to
     DIST_LOSS_BOUND, the second step's gradient and the gathered eval output
     to DIST_BOUND relative L2; each rank's step ms, the all-reduces' ms and
     its peak printed.
Yardsticks off the main path (`library_ms`): torch's
scaled_dot_product_attention forward and backward at the recipe shape,
`torch.cumsum` and `index_add_`.
The last two lines are a JSON record of the kernels and
{"ok": true, "device": {...}}.
"""
import argparse
import json
import math
import os
import re
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
# The bf16 bodies against their bf16 plain versions, relative L2: K5 over the accumulator's
# value columns, K5b of each of dfeats, dW, db. Sums in another order flip a bf16 rounding
# here and there (a hidden activation, a chunk's dW: one bf16 step of it), which L2 averages;
# tests/test_torch_port_payload_bf16.py emulates the bodies' arithmetic within these limits
# (about 1e-5 and 5e-4) and shows that positions left in f32 (8e-4) and a cotangent rounded
# to bf16 (6e-3) do not meet them. On an H100 the first layer's dW, a near-cancelling sum
# over a whole chunk, read up to 9e-4 (one 200,000-row chunk): K5b's limit is twice that
K5_BF16_BOUND = 1e-4
K5B_BF16_BOUND = 2e-3
K9_BOUND = 1e-6   # relative L2, K9 against the plain decoder_chunk: the same f32 products and
#                   exact GELUs, sums taken in another order (a few 1e-8 against float64 each)
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
NF_NODES = 40_000  # neural-field input and query nodes a graph (DatasetConfig's defaults)
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


def attention_bound(B, H, S, Skv, D, products, n_tensors, dropout, itemsize=2, extra_bytes=0):
    """Bound of an attention kernel: `products` tile products of 2*S*Skv*D
    flops a head, one exponential a score, one Philox call per four scores
    under dropout; `n_tensors` [B,H,S,D] tensors, lse, delta and
    `extra_bytes` moved."""
    scores = B * H * S * Skv
    ops = {"tensor": products * 2 * scores * D / BF16_FLOPS, "exp": scores / SFU_OPS}
    if dropout:
        ops["philox"] = scores / 4 * PHILOX_OPS / INT32_OPS
    return bound(n_tensors * B * H * max(S, Skv) * D * itemsize + 2 * B * H * S * 4
                 + extra_bytes, **ops)


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


def profiled(fn):
    """Run fn once under torch.profiler: (host ms until the device is done,
    [(name, device ms, count)] of every device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return wall, [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]


def print_profile(tag, label, wall, rows, top=5, mine=()):
    """Device busy and idle share of a profiled run, its `top` kernels by
    device time and the share of the kernels named in `mine`."""
    busy = sum(r[1] for r in rows)
    if busy <= 0:
        print(f"[{tag}] {label}: torch.profiler recorded no device time here: idle share "
              f"not measured")
        return
    print(f"[{tag}] {label}: wall {wall:.1f} ms, device busy {busy:.1f} ms, idle share "
          f"{100 * (1 - busy / wall):.1f}%")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"[{tag}]   {ms:8.3f} ms {count:4d}x {key[:90]}")
    if mine:
        own = [r for r in rows if any(n in r[0] for n in mine)]
        print(f"[{tag}]   K6-K8 kernels: {sum(r[1] for r in own):.3f} ms in "
              f"{sum(r[2] for r in own)} launches, {100 * sum(r[1] for r in own) / busy:.1f}% "
              f"of device busy")


FLUSH_BYTES = 128 << 20  # written between calls timed with a cold L2 (50 MB on an H100)


def kernel_ms(fn, names, bare=None, reps=5):
    """A kernel's readings: `device_ms`, the device time of the launches of
    one call of `fn` whose kernel names hold one of `names`, summed per call,
    median of `reps` calls in one torch.profiler session (warm L2), and
    `device_ms_cold` the same with FLUSH_BYTES written before each call;
    `call_ms`, one call of the wrapper between two CUDA events (cuda_ms);
    `device_launches_per_call`, those launches a call. Where the profiler
    records none of them, `bare()` (20 launches of the bare C entry point
    between two events, buffers allocated beforehand, in ms a launch) gives
    `device_ms` and the cold reading is not measured. `ms` is `device_ms`,
    and `ms_reading` says what it is."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")

    def session(cold):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if cold:
                    flush.fill_(1.0)
                fn()
            torch.cuda.synchronize()
        mine = sorted((e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and any(n in e.name for n in names)), key=lambda e: e.time_range.start)
        if not mine or len(mine) % reps:
            return None, len(mine)
        per = len(mine) // reps
        return [sum(e.time_range.elapsed_us() for e in mine[i * per:(i + 1) * per]) / 1e3
                for i in range(reps)], per

    fn()
    warm, per_call = session(False)
    cold, _ = session(True)
    rec = {"call_ms": cuda_ms(fn, reps), "device_launches_per_call": per_call if warm else None}
    if warm and cold:
        rec.update(device_ms=float(np.median(warm)), device_ms_cold=float(np.median(cold)),
                   ms_reading=f"device time of the kernel's launches under torch.profiler, "
                              f"median of {reps} calls, warm L2")
    else:
        print(f"kernel_ms: torch.profiler recorded {per_call} launches of {names} in {reps} "
              f"calls; timing 20 launches of the bare entry point between two CUDA events "
              f"instead")
        rec.update(device_ms=float(np.median([bare() for _ in range(reps)])),
                   device_ms_cold=None,
                   ms_reading="20 launches of the bare C entry point between two CUDA events, "
                              f"median of {reps}, warm L2 (the profiler saw no device time)")
    rec["ms"] = rec["device_ms"]
    del flush
    return rec


def bare_launches(launch, n=20):
    """ms a launch of `launch()` (a ctypes call on buffers allocated
    beforehand), n launches between two CUDA events."""
    import torch

    launch()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


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


def encoder_loaders():
    """The loaders of K5's and K5b's four libraries: each kernel's f32 and
    bf16 bodies, one source built twice."""
    import functools

    from gaot3d_tpu_torch.kernels import encoder_payload as k5

    return [functools.partial(load, dtype) for load in (k5._library, k5._backward_library)
            for dtype in k5.KERNEL_DTYPES]


def phase_build():
    from gaot3d_tpu_torch.kernels import (build, decoder_payload, dropout_bits,
                                          elementwise_chain, encoder_payload, flash_attention,
                                          prefix_sum, segment_sum_sorted, slot_build,
                                          tile_segment_sum)

    t0 = time.perf_counter()
    build.build_together([dropout_bits._library, flash_attention._library,
                          flash_attention._backward_library, flash_attention._split_library,
                          *encoder_loaders(), decoder_payload._library, prefix_sum._library,
                          segment_sum_sorted._library, tile_segment_sum._library,
                          elementwise_chain._library, slot_build._library])
    print(f"[build] fourteen kernel libraries built together in {time.perf_counter() - t0:.1f} s")
    for name in ("dropout_bits", "flash_attn_fwd", "flash_attn_bwd", "flash_attn_bwd_split",
                 "encoder_payload", "encoder_payload_bwd", "encoder_payload_bf16",
                 "encoder_payload_bwd_bf16", "decoder_payload", "prefix_sum",
                 "segment_sum_sorted", "tile_segment_sum", "elementwise_chain", "slot_build"):
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
    k3_build_facts()


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


SASS_FP32 = ("FFMA", "FADD", "FMUL", "FMNMX", "FSETP", "FSEL", "FSET", "FRND", "FCHK",
             "FFMA32I", "FADD32I", "FMUL32I")
SASS_INT = ("IADD3", "IMAD", "LOP3", "SHF", "ISETP", "SEL", "PRMT", "LEA", "IABS", "IMNMX",
            "IADD", "LOP", "SHL", "SHR", "BMSK", "POPC", "FLO", "BREV", "VIADD", "VIMNMX")


def sass_functions(text):
    """{kernel name: its SASS instructions as (opcode with modifiers, line)}
    in cuobjdump -sass output (those before any function's name under "")."""
    out, name = {"": []}, ""
    for line in text.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            out[name] = []
        elif "/*" in line and ";" in line:
            words = line.split("*/", 1)[1].replace(";", " ").split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words:
                out[name].append((words[0], line))
    return out


def sass_pipes(instructions):
    """Counts of instructions by pipe: MUFU, FP32 (the F* arithmetic),
    integer and logic, packed half (H*2), and every instruction issued (the
    issue slots; NOPs are padding and not counted)."""
    counts = {"mufu": 0, "fp32": 0, "int": 0, "half": 0, "issue": 0}
    for op, _ in instructions:
        base = op.split(".")[0]
        if base == "NOP":
            continue
        counts["issue"] += 1
        if base == "MUFU":
            counts["mufu"] += 1
        elif base in SASS_FP32:
            counts["fp32"] += 1
        elif base in SASS_INT:
            counts["int"] += 1
        elif base.startswith("H") and base.endswith("2"):
            counts["half"] += 1
    return counts


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
        counts = {}
        for name in ("copy", "gelu", "gelu_and_grad"):
            pipes = sass_pipes([ins for f in sass_functions(sass(out, "-fun", name)).values()
                                for ins in f])
            counts[name] = (pipes["fp32"], pipes["mufu"])
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
    """Registers, spills, shared memory and CTAs an SM of K5 and K5b, f32 and
    bf16 bodies, at the recipe's widths (64, 32, two hidden-to-hidden
    layers), and the TF32 and bf16 tensor-core and FFMA instructions in each
    library's SASS. Raises when a library lacks the tensor-core instructions
    of its products: TF32 for the f32 bodies (3xTF32), bf16 for K5's bf16
    body, bf16 (the recompute) and TF32 (2xTF32) for K5b's."""
    from gaot3d_tpu_torch.kernels import build, encoder_payload as k5

    for dtype in k5.KERNEL_DTYPES:
        bf16 = dtype == "bfloat16"
        body = "_bf16" if bf16 else ""
        for lib, fn, kernel, need in (
                (k5._library(dtype), "gaot_encoder_accumulate",
                 f"encoder_accumulate{body}_kernelILi64ELi32E", ("BF16",) if bf16 else ("TF32",)),
                (k5._backward_library(dtype), "gaot_encoder_backward",
                 f"encoder_backward{body}_kernelILi64ELi32ELi2E",
                 ("BF16", "TF32") if bf16 else ("TF32",))):
            name = os.path.basename(lib._name)[3:-3]
            text = sass(os.path.join(build.BUILD_DIR, f"lib{name}.so"))
            hmma = {kind: sum(1 for line in text.splitlines() if "HMMA" in line and kind in line)
                    for kind in ("TF32", "BF16")}
            ffma = sum(1 for line in text.splitlines() if "FFMA" in line)
            ctas = getattr(lib, f"{fn}_occupancy")(2, 64, 32)
            smem = getattr(lib, f"{fn}_smem")(2, 64, 32)
            regs, spill = next(((r, sp) for entry, (r, sp) in ptxas_entries(name).items()
                                if kernel in entry), ("?", "?"))
            print(f"[build] {name} at the recipe's widths: {regs} registers, {spill}; "
                  f"{smem / 1024:.1f} KiB shared, {ctas} CTA(s) of 8 warps an SM; SASS of the "
                  f"library: {hmma['TF32']} HMMA...TF32, {hmma['BF16']} HMMA...BF16, {ffma} FFMA")
            missing = [kind for kind in need if hmma[kind] == 0]
            if missing:
                raise RuntimeError(f"{name}: no {missing} tensor-core instruction in its SASS")


def kernel_label(entry):
    """A mangled kernel name of the attention libraries, shortened to its
    name and template arguments."""
    m = re.search(r"\d+((?:flash|bwd)\w*?_kernel)I(.+?)EEv", entry)
    if m is None:
        return entry
    args = m.group(2).replace("13__nv_bfloat16", "bf16E")
    if args.startswith("f"):
        args = "f32E" + args[1:]
    out = []
    for arg in args.split("E"):
        if arg.startswith("Li"):
            out.append(arg[2:])
        elif arg.startswith("Lb"):
            out.append("true" if arg[2:] == "1" else "false")
        elif arg:
            out.append(arg)
    return f"{m.group(1)}<{', '.join(out)}>"


def k3_build_facts():
    """Registers and spills of every body of K3 and of K2 (the dk/dv body is
    K2's with DQ false), and each K3 body's wgmma (HGMMA) and mma.sync (HMMA)
    instructions in the SASS. Raises when a bf16 body at head dim 16-64 has
    no wgmma or the library keeps an mma.sync."""
    from gaot3d_tpu_torch.kernels import build, flash_attention

    flash_attention._backward_library()
    flash_attention._split_library()
    for name in ("flash_attn_bwd", "flash_attn_bwd_split"):
        for entry, (regs, spill) in ptxas_entries(name).items():
            print(f"[build] {name} {kernel_label(entry)}: {regs} registers, {spill}")
    text = sass(os.path.join(build.BUILD_DIR, "libflash_attn_bwd_split.so"))
    counts = {}
    for part in text.split("Function : ")[1:]:
        counts[kernel_label(part.split(None, 1)[0])] = (part.count("HGMMA"), part.count("HMMA"))
    for label, (hgmma, hmma) in sorted(counts.items()):
        print(f"[build] flash_attn_bwd_split SASS {label}: {hgmma} HGMMA (wgmma), {hmma} HMMA "
              f"(mma.sync)")
    missing = [label for label, (hgmma, _) in counts.items()
               if "wgmma" in label and hgmma == 0]
    if missing or any(hmma for _, hmma in counts.values()) or len(counts) != 22:
        raise RuntimeError(f"K3's SASS: {len(counts)} kernels, wgmma missing in {missing}, "
                           f"mma.sync in {[n for n, c in counts.items() if c[1]]}")


def phase_k5():
    import torch

    from gaot3d_tpu_torch.data.host_graph import build_edge_slots_host
    from gaot3d_tpu_torch.kernels import encoder_payload as k5
    from gaot3d_tpu_torch.models.mlp import ChannelMLP, reset_linear_
    from gaot3d_tpu_torch.ops.grid_graph import LatentGrid, build_budgeted_slots
    from gaot3d_tpu_torch.tools import probe_encoder_payload as probe_payload

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
    # the L2 reductions (tools/probe_encoder_payload.py red_rates): K5's scatter the least
    # time any measured way of adding these rows' payloads takes, K5b's dW a reduction a
    # parameter a launch's output at the fastest rate measured
    arows = acc_rows(sections, grid.num_tokens)
    red = probe_payload.red_rates(probe_payload.build_red_probe(), arows, C, grid.num_tokens)
    print(f"[k5] red.global.add alone on the recipe's valid rows: K5's mix of v2 and scalar "
          f"{red['k5_ms']:.3f} ms ({red['k5_per_s']:.3e} reductions a second), every column "
          f"scalar {red['scalar_ms']:.3f} ms ({red['scalar_per_s']:.3e}), every pair v2 into rows "
          f"of 48 floats {red['v2_ms']:.3f} ms ({red['v2_per_s']:.3e}), v4 on the 16-byte aligned "
          f"groups {red['v4_ms']:.3f} ms ({red['v4_per_s']:.3e}) (median of 7)")
    l2_s, l2_mode, l2_count = l2_scatter(arows, C, red)
    fwd_ops = {"tensor": 3 * flops / TF32_FLOPS, "fp32": hidden * gelu["gelu"][0] / FP32_OPS,
               "sfu": hidden * gelu["gelu"][1] / SFU_OPS, "l2": l2_s}
    bwd_ops = {"tensor": 3 * 3 * flops / TF32_FLOPS,
               "fp32": hidden * (gelu["gelu"][0] + gelu["gelu_and_grad"][0]) / FP32_OPS,
               "sfu": hidden * (gelu["gelu"][1] + gelu["gelu_and_grad"][1]) / SFU_OPS,
               "l2": l2_dw(len(sections), params.numel(), red)}
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
          f"{1e3 * fwd_ops['fp32']:.3f}, MUFU {1e3 * fwd_ops['sfu']:.3f}, L2 reductions "
          f"{1e3 * fwd_ops['l2']:.3f} for {l2_count} as {l2_mode}, bytes "
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
          f"{1e3 * bwd_ops['sfu']:.3f}, L2 dW {1e3 * bwd_ops['l2']:.3f}; as f32 FMAs "
          f"{3e3 * flops / F32_FLOPS:.3f}) (median of 5)")
    rec["wrapper_ms"], rec_b["wrapper_ms"] = wrapper_ms, wrapper_b

    # the bf16 bodies at the recipe's sections, beside the f32 bodies' times above, then at
    # the neural-field step's slots (40,000 nodes of the cloud, uniform, budget 5) and at the
    # slots the card builds for the whole cloud (uniform, budget 5, as [serve-device])
    counts = {"gelu": gelu, "flops": flops, "n_weights": n_weights, "widths": ws}
    rec_bf, rec_b_bf = bf16_bodies("recipe's sections", "recipe", sections, ws, bs, g, grid,
                                   counts, red, (rec["ms"], rec_b["ms"]))
    lat_nf, msk_nf = build_edge_slots_host(pos[perm][:NF_NODES], grid, RADIUS,
                                           strategy="bidirectional", budget=BUDGET)
    nf = [(pos_t[:, :NF_NODES], feats[:, :NF_NODES].contiguous(),
           torch.from_numpy(lat_nf[None]).cuda(), torch.from_numpy(msk_nf[None]).cuda())]
    nf_fwd, nf_bwd = bf16_bodies(f"neural-field step's [1, {NF_NODES}, {BUDGET}]", "nf", nf, ws,
                                 bs, g, grid, counts, red)
    dev = build_budgeted_slots(pos_t, grid, RADIUS, 1, "bidirectional", None, BUDGET, CHUNK)
    device = [(pos_t, feats, dev.lat_idx.contiguous(), dev.mask.contiguous())]
    dev_fwd, dev_bwd = bf16_bodies(f"device-built [1, {N_POINTS}, {BUDGET}]", "device", device,
                                   ws, bs, g, grid, counts, red)
    for prefix, extra in (("nf_", (nf_fwd, nf_bwd)), ("device_", (dev_fwd, dev_bwd))):
        for rec_, other in zip((rec_bf, rec_b_bf), extra):
            rec_.update({prefix + k: other[k] for k in (
                "max_abs_err", "rel_l2", "ms", "plain_ms", "bound_ms", "bound_by", "f32_ms")})
    return rec, rec_b, rec_bf, rec_b_bf


# The bf16 bodies before their valid-row tiles (node-major tiles of every slot, K5b once a
# node chunk), their launches alone as this script timed them on an H100 80GB HBM3 at 700 W
# (PERF.md section 6)
NODE_MAJOR_MS = {("k5-bf16", "recipe"): 0.666, ("k5-bf16", "nf"): 0.107,
           ("k5b-bf16", "recipe"): 4.112, ("k5b-bf16", "nf"): 0.621}


def l2_scatter(arows, C, red):
    """The L2 term of K5's bound for the valid rows whose accumulator rows
    are `arows`: the least time among the ways `red` (probe_encoder_payload
    `red_rates`) measured of adding their payloads (K5's v2 and scalar mix,
    every column scalar, v4 on the 16-byte aligned groups), each its count of
    reductions over its measured rate. Returns (seconds, mode, reductions)."""
    from gaot3d_tpu_torch.tools.probe_encoder_payload import reduction_counts

    counts = reduction_counts(arows, C)
    return min((counts[m] / red[m + "_per_s"], m, counts[m]) for m in ("k5", "scalar", "v4"))


def l2_dw(slices, n_params, red):
    """The L2 term of K5b's bound: one reduction a parameter for each of
    `slices` dW outputs (a node chunk's slice, or a launch's whole dW), at
    the fastest rate `red` measured."""
    return slices * n_params / max(red[m + "_per_s"] for m in ("k5", "scalar", "v2", "v4"))


def acc_rows(sections, M):
    """Accumulator rows (b * M + cell) of the valid rows of `sections`, in
    node-major order, as K5 scatters them."""
    import torch

    out = []
    for _, _, lat, msk in sections:
        b = torch.arange(lat.shape[0], device=lat.device).view(-1, 1, 1).expand_as(lat)
        out.append((b * M + lat.long())[msk])
    return torch.cat(out).to(torch.int32)


def with_zero_first(x):
    """x with a 0 in front (an exclusive prefix's start)."""
    import torch

    return torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device), x])


def bf16_bodies(label, key, sections, ws, bs, g, grid, counts, red, f32_ms=None):
    """[k5-bf16] / [k5b-bf16]: K5's and K5b's bf16 bodies against their bf16
    plain versions on `sections` ([(pos, feats, lat, mask)], node chunks of
    CHUNK), K5 to K5_BF16_BOUND over the value columns and K5b to
    K5B_BF16_BOUND for each of dfeats, dW, db (relative L2), K5b's dfeats the
    same bits twice; each launched once a section; the share of tile rows
    that are valid, in node-major tiles of every slot and in the tile map;
    each timed as its launches alone beside the f32 body's time (`f32_ms`,
    or timed here), the node-major design's (NODE_MAJOR_MS[tag, key], if
    any) and its bound, whose L2-reduction terms take the rates `red`
    measured (`l2_scatter`, `l2_dw`). Returns the two records."""
    import torch

    from gaot3d_tpu_torch.kernels import encoder_payload as k5

    C = sections[0][1].shape[-1]
    bf = "bfloat16"
    acc = torch.zeros((1, grid.num_tokens, C + 11), device="cuda")
    params, n_mid, hid = k5._pack_mlp(ws, bs), len(ws) - 2, ws[0].shape[0]

    def run(fn):
        acc.zero_()
        for p, f, lat, msk in sections:
            fn(p, f, lat, msk, ws, bs, grid, acc, CHUNK, kernel_dtype=bf)
        return acc

    def plain_forward(p, f, lat, msk, ws_, bs_, grid_, acc_, chunk, kernel_dtype):
        return k5.encoder_accumulate_reference(p, f, lat, msk, ws_, bs_, grid_, acc_, chunk,
                                               kernel_dtype)

    n5 = k5.encoder_accumulate.launches_bf16
    got = run(k5.encoder_accumulate).clone()
    ref = run(plain_forward).clone()
    torch.cuda.synchronize()
    if not torch.isfinite(got).all() or k5.encoder_accumulate.launches_bf16 != n5 + len(sections):
        raise RuntimeError("K5 bf16: non-finite accumulator or a launch count off")
    rel = ((got[..., :C] - ref[..., :C]).norm() / ref[..., :C].norm()).item()
    err = (got - ref).abs().max().item()
    print(f"[k5-bf16] {label}: the value columns against the bf16 plain version: relative L2 "
          f"{rel:.3e} (max_abs_err {err:.3e})")
    if not rel <= K5_BF16_BOUND:
        raise RuntimeError(f"K5's bf16 body disagrees with its plain version: {rel}")

    def run_backward(fn):
        out = []
        for p, f, lat, msk in sections:
            df, dw, db = fn(g, p, f, lat, msk, ws, bs, grid, CHUNK, kernel_dtype=bf)
            out.append([df] + list(dw) + list(db))
        return [torch.cat([o[0] for o in out], dim=1)] + [sum(o[i] for o in out)
                                                          for i in range(1, len(out[0]))]

    def plain_backward(g_, p, f, lat, msk, ws_, bs_, grid_, chunk, kernel_dtype):
        return k5.encoder_accumulate_backward_reference(g_, p, f, lat, msk, ws_, bs_, grid_,
                                                        chunk, kernel_dtype)

    nb = k5.encoder_accumulate_backward.launches_bf16
    got_b = run_backward(k5.encoder_accumulate_backward)
    again = run_backward(k5.encoder_accumulate_backward)
    ref_b = run_backward(plain_backward)
    torch.cuda.synchronize()
    if k5.encoder_accumulate_backward.launches_bf16 != nb + 2 * len(sections):
        raise RuntimeError("K5b bf16: not one launch a call")
    if not torch.equal(got_b[0], again[0]):
        raise RuntimeError("K5b bf16: dfeats differs between two launches")
    names = ["dfeats"] + [f"dW{i}" for i in range(len(ws))] + [f"db{i}" for i in range(len(ws))]
    rels = {}
    for name, a, b in zip(names, got_b, ref_b):
        if not torch.isfinite(a).all():
            raise RuntimeError(f"K5b bf16: non-finite {name}")
        rels[name] = ((a - b).norm() / b.norm()).item()
    worst_abs = max((a - b).abs().max().item() for a, b in zip(got_b, ref_b))
    print(f"[k5b-bf16] {label}: {len(sections)} launches (one a section), against autograd "
          f"through the bf16 plain version, relative L2 "
          + ", ".join(f"{n} {r:.2e}" for n, r in rels.items())
          + "; dfeats the same bits in two calls")
    if max(rels.values()) > K5B_BF16_BOUND:
        raise RuntimeError(f"K5b's bf16 body disagrees with its plain version: {rels}")

    # the rows: valid ones, node-major tiles of every slot, the tile map's items
    maps = [k5.tile_map(msk, CHUNK) for *_, msk in sections]
    valid = int(sum(int(m.sum()) for *_, m in sections))
    node_major = sum(-(-lat.shape[1] // (k5.TILE_ROWS // lat.shape[2])) for _, _, lat, _ in sections)
    items = 0
    for tm, (*_, msk) in zip(maps, sections):
        total = int(tm.n_items)
        count = torch.cumsum(with_zero_first(msk.reshape(-1, msk.shape[-1]).sum(-1)), 0)
        nf = tm.node_first[:total + 1].long()
        items += int(((count[nf[1:]] - count[nf[:-1]]) > 0).sum())
    print(f"[k5-bf16] {label}: {valid} valid rows of {sum(m.numel() for *_, m in sections)} "
          f"slots; node-major tiles of every slot: {node_major} of 128 rows, "
          f"{100 * valid / (node_major * k5.TILE_ROWS):.1f}% of their rows valid; the tile map: "
          f"{items} items with rows, {100 * valid / (items * k5.TILE_ROWS):.1f}% of 128 rows "
          f"each filled")

    # bounds: K5's products one bf16 pass; K5b's recompute one bf16 pass, its chain (the
    # layers after the first) and dW each two TF32 passes; the GELU's and the bytes as f32's;
    # the L2 terms as the f32 bodies', K5b's with a dW slice a node chunk
    flops = valid * 2 * counts["n_weights"]
    chain = valid * 2 * (counts["n_weights"] - ws[0].numel())
    hidden = valid * sum(w.shape[0] for w in ws[:-1])
    gelu = counts["gelu"]
    l2_s, l2_mode, reductions = l2_scatter(acc_rows(sections, grid.num_tokens), C, red)
    slices = sum(tm.n_chunks for tm in maps)
    fwd_ops = {"tensor": flops / BF16_FLOPS, "fp32": hidden * gelu["gelu"][0] / FP32_OPS,
               "sfu": hidden * gelu["gelu"][1] / SFU_OPS, "l2": l2_s}
    bwd_ops = {"tensor": flops / BF16_FLOPS + 2 * (chain + flops) / TF32_FLOPS,
               "fp32": hidden * (gelu["gelu"][0] + gelu["gelu_and_grad"][0]) / FP32_OPS,
               "sfu": hidden * (gelu["gelu"][1] + gelu["gelu_and_grad"][1]) / SFU_OPS,
               "l2": l2_dw(slices, params.numel(), red)}
    n_nodes = sum(p.shape[1] for p, *_ in sections)
    slot_bytes = sum(lat.numel() * 5 for _, _, lat, _ in sections)
    moved = n_nodes * (3 + C) * 4 + slot_bytes + params.numel() * 4
    acc_bytes = 2 * acc.numel() * 4

    def launches_alone():
        for (p, f, lat, msk), tm in zip(sections, maps):
            k5.launch_accumulate(p, f, lat, msk, params, n_mid, hid, grid, acc, bf, tm)

    # K5b's outputs zeroed once, outside the events (the slices take every launch's sums)
    outs = [(torch.zeros_like(f), torch.zeros((tm.n_chunks, params.numel()), device="cuda"))
            for (_, f, _, _), tm in zip(sections, maps)]

    def backward_launches():
        for (p, f, lat, msk), tm, (df, dp) in zip(sections, maps, outs):
            k5.launch_backward(g, p, f, lat, msk, params, n_mid, hid, grid, df, dp, bf, tm)

    def f32_launches():
        for p, f, lat, msk in sections:
            k5.launch_accumulate(p, f, lat, msk, params, n_mid, hid, grid, acc)

    f32_outs = [(torch.empty_like(f), torch.zeros_like(params)) for _, f, _, _ in sections]

    def f32_backward_launches():
        for (p, f, lat, msk), (df, dp) in zip(sections, f32_outs):
            k5.launch_backward(g, p, f, lat, msk, params, n_mid, hid, grid, df, dp)

    if f32_ms is None:
        f32_ms = (cuda_ms(f32_launches), cuda_ms(f32_backward_launches))
    rec = {"max_abs_err": err, "rel_l2": rel, "ms": cuda_ms(launches_alone),
           "plain_ms": cuda_ms(lambda: run(plain_forward)),
           **bound(moved + acc_bytes, **fwd_ops), "library_ms": None, "f32_ms": f32_ms[0],
           "valid_share": valid / (node_major * k5.TILE_ROWS),
           "wrapper_ms": cuda_ms(lambda: [
               k5.encoder_accumulate(p, f, lat, msk, ws, bs, grid, acc, CHUNK, kernel_dtype=bf)
               for p, f, lat, msk in sections])}
    rec_b = {"max_abs_err": worst_abs, "rel_l2": max(rels.values()),
             "ms": cuda_ms(backward_launches), "plain_ms": cuda_ms(lambda: run_backward(
                 plain_backward)),
             **bound(moved + g.numel() * 4 + n_nodes * C * 4, **bwd_ops), "library_ms": None,
             "f32_ms": f32_ms[1],
             "wrapper_ms": cuda_ms(lambda: run_backward(k5.encoder_accumulate_backward))}
    for tag, r, ops in (("k5-bf16", rec, fwd_ops), ("k5b-bf16", rec_b, bwd_ops)):
        before = NODE_MAJOR_MS.get((tag, key))
        print(f"[{tag}] {label}: the launches alone {r['ms']:.3f} ms"
              + (f" (node-major design: {before:.3f} ms)" if before is not None else "")
              + f" against the f32 body's {r['f32_ms']:.3f} ms (through the wrapper "
              f"{r['wrapper_ms']:.3f} ms), plain {r['plain_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.3f} ms ({r['bound_by']}: tensor {1e3 * ops['tensor']:.3f}, GELU "
              f"FP32 {1e3 * ops['fp32']:.3f}, MUFU {1e3 * ops['sfu']:.3f}, L2 reductions "
              f"{1e3 * ops['l2']:.3f}" + (
                  f" for {slices} dW slices of {params.numel()}" if tag == "k5b-bf16"
                  else f" for {reductions} as {l2_mode}")
              + ") (median of 5, CUDA events)")
    return rec, rec_b


K9_POINTS = 8_388_608  # a request of configs/examples/drivaerml/pressure.yaml
K9_BUDGET = 8          # its slot_budget


def phase_k9():
    """[k9]: the decoder payload at the shape of a drivaerml request."""
    import torch

    from gaot3d_tpu_torch.kernels import decoder_payload as k9
    from gaot3d_tpu_torch.kernels.encoder_payload import _pack_mlp, tile_map
    from gaot3d_tpu_torch.models.mlp import kernel_weights
    from gaot3d_tpu_torch.ops.grid_graph import build_budgeted_slots

    decoder = dist_model().decoder
    gno, grid = decoder.gno, decoder.grid
    g = torch.Generator(device="cuda").manual_seed(9)
    pos = surface(K9_POINTS, g)
    mask = torch.ones(1, K9_POINTS, dtype=torch.bool, device="cuda")
    slots = build_budgeted_slots(pos, grid, RADIUS, 1, "bidirectional", mask, K9_BUDGET, CHUNK)
    lat, msk = slots.lat_idx, slots.mask
    latent = torch.randn(1, grid.num_tokens, gno.channel_mlp.fcs[-1].weight.shape[0],
                         device="cuda", generator=g)
    ws, bs = (list(map(torch.Tensor.detach, t)) for t in kernel_weights(gno.channel_mlp.fcs))

    def plain():
        return torch.cat([gno.decoder_chunk(latent, pos[:, c:c + CHUNK], lat[:, c:c + CHUNK],
                                            msk[:, c:c + CHUNK])
                          for c in range(0, K9_POINTS, CHUNK)], dim=1)

    k9.decoder_payload.launches = 0
    with torch.no_grad():
        means = decoder._payload_means(latent, pos, [slots])
        if means is None:
            raise RuntimeError("[k9] the drivaerml decoder's eval forward does not pick K9")
        again = k9.decoder_payload(latent, pos, lat, msk, ws, bs, grid)
        want = plain()
    torch.cuda.synchronize()
    got, launches = means[0], k9.decoder_payload.launches
    rel = rel_l2(got, want)
    valid = int(msk.sum())
    same = torch.equal(got, again)
    if not (bool(torch.isfinite(got).all()) and rel <= K9_BOUND and same and launches == 2):
        raise RuntimeError(f"[k9] relative L2 {rel:.3e} (limit {K9_BOUND}), the same bits in two "
                           f"launches {same}, launches {launches} (2 expected)")

    widths = [ws[0].shape[1]] + [w.shape[0] for w in ws]
    fmas = sum(a * b for a, b in zip(widths, widths[1:]))
    gelus = sum(widths[1:-1])
    gelu = gelu_instructions()["gelu"]
    C = widths[-1]
    moved = (lat.numel() * 4 + msk.numel() + pos.numel() * 4 + K9_POINTS * C * 4
             + latent.numel() * 4)
    ops = {"ffma": valid * fmas / FP32_OPS, "fp32": valid * (fmas + gelus * gelu[0]) / FP32_OPS,
           "sfu": valid * gelus * gelu[1] / SFU_OPS}
    params, tiles = _pack_mlp(ws, bs), tile_map(msk)
    out = torch.empty_like(got)
    rec = kernel_ms(lambda: k9.decoder_payload(latent, pos, lat, msk, ws, bs, grid),
                    ["decoder_payload"],
                    bare=lambda: bare_launches(lambda: k9.launch_payload(
                        latent, pos, lat, msk, params, len(ws) - 2, ws[0].shape[0], grid, tiles,
                        out)))
    with torch.no_grad():
        rec.update(plain_ms=cuda_ms(plain), **bound(moved, **ops), library_ms=None,
                   rel_l2=rel, launches_per_call=1, valid_slots=valid)
    print(f"[k9] [1, {K9_POINTS:,}, {lat.shape[-1]}] slots built on the card, {valid} valid "
          f"({valid / K9_POINTS:.3f} a node), the decoder MLP {widths}: K9 against the plain "
          f"decoder_chunk over node chunks of {CHUNK}: relative L2 {rel:.3e}; the same bits in "
          f"two launches; one launch a call")
    print(f"[k9] K9 {rec['ms']:.3f} ms ({rec['ms_reading']}; cold L2 {rec['device_ms_cold']}),"
          f" through the wrapper with its tile map {rec['call_ms']:.3f} ms, plain "
          f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.3f} ms ({rec['bound_by']}: FFMA "
          f"{1e3 * ops['ffma']:.3f}, the FP32 pipe with {gelus} GELUs of {gelu[0]} "
          f"instructions {1e3 * ops['fp32']:.3f}, MUFU {1e3 * ops['sfu']:.3f}, bytes "
          f"{1e3 * moved / HBM_BYTES_S:.3f})")
    del decoder, slots, lat, msk, means, again, want, got, out, tiles
    torch.cuda.empty_cache()
    return rec


K10_POINTS = (8_388_608, 1_048_576)  # a drivaerml request; a rank's shard of its training


def surface(n_points, g):
    """A closed surface of `n_points` points on the card (a deformed sphere
    inside the grid's box), as the benchmark's meshes are, drawn from the
    card's generator `g`."""
    import torch

    d = torch.randn(1, n_points, 3, device="cuda", generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    return 0.8 * d * (1 + 0.15 * torch.sin(3 * d[..., :1]) * torch.cos(2 * d[..., 1:2]))


def phase_k10():
    """[k10]: the slot build at the shapes of a drivaerml request and of a
    rank's shard of its training."""
    import torch

    from gaot3d_tpu_torch.kernels import slot_build as k10
    from gaot3d_tpu_torch.ops.grid_graph import LatentGrid, build_budgeted_slots, window_spec

    grid = LatentGrid(dims=LATENT)
    widths, _, _ = window_spec(grid, RADIUS, 1, "bidirectional")
    recs = {}
    for n in K10_POINTS:
        pos = surface(n, torch.Generator(device="cuda").manual_seed(10))
        mask = torch.ones(1, n, dtype=torch.bool, device="cuda")

        def build():
            return build_budgeted_slots(pos, grid, RADIUS, 1, "bidirectional", mask, K9_BUDGET,
                                        CHUNK)

        def plain():
            with mock.patch.object(k10, "engages", lambda *a, **kw: False):
                return build()

        before = k10.slot_build.launches
        got, again, want = build(), build(), plain()
        torch.cuda.synchronize()
        launches = k10.slot_build.launches - before
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        valid = int(got.mask.sum())
        print(f"[k10] [1, {n:,}] points -> [1, {n:,}, {K9_BUDGET}] slots, {valid} valid "
              f"({valid / n:.3f} a node), window {widths}: against the plain build bit for bit "
              f"{same}; two launches the same bits {repeat}; launches {launches} (2 expected)")
        if not (same and repeat and launches == 2):
            raise RuntimeError(f"[k10] at {n} points: K10 differs from the plain build or "
                               f"itself, or did not launch once a build")
        K = math.prod(widths)
        moved = pos.numel() * 4 + mask.numel() + got.lat_idx.numel() * 4 + got.mask.numel()
        # FP32 work of a walk of the whole window: each axis's squared offsets once a point
        # (product, sum, difference, square), the first two axes' sums once a pair, a sum
        # and a compare a slot (K10 skips most of the window; the bytes bound it anyway)
        fp32 = n * (4 * sum(widths) + widths[0] * widths[1] + 2 * K)
        ops = {"fp32": fp32 / FP32_OPS}
        lat = torch.empty_like(got.lat_idx)
        msk = torch.empty_like(got.mask)
        rec = kernel_ms(build, ["slot_build_kernel"], bare=lambda: bare_launches(
            lambda: k10.launch_build(pos, mask, grid, RADIUS, 1, "bidirectional", lat, msk)))
        rec.update(plain_ms=cuda_ms(plain), **bound(moved, **ops), library_ms=None,
                   launches_per_call=1, valid_slots=valid, points=n)
        print(f"[k10] K10 {rec['ms']:.3f} ms ({rec['ms_reading']}; cold L2 "
              f"{rec['device_ms_cold']}), through build_budgeted_slots {rec['call_ms']:.3f} ms, "
              f"plain {rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.3f} ms "
              f"({rec['bound_by']}: bytes {1e3 * moved / HBM_BYTES_S:.3f}, the FP32 pipe "
              f"{1e3 * ops['fp32']:.3f})")
        recs[n] = rec
        del pos, mask, got, again, want, lat, msk
        torch.cuda.empty_cache()
    return recs[K10_POINTS[0]], recs


def recipe_model(latent=LATENT, radius=RADIUS, budget=BUDGET, kernel_dtype="bfloat16",
                 positional_embedding="rope", conditional_norm=False, **magno_overrides):
    """The DrivAerNet++ pressure recipe at full width and depth, on the card,
    with random weights from seed 0, its GNO kernel MLPs at `kernel_dtype`
    (bfloat16, as tpu_500k.yaml sets it); `magno_overrides` replace fields of
    its MAGNOConfig (the edge layout and the reductions); the processor's
    `positional_embedding` and, with `conditional_norm`, a ConditionedNorm in
    every block's attention and FFN."""
    import torch

    from gaot3d_tpu_torch.models import (AttentionConfig, FFNConfig, MAGNOConfig,
                                         TransformerConfig, init_model)

    magno = MAGNOConfig(**{**dict(
        lifting_channels=32, gno_radius=radius, neighbor_strategy="bidirectional",
        use_geoembed=[True, False], in_gno_channel_mlp_hidden_layers=[64, 64, 64],
        out_gno_channel_mlp_hidden_layers=[64, 64], projection_channels=256,
        mlp_type="linear", edge_chunk_size=CHUNK, slot_budget=budget,
        kernel_dtype=kernel_dtype, edge_layout="sectioned"), **magno_overrides})
    attn = TransformerConfig(
        patch_size=2, hidden_size=256, num_layers=10, positional_embedding=positional_embedding,
        attn_config=AttentionConfig(hidden_size=256, num_heads=8, num_kv_heads=8,
                                    atten_dropout=RATE, attention_dtype="bfloat16",
                                    use_conditional_norm=conditional_norm),
        ffn_config=FFNConfig(hidden_size=1024, use_conditional_norm=conditional_norm))
    return init_model(3, 1, "gaot_3d", magno, attn, latent_tokens=latent,
                      generator=torch.Generator().manual_seed(0))


def cloud(seed, n_points, grid=None, radius=RADIUS, budget=BUDGET):
    """One random cloud with features and a target on the card: (pos, feats,
    target, mask, slots, n_sections, host seconds of graph build and
    upload). Given a grid, uploaded in its degree sections' node order with
    their slots; without one, in the order drawn, with no slots (None, 0
    sections, no build), for a model that builds its own."""
    import torch

    from gaot3d_tpu_torch.ops.grid_graph import SectionedEdgeSlots

    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (n_points, 3)).astype(np.float32)
    feats = rng.standard_normal((n_points, 3), dtype=np.float32)
    target = rng.standard_normal((n_points, 1), dtype=np.float32)
    t0 = time.perf_counter()
    perm, secs = (host_sections(pos, grid, radius, budget) if grid is not None
                  else (slice(None), []))
    t1 = time.perf_counter()
    tensors = [torch.from_numpy(x[perm][None]).cuda() for x in (pos, feats, target)]
    mask = torch.ones((1, n_points), dtype=torch.bool, device="cuda")
    slots = (SectionedEdgeSlots.from_numpy([(l[None], m[None]) for l, m in secs], device="cuda")
             if grid is not None else None)
    torch.cuda.synchronize()
    return (*tensors, mask, slots, len(secs), (t1 - t0, time.perf_counter() - t1))


def rel_l2(got, want):
    return ((got - want).norm() / want.norm()).item()


def against_plain(tag, what, fn, got):
    """Hold `got`, what fn() gave with the kernels, against fn() with every
    kernel replaced by its plain version: its first item (an output or a
    gradient) to E2E_BOUND relative L2, any further ones (a loss) to
    E2E_BOUND relative. The plain run may launch no kernel."""
    import torch

    from gaot3d_tpu_torch.kernels import decoder_payload as k9
    from gaot3d_tpu_torch.kernels import slot_build as k10

    counters = {**attention_counters(), "k9": k9.decoder_payload, "k10": k10.slot_build}
    launched = {n: fn_.launches for n, fn_ in counters.items()}
    with plain_versions():
        plain = fn()
    torch.cuda.synchronize()
    if {n: fn_.launches for n, fn_ in counters.items()} != launched:
        raise RuntimeError(f"[{tag}] the plain run launched a kernel")
    rel = ((got[0] - plain[0]).norm() / plain[0].norm()).item()
    losses = "".join(f"; loss {a:.6f} with kernels, {b:.6f} with plain versions"
                     for a, b in zip(got[1:], plain[1:]))
    print(f"[{tag}] {what} with every kernel and with its plain version: relative L2 "
          f"{rel:.3e} ({plain[0].numel()} values){losses}")
    if not (rel <= E2E_BOUND and all(abs(a - b) <= E2E_BOUND * abs(b)
                                     for a, b in zip(got[1:], plain[1:]))):
        raise RuntimeError(f"[{tag}] kernels and plain versions disagree: {rel}")


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
    fwd.launches = acc.launches = acc.launches_bf16 = 0
    outs = []
    for i, seed in enumerate((11, 12)):
        pos, feats, _, mask, slots, nsec, (t_graph, t_upload) = cloud(seed, N_POINTS, grid)
        n1, n5, n5bf = fwd.launches, acc.launches, acc.launches_bf16
        t0 = time.perf_counter()
        out = infer(pos, feats, mask, slots, slots)
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
        d1, d5, d5bf = fwd.launches - n1, acc.launches - n5, acc.launches_bf16 - n5bf
        ok = tuple(out.shape) == (1, N_POINTS, 1) and bool(torch.isfinite(out).all())
        print(f"[serve] request {i + 1}: graph build {t_graph * 1e3:.1f} ms, upload "
              f"{t_upload * 1e3:.1f} ms, forward {t_fwd * 1e3:.1f} ms; out "
              f"{tuple(out.shape)} finite={ok}; K1 launches {d1}, K5 launches {d5} "
              f"({nsec} sections), of its bf16 body {d5bf}")
        if not ok or d1 != 10 or d5 != nsec or d5bf != nsec:
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
    launches = {"k1": fwd.launches, "k5": acc.launches, "k5_bf16": acc.launches_bf16}

    args, slots, out = outs[0]
    against_plain("serve", "request 1", lambda: (infer(*args, slots, slots),), (out,))
    return launches


def plain_versions():
    """Context in which the model calls the plain version of every kernel
    instead of launching it."""
    import contextlib

    from gaot3d_tpu_torch.kernels import encoder_payload as k5
    from gaot3d_tpu_torch.kernels import flash_attention as k1
    from gaot3d_tpu_torch.kernels import prefix_sum as k7
    from gaot3d_tpu_torch.kernels import segment_sum_sorted as k6
    from gaot3d_tpu_torch.kernels import slot_build as k10
    from gaot3d_tpu_torch.kernels import tile_segment_sum as k8
    from gaot3d_tpu_torch.models import magno
    from gaot3d_tpu_torch.ops import segment

    def plain_tile(rows, sorted_seg, *, ts, num_segments, seg_tile, perm):
        return k8.tile_segment_sum_reference(rows, sorted_seg, ts, num_segments, perm)

    stack = contextlib.ExitStack()
    for mod, name, plain in (
            (k1, "flash_attention", k1.flash_attention_plain),
            (k1, "flash_attention_backward", k1.flash_attention_backward_plain),
            (k5, "encoder_accumulate",
             lambda *a, params=None, tiles=None, **kw: k5.encoder_accumulate_reference(*a, **kw)),
            (k5, "encoder_accumulate_backward",
             lambda *a, params=None, tiles=None, **kw:
             k5.encoder_accumulate_backward_reference(*a, **kw)),
            (k7, "prefix_sum", k7.prefix_sum_reference),
            (segment, "segment_sum_sorted",
             lambda data, ids, num_segments, passes=1:
             k6.segment_sum_sorted_reference(data, ids, num_segments)),
            (segment, "tile_segment_sum", plain_tile),
            # the decoder's GNO by node chunks through decoder_chunk instead of K9
            (magno, "engages", lambda *a, **kw: False),
            # the slot build by node chunks, window and sort, instead of K10
            (k10, "engages", lambda *a, **kw: False)):
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
    dropout_offset(rng, seed)
    return rec_k1d, rec_k2, replay_launches


def dropout_offset(rng, seed, offset=1):
    """[offset]: a rank that holds batch rows `offset`.. of a larger batch
    passes bh_offset = offset * H and draws those rows' keep bits. K4, K1,
    K2 and K3's dk/dv kernel at a non-zero offset against their plain
    versions fed the plain Philox's bits at that offset, and against row 1
    of a launch over the whole batch of 2: K4, K1's out and lse, K2's and
    K3's dk and dv bit for bit, K2's dq to one bf16 step of its max-abs (its
    float atomics), K3's keep mask the plain packing of the offset bits."""
    import torch

    from gaot3d_tpu_torch.kernels import dropout_bits as k4
    from gaot3d_tpu_torch.kernels import flash_attention as k1

    H, S, Skv, D = 8, 1000, 130, 32
    q2, k2, v2 = qkv(rng, (2, H, S, D), skv=Skv)
    do2 = qkv(rng, (2, H, S, D))[0]
    q, k, v, do = (t[1:].contiguous() for t in (q2, k2, v2, do2))
    off = offset * H
    bits = k4.export_dropout_bits(seed, H, S, Skv, bh_offset=off)
    plain_bits = k4.dropout_bits_reference(seed, H, S, Skv, device="cuda", bh_offset=off)
    whole = k4.export_dropout_bits(seed, 2 * H, S, Skv)
    for name, a, b in (("plain", bits, plain_bits), ("whole batch", bits, whole[off:])):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise RuntimeError(f"[offset] K4 at bh_offset {off} differs from the {name} bits")
    out, lse = k1.flash_attention(q, k, v, RATE, seed=seed, bh_offset=off)
    out2, lse2 = k1.flash_attention(q2, k2, v2, RATE, seed=seed)
    ref, ref_lse = k1.flash_attention_reference(q, k, v, RATE, plain_bits)
    err = (out.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
    if not (torch.equal(out, out2[1:]) and torch.equal(lse, lse2[1:])) or err > K1_BOUND \
            or (lse - ref_lse).abs().max().item() > 1e-3:
        raise RuntimeError(f"[offset] K1 at bh_offset {off}: {err} against its plain version")
    got = k1.flash_attention_backward(q, k, v, out, lse, do, RATE, seed=seed, bh_offset=off)
    got2 = k1.flash_attention_backward(q2, k2, v2, out2, lse2, do2, RATE, seed=seed)
    want = k1.flash_attention_backward_reference(q, k, v, out, lse, do, RATE, plain_bits)
    errs = []
    for name, a, a2, b in zip(("dq", "dk", "dv"), got, got2, want):
        rel = (a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
        errs.append(rel)
        same = torch.equal(a, a2[1:]) if name != "dq" else \
            (a.float() - a2[1:].float()).abs().max().item() <= 2.0 ** -7 * a.float().abs().max()
        if rel > K2_BOUND or not same:
            raise RuntimeError(f"[offset] K2 at bh_offset {off}: {name} {rel}, whole batch {same}")
    delta = (do.float() * out.float()).sum(dim=-1)
    dk, dv, mask = k1.flash_attention_backward_dkv(q, k, v, lse, do, delta, RATE, seed=seed,
                                                   bh_offset=off)
    want_mask = k1.pack_keep_mask_reference(plain_bits, RATE)
    if not (torch.equal(dk, got[1]) and torch.equal(dv, got[2])
            and torch.equal(mask.view(torch.int32), want_mask.view(torch.int32))):
        raise RuntimeError(f"[offset] K3's dk/dv kernel at bh_offset {off} differs from K2 or "
                           "from the plain keep mask")
    print(f"[offset] batch row {offset} of 2 (bh_offset {off}), S={S} Skv={Skv}: K4 the plain "
          f"and the whole batch's bits; K1 out and lse the whole batch's row bit for bit, "
          f"{err:.3e} of the plain max-abs; K2 dq/dk/dv {errs[0]:.3e}/{errs[1]:.3e}/"
          f"{errs[2]:.3e} of the plain max-abs, dk and dv the whole batch's bits; K3 dk/dv "
          f"K2's bits, its keep mask the plain packing")


def phase_k3():
    """[k3]: the split backward (its dk/dv kernel, then its dq kernel on the
    keep mask the first hands over) against the plain backward, against the
    fused kernel (dk and dv bit for bit) and against itself; the mask against
    the plain packing of K4's bits."""
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

    def check_mask(q, k, v, out, lse, dout, rate, bits, label):
        """The dk/dv kernel's keep mask from the seed and from K4's bits for it
        against the plain packing of those bits, one (batch, head) at a time."""
        delta = (dout.float() * out.float()).sum(dim=-1)
        _, _, mask = k1.flash_attention_backward_dkv(q, k, v, lse, dout, delta, rate, seed)
        _, _, mask_b = k1.flash_attention_backward_dkv(q, k, v, lse, dout, delta, rate,
                                                       dropout_bits=bits)
        torch.cuda.synchronize()
        wrong = 0
        for bh in range(bits.shape[0]):
            want = k1.pack_keep_mask_reference(bits[bh:bh + 1], rate).view(torch.int32)[0]
            wrong += int((mask[bh].view(torch.int32) != want).sum())
            wrong += int((mask_b[bh].view(torch.int32) != want).sum())
        print(f"[k3] {label} keep mask {tuple(mask.shape)} ({mask.numel() * 4} bytes): "
              f"{wrong} words differ from the plain packing of K4's bits (seed and bits)")
        if wrong:
            raise RuntimeError(f"K3 {label}: the keep mask differs from the plain packing")

    def check(q, k, v, dout, rate, label):
        B, H, S, _ = q.shape
        bits = k4.export_dropout_bits(seed, B * H, S, k.shape[2]) if rate > 0 else None
        out, lse = k1.flash_attention(q, k, v, rate, seed=seed)
        got = k1.flash_attention_backward_split(q, k, v, out, lse, dout, rate, seed=seed)
        again = k1.flash_attention_backward_split(q, k, v, out, lse, dout, rate, seed=seed)
        from_bits = (k1.flash_attention_backward_split(q, k, v, out, lse, dout, rate,
                                                       dropout_bits=bits)
                     if rate > 0 else got)
        fused = k1.flash_attention_backward(q, k, v, out, lse, dout, rate, seed=seed)
        want = k1.flash_attention_backward_reference(q, k, v, out, lse, dout, rate, bits)
        torch.cuda.synchronize()
        worst = 0.0
        for name, a, a2, ab, f, b in zip(("dq", "dk", "dv"), got, again, from_bits, fused, want):
            if not torch.isfinite(a.float()).all():
                raise RuntimeError(f"K3 {label}: non-finite {name}")
            top = b.float().abs().max().item()
            abs_err = (a.float() - b.float()).abs().max().item()
            vs_fused = (a.float() - f.float()).abs().max().item()
            same, same_bits = torch.equal(a, a2), torch.equal(a, ab)
            fused_bits = torch.equal(a, f)
            print(f"[k3] {label} {name}: max_abs_err {abs_err:.3e}, over the plain max-abs "
                  f"{abs_err / top:.3e} (limit {K2_BOUND:.0e}); against the fused kernel "
                  f"{vs_fused / top:.3e} (limit {K3_FUSED_BOUND:.1e}), bit for bit: "
                  f"{fused_bits}; two launches identical: {same}; seed and its bits "
                  f"identical: {same_bits}")
            if abs_err > K2_BOUND * top:
                raise RuntimeError(f"K3 {label}: {name} disagrees with the plain backward")
            if vs_fused > K3_FUSED_BOUND * top:
                raise RuntimeError(f"K3 {label}: {name} disagrees with the fused kernel")
            if name != "dq" and not fused_bits:
                raise RuntimeError(f"K3 {label}: {name} differs from the fused kernel's bits")
            if not (same and same_bits):
                raise RuntimeError(f"K3 {label}: {name} differs between two launches, or "
                                   "between the seed and its bits")
            worst = max(worst, abs_err)
        if rate > 0:
            check_mask(q, k, v, out, lse, dout, rate, bits, label)
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
        args = (q, k, v, lse, dout, delta, rate)
        ms_dkv = cuda_ms(lambda: k1.flash_attention_backward_dkv(*args, seed))
        _, _, mask = k1.flash_attention_backward_dkv(*args, seed)
        ms_dq = cuda_ms(lambda: k1.flash_attention_backward_dq(*args, mask))
        mask_bytes = 0 if mask is None else mask.numel() * 4
        del mask
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        k1.flash_attention_backward_split(q, k, v, out, lse, dout, rate, seed=seed)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        # each kernel's own work: dk/dv four products, the exponentials, the
        # Philox calls, q, k, v, dO read and dk, dv written, the mask written;
        # dq three products, the exponentials, q, k, v, dO read, dq written,
        # the mask read. They run one after the other: the pair's bound is
        # the sum.
        b_dkv = attention_bound(B, H, S, S, D, products=4, n_tensors=6, dropout=rate > 0,
                                extra_bytes=mask_bytes)
        b_dq = attention_bound(B, H, S, S, D, products=3, n_tensors=5, dropout=False,
                               extra_bytes=mask_bytes)
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, dropout_p=rate)
        rec = {"max_abs_err": worst,
               "ms": cuda_ms(lambda: k1.flash_attention_backward_split(
                   q, k, v, out, lse, dout, rate, seed=seed)),
               "ms_dkv": ms_dkv, "ms_dq": ms_dq,
               "fused_ms": cuda_ms(lambda: k1.flash_attention_backward(
                   q, k, v, out, lse, dout, rate, seed=seed)),
               "plain_ms": cuda_ms(lambda: k1.flash_attention_backward_reference(
                   q, k, v, out, lse, dout, rate, bits), reps=3),
               "bound_ms": b_dkv["bound_ms"] + b_dq["bound_ms"],
               "bound_by": "bytes" if b_dkv["bound_by"] == b_dq["bound_by"] == "bytes"
               else "operations",
               "bound_ms_dkv": b_dkv["bound_ms"], "bound_ms_dq": b_dq["bound_ms"],
               "library_ms": cuda_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), dout,
                                                                 retain_graph=True)),
               "mask_bytes": mask_bytes, "peak_bytes": peak}
        print(f"[k3] B1 H8 S16384 D32 bf16 rate {rate}: dk/dv kernel {ms_dkv:.3f} ms (bound "
              f"{b_dkv['bound_ms']:.3f}, {b_dkv['bound_by']}), then dq kernel {ms_dq:.3f} ms "
              f"(bound {b_dq['bound_ms']:.3f}, {b_dq['bound_by']}), both with delta "
              f"{rec['ms']:.3f} ms (bound {rec['bound_ms']:.3f}); fused kernel "
              f"{rec['fused_ms']:.3f} ms, plain {rec['plain_ms']:.3f} ms, library backward "
              f"{rec['library_ms']:.3f} ms (median of 5); keep mask {mask_bytes} bytes, the "
              f"pair's peak {peak / 2 ** 20:.1f} MiB above its inputs")
        recs[rate] = rec
        del lib_out, ql, kl, vl, bits
    # the recorded entry is the train path's: rate 0.1; rate 0 rides along
    return {**recs[RATE], "rate0": {n: recs[0.0][n] for n in
                                    ("ms", "ms_dkv", "ms_dq", "fused_ms", "bound_ms",
                                     "bound_ms_dkv", "bound_ms_dq", "peak_bytes")}}


def grad_vector(model):
    import torch

    return torch.cat([p.grad.detach().float().flatten() for p in model.parameters()])


def train_steps(tag, card, model, batch, expect, sampling=None):
    """Two AdamW steps (mix schedule) on `batch`, full grid or by the
    neural-field `sampling`: each step's launches, held to `expect`, its
    loss, its time by CUDA events and on the host clock, and its peak; the
    loss and every gradient finite, and every parameter moved. Returns (the
    launches summed, the optimizer, the dropout generator)."""
    import torch

    from gaot3d_tpu_torch.train import OptimizerargsConfig, make_optimizer, train_step

    counters = attention_counters()
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
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        loss, grad_norm = train_step(model, optimizer, batch, generator, sampling)
        end.record()
        end.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        got = {name: fn.launches for name, fn in counters.items()}
        finite = bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(p.grad).all()) for p in model.parameters())
        print(f"[{tag}] {card}: step {step}: loss {loss.item():.6f} grad_norm "
              f"{grad_norm.item():.6f} lr {lr:.3e} step {start.elapsed_time(end):.1f} ms (CUDA "
              f"events), {host_ms:.1f} ms (host clock); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches K1 {got['k1']} "
              f"K2 {got['k2']} K5 {got['k5']} K5b {got['k5b']} (of their bf16 bodies "
              f"{got['k5_bf16']} and {got['k5b_bf16']}); finite={finite}")
        if not finite:
            raise RuntimeError(f"[{tag}] step {step}: non-finite loss or gradient")
        if got != {**dict.fromkeys(counters, 0), **expect}:
            raise RuntimeError(f"[{tag}] step {step}: launches {got}, expected {expect}")
        for name in total:
            total[name] += got[name]
    still = [n for (n, p), b in zip(model.named_parameters(), before) if torch.equal(p, b)]
    if still:
        raise RuntimeError(f"[{tag}] parameters that did not move in 2 steps: {still}")
    print(f"[{tag}] every one of {len(before)} parameter tensors moved")
    return total, optimizer, generator


def phase_train(card, k5b_ms=None):
    import torch

    from gaot3d_tpu_torch.ops.grid_graph import LatentGrid
    from gaot3d_tpu_torch.train import TrainBatch, masked_mse, train_step

    grid = LatentGrid(dims=LATENT)
    model = recipe_model()
    pos, feats, target, mask, slots, nsec, _ = cloud(21, N_POINTS, grid)
    if nsec != 5:
        raise RuntimeError(f"[train] {nsec} sections, expected 5")
    batch = TrainBatch(pos, feats, target, mask, slots, slots)
    print(f"[train] the recipe at kernel_dtype bfloat16: {nsec} sections")
    total, optimizer, generator = train_steps(
        "train", card, model, batch,
        {"k1": 10, "k2": 10, **payload_launches(nsec, "bfloat16")})

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
    wall, rows = profiled(lambda: train_step(model, optimizer, batch, generator))
    print_profile("train", "profiled step", wall, rows, top=8)
    if rows:
        busy = sum(r[1] for r in rows)
        for label, key in (("K5", "encoder_accumulate"), ("K5b", "encoder_backward"),
                           ("GEMMs", "gemm")):
            mine = [r for r in rows if key in r[0].lower()]
            print(f"[train] {label} in the profiled step: {sum(r[1] for r in mine):.3f} ms for "
                  f"{sum(r[2] for r in mine)} launches, {100 * sum(r[1] for r in mine) / busy:.1f}"
                  f"% of device busy"
                  + (f" ([k5b-bf16]'s launches alone: {k5b_ms:.3f} ms)"
                     if label == "K5b" and k5b_ms is not None else ""))
    del model, optimizer, batch
    decoder_mlp_products()

    # kernels against their plain versions through one forward and backward:
    # same widths and depth on a 32x32x16 grid with 65,536 points, where the
    # plain [S, S] logits under autograd fit the run's time (2,048 tokens)
    small = LatentGrid(dims=(32, 32, 16))
    radius = 2 * RADIUS
    # the budget is the max degree of the cloud that cloud(22, ...) draws first
    budget = max_degree(np.random.default_rng(22).uniform(-1, 1, (65_536, 3)).astype(np.float32),
                        small, radius)
    pos, feats, target, mask, slots, nsec, _ = cloud(22, 65_536, small, radius, budget)
    # the f32 bodies, then the bf16 ones, the gradient against the plain versions'
    for dtype in ("float32", "bfloat16"):
        model = recipe_model(small.dims, radius, budget, kernel_dtype=dtype).train()

        def forward_backward():
            model.zero_grad(set_to_none=True)
            pred = model(pos, feats, mask, encoder_slots=[slots], decoder_slots=[slots],
                         generator=torch.Generator().manual_seed(9))
            loss = masked_mse(pred, target, mask)
            loss.backward()
            return grad_vector(model), loss.item()

        against_plain("train", f"32x32x16 grid, 65,536 points, {nsec} sections (budget "
                      f"{budget}), rate {RATE}, one seed, kernel_dtype {dtype}: the gradient",
                      forward_backward, forward_backward())
    return total


def decoder_mlp_products():
    """The decoder's bf16 kernel MLP (6-64-64-32) on the rows of one node
    chunk at K = 5 (327,680), forward, two ways: the port's (F.linear of
    bf16-rounded f32 operands, an f32 GEMM) and torch.mm of bf16 operands
    with an f32 result (`out_dtype`, bf16 tensor cores). Each timed by CUDA
    events, median of 5, and held to the other in relative L2. A yardstick
    for the port's choice; the port never calls the second."""
    import torch
    import torch.nn.functional as F

    from gaot3d_tpu_torch.kernels.encoder_payload import kernel_mlp

    rng = np.random.default_rng(3)
    rows, widths = CHUNK * BUDGET, (6, 64, 64, 32)
    x = torch.from_numpy(rng.uniform(-1, 1, (rows, 6)).astype(np.float32)).cuda()
    ws = [torch.from_numpy(rng.uniform(-i ** -0.5, i ** -0.5, (o, i)).astype(np.float32)).cuda()
          for i, o in zip(widths[:-1], widths[1:])]
    bs = [torch.zeros(o, device="cuda") for o in widths[1:]]

    def bf16_mm():
        h = x
        for i, (w, b) in enumerate(zip(ws, bs)):
            h = torch.mm(h.bfloat16(), w.t().bfloat16(), out_dtype=torch.float32) + b
            if i < len(ws) - 1:
                h = F.gelu(h)
        return h

    port = kernel_mlp(x, ws, bs, "bfloat16")
    port_ms = cuda_ms(lambda: kernel_mlp(x, ws, bs, "bfloat16"))
    try:
        other = bf16_mm()
    except (TypeError, RuntimeError) as e:  # a torch without mm's out_dtype
        print(f"[train] the decoder's bf16 kernel MLP on {rows} rows: the port's f32 GEMMs "
              f"{port_ms:.3f} ms; torch.mm with out_dtype not available here ({e})")
        return
    rel = ((other - port).norm() / port.norm()).item()
    print(f"[train] the decoder's bf16 kernel MLP on {rows} rows: the port's f32 GEMMs on "
          f"bf16-rounded operands {port_ms:.3f} ms, torch.mm of bf16 operands with an f32 "
          f"result {cuda_ms(bf16_mm):.3f} ms; relative L2 between them {rel:.3e} (CUDA events, "
          f"median of 5)")


class PayloadCalls:
    """Context that keeps the inputs and the results of the first K5 and the
    first K5b launch under it (`kernels/encoder_payload.py`
    `launch_accumulate`, `launch_backward`, either body), copied at the
    call, so that `check` can hold them against the plain versions at the
    shapes the path gave them."""

    def __enter__(self):
        from gaot3d_tpu_torch.kernels import encoder_payload as k5

        self.k5, self.fwd, self.bwd = k5, None, None
        fwd, bwd = k5.launch_accumulate, k5.launch_backward

        def spy_fwd(pos, feats, lat_idx, mask, params, n_mid, hid, grid, acc,
                    kernel_dtype="float32", tiles=None):
            if self.fwd is not None:
                return fwd(pos, feats, lat_idx, mask, params, n_mid, hid, grid, acc, kernel_dtype,
                           tiles)
            inputs = [t.clone() for t in (pos, feats, lat_idx, mask, params, acc)]
            fwd(pos, feats, lat_idx, mask, params, n_mid, hid, grid, acc, kernel_dtype, tiles)
            self.fwd = (inputs, n_mid, hid, grid, acc.clone(), kernel_dtype)

        def spy_bwd(g, pos, feats, lat_idx, mask, params, n_mid, hid, grid, dfeats, dparams,
                    kernel_dtype="float32", tiles=None):
            if self.bwd is not None:
                return bwd(g, pos, feats, lat_idx, mask, params, n_mid, hid, grid, dfeats,
                           dparams, kernel_dtype, tiles)
            inputs = [t.clone() for t in (g, pos, feats, lat_idx, mask, params)]
            bwd(g, pos, feats, lat_idx, mask, params, n_mid, hid, grid, dfeats, dparams,
                kernel_dtype, tiles)
            chunk = tiles.chunk if tiles is not None else None
            self.bwd = (inputs, n_mid, hid, grid, dfeats.clone(), dparams.clone(), kernel_dtype,
                        chunk)

        self.patches = [mock.patch.object(k5, "launch_accumulate", spy_fwd),
                        mock.patch.object(k5, "launch_backward", spy_bwd)]
        for patch in self.patches:
            patch.start()
        return self

    def __exit__(self, *exc):
        for patch in self.patches:
            patch.stop()

    def shapes(self, n_mid, hid, C):
        return [(hid, 6)] + [(hid, hid)] * n_mid + [(C, hid)]

    def mlp(self, params, n_mid, hid, C):
        return self.k5._unpack_mlp(params, self.shapes(n_mid, hid, C))

    def check(self, tag):
        """The f32 bodies: K5 to K5_BOUND and K5b to K5B_BOUND, relative to
        the max abs; the bf16 bodies: K5_BF16_BOUND and K5B_BF16_BOUND in
        relative L2, the bf16 launch's dW slices rounded and summed as the
        wrapper does, against the plain version at the launch's node chunk.
        Against the plain versions on the kept inputs (each kept launch's,
        forward or backward, if any). The inputs
        are copied again here: copies made under inference mode (a served
        request) take no in-place update or autograd outside it."""
        k5 = self.k5
        if self.fwd is not None:
            inputs, n_mid, hid, grid, got, dtype = self.fwd
            pos, feats, lat_idx, mask, params, acc = (t.clone() for t in inputs)
            C = feats.shape[-1]
            ws, bs = self.mlp(params, n_mid, hid, C)
            ref = k5.encoder_accumulate_reference(pos, feats, lat_idx, mask, ws, bs, grid, acc,
                                                  CHUNK, dtype)
            if dtype == "bfloat16":
                rel = rel_vals = ((got[..., :C] - ref[..., :C]).norm()
                                  / ref[..., :C].norm()).item()
                limit, what = K5_BF16_BOUND, "relative L2 of the value columns"
            else:
                rel = ((got - ref).abs().max() / ref.abs().max()).item()
                rel_vals = ((got[..., :C] - ref[..., :C]).abs().max()
                            / ref[..., :C].abs().max()).item()
                limit, what = K5_BOUND, "value columns"
            print(f"[{tag}] K5 ({dtype} body) as the path launched it, slots "
                  f"{list(lat_idx.shape)} ({int(mask.sum())} valid) into [{acc.shape[1]}, "
                  f"{acc.shape[2]}] cells, against its plain version: relative {rel:.3e}, "
                  f"{what} {rel_vals:.3e}")
            if not (rel <= limit and rel_vals <= limit):
                raise RuntimeError(f"[{tag}] K5 disagrees with its plain version: {rel}")
        if self.bwd is not None:
            inputs, n_mid, hid, grid, dfeats, dparams, dtype, chunk = self.bwd
            g, pos, feats, lat_idx, mask, params = (t.clone() for t in inputs)
            C = feats.shape[-1]
            ws, bs = self.mlp(params, n_mid, hid, C)
            ref = k5.encoder_accumulate_backward_reference(g, pos, feats, lat_idx, mask, ws, bs,
                                                           grid, chunk or CHUNK, dtype)
            n_slices = dparams.shape[0] if dtype == "bfloat16" else 1
            if dtype == "bfloat16":
                dparams = k5.sum_chunk_slices(dparams, self.shapes(n_mid, hid, C))
            dws, dbs = self.mlp(dparams, n_mid, hid, C)
            pairs = list(zip([dfeats, *dws, *dbs], [ref[0], *ref[1], *ref[2]]))
            if dtype == "bfloat16":
                worst = max(((a - b).norm() / b.norm()).item() for a, b in pairs)
                limit, what = K5B_BF16_BOUND, "relative L2"
            else:
                worst = max(((a - b).abs().max() / b.abs().max()).item() for a, b in pairs)
                limit, what = K5B_BOUND, "relative"
            print(f"[{tag}] K5b ({dtype} body) as the path launched it, slots "
                  f"{list(lat_idx.shape)}"
                  + (f" ({n_slices} node chunks)" if dtype == "bfloat16" else "")
                  + ", against autograd through the plain version: worst "
                  f"{what} {worst:.3e} of dfeats, dW, db")
            if not worst <= limit:
                raise RuntimeError(f"[{tag}] K5b disagrees with its plain version: {worst}")


class BuildSpy:
    """Context that times every slot build the model makes
    (`models/magno.py` `build_budgeted_slots`) between two CUDA events,
    records its peak device memory above what was allocated before it, and
    keeps the slots it returned. Nothing here waits for the card."""

    def __enter__(self):
        import torch

        from gaot3d_tpu_torch.models import magno

        build = magno.build_budgeted_slots
        self.builds = []

        def spy(*args, **kwargs):
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            slots = build(*args, **kwargs)
            end.record()
            self.builds.append({"events": (start, end), "slots": slots,
                                "peak": torch.cuda.max_memory_allocated() - base})
            return slots

        self.patch = mock.patch.object(magno, "build_budgeted_slots", spy)
        self.patch.start()
        return self

    def __exit__(self, *exc):
        self.patch.stop()

    def ms(self, i=-1):
        start, end = self.builds[i]["events"]
        return start.elapsed_time(end)


BAND = 3e-5  # of r^2: a slot where the card's build and the host build differ must lie this
#              close to the radius; one rounding of each cell coordinate moves d^2 by about
#              6e-6 r^2 on the recipe's grid


def host_build_differences(pos, lat_a, msk_a, lat_b, msk_b, grid, radius=RADIUS):
    """(point, cell) edges in one of two compacted slot sets and not the
    other, with each one's d^2 - r^2 over r^2 (float64)."""
    import torch

    big = np.iinfo(np.int32).max
    key_a = np.sort(np.where(msk_a, lat_a, big), axis=1)
    key_b = np.sort(np.where(msk_b, lat_b, big), axis=1)
    rows = np.nonzero((key_a != key_b).any(axis=1))[0]
    pairs = [(r, c) for r in rows
             for c in set(key_a[r][key_a[r] < big]) ^ set(key_b[r][key_b[r] < big])]
    if not pairs:
        return []
    cells = grid.positions_from_idx(torch.tensor([c for _, c in pairs], dtype=torch.int64),
                                    dtype=torch.float64).numpy()
    d2 = ((cells - pos[[r for r, _ in pairs]].astype(np.float64)) ** 2).sum(axis=1)
    r2 = float(np.float32(radius)) ** 2
    return [(int(r), int(c), float((d - r2) / r2)) for (r, c), d in zip(pairs, d2)]


def phase_serve_device(card):
    """[serve-device]: the recipe over uniform slots, exported and loaded
    with edges="device": 2 requests of 524,288 points whose slots the card
    builds in the forward."""
    import torch

    from gaot3d_tpu_torch.data.host_graph import build_edge_slots_host
    from gaot3d_tpu_torch.kernels import encoder_payload as k5
    from gaot3d_tpu_torch.kernels import flash_attention as k1
    from gaot3d_tpu_torch.kernels import slot_build as k10
    from gaot3d_tpu_torch.ops.grid_graph import EdgeSlots, LatentGrid, build_budgeted_slots
    from gaot3d_tpu_torch.serve import export_inference, load_inference

    grid = LatentGrid(dims=LATENT)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "recipe_slots.pt")
        export_inference(recipe_model(edge_layout="slots"), path)
        infer = load_inference(path, edges="device")
        infer_args = load_inference(path)  # the same weights, edges as call-time arguments

    fwd, acc = k1.flash_attention, k5.encoder_accumulate
    fwd.launches = acc.launches = acc.launches_bf16 = 0
    k10_before = k10.slot_build.launches
    requests = []
    with BuildSpy() as spy, PayloadCalls() as payload:
        for i, seed in enumerate((13, 14)):
            pos, feats, _, mask, *_ = cloud(seed, N_POINTS)
            n1, n5, nb, n10 = fwd.launches, acc.launches_bf16, len(spy.builds), \
                k10.slot_build.launches
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = infer(pos, feats, mask)
            end.record()
            end.synchronize()
            total = start.elapsed_time(end)
            d1, d5, d10 = fwd.launches - n1, acc.launches_bf16 - n5, k10.slot_build.launches - n10
            builds = spy.builds[nb:]
            ok = tuple(out.shape) == (1, N_POINTS, 1) and bool(torch.isfinite(out).all())
            build_ms = sum(spy.ms(nb + j) for j in range(len(builds)))
            print(f"[serve-device] {card}: request {i + 1}: {len(builds)} slot build "
                  f"{build_ms:.2f} ms (CUDA events), its peak {builds[0]['peak'] / 2 ** 20:.1f} "
                  f"MiB above the memory held before it; forward {total - build_ms:.2f} ms, "
                  f"request {total:.2f} ms; out {tuple(out.shape)} finite={ok}; K1 launches "
                  f"{d1}, launches of K5's bf16 body {d5}, of K10 {d10}")
            if not ok or d1 != 10 or d5 != 1 or d10 != 1 or len(builds) != 1:
                raise RuntimeError(f"[serve-device] request {i + 1}: bad output, launch counts "
                                   f"or builds ({len(builds)})")
            requests.append(((pos, feats, mask), builds[0]["slots"], out))
        args, slots, out = requests[-1]
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        warm = infer(*args)
        end.record()
        end.synchronize()
        warm_build = spy.ms()
    if not torch.isfinite(warm).all():
        raise RuntimeError("[serve-device] the warm request gave a non-finite output")
    launches = {"k1": fwd.launches, "k5": acc.launches, "k5_bf16": acc.launches_bf16,
                "k10": k10.slot_build.launches - k10_before}
    payload.check("serve-device")  # request 1's K5 launch
    args, slots, out = requests[0]
    against_plain("serve-device", "request 1", lambda: (infer(*args),), (out,))

    pos, _, mask = args
    pos_np = pos[0].cpu().numpy()
    cpu = build_budgeted_slots(pos.cpu(), grid, RADIUS, 1, "bidirectional", mask.cpu(), BUDGET,
                               CHUNK)
    same = torch.equal(cpu.lat_idx, slots.lat_idx.cpu()) and torch.equal(cpu.mask,
                                                                           slots.mask.cpu())
    print(f"[serve-device] request 1's slots [1, {N_POINTS}, {BUDGET}] against the port's build "
          f"on the CPU of the same cloud: bit for bit {same}")
    if not same:
        raise RuntimeError("[serve-device] the card's build differs from the CPU build")
    t0 = time.perf_counter()
    h_lat, h_msk = build_edge_slots_host(pos_np, grid, RADIUS, strategy="bidirectional",
                                         budget=BUDGET)
    host_ms = (time.perf_counter() - t0) * 1e3
    diffs = host_build_differences(pos_np, slots.lat_idx[0].cpu().numpy(),
                                   slots.mask[0].cpu().numpy(), h_lat, h_msk, grid)
    worst = max((abs(d) for *_, d in diffs), default=0.0)
    print(f"[serve-device] against the host build (native/gaot_graph.cpp, budget {BUDGET}): "
          f"{len(diffs)} edges differ of {int(h_msk.sum())}, the farthest at |d^2 - r^2| = "
          f"{worst:.2e} r^2 (band {BAND:.0e} r^2): {diffs[:4]}")
    if worst > BAND:
        raise RuntimeError(f"[serve-device] a slot differs from the host build outside the band: "
                           f"{diffs}")
    host_slots = EdgeSlots.from_numpy(h_lat[None], h_msk[None], device="cuda")
    ref = infer_args(*args, host_slots, host_slots)
    rel = ((out - ref).norm() / ref.norm()).item()
    print(f"[serve-device] request 1 against the same model's forward on the host-built slots: "
          f"relative L2 {rel:.3e}")
    if not rel <= E2E_BOUND:
        raise RuntimeError(f"[serve-device] device-built and host-built slots disagree: {rel}")
    print(f"[serve-device] {card}: request 2 answered again (warm): {warm_build:.2f} ms build, "
          f"forward {start.elapsed_time(end) - warm_build:.2f} ms, request "
          f"{start.elapsed_time(end):.2f} ms; the host build of request 1's cloud "
          f"{host_ms:.1f} ms (budgeted slots, without sections or upload)")
    return launches


BUCKETS = (262_144, N_POINTS)
PADDED = 400_000  # the request the dispatcher pads to the larger bucket
# relative L2, a forward against the same forward on the same inputs and weights (the
# dispatcher against the model on the padded inputs, an exported model against the
# trainer's): K5's float atomics add in another order on every run, and through the bf16
# attention two runs of one model on one input differ by about 3e-5 on an H100; the limit
# is RELOAD_BOUND's, for the same cause. Each phase prints that spread beside its reading
RERUN_BOUND = 1e-4


class DispatchSpy:
    """Answers requests through a bucket dispatcher (`serve.BucketedInference`)
    and records CUDA events around its pad, around its forward and after it
    returns (the slice back to the request's nodes, a view), the request's
    wall on the host clock (synchronized) and its peak device memory above
    what was held before it."""

    def __init__(self, infer):
        self.infer = infer

    def __call__(self, *args):
        import torch

        marks = {}

        def mark(name):
            marks[name] = torch.cuda.Event(enable_timing=True)
            marks[name].record()

        def timed(name, fn):
            def run(*a):
                mark(name)
                out = fn(*a)
                mark(name + " end")
                return out
            return run

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with mock.patch.object(self.infer, "pad", timed("pad", self.infer.pad)), \
                mock.patch.object(self.infer, "infer", timed("forward", self.infer.infer)):
            t0 = time.perf_counter()
            mark("request")
            out = self.infer(*args)
            mark("request end")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0

        def ms(a, b):
            return marks[a].elapsed_time(marks[b]) if a in marks else 0.0

        times = {"pad": ms("pad", "pad end"), "forward": ms("forward", "forward end"),
                 "slice": ms("forward end", "request end"), "request": ms("request", "request end"),
                 "wall": 1e3 * wall,
                 "peak_mib": (torch.cuda.max_memory_allocated() - base) / 2 ** 20}
        return out, times


def phase_serve_buckets(card):
    """[serve-buckets]: the recipe over uniform slots in a bucket bundle of
    {262,144, 524,288} nodes that builds its slots on the card: requests of
    400,000 points (padded), 262,144, 524,288, 524,288 with host-built
    sections passed at call time, and 600,000, which must raise."""
    import torch

    from gaot3d_tpu_torch.kernels import encoder_payload as k5
    from gaot3d_tpu_torch.kernels import flash_attention as k1
    from gaot3d_tpu_torch.ops.grid_graph import LatentGrid
    from gaot3d_tpu_torch.serve import export_inference_buckets, load_inference_buckets

    grid = LatentGrid(dims=LATENT)
    model = recipe_model(edge_layout="slots").eval()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "recipe_buckets.pt")
        export_inference_buckets(model, path, BUCKETS)
        infer = load_inference_buckets(path)
    if infer.buckets != list(BUCKETS):
        raise RuntimeError(f"[serve-buckets] buckets {infer.buckets}")
    spy = DispatchSpy(infer)
    fwd, acc = k1.flash_attention, k5.encoder_accumulate
    fwd.launches = acc.launches = acc.launches_bf16 = 0
    answered = []
    with PayloadCalls() as payload:  # request 1's K5 launch, at the padded shape
        for label, n, seed, sectioned in (("padded", PADDED, 21, False),
                                          ("bucket 262,144", BUCKETS[0], 22, False),
                                          ("bucket 524,288", N_POINTS, 23, False),
                                          ("sections at call time", N_POINTS, 24, True)):
            pos, feats, _, mask, slots, nsec, _ = cloud(seed, n, grid if sectioned else None)
            edges = (slots, slots) if sectioned else ()
            n1, n5 = fwd.launches, acc.launches_bf16
            out, ms = spy(pos, feats, mask, *edges)
            d1, d5 = fwd.launches - n1, acc.launches_bf16 - n5
            ok = tuple(out.shape) == (1, n, 1) and bool(torch.isfinite(out).all())
            print(f"[serve-buckets] {card}: request {len(answered) + 1} ({label}), {n} points in "
                  f"bucket {infer.bucket(n)}: pad {ms['pad']:.3f} ms, forward {ms['forward']:.2f} "
                  f"ms, slice {ms['slice']:.3f} ms, request {ms['request']:.2f} ms (CUDA events), "
                  f"wall {ms['wall']:.1f} ms, peak {ms['peak_mib']:.1f} MiB above the memory held "
                  f"before it; out {tuple(out.shape)} finite={ok}; K1 launches {d1}, launches of "
                  f"K5's bf16 body {d5}{f' ({nsec} sections)' if sectioned else ''}")
            if not ok or d1 != 10 or d5 != (nsec if sectioned else 1):
                raise RuntimeError(f"[serve-buckets] request {label}: bad output or launch counts")
            answered.append(((pos, feats, mask), out))
    (pos, feats, mask), out = answered[0]
    warm, ms = spy(pos, feats, mask)
    print(f"[serve-buckets] {card}: request 1 answered again (warm): pad {ms['pad']:.3f} ms, "
          f"forward {ms['forward']:.2f} ms, slice {ms['slice']:.3f} ms, request "
          f"{ms['request']:.2f} ms, wall {ms['wall']:.1f} ms")
    if not torch.isfinite(warm).all():
        raise RuntimeError("[serve-buckets] the warm request gave a non-finite output")
    launches = {"k1": fwd.launches, "k5": acc.launches, "k5_bf16": acc.launches_bf16}
    payload.check("serve-buckets")

    with torch.inference_mode():
        padded, again = (model(*infer.pad(pos, feats, mask, BUCKETS[1]))[:, :PADDED]
                         for _ in range(2))
    rel, own = rel_l2(out, padded), rel_l2(again, padded)
    print(f"[serve-buckets] request 1 against the model's forward on the same padded inputs: "
          f"relative L2 {rel:.3e} (the same bits {torch.equal(out, padded)}); that forward "
          f"against itself {own:.3e}, request 1 against its warm answer "
          f"{rel_l2(warm, out):.3e}")
    if not rel <= RERUN_BOUND:
        raise RuntimeError(f"[serve-buckets] the dispatcher and the padded forward disagree: {rel}")
    against_plain("serve-buckets", "request 1", lambda: (infer(pos, feats, mask),), (out,))

    big = [torch.zeros((1, 600_000, c), device="cuda") for c in (3, 3)]
    before = (fwd.launches, acc.launches)
    try:
        infer(*big, torch.ones((1, 600_000), dtype=torch.bool, device="cuda"))
    except ValueError as e:
        if "exceeds the largest bucket" not in str(e):
            raise
        print(f"[serve-buckets] a request of 600,000 points raised: {e}")
    else:
        raise RuntimeError("[serve-buckets] a request above the largest bucket was answered")
    if (fwd.launches, acc.launches) != before:
        raise RuntimeError("[serve-buckets] the refused request launched a kernel")
    return launches


def phase_nf(card):
    """[nf]: the recipe model over uniform slots trains by neural field."""
    import torch

    from gaot3d_tpu_torch.kernels import decoder_payload as k9
    from gaot3d_tpu_torch.kernels import encoder_payload as k5
    from gaot3d_tpu_torch.kernels import flash_attention as k1
    from gaot3d_tpu_torch.ops.grid_graph import LatentGrid, build_edge_slots, max_slot_degree
    from gaot3d_tpu_torch.train import (NeuralField, TrainBatch, eval_step, neural_field_loss,
                                        sample_nodes_without_replacement)

    # kernel_dtype float32: the f32 bodies of K5 and K5b on a path at full width ([trainer-nf]
    # takes the same path at bf16)
    model = recipe_model(edge_layout="slots", kernel_dtype="float32")
    pos, feats, target, mask, *_ = cloud(23, N_POINTS)
    batch = TrainBatch(pos, feats, target, mask, None, None)
    sampling = NeuralField(NF_NODES, NF_NODES, torch.Generator(device="cuda").manual_seed(6))
    print(f"[nf] {NF_NODES} input = query nodes of {N_POINTS} a step, kernel_dtype float32")
    with PayloadCalls() as payload:  # the first step's K5 and K5b launches
        total, *_ = train_steps("nf", card, model, batch,
                                {"k1": 10, "k2": 10, "k5": 1, "k5b": 1}, sampling)
    payload.check("nf")
    sampler_ms = cuda_ms(lambda: sample_nodes_without_replacement(mask, NF_NODES,
                                                                  sampling.generator))
    print(f"[nf] {card}: the node sampler ({NF_NODES} of {N_POINTS}, a stable sort) "
          f"{sampler_ms:.3f} ms (CUDA events, median of 5)")

    # a full-grid eval forward, its slots built on the card
    n1, n5, n9 = (k1.flash_attention.launches, k5.encoder_accumulate.launches,
                  k9.decoder_payload.launches)
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    pred, val = eval_step(model, batch)
    end.record()
    end.synchronize()
    d1, d5, d9 = (k1.flash_attention.launches - n1, k5.encoder_accumulate.launches - n5,
                  k9.decoder_payload.launches - n9)
    ok = tuple(pred.shape) == (1, N_POINTS, 1) and bool(torch.isfinite(pred).all())
    print(f"[nf] {card}: full-grid eval forward on {N_POINTS} points: {start.elapsed_time(end):.1f}"
          f" ms with its slot build, loss {val.item():.6f}, finite={ok}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; K1 {d1}, K5 {d5}, K9 {d9}")
    if not ok or (d1, d5, d9) != (10, 1, 1):
        raise RuntimeError("[nf] the eval forward: bad output or launch counts")
    total["k1_eval"] = d1
    total["k5"] += d5
    total["k9"] = d9
    against_plain("nf", f"the full-grid eval forward on {N_POINTS} points",
                  lambda: (eval_step(model, batch)[0],), (pred,))
    del model, batch, pred

    # attention under autograd against its plain version through one
    # neural-field loss and backward on the same indices, on a 32x32x16 grid
    # where the plain [S, S] logits fit
    small = LatentGrid(dims=(32, 32, 16))
    radius = 2 * RADIUS
    pos, feats, target, mask, *_ = cloud(24, 65_536)
    budget = max_slot_degree(build_edge_slots(pos[0], small, radius, 1, "bidirectional"))
    model = recipe_model(small.dims, radius, budget, edge_layout="slots",
                         kernel_dtype="float32").train()
    batch = TrainBatch(pos, feats, target, mask, None, None)

    def loss_and_grad():
        model.zero_grad(set_to_none=True)
        nodes = NeuralField(20_000, 12_000, torch.Generator(device="cuda").manual_seed(7))
        loss = neural_field_loss(model, batch, nodes, torch.Generator().manual_seed(9))
        loss.backward()
        return grad_vector(model), loss.item()

    against_plain("nf", f"32x32x16 grid, 65,536 points, 20,000 inputs and 12,000 queries "
                  f"(budget {budget}), rate {RATE}, one seed: the gradient", loss_and_grad,
                  loss_and_grad())
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


ADD_RATE = F32_FLOPS / 2  # f32 additions a second: one a cycle a lane, half the FMA flop rate


def timed_line(tag, label, rec):
    print(f"[{tag}] {label}: device {rec['device_ms']:.4f} ms (cold L2 "
          f"{'not measured' if rec['device_ms_cold'] is None else format(rec['device_ms_cold'], '.4f')}"
          f"), call {rec['call_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), library {rec['library_ms']:.4f} ms "
          f"(medians of 5; {rec['ms_reading']})")


def check_segments(name, limit, got, again, plain):
    """Kernel against plain, each column to `limit` of its max-abs in the
    plain result, and two launches bit for bit; returns the max abs error."""
    import torch

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


def library_index_add(ids, data, M):
    import torch

    return torch.zeros((M + 1, data.shape[1]), device="cuda").index_add_(0, ids, data)


def phase_k7(cloud_):
    """[k7]: the prefix sum at a ragged shape and at the shapes of chunk 0 of
    the cloud: its flat list ([E, 32], [E, 43]) and, for `sort`, its slots."""
    import torch

    from gaot3d_tpu_torch.kernels import prefix_sum as k7

    rng = np.random.default_rng(3)
    E = cloud_["by_dst"].edges_per_chunk
    lib = k7._library()
    shapes = {}
    for rows, C in ((1003, 43), (E, 32), (CHUNK * BUDGET, 43), (E, 43)):
        x = payload_like(rng, rows)[:, :C].contiguous()
        got, again, plain = k7.prefix_sum(x), k7.prefix_sum(x), k7.prefix_sum_reference(x)
        twin = k7.prefix_sum_ordered_reference(x)
        library = torch.cumsum(x, dim=0)
        torch.cuda.synchronize()
        top = plain.abs().amax(dim=0)
        rel = ((got - plain).abs() / top).max().item()
        rel_library = ((library - plain).abs() / top).max().item()
        same = torch.equal(got, again) and torch.equal(got, twin)
        print(f"[k7] [{rows}, {C}]: kernel vs plain {rel:.3e} of the column's largest prefix "
              f"(limit {K7_BOUND:.0e}; torch.cumsum in float32 reads {rel_library:.3e}); two "
              f"launches and the ordered twin bit for bit: {same}")
        if not (torch.isfinite(got).all() and rel <= K7_BOUND and same):
            raise RuntimeError(f"K7 [{rows}, {C}] disagrees with its plain version, its twin "
                               f"or itself")
        if rows < E:
            continue
        out = torch.empty_like(x)
        R = k7.tile_rows(C)
        blocks = -(-rows // (R * k7.SCAN_RADIX))
        print(f"[k7] [{rows}, {C}]: tiles of {R} rows, {blocks} blocks of {k7.SCAN_RADIX} "
              f"tiles, {lib.gaot_prefix_sum_ctas_per_sm(rows, C, R)} CTAs an SM")
        scratch = torch.zeros(lib.gaot_prefix_sum_scratch_bytes(rows, C, R) + 16,
                              dtype=torch.uint8, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        epoch = [0]

        def launch():
            epoch[0] += 1
            if lib.gaot_prefix_sum(x.data_ptr(), out.data_ptr(), scratch.data_ptr(), rows, C, R,
                                   k7.SCAN_RADIX, epoch[0], stream):
                raise RuntimeError("K7's bare launch failed")

        rec = {"max_abs_err": (got - plain).abs().max().item(),
               **kernel_ms(lambda: k7.prefix_sum(x), k7.DEVICE_KERNELS,
                           lambda: bare_launches(launch)),
               "plain_ms": cuda_ms(lambda: k7.prefix_sum_reference(x)),
               **bound(2 * x.numel() * 4, add=x.numel() / ADD_RATE),
               "library_ms": cuda_ms(lambda: torch.cumsum(x, 0))}
        timed_line("k7", f"[{rows}, {C}] f32", rec)
        if rec["device_launches_per_call"] not in (1, None):
            raise RuntimeError(f"K7 launched {rec['device_launches_per_call']} kernels a call")
        shapes[f"{rows}x{C}"] = rec
    # the record is the flat list's [E, 43], the last of the loop; the others ride along
    rec = dict(shapes.pop(f"{E}x43"))
    rec["other_shapes"] = {k: {n: v[n] for n in ("device_ms", "device_ms_cold", "call_ms",
                                                 "bound_ms", "library_ms")}
                           for k, v in shapes.items()}
    return rec


def k6_occupancy():
    """K6's share at the recipe's 43 columns and the CTAs an SM holds."""
    from gaot3d_tpu_torch.kernels import segment_sum_sorted as k6

    share = k6.share_items(43)
    ctas = k6._library().gaot_segment_sum_sorted_ctas_per_sm(43, share)
    print(f"[k6] at P = 43: shares of {share} items, {ctas} CTAs an SM")
    if ctas < 1:
        raise RuntimeError("K6 fits no CTA on an SM")


def host_us(fn, n=2000):
    """Host microseconds a call of fn, over n calls."""
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def phase_k6(cloud_):
    """[k6]: rows that arrive sorted (chunk 0 of the 'dst' list, padding at
    the tail), a ragged small case and three batches; each against its plain
    version and, bit for bit, its ordered twin, and timed."""
    import torch

    from gaot3d_tpu_torch.kernels import segment_sum_sorted as k6

    rng = np.random.default_rng(4)
    M = LATENT[0] * LATENT[1] * LATENT[2]
    E = cloud_["by_dst"].edges_per_chunk
    lib = k6._library()
    stream = torch.cuda.current_stream().cuda_stream
    k6_occupancy()

    def measure(label, data, ids, S):
        B, rows, P = data.shape
        got = k6.segment_sum_sorted(data, ids, S)
        err = check_segments(f"k6 {label}", K6_BOUND, got, k6.segment_sum_sorted(data, ids, S),
                             k6.segment_sum_sorted_reference(data, ids, S))
        share = k6.share_items(P)
        same = torch.equal(got, k6.segment_sum_sorted_ordered_reference(data, ids, S, share))
        print(f"[k6] {label}: {-(-(rows + S) // share)} shares of {share} items a batch; the "
              f"same bits as its ordered twin: {same}")
        if not same:
            raise RuntimeError(f"K6 {label}: not its ordered twin's bits")
        out = torch.empty_like(got)

        def bare():
            return bare_launches(lambda: lib.gaot_segment_sum_sorted(
                data.data_ptr(), ids.data_ptr(), out.data_ptr(), B, rows, P, S, share, stream))

        keep = (ids >= 0) & (ids < S)
        n_valid = int(keep.sum())
        # index_add_ over the batches at once, each batch's rows onto its own S + 1 cells
        flat_ids = (torch.where(keep, ids, S).long()
                    + (S + 1) * torch.arange(B, device="cuda")[:, None]).reshape(-1)
        flat_rows = data.reshape(-1, P)
        rec = {"max_abs_err": err,
               **kernel_ms(lambda: k6.segment_sum_sorted(data, ids, S), k6.DEVICE_KERNELS, bare),
               "plain_ms": cuda_ms(lambda: k6.segment_sum_sorted_reference(data, ids, S)),
               **bound(n_valid * P * 4 + B * rows * 4 + B * S * P * 4,
                       add=n_valid * P / ADD_RATE),
               "library_ms": cuda_ms(lambda: library_index_add(flat_ids, flat_rows,
                                                               B * (S + 1) - 1))}
        timed_line("k6", label, rec)
        if rec["device_launches_per_call"] not in (1, None):
            raise RuntimeError(f"K6 launched {rec['device_launches_per_call']} kernels a call")
        return rec

    ids_small = torch.from_numpy(np.sort(np.where(
        rng.random(1003) < 0.9, rng.integers(0, 517, 1003), 517)).astype(np.int32)).cuda()
    small = measure("ragged [1003, 43] -> [517, 43]", payload_like(rng, 1003)[None],
                    ids_small[None], 517)
    # three batches of tests/test_torch_port_cuda.py's shape, 3000, 2100 and 3 valid rows
    ids3 = torch.from_numpy(np.stack([np.sort(np.where(
        np.arange(3000) < n, rng.integers(0, 257, 3000), 257)).astype(np.int32)
        for n in (3000, 2100, 3)])).cuda()
    three = measure("B = 3 [3, 3000, 43] -> [3, 257, 43]",
                    payload_like(rng, 9000).reshape(3, 3000, 43), ids3, 257)
    mask = cloud_["by_dst"].mask[:, 0]
    ids = torch.where(mask, cloud_["by_dst"].dst[:, 0], torch.full_like(mask, M, dtype=torch.int32))
    rec = measure(f"[1, {E}, 43] ({int(mask.sum())} valid rows) -> [1, {M}, 43]",
                  payload_like(rng, E)[None], ids, M)
    # host cost of the two steps PR 8's wrapper took on every call and this one
    # does not: setting ctypes' argtypes, and entering the tensor's device
    fn = lib.gaot_segment_sum_sorted
    types = list(fn.argtypes)
    device = torch.device("cuda", torch.cuda.current_device())

    def set_types():
        fn.argtypes = types

    def enter_device():
        with torch.cuda.device(device):
            pass

    rec["host_us_removed"] = {"argtypes": host_us(set_types), "device": host_us(enter_device)}
    print(f"[k6] the call {rec['call_ms']:.4f} ms; the steps it no longer takes, host us a "
          f"call: setting argtypes {rec['host_us_removed']['argtypes']:.1f}, entering the "
          f"device {rec['host_us_removed']['device']:.1f}")
    rec["other_shapes"] = {name: {n: r[n] for n in ("device_ms", "device_ms_cold", "call_ms",
                                                   "bound_ms", "library_ms")}
                           for name, r in (("ragged 1003x43", small), ("3x3000x43", three))}
    return rec


def phase_k8(cloud_):
    """[k8]: the slots of chunk 0, masked ones included, sorted on the card,
    read through perm; a ragged small case; K6 on the same sorted rows."""
    import torch

    from gaot3d_tpu_torch.kernels import segment_sum_sorted as k6
    from gaot3d_tpu_torch.kernels import tile_segment_sum as k8
    from gaot3d_tpu_torch.ops.segment import make_tile_fold

    rng = np.random.default_rng(5)
    M = LATENT[0] * LATENT[1] * LATENT[2]
    ids_small = torch.from_numpy(np.sort(np.where(
        rng.random(1003) < 0.9, rng.integers(0, 517, 1003), 517)).astype(np.int32)).cuda()
    fold_small = make_tile_fold(ids_small[torch.from_numpy(rng.permutation(1003)).cuda()], 517,
                                seg_tile=100)
    shuffled = payload_like(rng, 1003)

    def tile(fold, rows, S, seg_tile=512):
        return k8.tile_segment_sum(rows, fold.sorted_seg, ts=fold.ts, num_segments=S,
                                   seg_tile=seg_tile, perm=fold.perm)

    got_small = tile(fold_small, shuffled, 517, 100)
    check_segments("k8 ragged [1003, 43] -> [517, 43], seg_tile 100", K8_BOUND,
                   got_small, tile(fold_small, shuffled, 517, 100),
                   k8.tile_segment_sum_reference(shuffled, fold_small.sorted_seg, fold_small.ts,
                                                 517, fold_small.perm))
    if not torch.equal(got_small, k8.tile_segment_sum_ordered_reference(
            shuffled, fold_small.sorted_seg, fold_small.ts, 517, fold_small.perm, seg_tile=100)):
        raise RuntimeError("K8 ragged: not its ordered twin's bits")
    lat = cloud_["slots"].lat_idx[0, :CHUNK].reshape(-1)
    msk = cloud_["slots"].mask[0, :CHUNK].reshape(-1)
    rows = payload_like(rng, lat.shape[0])
    t_fold = cuda_ms(lambda: make_tile_fold(lat, M, msk))
    fold = make_tile_fold(lat, M, msk)
    n_valid = int(msk.sum())
    got = tile(fold, rows, M)
    err = check_segments(f"k8 [{lat.shape[0]}, 43] ({n_valid} valid rows) -> [{M}, 43]",
                         K8_BOUND, got, tile(fold, rows, M),
                         k8.tile_segment_sum_reference(rows, fold.sorted_seg, fold.ts, M,
                                                       fold.perm))
    sorted_rows = rows[fold.perm.long()]
    same_k6 = torch.equal(got, k6.segment_sum_sorted(sorted_rows, fold.sorted_seg, M))
    same_sorted = torch.equal(got, k8.tile_segment_sum(sorted_rows, fold.sorted_seg, ts=fold.ts,
                                                       num_segments=M))
    same_twin = torch.equal(got, k8.tile_segment_sum_ordered_reference(
        rows, fold.sorted_seg, fold.ts, M, fold.perm))
    print(f"[k8] the same bits as its ordered twin: {same_twin}; as K6 on the sorted rows: "
          f"{same_k6}; as K8 on the sorted rows without perm: {same_sorted}")
    if not (same_twin and same_k6 and same_sorted):
        raise RuntimeError("K8 differs from its twin, from K6, or from itself on the sorted rows")
    lib = k8._library()
    out = torch.empty((M, 43), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def bare():
        return bare_launches(lambda: lib.gaot_tile_segment_sum(
            rows.data_ptr(), fold.sorted_seg.data_ptr(), fold.perm.data_ptr(),
            fold.ts.data_ptr(), out.data_ptr(), 43, M, 512, stream))

    sorted_ids = fold.sorted_seg.long()
    rec = {"max_abs_err": err,
           **kernel_ms(lambda: tile(fold, rows, M), k8.DEVICE_KERNELS, bare),
           "plain_ms": cuda_ms(lambda: k8.tile_segment_sum_reference(
               rows, fold.sorted_seg, fold.ts, M, fold.perm)),
           **bound(n_valid * 43 * 4 + 2 * lat.shape[0] * 4 + M * 43 * 4,
                   add=n_valid * 43 / ADD_RATE),
           "library_ms": cuda_ms(lambda: library_index_add(sorted_ids, rows[fold.perm.long()], M))}
    timed_line("k8", f"one chunk (the sort and tile boundaries before it {t_fold:.3f} ms)", rec)
    return rec


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

    # kernel_dtype float32 throughout: the sorted reductions are held to f32 limits against
    # K5's f32 body
    counters = {"k1": k1.flash_attention, "k2": k1.flash_attention_backward,
                "k5": k5.encoder_accumulate, "k5b": k5.encoder_accumulate_backward,
                "k6": k6.segment_sum_sorted, "k7": k7.prefix_sum, "k8": k8.tile_segment_sum}
    total = dict.fromkeys(counters, 0)
    sorted_names = k6.DEVICE_KERNELS + k7.DEVICE_KERNELS + k8.DEVICE_KERNELS
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
        # one more warm forward under the profiler: where its device time goes
        for fn in counters.values():
            fn.launches = 0
        wall, rows = profiled(lambda: infer(pos, feats, mask, enc, dec))
        got = {n: fn.launches for n, fn in counters.items() if fn.launches}
        if got != expect:
            raise RuntimeError(f"{label}: the profiled forward launched {got}")
        for n, v in got.items():
            total[n] += v
        print_profile("flat", f"{label}, profiled warm forward", wall, rows, mine=sorted_names)
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
    ref_model = recipe_model(edge_layout="slots", kernel_dtype="float32").eval()
    ref_out, ref_acc, _, _ = serve(make_edge_arg_model(ref_model), ref_model, cloud_["slots"],
                                   cloud_["slots"], "uniform slots, segment_impl scatter (K5)",
                                   {"k1": 10, "k5": 1})
    del ref_model

    # config A through the entry points a server calls
    config_a = dict(edge_layout="flat", flat_order="dst", flat_reduce_impl="pallas")
    model_a = recipe_model(kernel_dtype="float32", **config_a)
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
        model = recipe_model(kernel_dtype="float32", **overrides).eval()
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
    model = recipe_model(small.dims, radius, budget, kernel_dtype="float32",
                         edge_chunk_size=8192, **config_a).train()

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


# T1's bound: each pipe's instructions over its rate, in thread instructions a
# second. An SM sub-partition issues one warp instruction a clock, so the
# issue slots' rate is the FP32 pipe's (32 lanes a sub-partition); the packed
# half (H*2) instructions have no rate of their own here, since whether one
# issues at the f32 rate is what the probe measures: they count in the issue
# slots only.
T1_RATES = {"mufu": SFU_OPS, "fp32": FP32_OPS, "int": INT32_OPS, "issue": FP32_OPS}


def t1_instructions():
    """Instructions a thread spends on one element-step of each T1 case, by
    pipe, from the SASS of the built library: the kernel unrolled 64 times
    less the one unrolled 32 times, over 32 steps of its 8 elements. Prints
    them, and how many MUFU ops a packed bf16x2 exponential takes."""
    from gaot3d_tpu_torch.kernels import build

    funcs = sass_functions(sass(os.path.join(build.BUILD_DIR, "libelementwise_chain.so")))

    def kernel(dtype, chain, reps):
        found = [v for k, v in funcs.items()
                 if f"chain_{dtype}_kernelILi{chain}ELi{reps}E" in k]
        if len(found) != 1:
            raise RuntimeError(f"T1: {len(found)} SASS functions for {dtype} {chain} {reps}")
        return sass_pipes(found[0])

    out = {}
    for c, chain in enumerate(("exp", "select")):
        for dtype, name in (("f32", "float32"), ("bf16", "bfloat16")):
            hi, lo = kernel(dtype, c, 64), kernel(dtype, c, 32)
            out[f"{chain} {name}"] = {pipe: (hi[pipe] - lo[pipe]) / (32 * 8) for pipe in hi}
            print(f"[t1] SASS of {chain} {name}, instructions a thread an element-step: "
                  + ", ".join(f"{p} {v:.3f}" for p, v in out[f"{chain} {name}"].items()))
    print(f"[t1] ex2.approx.ftz.bf16x2 takes {2 * out['exp bfloat16']['mufu']:.2f} MUFU "
          f"instructions a packed pair of elements")
    return out


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
    per_step = t1_instructions()
    for key, case in cases.items():
        chain, name = key.split()
        dtype = getattr(torch, name)
        x = x32.to("cuda", dtype)
        counts = per_step[key]
        times = {pipe: steps * counts[pipe] / rate for pipe, rate in T1_RATES.items()}
        case.update(bound(2 * x.numel() * x.element_size(), **times))
        case["bound_pipe"] = max(times, key=times.get)
        case["sass_per_element_step"] = counts
        case["plain_ms"] = cuda_ms(lambda: [t1.chain_plain(x, chain, reps) for _ in range(grid)],
                                   reps=3)
        print(f"[t1] {key} reps {reps} grid {grid}: kernel {case['ms']:.3f} ms "
              f"({case['gelem_s']:.1f} Gelem/s), bound {case['bound_ms']:.3f} ms "
              f"({case['bound_by']}: {case['bound_pipe']}; the kernel at "
              f"{case['bound_ms'] / case['ms']:.2f} of it), plain {case['plain_ms']:.3f} ms")
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
    card), the host seconds of every validate() call, and the time between
    two CUDA events of each eval step inside it."""

    def __init__(self, counters):
        self.counters = counters
        self.steps, self.events, self.validate_s, self.eval_events = [], [], [], []
        self.before = None

    def __enter__(self):
        import torch

        from gaot3d_tpu_torch.train import trainer as trainer_module

        step, validate = trainer_module.train_step, trainer_module.StaticTrainer3D.validate
        eval_step = trainer_module.StaticTrainer3D.eval_step

        def spy_step(model, optimizer, batch, generator=None, neural_field=None):
            if self.before is None:
                self.before = [p.detach().clone() for p in model.parameters()]
            was = {n: fn.launches for n, fn in self.counters.items()}
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = step(model, optimizer, batch, generator, neural_field)
            end.record()
            self.events.append((start, end))
            # K5 launches once a section; uniform slots, passed in or built
            # in the forward, are one section (of the sampled input nodes by
            # neural field)
            slots = batch.enc_slots
            if isinstance(slots, list):  # one structure a scale: count the first scale's
                slots = slots[0]
            if hasattr(slots, "sections"):
                sizes = [int(sec.lat_idx.shape[1]) for sec in slots.sections]
            elif slots is not None:
                sizes = [int(slots.lat_idx.shape[1])]
            else:
                n = int(batch.pos.shape[1])
                sizes = [min(n, neural_field.input_nodes) if neural_field else n]
            self.steps.append({**{n: fn.launches - was[n] for n, fn in self.counters.items()},
                               "sections": len(sizes),
                               "kernel_dtype": model.magno_config.kernel_dtype})
            return out

        def spy_eval(trainer, batch, *args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = eval_step(trainer, batch, *args, **kwargs)
            end.record()
            self.eval_events.append((start, end))
            return out

        def spy_validate(trainer, loader):
            first = len(self.eval_events)
            t0 = time.perf_counter()
            out = validate(trainer, loader)
            self.validate_s.append((time.perf_counter() - t0, len(loader.dataset),
                                    self.eval_events[first:]))
            return out

        self.patches = [mock.patch.object(trainer_module, "train_step", spy_step),
                        mock.patch.object(trainer_module.StaticTrainer3D, "validate",
                                          spy_validate),
                        mock.patch.object(trainer_module.StaticTrainer3D, "eval_step",
                                          spy_eval)]
        for patch in self.patches:
            patch.start()
        return self

    def __exit__(self, *exc):
        for patch in self.patches:
            patch.stop()

    def step_ms(self):
        """Device ms of every step but the first (which warms up)."""
        return [a.elapsed_time(b) for a, b in self.events[1:]]


class Bf16Launches:
    """The launches of a K5 / K5b wrapper's bf16 body (its `launches_bf16`),
    read and reset as `launches`, beside the wrapper's own count of all."""

    def __init__(self, fn):
        self.fn = fn

    @property
    def launches(self):
        return self.fn.launches_bf16

    @launches.setter
    def launches(self, n):
        self.fn.launches_bf16 = n


def attention_counters():
    from gaot3d_tpu_torch.kernels import encoder_payload as k5
    from gaot3d_tpu_torch.kernels import flash_attention as k1

    return {"k1": k1.flash_attention, "k2": k1.flash_attention_backward,
            "k3_dq": k1.flash_attention_backward_dq, "k3_dkv": k1.flash_attention_backward_dkv,
            "k5": k5.encoder_accumulate, "k5b": k5.encoder_accumulate_backward,
            "k5_bf16": Bf16Launches(k5.encoder_accumulate),
            "k5b_bf16": Bf16Launches(k5.encoder_accumulate_backward)}


def payload_launches(sections, kernel_dtype):
    """K5's and K5b's launches of one step with `sections` sections: each
    once a section, through the body for `kernel_dtype` (the bf16 K5b keeps
    a dW slice for each node chunk in its one launch)."""
    bf16 = kernel_dtype == "bfloat16"
    return {"k5": sections, "k5b": sections, "k5_bf16": sections if bf16 else 0,
            "k5b_bf16": sections if bf16 else 0}


def check_steps(label, spy, expect_per_step):
    """Every recorded step launched what `expect_per_step` says, and K5 and
    K5b what the step's sections give (`payload_launches`)."""
    for i, step in enumerate(spy.steps):
        want = {**expect_per_step,
                **payload_launches(step["sections"], step["kernel_dtype"])}
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
    dtypes = sorted({s["kernel_dtype"] for s in spy.steps})
    if dtypes != ["bfloat16"]:
        raise RuntimeError(f"[trainer] kernel_dtype {dtypes}, the recipe's is bfloat16")

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
    val_s, val_n, _ = spy.validate_s[-1]
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
    print(f"[trainer] kernel_dtype {dtypes[0]}; launches a step: K1 10, K2 10, K3 0, K5's and "
          f"K5b's bf16 bodies one a section (sections a batch: {sections}); in all {total}")
    return total, float(np.median(ms)), trainer


def phase_export(card, trainer):
    """[export] (run after [trainer], on its checkpoint): the port's export
    tool writes a serving artifact that builds its slots on the card, which
    `load_inference` serves; then the checkpoint goes out to the reference's
    layout and back in."""
    import torch

    from gaot3d_tpu_torch.kernels import encoder_payload as k5
    from gaot3d_tpu_torch.kernels import flash_attention as k1
    from gaot3d_tpu_torch.serve import load_inference
    from gaot3d_tpu_torch.tools import export_model, export_torch_ckpt, import_torch_ckpt
    from gaot3d_tpu_torch.train.checkpoint import load_params_only

    ckpt = trainer.path_config.ckpt_path
    cin, cout = trainer.num_input_channels, trainer.num_output_channels
    out_dir = os.path.join(TRAINER_DIR, "export")
    os.makedirs(out_dir, exist_ok=True)
    artifact = os.path.join(out_dir, "h100_500k_serve.pt")
    t0 = time.perf_counter()
    export_model.main(["--config", TRAINER_CONFIG, "--ckpt", ckpt, "--output", artifact,
                       "--nodes", str(N_POINTS), "--in-channels", str(cin),
                       "--out-channels", str(cout)])
    t_export = time.perf_counter() - t0
    infer = load_inference(artifact)

    rng = np.random.default_rng(41)
    pos = torch.from_numpy(rng.uniform(-1, 1, (1, N_POINTS, 3)).astype(np.float32)).cuda()
    feats = torch.from_numpy(rng.standard_normal((1, N_POINTS, cin), dtype=np.float32)).cuda()
    mask = torch.ones((1, N_POINTS), dtype=torch.bool, device="cuda")
    fwd, acc = k1.flash_attention, k5.encoder_accumulate
    fwd.launches = acc.launches = acc.launches_bf16 = 0
    t0 = time.perf_counter()
    out = infer(pos, feats, mask)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"k1": fwd.launches, "k5": acc.launches, "k5_bf16": acc.launches_bf16}
    with torch.inference_mode():
        want, again = (trainer.model.eval()(pos, feats, mask) for _ in range(2))
    rel, own = rel_l2(out, want), rel_l2(again, want)
    ok = tuple(out.shape) == (1, N_POINTS, cout) and bool(torch.isfinite(out).all())
    print(f"[export] {card}: export_model on the trainer's checkpoint in {t_export:.1f} s "
          f"({os.path.getsize(artifact)} bytes), served by load_inference (its stored mode "
          f"'device'): a request of {N_POINTS} points in {1e3 * wall:.1f} ms (first, kernels "
          f"built), out {tuple(out.shape)} finite={ok}, against the trainer's model's eval "
          f"forward relative L2 {rel:.3e} (that forward against itself {own:.3e}); K1 "
          f"launches {launches['k1']}, launches of K5's bf16 body {launches['k5_bf16']}")
    if not ok or not rel <= RERUN_BOUND or launches != {"k1": 10, "k5": 1, "k5_bf16": 1}:
        raise RuntimeError(f"[export] bad output, relative L2 {rel} or launches {launches}")

    reference, back = (os.path.join(out_dir, f) for f in ("reference.pt", "back.pt"))
    export_torch_ckpt.main(["--config", TRAINER_CONFIG, "--ckpt", ckpt, "--output", reference])
    import_torch_ckpt.main(["--config", TRAINER_CONFIG, "--torch-ckpt", reference,
                            "--output", back])
    a, b = load_params_only(ckpt), load_params_only(back)
    same = list(a) == list(b) and all(torch.equal(a[k].cpu(), b[k]) for k in a)
    print(f"[export] the checkpoint to the reference's layout and back: {len(a)} tensors, the "
          f"same bits {same}")
    if not same:
        raise RuntimeError("[export] export_torch_ckpt -> import_torch_ckpt changed the weights")
    return launches


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


def phase_trainer_nf(card):
    """[trainer-nf]: the recipe's config through the CLI's entry point,
    trained by neural field with the slots built on the card."""
    import torch

    from gaot3d_tpu_torch import cli

    root = TRAINER_DIR
    overrides = trainer_overrides(root, epoch=2)
    overrides["dataset"].update(training_strategy="neural_field",
                                neural_field_input_nodes=NF_NODES,
                                neural_field_query_nodes_train=NF_NODES,
                                update_pt_files_with_edges=False)
    overrides["model"] = {"args": {"magno": {"edge_layout": "slots"}}}
    out = overrides["path"] = {k: v.replace(os.sep + "out" + os.sep, os.sep + "out_nf" + os.sep)
                               for k, v in overrides["path"].items()}
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
    if trainer.slot_mode != "device" or trainer.model_config.args.magno.precompute_edges:
        raise RuntimeError(f"[trainer-nf] slot mode {trainer.slot_mode}, precompute_edges "
                           f"{trainer.model_config.args.magno.precompute_edges}")
    args = trainer.optimizer_config.args
    steps_per_epoch = len(trainer.train_loader)
    if len(spy.steps) != args.epoch * steps_per_epoch:
        raise RuntimeError(f"[trainer-nf] {len(spy.steps)} steps, expected "
                           f"{args.epoch} x {steps_per_epoch}")
    check_steps("[trainer-nf]", spy, {"k1": 10, "k2": 10, "k3_dq": 0, "k3_dkv": 0})
    losses = np.load(out["loss_path"].rsplit(".", 1)[0] + ".npz")
    if not (np.isfinite(losses["train_loss"]).all() and np.isfinite(losses["val_loss"]).all()) \
            or len(spy.validate_s) != 1:
        raise RuntimeError("[trainer-nf] non-finite loss or no validation")
    still = [n for (n, p), b in zip(trainer.model.named_parameters(), spy.before)
             if torch.equal(p, b)]
    if still:
        raise RuntimeError(f"[trainer-nf] parameters that did not move: {still}")
    pred = np.load(out["result_path"].rsplit(".", 1)[0] + ".npz")["prd"]
    n_nodes = trainer.dataset_config.synthetic_num_nodes
    if pred.shape != (n_nodes, 1) or not np.isfinite(pred).all():
        raise RuntimeError(f"[trainer-nf] result npz: prediction {pred.shape} or non-finite")
    stats = trainer.last_loader_stats
    val_s, val_n, val_events = spy.validate_s[-1]
    val_eval = [a.elapsed_time(b) for a, b in val_events]
    ms = spy.step_ms()
    print(f"[trainer-nf] {card}: {args.epoch} epochs of {steps_per_epoch} steps by neural field "
          f"({NF_NODES} input and query nodes of {n_nodes}), slots built on the card, in "
          f"{wall:.1f} s; train loss {losses['train_loss'].tolist()}, val loss "
          f"{losses['val_loss'].tolist()}; MSE (x10^-2) {float(row['MSE (x10^-2)']):.4f}")
    print(f"[trainer-nf] {card}: step device time median {np.median(ms):.1f} ms (min "
          f"{min(ms):.1f}, max {max(ms):.1f}); last epoch: wall "
          f"{1e3 * stats['epoch_wall_s'] / stats['steps']:.1f} ms a step, loader stall "
          f"{trainer.last_loader_stall_s:.3f} s (first wait "
          f"{trainer.last_loader_first_wait_s:.3f} s), host_load_s "
          f"{stats.get('host_load_s', 0.0):.3f}, put_s {stats.get('put_s', 0.0):.3f} for "
          f"{stats['steps']} batches; validate {1e3 * val_s / val_n:.1f} ms a sample and test "
          f"inference {1e3 * float(row['inference time']):.1f} ms a sample, full grid with "
          f"the slot build; peak memory {peak:.2f} GiB")
    print(f"[trainer-nf] {card}: validate of {val_n} samples {1e3 * val_s:.1f} ms on the host "
          f"clock: eval steps {[round(t, 1) for t in val_eval]} ms between events (each "
          f"forward with its slot build), the rest {1e3 * val_s - sum(val_eval):.1f} ms (the "
          f"prefetch thread's load and upload of the first sample, and the waits)")
    print(f"[trainer-nf] launches a step: K1 10, K2 10, K3 0, K5 1, K5b 1 (their bf16 bodies; "
          f"{NF_NODES} nodes are one chunk); in all {total}")
    return total


# -- the MAGNO variants ---------------------------------------------------------------

# (label, MAGNOConfig overrides of the recipe over uniform slots built on the card);
# "budget2" is replaced by the max degree at twice the radius
VARIANTS = (
    ("a unfused sort", dict(fused_encoder=False, fused_decoder=False, segment_impl="sort")),
    ("a unfused scatter", dict(fused_encoder=False, fused_decoder=False,
                               segment_impl="scatter")),
    # at float32: these kernel MLPs take the latent features, whose bf16 rounding flips
    # where K1 and its plain version differ in the last bits (2.1e-3 relative L2 apart)
    ("b nonlinear cosine", dict(in_gno_transform_type="nonlinear",
                                out_gno_transform_type="nonlinear_kernelonly", use_attn=True,
                                attention_type="cosine", kernel_dtype="float32")),
    ("c dot product", dict(use_attn=True, attention_type="dot_product")),
    ("d pointnet max", dict(embedding_method="pointnet", use_geoembed=[True, True],
                            pooling="max")),
    ("d pointnet mean", dict(embedding_method="pointnet", use_geoembed=[True, True],
                             pooling="mean")),
    ("e decoder geoembed", dict(use_geoembed=[True, True])),
    ("f multiscale", dict(scales=[1.0, 2.0], use_scale_weights=True, slot_budget="budget2")),
    ("g ratio", dict(sampling_strategy="ratio", sample_ratio=0.5)),
    ("g max_neighbors", dict(sampling_strategy="max_neighbors", max_neighbors=3)),
    ("g radius cap", dict(max_radius_neighbors=4)),
    ("h no gno", dict(use_gno=False)),
)


def variant_counters():
    from gaot3d_tpu_torch.kernels import prefix_sum as k7

    return {**attention_counters(), "k7": k7.prefix_sum}


def variant_expect(over, step):
    """The launches of one eval forward (step False) or one train step of a
    variant of the recipe over uniform slots: K1 once a layer (K2 too in a
    step); K5 once a scale where the fused encoder runs a linear GNO under
    'scatter', K5b in a step once a scale too; K7 only under 'sort' (checked
    apart: at least once)."""
    scales = len(over.get("scales", [1.0]))
    fused = (over.get("fused_encoder", True) and not over.get("use_attn")
             and over.get("embedding_method", "statistical") == "statistical")
    k5 = scales if (fused and over.get("use_gno", True)
                    and over.get("in_gno_transform_type", "linear") == "linear"
                    and over.get("segment_impl", "scatter") == "scatter") else 0
    payload = payload_launches(k5, over.get("kernel_dtype", "bfloat16"))
    if not step:
        payload.update(k5b=0, k5b_bf16=0)
    return {"k1": 10, "k2": 10 if step else 0, "k3_dq": 0, "k3_dkv": 0, **payload}


def phase_variants(card):
    """[variants]: each MAGNO variant of the recipe on one 524,288-point cloud,
    its slots built on the card: an eval forward against the plain versions,
    one train step, their times, peaks and launches."""
    import torch

    from gaot3d_tpu_torch.ops.grid_graph import LatentGrid, build_edge_slots, max_slot_degree
    from gaot3d_tpu_torch.train import OptimizerargsConfig, TrainBatch, make_optimizer
    from gaot3d_tpu_torch.train import train_step

    grid = LatentGrid(dims=LATENT)
    pos, feats, target, mask, *_ = cloud(81, N_POINTS)
    degrees = [max_slot_degree(build_edge_slots(pos[0], grid, s * RADIUS, 1, "bidirectional"))
               for s in (1.0, 2.0)]
    budget2 = degrees[1]
    print(f"[variants] {card}: one cloud of {N_POINTS} points; max degree {degrees[0]} at the "
          f"radius, {budget2} at twice it: the slot budget of (f), the one the trainer's "
          f"budget check asks for at scale 2.0")
    counters = variant_counters()
    batch = TrainBatch(pos, feats, target, mask, None, None)
    totals = {"k1_eval": 0, "k1": 0, "k2": 0, "k5": 0, "k5_bf16": 0, "k5b": 0, "k5b_bf16": 0,
              "k7": 0}
    rows = []
    for label, over in VARIANTS:
        over = {k: (budget2 if v == "budget2" else v) for k, v in over.items()}
        tag = f"variants {label}"
        model = recipe_model(edge_layout="slots", **over)
        for fn in counters.values():
            fn.launches = 0
        model.eval()
        with torch.no_grad():
            out = model(pos, feats, mask)
            torch.cuda.synchronize()
            fwd = {n: fn.launches for n, fn in counters.items()}
            torch.cuda.reset_peak_memory_stats()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            again = model(pos, feats, mask)
            end.record()
            end.synchronize()
        fwd_ms = start.elapsed_time(end)
        fwd_peak = torch.cuda.max_memory_allocated() / 2 ** 20
        ok = (tuple(out.shape) == (1, N_POINTS, 1) and bool(torch.isfinite(out).all())
              and bool(torch.isfinite(again).all()))
        want = variant_expect(over, step=False)
        got = {n: fwd[n] for n in want}
        print(f"[{tag}] {card}: eval forward {fwd_ms:.1f} ms (CUDA events, warm), peak "
              f"{fwd_peak:.1f} MiB; out {tuple(out.shape)} finite={ok}; launches {got}, "
              f"K7 {fwd['k7']}")
        if not ok:
            raise RuntimeError(f"[{tag}] bad output")
        if got != want or (fwd["k7"] > 0) != (over.get("segment_impl") == "sort"):
            raise RuntimeError(f"[{tag}] forward launches {got}, K7 {fwd['k7']}, expected "
                               f"{want}, and K7 only under 'sort'")
        against_plain(tag, f"the eval forward on {N_POINTS} points",
                      lambda: (model(pos, feats, mask),), (out,))
        del out, again

        # one train step: AdamW, dropout, edge sampling from a generator on the card
        optimizer = make_optimizer("adamw", model.parameters(),
                                   OptimizerargsConfig(scheduler="mix"), steps_per_epoch=1)
        before = [p.detach().clone() for p in model.parameters()]
        generator = torch.Generator(device="cuda").manual_seed(5)
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        loss, grad_norm = train_step(model, optimizer, batch, generator)
        end.record()
        end.synchronize()
        step_ms = start.elapsed_time(end)
        step_peak = torch.cuda.max_memory_allocated() / 2 ** 20
        step = {n: fn.launches for n, fn in counters.items()}
        finite = bool(torch.isfinite(loss)) and all(
            p.grad is not None and bool(torch.isfinite(p.grad).all())
            for p in model.parameters())
        still = [n for (n, p), b in zip(model.named_parameters(), before) if torch.equal(p, b)]
        want = variant_expect(over, step=True)
        got = {n: step[n] for n in want}
        print(f"[{tag}] {card}: train step {step_ms:.1f} ms (CUDA events, the first), peak "
              f"{step_peak:.1f} MiB; loss {loss.item():.6f} grad_norm {grad_norm.item():.6f}; "
              f"finite={finite}, parameters not moved {still}; launches {got}, K7 "
              f"{step['k7']}")
        if not finite or still:
            raise RuntimeError(f"[{tag}] step: non-finite loss or gradient, or unmoved "
                               f"parameters {still}")
        if got != want or (step["k7"] > 0) != (over.get("segment_impl") == "sort"):
            raise RuntimeError(f"[{tag}] step launches {got}, K7 {step['k7']}, expected {want}")
        for name in ("k5", "k5_bf16", "k7"):
            totals[name] += fwd[name] + step[name]
        for name in ("k2", "k5b", "k5b_bf16"):
            totals[name] += step[name]
        totals["k1_eval"] += fwd["k1"]
        totals["k1"] += step["k1"]
        rows.append((label, fwd_ms, step_ms, fwd_peak, step_peak))
        del model, optimizer, before, loss
        torch.cuda.empty_cache()
    print(f"[variants] {card}: label, eval forward ms, train step ms, peak MiB forward, step")
    for label, f_ms, s_ms, f_mib, s_mib in rows:
        print(f"[variants]   {label:20s} {f_ms:9.1f} {s_ms:9.1f} {f_mib:10.1f} {s_mib:10.1f}")
    return totals, budget2


VARIANT_TRAINER = dict(  # (f), (d) and (b) combined, with 'ratio' sampling
    scales=[1.0, 2.0], use_scale_weights=True, embedding_method="pointnet",
    use_geoembed=[True, True], pooling="max", in_gno_transform_type="nonlinear",
    out_gno_transform_type="nonlinear_kernelonly", use_attn=True, attention_type="cosine",
    sampling_strategy="ratio", sample_ratio=0.5, edge_layout="slots",
    asynchronous_graph_building=True)


def phase_trainer_variants(card, budget2):
    """[trainer-variants]: the recipe's config through the CLI's entry point
    with VARIANT_TRAINER, host-built multiscale slots through the loader, one
    epoch of 2 samples, 1 validation and 1 test sample."""
    import torch

    from gaot3d_tpu_torch import cli

    root = TRAINER_DIR
    overrides = trainer_overrides(root, epoch=1, eval_every_eps=1)
    overrides["dataset"].update(train_size=2, val_size=1, test_size=1,
                                update_pt_files_with_edges=False)
    out = overrides["path"] = {
        k: v.replace(os.sep + "out" + os.sep, os.sep + "out_variants" + os.sep)
        for k, v in overrides["path"].items()}
    counters = variant_counters()

    def run(budget):
        overrides["model"] = {"args": {"magno": {**VARIANT_TRAINER, "slot_budget": budget}}}
        for fn in counters.values():
            fn.launches = 0
        return cli.run_config_file(TRAINER_CONFIG, overrides, return_trainer=True)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with TrainerSpy(counters) as spy:
        try:
            row, trainer = run(budget2)
        except ValueError as err:  # the budget check on the set's test sample 0
            need = re.search(r"Raise slot_budget to at least (\d+)", str(err))
            if need is None:
                raise
            print(f"[trainer-variants] the trainer's budget check asks for {need.group(1)} "
                  f"(the cloud of [variants] gave {budget2})")
            budget2 = int(need.group(1))
            row, trainer = run(budget2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    total = {n: fn.launches for n, fn in counters.items()}
    if trainer.slot_mode != "async":
        raise RuntimeError(f"[trainer-variants] slot mode {trainer.slot_mode}, expected async")
    if len(spy.steps) != 2:
        raise RuntimeError(f"[trainer-variants] {len(spy.steps)} steps, expected 2")
    for i, step in enumerate(spy.steps):
        got = {n: step[n] for n in ("k1", "k2", "k5", "k5b")}
        if got != {"k1": 10, "k2": 10, "k5": 0, "k5b": 0}:
            raise RuntimeError(f"[trainer-variants] step {i}: launches {got}")
    losses = np.load(out["loss_path"].rsplit(".", 1)[0] + ".npz")
    if not (np.isfinite(losses["train_loss"]).all() and np.isfinite(losses["val_loss"]).all()):
        raise RuntimeError("[trainer-variants] non-finite loss")
    still = [n for (n, p), b in zip(trainer.model.named_parameters(), spy.before)
             if torch.equal(p, b)]
    if still:
        raise RuntimeError(f"[trainer-variants] parameters that did not move: {still}")
    pred = np.load(out["result_path"].rsplit(".", 1)[0] + ".npz")["prd"]
    if not np.isfinite(pred).all():
        raise RuntimeError("[trainer-variants] non-finite prediction")
    stats = trainer.last_loader_stats
    ms = [a.elapsed_time(b) for a, b in spy.events]
    print(f"[trainer-variants] {card}: slot budget {budget2}; 1 epoch of 2 steps, validation "
          f"and test of 1 sample each, host-built slots of 2 scales through the loader, in "
          f"{wall:.1f} s; train loss {losses['train_loss'].tolist()}, val loss "
          f"{losses['val_loss'].tolist()}, MSE (x10^-2) {float(row['MSE (x10^-2)']):.4f}")
    print(f"[trainer-variants] {card}: steps {[round(t, 1) for t in ms]} ms (CUDA events); "
          f"epoch wall {1e3 * stats['epoch_wall_s'] / stats['steps']:.1f} ms a step, loader "
          f"stall {trainer.last_loader_stall_s:.3f} s (first wait "
          f"{trainer.last_loader_first_wait_s:.3f} s), host_load_s "
          f"{stats.get('host_load_s', 0.0):.3f}; peak memory {peak:.2f} GiB; launches in all "
          f"{total}")
    del trainer
    return total


# -- the processor's variants ------------------------------------------------------------

# (tag, recipe_model keywords, the condition c): rope3d alone, then rope3d with a
# ConditionedNorm in every block's attention and FFN
PROCESSOR_VARIANTS = (
    ("rope3d", dict(positional_embedding="rope3d"), None),
    ("cond", dict(positional_embedding="rope3d", conditional_norm=True), 0.7),
)


def cond_norm_moves(model, before):
    """The largest relative change of each ConditionedNorm map's weight."""
    import torch

    out = []
    for (name, p), b in zip(model.named_parameters(), before):
        if ".cond_norm." in name and name.endswith("weight"):
            out.append(((p - b).norm() / b.norm()).item())
    return out


def phase_processor_variants(card):
    """[rope3d] and [cond]: the recipe at full width (524,288 points in 5
    degree sections, a 64x64x32 grid, 10 blocks of 8 heads, bf16), with
    rope3d, then with ConditionedNorm in attention and FFN under c =
    [[0.7]]: an eval forward (K1 10) against the plain versions to E2E_BOUND
    relative L2 and timed warm, two AdamW steps (K1 10, K2 10, K5 a section,
    K5b a section; every parameter moves, each ConditionedNorm map
    printed); then two steps of the same model on a 32x32x16 grid with 65,536
    points, with the kernels and with their plain versions from the same
    weights and seeds: each step's loss to E2E_BOUND relative, the second
    step's gradient to E2E_BOUND relative L2."""
    import torch

    from gaot3d_tpu_torch.ops.grid_graph import LatentGrid
    from gaot3d_tpu_torch.train import (OptimizerargsConfig, TrainBatch, make_optimizer,
                                        train_step)

    grid = LatentGrid(dims=LATENT)
    pos, feats, target, mask, slots, nsec, _ = cloud(41, N_POINTS, grid)
    small = LatentGrid(dims=(32, 32, 16))
    radius = 2 * RADIUS
    budget = max_degree(np.random.default_rng(42).uniform(-1, 1, (65_536, 3)).astype(np.float32),
                        small, radius)
    spos, sfeats, starget, smask, sslots, snsec, _ = cloud(42, 65_536, small, radius, budget)
    counters = attention_counters()
    totals = {}
    for tag, kw, c in PROCESSOR_VARIANTS:
        cond = None if c is None else torch.tensor([[c]], device="cuda")
        model = recipe_model(**kw).eval()
        for fn in counters.values():
            fn.launches = 0

        def forward():
            with torch.no_grad():
                return model(pos, feats, mask, encoder_slots=[slots], decoder_slots=[slots],
                             condition=cond)
        out = forward()
        torch.cuda.synchronize()
        k1_eval = counters["k1"].launches
        ms = cuda_ms(forward, reps=3)
        if k1_eval != 10 or not torch.isfinite(out).all():
            raise RuntimeError(f"[{tag}] eval forward: K1 launches {k1_eval}, or non-finite")
        print(f"[{tag}] {card}: eval forward, {nsec} sections: {ms:.1f} ms warm (CUDA events, "
              f"median of 3), K1 launches {k1_eval}; out finite {tuple(out.shape)}")
        against_plain(tag, "the eval forward", lambda: (forward(),), (out,))
        before = [p.detach().clone() for p in model.parameters()]
        batch = TrainBatch(pos, feats, target, mask, slots, slots, condition=cond)
        total, _, _ = train_steps(tag, card, model, batch,
                                  {"k1": 10, "k2": 10,
                                   **payload_launches(nsec, "bfloat16")})
        moves = cond_norm_moves(model, before)
        if moves:
            print(f"[{tag}] each of the {len(moves)} ConditionedNorm weights moved by "
                  f"{min(moves):.3e} to {max(moves):.3e} of its norm in 2 steps")
        totals[tag] = {"k1_eval": k1_eval, **total}
        del model, batch, out

        # two steps against the plain versions on the small grid
        sbatch = TrainBatch(spos, sfeats, starget, smask, sslots, sslots, condition=cond)

        def two_steps():
            m = recipe_model(small.dims, radius, budget, **kw)
            opt = make_optimizer("adamw", m.parameters(), OptimizerargsConfig(scheduler="mix"),
                                 steps_per_epoch=1)
            gen = torch.Generator().manual_seed(9)
            losses = [train_step(m, opt, sbatch, gen)[0].item() for _ in range(2)]
            return (grad_vector(m), *losses)
        against_plain(tag, f"two steps on a 32x32x16 grid, 65,536 points, {snsec} sections "
                      f"(budget {budget}), rate {RATE}: the second step's gradient",
                      two_steps, two_steps())
        torch.cuda.empty_cache()
    return totals


# -- distribution ------------------------------------------------------------------------

DIST_POINTS = 2 * N_POINTS  # node_shards 2 times pressure.yaml's pad_multiple, 524,288
DIST_LOSS_BOUND = 1e-4  # relative: the sharded run's losses against one process's (K5's
#                         float atomics and the all-reduce add in other orders)
DIST_BOUND = 1e-3  # relative L2: gradients and eval outputs, sharded against one process
DIST_TIMEOUT = 600  # seconds the two ranks of one [dist] run may take


def dist_model():
    """The model of configs/examples/drivaerml/pressure.yaml (its model
    section) at full width: the recipe with slot budget 8 and slots built on
    the card, kernel_dtype float32 (the file sets none), weights from seed
    0."""
    return recipe_model(budget=8, kernel_dtype="float32", edge_layout="slots")


def dist_batch(mode):
    """The global batch of a [dist] run: 'node', one synthetic cloud of
    DIST_POINTS; 'data', two clouds of N_POINTS. No edges: the model builds
    each rank's slots on the card."""
    import torch

    from gaot3d_tpu_torch.train import TrainBatch

    seeds = [(51, DIST_POINTS)] if mode == "node" else [(52, N_POINTS), (53, N_POINTS)]
    parts = [cloud(seed, n)[:4] for seed, n in seeds]
    return TrainBatch(*(torch.cat([p[i] for p in parts]) for i in range(4)), None, None)


def dist_run(tag, batch, mesh=None, shard_nodes=False):
    """Two AdamW steps (mix schedule, dropout from one generator) then an
    eval of dist_model() on `batch`, in one process or sharded over `mesh`:
    per step the global loss and ms by CUDA events, the launches, the
    gradient after step 2, the eval output (gathered over the ranks) and
    the peak MiB."""
    import torch

    from gaot3d_tpu_torch.parallel import make_sharded_eval_step, make_sharded_train_step
    from gaot3d_tpu_torch.train import (OptimizerargsConfig, eval_step, make_optimizer,
                                        train_step)

    model = dist_model()
    counters = attention_counters()
    for fn in counters.values():
        fn.launches = 0
    optimizer = make_optimizer("adamw", model.parameters(), OptimizerargsConfig(scheduler="mix"),
                               steps_per_epoch=1)
    generator = torch.Generator().manual_seed(5)
    step = train_step if mesh is None else make_sharded_train_step(train_step, mesh, shard_nodes)
    evaluate = eval_step if mesh is None else make_sharded_eval_step(
        eval_step, mesh, shard_nodes, replicate_outputs=True)
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(2):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        loss, _ = step(model, optimizer, batch, generator)
        end.record()
        end.synchronize()
        losses.append(loss.item())
        ms.append(start.elapsed_time(end))
    grads = grad_vector(model)
    pred, val = evaluate(model, batch)
    torch.cuda.synchronize()
    finite = all(np.isfinite(losses)) and bool(torch.isfinite(grads).all()) \
        and bool(torch.isfinite(pred).all())
    if not finite:
        raise RuntimeError(f"[dist] {tag}: non-finite loss, gradient or output")
    return {"losses": np.asarray(losses), "ms": np.asarray(ms), "grads": grads,
            "pred": pred, "eval_loss": val.item(),
            "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
            "launches": {n: fn.launches for n, fn in counters.items()}}


def dist_worker(mode, rank, port, out_path):
    """One of the two ranks of a [dist] run on the one card, over gloo (NCCL
    refuses two ranks on one device): `mode` 'node' (node_shards 2) or
    'data' (data_parallel 2). Prints its step ms, the all-reduces' ms and
    its peak; rank 0 writes its losses, gradient and gathered output."""
    import torch
    import torch.distributed as dist

    from gaot3d_tpu_torch.parallel import make_mesh
    from gaot3d_tpu_torch.parallel.sharding import all_reduce_gradients, all_reduce_sum

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2)
    mesh = make_mesh(1, 2) if mode == "node" else make_mesh(2, 1)
    sums = all_reduce_sum.calls
    res = dist_run(mode, dist_batch(mode), mesh, mode == "node")
    # the collectives of a step alone: the encoder's accumulator [1, 131,072, 43] (node) and
    # the gradient, each on the host clock until the card is done (gloo stages CUDA tensors
    # through the host), median of 3
    acc = torch.ones((1, 64 * 64 * 32, 43), device="cuda")
    flat = torch.ones(res["grads"].numel(), device="cuda")

    def host_ms(fn):
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times[1:]))
    acc_ms = host_ms(lambda: dist.all_reduce(acc))
    grad_ms = host_ms(lambda: dist.all_reduce(flat))
    print(f"[dist] {mode} rank {rank}: steps {res['ms'].round(1).tolist()} ms (CUDA events), "
          f"losses {res['losses'].tolist()}; all-reduce over gloo on the host clock: the "
          f"accumulator "
          f"{acc_ms:.2f} ms, the gradient ({flat.numel()} floats) {grad_ms:.2f} ms; "
          f"{all_reduce_sum.calls - sums} accumulator sums, {all_reduce_gradients.calls} "
          f"gradient all-reduces; peak {res['peak_mib']:.0f} MiB; launches {res['launches']}",
          flush=True)
    if rank == 0:
        np.savez(out_path, losses=res["losses"], ms=res["ms"], grads=res["grads"].cpu().numpy(),
                 pred=res["pred"].cpu().numpy(), eval_loss=res["eval_loss"],
                 peak_mib=res["peak_mib"], acc_ms=acc_ms, grad_ms=grad_ms,
                 **{f"launch_{n}": v for n, v in res["launches"].items()})
    dist.destroy_process_group()


def spawn_ranks(mode, tmp):
    """Run the two ranks of a [dist] run as processes of this script; raise
    with their output unless both end with 0. Every process is ended."""
    port = _free_port()
    out = os.path.join(tmp, f"dist_{mode}.npz")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    logs = [open(os.path.join(tmp, f"dist_{mode}_{r}.log"), "w+") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dist-worker",
                               mode, str(r), str(port), out], cwd=HERE, env=env,
                              stdout=log, stderr=subprocess.STDOUT, text=True)
             for r, log in enumerate(logs)]
    deadline = time.monotonic() + DIST_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    for text in outs:
        for line in text.splitlines():
            if line.startswith("[dist]"):
                print(line)
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError(f"[dist] {mode}: a rank failed:\n" + "\n".join(o[-4000:] for o in outs))
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class LossSpy:
    """Context that records the loss of every train step the trainer takes."""

    def __enter__(self):
        from gaot3d_tpu_torch.train import trainer as trainer_module

        step = trainer_module.train_step
        self.losses = []

        def spy(*args, **kwargs):
            out = step(*args, **kwargs)
            self.losses.append(out[0].item())
            return out
        self.patch = mock.patch.object(trainer_module, "train_step", spy)
        self.patch.start()
        return self

    def __exit__(self, *exc):
        self.patch.stop()


def phase_dist(card):
    """[dist]: (a) the trainer with `distributed: true` in one process over
    NCCL (a group of one) on [trainer]'s data, two steps, against the
    undistributed trainer; (b) node_shards 2 and (c) data_parallel 2, two
    processes on the one card over gloo, against one process on the same
    global batch. Returns the launches of (b) and (c)'s rank 0 and of (a)."""
    import torch
    import torch.distributed as dist

    from gaot3d_tpu_torch import cli

    # (a)
    root = TRAINER_DIR
    counters = attention_counters()
    for fn in counters.values():
        fn.launches = 0
    runs = {}
    for label, setup in (("undistributed", {}), ("distributed", {"distributed": True})):
        overrides = trainer_overrides(root, epoch=1, eval_every_eps=1)
        overrides["dataset"].update(train_size=2, val_size=2, test_size=2)
        overrides["setup"] = {"test": False, **setup}
        overrides["path"] = {k: v.replace(os.sep + "out" + os.sep, os.sep + f"out_{label}" + os.sep)
                             for k, v in overrides["path"].items()}
        with LossSpy() as spy:
            row, trainer = cli.run_config_file(TRAINER_CONFIG, overrides, return_trainer=True)
        backend = dist.get_backend() if dist.is_initialized() else None
        world = dist.get_world_size() if dist.is_initialized() else None
        if label == "distributed":
            if trainer.mesh is None or backend != "nccl" or world != 1:
                raise RuntimeError(f"[dist] (a): mesh {trainer.mesh}, backend {backend}, world "
                                   f"{world}")
            dist.destroy_process_group()
        runs[label] = spy.losses
        del trainer
        torch.cuda.empty_cache()
    a, b = np.asarray(runs["distributed"]), np.asarray(runs["undistributed"])
    rel = np.abs(a - b) / np.abs(b)
    print(f"[dist] (a) {card}: distributed: true, world 1 over NCCL, through the trainer: step "
          f"losses {a.tolist()} against {b.tolist()} undistributed, relative {rel.max():.2e} "
          f"(limit {DIST_LOSS_BOUND})")
    if len(a) != 2 or len(b) != 2 or not (rel <= DIST_LOSS_BOUND).all():
        raise RuntimeError("[dist] (a) the distributed trainer's losses differ")
    launches = {n: fn.launches for n, fn in counters.items()}

    # (b) and (c)
    with tempfile.TemporaryDirectory() as tmp:
        for mode, what in (("node", f"node_shards 2, one cloud of {DIST_POINTS} points"),
                           ("data", f"data_parallel 2, two clouds of {N_POINTS} points")):
            ref = dist_run(mode, dist_batch(mode))
            ref = {k: (v.cpu() if hasattr(v, "cpu") else v) for k, v in ref.items()}
            torch.cuda.empty_cache()
            got = spawn_ranks(mode, tmp)
            for name in launches:
                launches[name] += int(got[f"launch_{name}"])
            loss_rel = np.abs(got["losses"] - ref["losses"]) / np.abs(ref["losses"])
            grad_rel = rel_l2(torch.from_numpy(got["grads"]), ref["grads"])
            pred_rel = rel_l2(torch.from_numpy(got["pred"]), ref["pred"])
            print(f"[dist] ({'b' if mode == 'node' else 'c'}) {card}: {what}, the "
                  f"pressure.yaml model (slot budget 8, slots built on the card), 2 ranks on "
                  f"one card over gloo against one process: losses {got['losses'].tolist()} "
                  f"against {ref['losses'].tolist()} (relative {loss_rel.max():.2e}, limit "
                  f"{DIST_LOSS_BOUND}); the second step's gradient {grad_rel:.2e} and the eval "
                  f"output {pred_rel:.2e} relative L2 (limit {DIST_BOUND}); one process: steps "
                  f"{ref['ms'].round(1).tolist()} ms, peak {ref['peak_mib']:.0f} MiB; rank 0: "
                  f"steps {got['ms'].round(1).tolist()} ms, peak {float(got['peak_mib']):.0f} "
                  f"MiB, all-reduce over gloo of the accumulator {float(got['acc_ms']):.2f} ms "
                  f"and of the gradient {float(got['grad_ms']):.2f} ms (host clock)")
            if not ((loss_rel <= DIST_LOSS_BOUND).all() and grad_rel <= DIST_BOUND
                    and pred_rel <= DIST_BOUND):
                raise RuntimeError(f"[dist] {mode}: the sharded run differs from one process")
            want = {"k1": 30, "k2": 20}  # two steps and an eval of 10 layers
            if any(int(got[f"launch_{n}"]) != v for n, v in want.items()):
                raise RuntimeError(f"[dist] {mode}: rank 0 launched "
                                   f"{ {n: int(got[f'launch_{n}']) for n in want} }")
    return launches


def body_launches(phases, name, kernel_dtype):
    """Launches of K5's or K5b's body for `kernel_dtype` over the main path's
    phases (each counts all its launches under `name` and the bf16 body's
    under `name`_bf16)."""
    bf16 = sum(p.get(f"{name}_bf16", 0) for p in phases)
    return bf16 if kernel_dtype == "bfloat16" else sum(p[name] for p in phases) - bf16


FLAT_PHASES = {"k7": phase_k7, "k6": phase_k6, "k8": phase_k8, "flat": phase_flat}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--flat-seed", type=int, default=31,
                        help="seed of the cloud of the [k6], [k7], [k8] and [flat] phases")
    parser.add_argument("--only", default="",
                        help="comma-separated subset of k1, attention-train, k3, k5, k9, k10, "
                             "serve-device, serve-buckets, nf, trainer, export (after trainer), "
                             "trainer-split, trainer-nf, variants, trainer-variants, "
                             "processor, dist (its part (a) on trainer's data), t1, k7, k6, "
                             "k8, flat: run just these "
                             "phases (kernels build at first use; the last four share one "
                             "cloud) and print no record")
    parser.add_argument("--dist-worker", nargs=4, metavar=("MODE", "RANK", "PORT", "OUT"),
                        help="run one rank of a [dist] run (the script starts them itself)")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA GPU",
              file=sys.stderr)
        return 1
    import gaot3d_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from gaot3d_tpu_torch.ops.grid_graph import LatentGrid

    if args.dist_worker:
        mode, rank, port, out = args.dist_worker
        dist_worker(mode, int(rank), int(port), out)
        return 0

    card = card_name_and_power()
    print(f"[device] {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.only:
        fused_ms = float("nan")
        flat_input = trainer = None
        budget2 = BUDGET  # [variants] finds (f)'s; the trainer's check asks for its own
        for name in args.only.split(","):
            if name in FLAT_PHASES and flat_input is None:  # one cloud for all four
                flat_input = flat_cloud(args.flat_seed, N_POINTS, LatentGrid(dims=LATENT))
            if name == "k1":
                phase_k1()
            elif name == "attention-train":
                phase_attention_train()
            elif name == "t1":
                phase_t1()
            elif name == "k5":
                from gaot3d_tpu_torch.kernels import build
                build.build_together(encoder_loaders())
                encoder_build_facts()
                phase_k5()
            elif name == "k9":
                phase_k9()
            elif name == "k10":
                phase_k10()
            elif name == "k3":
                k3_build_facts()
                phase_k3()
            elif name == "trainer":
                _, fused_ms, trainer = phase_trainer(card)
            elif name == "export":
                if trainer is None:
                    parser.error("export runs on the checkpoint of trainer: list trainer first")
                phase_export(card, trainer)
            elif name == "trainer-split":
                phase_trainer_split(card, fused_ms)
            elif name == "serve-device":
                phase_serve_device(card)
            elif name == "serve-buckets":
                phase_serve_buckets(card)
            elif name == "nf":
                phase_nf(card)
            elif name == "trainer-nf":
                phase_trainer_nf(card)
            elif name == "variants":
                _, budget2 = phase_variants(card)
            elif name == "trainer-variants":
                phase_trainer_variants(card, budget2)
            elif name == "processor":
                phase_processor_variants(card)
            elif name == "dist":
                phase_dist(card)
            elif name in FLAT_PHASES:
                FLAT_PHASES[name](flat_input)
            else:
                parser.error(f"unknown phase {name!r}")
        return 0
    phase_build()
    # first, while no phase has profiled yet: later in the process torch.profiler
    # has recorded none of these kernels' short launches
    flat_input = flat_cloud(args.flat_seed, N_POINTS, LatentGrid(dims=LATENT))
    k7, k6, k8 = phase_k7(flat_input), phase_k6(flat_input), phase_k8(flat_input)
    k1 = phase_k1()
    k5, k5b, k5_bf16, k5b_bf16 = phase_k5()
    k9 = phase_k9()
    k10, _ = phase_k10()
    serve = phase_serve()
    serve_device = phase_serve_device(card)
    serve_buckets = phase_serve_buckets(card)
    k4 = phase_k4()
    k1d, k2, replay_launches = phase_attention_train()
    k3 = phase_k3()
    train = phase_train(card, k5b_bf16["ms"])
    torch.cuda.empty_cache()
    nf = phase_nf(card)
    torch.cuda.empty_cache()
    fit, fused_ms, trainer = phase_trainer(card)
    export = phase_export(card, trainer)
    del trainer
    split = phase_trainer_split(card, fused_ms)
    fit_nf = phase_trainer_nf(card)
    torch.cuda.empty_cache()
    variants, budget2 = phase_variants(card)
    fit_variants = phase_trainer_variants(card, budget2)
    torch.cuda.empty_cache()
    proc = phase_processor_variants(card)
    torch.cuda.empty_cache()
    dist_ = phase_dist(card)  # (a) on [trainer]'s data
    shutil.rmtree(TRAINER_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    flat = phase_flat(flat_input)
    del flat_input
    t1 = phase_t1()
    pallas = "gaot3d_tpu/ops/pallas_attention.py"
    rope3d, cond = proc["rope3d"], proc["cond"]
    k5_phases = (serve, serve_device, serve_buckets, train, nf, fit, export, fit_nf, variants,
                 fit_variants, rope3d, cond, dist_)
    k5b_phases = (train, nf, fit, fit_nf, variants, fit_variants, rope3d, cond, dist_)
    kernels = [
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": "gaot3d_tpu_torch/csrc/flash_attn_fwd.cu", "replaces": f"{pallas}:394",
         # serving, and the eval forwards of [nf] and of the trainers
         "launches": serve["k1"] + serve_device["k1"] + serve_buckets["k1"] + export["k1"]
         + nf["k1_eval"] + fit["k1"] - fit["k2"] + fit_nf["k1"] - fit_nf["k2"]
         + variants["k1_eval"] + fit_variants["k1"] - fit_variants["k2"] + rope3d["k1_eval"]
         + cond["k1_eval"] + dist_["k1"] - dist_["k2"], **k1},
        {"name": "flash_attn_fwd_dropout", "route": "cuda",
         "source": "gaot3d_tpu_torch/csrc/flash_attn_fwd.cu", "replaces": f"{pallas}:144",
         # one train forward a fused backward
         "launches": train["k1"] + nf["k2"] + fit["k2"] + fit_nf["k2"] + variants["k1"]
         + fit_variants["k2"] + rope3d["k1"] + cond["k1"] + dist_["k2"], **k1d},
        {"name": "flash_attn_bwd", "route": "cuda",
         "source": "gaot3d_tpu_torch/csrc/flash_attn_bwd.cu", "replaces": f"{pallas}:502",
         "launches": train["k2"] + nf["k2"] + fit["k2"] + fit_nf["k2"] + variants["k2"]
         + fit_variants["k2"] + rope3d["k2"] + cond["k2"] + dist_["k2"], **k2},
        # the two kernels of the pair launch together: `launches` is the dq kernel's count,
        # held equal to the dk/dv kernel's by [trainer-split]; the dk/dv kernel's body is
        # K2's, in flash_bwd_wgmma.cuh
        {"name": "flash_attn_bwd_split", "route": "cuda",
         "source": "gaot3d_tpu_torch/csrc/flash_attn_bwd_split.cu", "replaces": f"{pallas}:544",
         "replaces_dkv": f"{pallas}:564",
         "launches": split["k3_dq"], "launches_dkv": split["k3_dkv"], **k3},
        {"name": "dropout_bits", "route": "cuda",
         "source": "gaot3d_tpu_torch/csrc/dropout_bits.cu", "replaces": f"{pallas}:709",
         "launches": replay_launches, **k4},
        {"name": "encoder_payload", "route": "cuda",
         "source": "gaot3d_tpu_torch/csrc/encoder_payload.cu",
         "replaces": "gaot3d_tpu/ops/pallas_encoder.py:203",
         "launches": body_launches(k5_phases, "k5", "float32"), **k5},
        {"name": "encoder_payload_bwd", "route": "cuda",
         "source": "gaot3d_tpu_torch/csrc/encoder_payload_bwd.cu",
         "replaces": "gaot3d_tpu/ops/pallas_encoder.py:246",
         "launches": body_launches(k5b_phases, "k5b", "float32"), **k5b},
        # the bf16 bodies (kernel_dtype bfloat16), valid-row tiles over the tile map. JAX
        # takes its bf16 kernel MLP in XLA (models/fused_encoder.py:108), so they replace the
        # Pallas kernels' work at another dtype, not another Pallas kernel
        {"name": "encoder_payload_bf16", "route": "cuda",
         "source": "gaot3d_tpu_torch/csrc/encoder_payload_bf16.cu",
         "replaces": "gaot3d_tpu/ops/pallas_encoder.py:203",
         "launches": body_launches(k5_phases, "k5", "bfloat16"), **k5_bf16},
        {"name": "encoder_payload_bwd_bf16", "route": "cuda",
         "source": "gaot3d_tpu_torch/csrc/encoder_payload_bwd_bf16.cu",
         "replaces": "gaot3d_tpu/ops/pallas_encoder.py:246",
         "launches": body_launches(k5b_phases, "k5b", "bfloat16"), **k5b_bf16},
        # the decoder's GNO mean of an f32 eval forward on the card, which JAX leaves to XLA
        # (gaot3d_tpu/models/integral_transform.py `_decoder_chunk`)
        {"name": "decoder_payload", "route": "cuda",
         "source": "gaot3d_tpu_torch/csrc/decoder_payload.cu",
         "replaces": "gaot3d_tpu/models/integral_transform.py:194", "launches": nf["k9"], **k9},
        # the budgeted slot build on the card, which JAX leaves to XLA
        # (gaot3d_tpu/ops/grid_graph.py `build_edge_slots_batched`, then `compact_slots`)
        {"name": "slot_build", "route": "cuda", "source": "gaot3d_tpu_torch/csrc/slot_build.cu",
         "replaces": "gaot3d_tpu/ops/grid_graph.py:640", "launches": serve_device["k10"], **k10},
        {"name": "segment_sum_sorted", "route": "cuda",
         "source": "gaot3d_tpu_torch/csrc/segment_sum_sorted.cu",
         "replaces": "gaot3d_tpu/ops/pallas_segment.py:103", "launches": flat["k6"], **k6},
        {"name": "prefix_sum", "route": "cuda",
         "source": "gaot3d_tpu_torch/csrc/prefix_sum.cu",
         "replaces": "gaot3d_tpu/ops/pallas_kernels.py:49",
         "launches": flat["k7"] + variants["k7"] + fit_variants["k7"], **k7},
        {"name": "tile_segment_sum", "route": "cuda",
         "source": "gaot3d_tpu_torch/csrc/tile_segment_sum.cu",
         "replaces": "gaot3d_tpu/ops/pallas_kernels.py:138", "launches": flat["k8"], **k8},
        # the probe's own entry point is its main path
        {"name": "elementwise_chain", "route": "cuda",
         "source": "gaot3d_tpu_torch/csrc/elementwise_chain.cu",
         "replaces": "tools/microbench_vpu_bf16.py:28", **t1},
    ]
    idle = [k["name"] for k in kernels if not k["launches"] > 0]
    if idle:
        raise RuntimeError(f"kernels the main path never launched: {idle}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
