// Non-causal flash-attention forward for Hopper (sm_90a), eval and train.
//
// Replaces gaot3d_tpu/ops/pallas_attention.py `_flash_fwd_impl` (kernel
// `_make_fwd_kernel`). Same math: q is prescaled by 1/sqrt(D) in f32 and
// rounded back to the input type; an online softmax runs over key tiles in
// f32; P is rounded to the value type before P.V; the denominator uses the
// unrounded P. Outputs `out` (input type) and lse = m + log(max(l, 1e-30))
// (f32), which the backward pass needs.
//
// Probability dropout (training): the denominator sums the probabilities
// BEFORE dropout; a kept probability is multiplied by 1/(1-rate), a dropped
// one set to 0, and only then is P rounded to the value type for P.V. The
// keep bits come from the counter-based stream of philox.cuh, or from an
// explicit [bh, sq, skv] tensor. The stream hands out four words per 2x2
// block of (q row, key), so the tensor-core body maps its fragment rows
// (g, g + 8) to the q rows (2g, 2g + 1) of the warp's 16: a thread's four
// scores per 8-key block are then exactly one Philox call.
//
// On the TPU the kv-block axis was a sequential grid dimension with the
// running (m, l, acc) in VMEM scratch. Here a CTA owns a tile of q rows of
// one (batch, head) and walks every key tile in a loop, keeping m, l and acc
// in registers; K and V tiles pass through shared memory. Keys past the
// sequence end are masked to -inf in the last tile, and a row whose keys are
// all masked gets out = 0 instead of NaN. Two bodies:
//   - bf16 with head dim 16/32/64 (the main path), warp-specialized for
//     Hopper. A CTA is three warpgroups and owns 128 q rows. The producer
//     warpgroup gives up registers to the consumers (setmaxnreg) and one of
//     its threads keeps
//     a ring of 3 stages of 128-key K and V tiles full by TMA, with a full
//     and an empty mbarrier per stage. Each of the two consumer warpgroups
//     owns 64 q rows: its q sits in registers (prescaled, rows permuted as
//     above) as the register A operand of wgmma m64n128k16 for S = Q K^T,
//     with B the K tile in shared memory (K-major); P goes from the
//     accumulator straight into the A registers of O += P V (wgmma m64nDk16),
//     whose B is the V tile read MN-major through the descriptor, so V is
//     never transposed. Inside a consumer, S of tile j+1 is issued together
//     with P V of tile j, and the exponentials of tile j+1 run while that
//     product is in flight; the two consumers take turns at the tensor cores
//     on two named barriers, so one's softmax runs while the other's
//     products do. The dropout mask depends on positions only, so a tile's
//     Philox calls run while its products are in flight.
//   - f32, and bf16 at head dim 8: one thread per q row, scalar f32 FMAs,
//     every lane of a warp reading the same key (shared-memory broadcast).
//
// What bounds it on an H100: at the main-path shape (B1 H8 S16384 D32) a
// layer is 2.7e11 flops and 2.1e9 exponentials. With head dim 32 the matrix
// work per score is small, so the wgmma body is bound by the softmax: exp on
// the 16-per-clock special-function unit (0.513 ms a layer), against 0.28 ms
// of tensor-core work; max, the FFMA, the sum, the conversion and the
// rescale go to the FP32 pipe, off the special-function unit's path. The
// exponential is ex2.approx.ftz of a fused multiply-add (one FFMA and one
// MUFU op a score; exp2f would add the denormal handling on the FP32 pipe).
// With dropout add one Philox call per four scores (integer multiplies, the
// largest term then). ptxas compiles every path under the launch bound of
// 168 registers (three warps share a sub-partition's registers), whatever
// setmaxnreg gives the consumers at run time: the dropout and head-dim-64
// bodies spill a few words. The scalar body is FMA-issue bound (about 60
// TFLOP/s peak) and serves the f32 reference checks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "philox.cuh"

namespace {

using gaot::DropoutParams;

constexpr int BLOCK_M = 64;  // q rows per CTA, one per thread
constexpr int BLOCK_N = 64;  // keys per shared-memory tile

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(BLOCK_M)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int sq, int skv, float scale,
                     bool drop, DropoutParams dp) {
  __shared__ __align__(16) float ks[BLOCK_N][D];
  __shared__ __align__(16) float vs[BLOCK_N][D];

  const int bh = blockIdx.y;
  const int row = blockIdx.x * BLOCK_M + threadIdx.x;
  const bool active = row < sq;
  const T* qb = q + (size_t)bh * sq * D;
  const T* kb = k + (size_t)bh * skv * D;
  const T* vb = v + (size_t)bh * skv * D;

  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = active ? Cvt<T>::round(__fmul_rn(Cvt<T>::load(qb[(size_t)row * D + d]), scale))
                   : 0.f;
  }
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = -INFINITY;
  float l = 0.f;
  const float kept = drop ? dp.inv_keep : 1.f;  // factor of a kept probability

  for (int kv0 = 0; kv0 < skv; kv0 += BLOCK_N) {
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < BLOCK_N * D; i += BLOCK_M) {
      const int j = i / D;
      const int d = i - j * D;
      const int key = kv0 + j;
      const bool in = key < skv;
      ks[j][d] = in ? Cvt<T>::load(kb[(size_t)key * D + d]) : 0.f;
      vs[j][d] = in ? Cvt<T>::load(vb[(size_t)key * D + d]) : 0.f;
    }
    __syncthreads();

    float s[BLOCK_N];
#pragma unroll
    for (int j = 0; j < BLOCK_N; ++j) s[j] = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
#pragma unroll
      for (int j = 0; j < BLOCK_N; ++j) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][d]);
        s[j] = fmaf(qr[d], kk.x, s[j]);
        s[j] = fmaf(qr[d + 1], kk.y, s[j]);
        s[j] = fmaf(qr[d + 2], kk.z, s[j]);
        s[j] = fmaf(qr[d + 3], kk.w, s[j]);
      }
    }
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < BLOCK_N; ++j) {
      if (kv0 + j >= skv) s[j] = -INFINITY;  // ragged kv tail
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;  // all keys masked
    const float alpha = expf(m - m_safe);
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
    uint64_t keep = ~0ull;  // bit j: key kv0 + j of this row is kept
    if (drop) {
      keep = 0ull;
#pragma unroll 1
      for (int j = 0; j < BLOCK_N; j += 2) {
        uint32_t w[4];
        gaot::dropout_block_bits(dp, bh, row, kv0 + j, sq, skv, w);
        const int o = (row & 1) * 2;
        keep |= (uint64_t)(w[o] >= dp.thresh) << j;
        keep |= (uint64_t)(w[o + 1] >= dp.thresh) << (j + 1);
      }
    }
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BLOCK_N; ++j) {
      const float p = expf(s[j] - m_safe);
      psum += p;  // the denominator sums the probabilities before dropout
      const float pr = Cvt<T>::round((keep >> j) & 1ull ? p * kept : 0.f);
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][d]);
        acc[d] = fmaf(pr, vv.x, acc[d]);
        acc[d + 1] = fmaf(pr, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(pr, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(pr, vv.w, acc[d + 3]);
      }
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (active) {
    const float ls = fmaxf(l, 1e-30f);
    T* ob = out + ((size_t)bh * sq + row) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) ob[d] = Cvt<T>::store(acc[d] / ls);
    lse[(size_t)bh * sq + row] = m + logf(ls);
  }
}

// ---------------------------------------------------------------------------
// bf16 warp-specialized body (head dims 16, 32, 64). See the header for the
// layout. Fragment rows (g, g + 8) of each warp's 16 hold the q rows
// (2g, 2g + 1), see the note on dropout above.
// ---------------------------------------------------------------------------
constexpr int WG = 128;          // threads of a warpgroup
constexpr int W_BM = 128;        // q rows per CTA, 64 per consumer warpgroup
constexpr int W_BN = 128;        // keys per TMA tile
constexpr int W_STAGES = 3;      // K/V tile pairs in flight
constexpr int W_THREADS = 3 * WG;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr size_t wgmma_smem_bytes() {
  return (size_t)W_STAGES * 2 * W_BN * D * 2 + 1024;  // + room to align to 1024
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two q elements (row, col..col+1), prescaled in f32 and rounded back to bf16
__device__ __forceinline__ uint32_t load_q_pair(const __nv_bfloat16* qb, int row,
                                                int col, int sq, int d, float scale) {
  if (row >= sq) return 0u;
  const float2 x = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(qb + (size_t)row * d + col));
  return pack_bf16(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale));
}

template <int D, bool DROP>
__global__ void __launch_bounds__(W_THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_k,
                           const __grid_constant__ CUtensorMap tmap_v,
                           const __nv_bfloat16* __restrict__ q,
                           __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int sq,
                           int skv, float scale, DropoutParams dp) {
  using namespace gaot;
  constexpr int RB = 2 * D;           // bytes of a K or V row
  constexpr int TILE = W_BN * RB;     // bytes of a K or V tile
  constexpr int NS = W_BN / 8;        // 8-key blocks of a tile
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[W_STAGES], empty[W_STAGES];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int bh = blockIdx.y;
  const int n_tiles = (skv + W_BN - 1) / W_BN;
  // the warpgroup's index, read from lane 0 so the compiler knows it is the
  // same across the warp: the branches below, and every wgmma in them, are
  // then not divergent
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / WG, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 8);  // the 4 warps of each consumer
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    regs_dec<24>();
    if (threadIdx.x == 0) {
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % W_STAGES;
        mbar_wait(smem_u32(&empty[s]), ((i / W_STAGES) & 1) ^ 1);
        const uint32_t bar = smem_u32(&full[s]);
        const uint32_t dst = base + s * 2 * TILE;
        mbar_expect_tx(bar, 2 * TILE);
        tma_load_3d(dst, &tmap_k, bar, 0, i * W_BN, bh);
        tma_load_3d(dst + TILE, &tmap_v, bar, 0, i * W_BN, bh);
      }
    }
  } else {  // consumers
    regs_inc<240>();
    const int c = wg - 1;  // consumer 0 or 1
    const int ct = threadIdx.x - wg * WG;
    const int warp = ct >> 5;
    const int lane = ct & 31;
    const int g = lane >> 2;  // row within the 8-row half of the fragment
    const int t = lane & 3;   // column pair
    const int r0 = blockIdx.x * W_BM + c * 64 + warp * 16 + 2 * g;
    const int r1 = r0 + 1;
    const __nv_bfloat16* qb = q + (size_t)bh * sq * D;

    uint32_t qa[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = load_q_pair(qb, r0, kk * 16 + 2 * t, sq, D, scale);
      qa[kk][1] = load_q_pair(qb, r1, kk * 16 + 2 * t, sq, D, scale);
      qa[kk][2] = load_q_pair(qb, r0, kk * 16 + 2 * t + 8, sq, D, scale);
      qa[kk][3] = load_q_pair(qb, r1, kk * 16 + 2 * t + 8, sq, D, scale);
    }
    float o[D / 2];  // [nd * 4 + e]: rows (g, g + 8) x columns nd * 8 + 2t + (0, 1)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float sc[W_BN / 2];         // scores, then probabilities, of one tile: [nb * 4 + e]
    uint32_t pa[W_BN / 16][4];  // P of the previous tile as the A operand of P V
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    float mp0 = -INFINITY, mp1 = -INFINITY;  // m * log2e of the previous tile
    float a0 = 0.f, a1 = 0.f;                // this tile's rescale of o
    uint32_t keep[2] = {0u, 0u};             // keep bits of a tile: 4 per 8-key block

    // The dropout mask depends on positions only, so each tile's Philox calls
    // (integer pipe) run while that tile's products are on the tensor cores.
    auto keep_bits = [&](int i) {
      if constexpr (DROP) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t b = 0u;
#pragma unroll
          for (int nb = 0; nb < NS / 2; ++nb)
            b |= gaot::dropout_block_keep(dp, bh, r0, i * W_BN + (h * NS / 2 + nb) * 8 + 2 * t,
                                          sq, skv)
                 << (4 * nb);
          keep[h] = b;
        }
        fence_regs(keep);  // here, before the wait for the products
      }
    };

    auto issue_s = [&](int i) {  // S of tile i into sc
      const uint32_t kt = base + (i % W_STAGES) * 2 * TILE;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_rs<0>(sc, qa[kk], wgmma_desc(kt + kk * 32, RB, false), kk > 0);
      wgmma_commit();
    };
    auto issue_pv = [&](int i) {  // o += P V of tile i, P in pa
      const uint32_t vt = base + (i % W_STAGES) * 2 * TILE + TILE;
#pragma unroll
      for (int j = 0; j < W_BN / 16; ++j)
        wgmma_rs<1>(o, pa[j], wgmma_desc(vt + j * 16 * RB, RB, true), 1);
      wgmma_commit();
    };
    auto softmax = [&](int i) {  // sc of tile i -> probabilities (kept ones scaled), a0, a1
      const int kv0 = i * W_BN;
      if (kv0 + W_BN > skv) {  // ragged kv tail
#pragma unroll
        for (int nb = 0; nb < NS; ++nb) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (kv0 + nb * 8 + 2 * t + e >= skv) sc[nb * 4 + e] = sc[nb * 4 + 2 + e] = -INFINITY;
          }
        }
      }
      float mt0 = -INFINITY, mt1 = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < NS; ++nb) {
        mt0 = fmaxf(mt0, fmaxf(sc[nb * 4 + 0], sc[nb * 4 + 1]));
        mt1 = fmaxf(mt1, fmaxf(sc[nb * 4 + 2], sc[nb * 4 + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, off));
        mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, off));
      }
      const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
      // exp(s - m) as exp2(s*log2e - m*log2e): one FFMA and one MUFU op a score
      const float ms0 = mn0 == -INFINITY ? 0.f : mn0 * LOG2E;  // all keys masked
      const float ms1 = mn1 == -INFINITY ? 0.f : mn1 * LOG2E;
      // rescale from the previous tile's scaled max: exactly 1 while the max
      // holds, so rounding in ms does not compound over the key tiles
      a0 = ex2_ftz(mp0 - ms0);
      a1 = ex2_ftz(mp1 - ms1);
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int nb = 0; nb < NS; ++nb) {
        float* p = sc + nb * 4;
        p[0] = ex2_ftz(fmaf(p[0], LOG2E, -ms0));
        p[1] = ex2_ftz(fmaf(p[1], LOG2E, -ms0));
        p[2] = ex2_ftz(fmaf(p[2], LOG2E, -ms1));
        p[3] = ex2_ftz(fmaf(p[3], LOG2E, -ms1));
        l0 += p[0] + p[1];  // the denominator sums the probabilities before dropout
        l1 += p[2] + p[3];
        if constexpr (DROP) {
          // (r0, c), (r0, c + 1), (r1, c), (r1, c + 1): one 2x2 block
          const uint32_t b = keep[nb / 8] >> (4 * (nb % 8));
          p[0] = (b & 1u) ? p[0] * dp.inv_keep : 0.f;
          p[1] = (b & 2u) ? p[1] * dp.inv_keep : 0.f;
          p[2] = (b & 4u) ? p[2] * dp.inv_keep : 0.f;
          p[3] = (b & 8u) ? p[3] * dp.inv_keep : 0.f;
        }
      }
      m0 = mn0;
      m1 = mn1;
      mp0 = mn0 == -INFINITY ? -INFINITY : ms0;
      mp1 = mn1 == -INFINITY ? -INFINITY : ms1;
    };
    auto rescale_and_pack = [&]() {  // o *= (a0, a1); P rounded to bf16 into pa
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        o[nd * 4 + 0] *= a0;
        o[nd * 4 + 1] *= a0;
        o[nd * 4 + 2] *= a1;
        o[nd * 4 + 3] *= a1;
      }
      // k-step j of P V covers the score blocks 2j (columns 0-7) and 2j+1 (8-15)
#pragma unroll
      for (int nb = 0; nb < NS; ++nb) {
        pa[nb / 2][(nb % 2) * 2 + 0] = pack_bf16(sc[nb * 4 + 0], sc[nb * 4 + 1]);
        pa[nb / 2][(nb % 2) * 2 + 1] = pack_bf16(sc[nb * 4 + 2], sc[nb * 4 + 3]);
      }
    };

    // ping-pong: consumer c issues its products after named barrier 1 + c,
    // then lets the other one issue (barrier 2 - c); consumer 1 lets
    // consumer 0 go first. Each syncs n_tiles + 1 times and is arrived at as
    // often.
    if (c == 1) named_arrive(1, 2 * WG);
    mbar_wait(smem_u32(&full[0]), 0);
    named_sync(1 + c, 2 * WG);
    wgmma_fence();
    issue_s(0);
    named_arrive(2 - c, 2 * WG);
    keep_bits(0);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(0);
    rescale_and_pack();
    // step i: S of tile i and P V of tile i - 1 in flight together; the
    // exponentials of tile i run while P V of tile i - 1 is on the tensor cores
    for (int i = 1; i < n_tiles; ++i) {
      mbar_wait(smem_u32(&full[i % W_STAGES]), (i / W_STAGES) & 1);
      named_sync(1 + c, 2 * WG);
      wgmma_fence();
      issue_s(i);
      issue_pv(i - 1);
      named_arrive(2 - c, 2 * WG);
      keep_bits(i);
      wgmma_wait<1>();
      fence_regs(sc);
      softmax(i);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(smem_u32(&empty[(i - 1) % W_STAGES]));
      rescale_and_pack();
    }
    named_sync(1 + c, 2 * WG);
    wgmma_fence();
    issue_pv(n_tiles - 1);
    if (c == 0) named_arrive(2 - c, 2 * WG);
    wgmma_wait<0>();
    fence_regs(o);

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float ls0 = fmaxf(l0, 1e-30f), ls1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* ob = out + (size_t)bh * sq * D;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const int col = nd * 8 + 2 * t;
      if (r0 < sq)
        *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * D + col) =
            pack_bf16(o[nd * 4 + 0] / ls0, o[nd * 4 + 1] / ls0);
      if (r1 < sq)
        *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * D + col) =
            pack_bf16(o[nd * 4 + 2] / ls1, o[nd * 4 + 3] / ls1);
    }
    if (t == 0) {
      if (r0 < sq) lse[(size_t)bh * sq + r0] = m0 + logf(ls0);
      if (r1 < sq) lse[(size_t)bh * sq + r1] = m1 + logf(ls1);
    }
  }
}

template <int D, bool DROP>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
                 int sq, int skv, float scale, const DropoutParams& dp, cudaStream_t stream) {
  CUtensorMap tk, tv;
  if (!gaot::bf16_rows_map(&tk, k, bh, skv, D, W_BN) ||
      !gaot::bf16_rows_map(&tv, v, bh, skv, D, W_BN))
    return (int)cudaErrorInvalidValue;
  constexpr size_t bytes = wgmma_smem_bytes<D>();
  auto kern = flash_fwd_wgmma_kernel<D, DROP>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3((sq + W_BM - 1) / W_BM, bh), W_THREADS, bytes, stream>>>(
      tk, tv, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(out), lse, sq,
      skv, scale, dp);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int bh, int sq, int skv, float scale, bool drop, DropoutParams dp,
           cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> && D % 16 == 0) {
    if (drop) return launch_wgmma<D, true>(q, k, v, out, lse, bh, sq, skv, scale, dp, stream);
    return launch_wgmma<D, false>(q, k, v, out, lse, bh, sq, skv, scale, dp, stream);
  } else {
    const dim3 grid((sq + BLOCK_M - 1) / BLOCK_M, bh);
    flash_fwd_kernel<T, D><<<grid, BLOCK_M, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), lse, sq, skv, scale, drop, dp);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out,
               float* lse, int bh, int sq, int skv, int d, float scale, bool drop,
               DropoutParams dp, cudaStream_t stream) {
  switch (d) {
    case 8: return launch<T, 8>(q, k, v, out, lse, bh, sq, skv, scale, drop, dp, stream);
    case 16: return launch<T, 16>(q, k, v, out, lse, bh, sq, skv, scale, drop, dp, stream);
    case 32: return launch<T, 32>(q, k, v, out, lse, bh, sq, skv, scale, drop, dp, stream);
    case 64: return launch<T, 64>(q, k, v, out, lse, bh, sq, skv, scale, drop, dp, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [bh, sq, d], k and v [bh, skv, d], out [bh, sq, d] in one type
// (dtype 0: float32, 1: bfloat16), lse [bh, sq] float32; all contiguous.
// drop != 0 applies probability dropout: keep iff bits >= thresh, kept
// probabilities times inv_keep; the bits are `bits` [bh, sq, skv] uint32 when
// given, else drawn from (seed_lo, seed_hi) with the launch's bh 0 taken as
// batch*head bh0 of the stream (philox.cuh). Returns the launch's cudaError_t
// (0 on success).
int gaot_flash_attn_fwd(const void* q, const void* k, const void* v, void* out,
                        void* lse, int bh, int sq, int skv, int d, int dtype,
                        float scale, int drop, const void* bits, unsigned int seed_lo,
                        unsigned int seed_hi, unsigned int thresh, float inv_keep,
                        unsigned int bh0, void* stream) {
  if (bh <= 0 || bh > 65535 || sq <= 0 || skv <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const DropoutParams dp{static_cast<const uint32_t*>(bits), seed_lo, seed_hi, thresh,
                         inv_keep, bh0};
  const bool dr = drop != 0;
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, out, l, bh, sq, skv, d, scale, dr, dp, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, l, bh, sq, skv, d, scale, dr, dp, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
