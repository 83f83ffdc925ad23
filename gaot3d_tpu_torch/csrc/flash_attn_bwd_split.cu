// Split flash-attention backward for Hopper (sm_90a): a dk/dv kernel, then a
// dq kernel, no shared accumulator, the same bits on every launch.
//
// Replaces gaot3d_tpu/ops/pallas_attention.py `_flash_bwd_impl`, split calls
// :564 (kernel `_make_bwd_dkv_kernel`) and :544 (`_make_bwd_dq_kernel`).
// Given q, k, v, dO, the forward's lse and delta = rowsum(dO * O) (f32, a
// plain reduction outside, as in the JAX code), per (q tile, key tile) both
// kernels recompute
//     s   = q_scaled k^T          (q prescaled by 1/sqrt(D) in f32, rounded back)
//     p   = exp(s - lse)          (0 on padded keys and padded q rows)
//     dpv = dO v^T
//     km  = keep ? 1/(1-rate) : 0 (1 at rate 0)
//     ds  = p (dpv km - delta)
// and then
//     dk/dv kernel: dv = sum over q rows of (p km)^T dO    (p km rounded to dO's type)
//                   dk = sum over q rows of ds^T q_scaled  (ds rounded to the input type)
//     dq kernel:    dq = scale * sum over keys of ds k     (f32 accumulator, rounded once)
//
// On the TPU this pair is the fallback for heads whose dq does not fit VMEM.
// Here it is the backward whose results repeat: the fused kernel
// (flash_attn_bwd.cu) adds dq tiles with a bulk reduce-add in a run-dependent
// order, these two add nothing across CTAs. The dk/dv kernel's CTA owns 128
// keys, walks every q tile and keeps dk and dv in registers; the dq kernel's
// CTA owns 128 q rows, walks every key tile and keeps dq in registers. Every
// sum runs in program order, within one CTA.
//
// The mask, drawn once. The dk/dv kernel runs first. Under dropout it draws
// the keep bits (Philox, philox.cuh, or the explicit bits) and writes them,
// one bit a score, into the keep mask whose layout flash_bwd_wgmma.cuh
// defines: [bh][key tile of 64][q tile of 64][128 words], B*H*S*Skv/8 bytes
// (268 MB a layer at B1 H8 S16384; the wrapper allocates it and frees it with
// the layer's backward). The dq kernel reads it and holds no Philox code.
// Rows past sq and keys past skv read 0, so the mask drawn from a seed equals
// the mask drawn from that seed's exported bits.
//
// Two bodies each:
//   - bf16 with head dim 16/32/64 (the main path), warp-specialized on
//     hopper.cuh. dk/dv: K2's body (flash_bwd_wgmma.cuh) with DQ = false,
//     so dk and dv equal K2's bit for bit. dq: one TMA producer warpgroup
//     keeps a ring of 4 stages of 64-key K and V tiles (and the two 512-byte
//     mask tiles of the CTA's q tiles, by one bulk copy) full; each of two
//     consumer warpgroups owns 64 q rows, with q_s and dO in registers as
//     wgmma A operands (rows permuted as in K1: fragment rows (g, g + 8) are
//     q rows (2g, 2g + 1)). S = q_s K^T and dP = dO V^T are wgmma m64n64k16
//     with B the tiles K-major; p and ds in registers, ds rounded into the A
//     registers of dq += ds K, whose B is the same K tile read MN-major. S and
//     dP of tile j + 1 are issued with dq of tile j, and the two consumers
//     take turns at the tensor cores on two named barriers, as in K1. 64-key
//     tiles keep S, dP and dq (32 + 32 + D/2 floats a thread) within the 168
//     registers ptxas allots.
//     A thread's scores of a tile are 8 blocks of the same q pair; the mask
//     word of the dk/dv thread holds 8 blocks of the same key pair, so the dq
//     thread takes its nibbles from 8 words of the stage's mask tile in
//     shared memory (8 conflict-free loads a tile, each a broadcast to 2
//     lanes). No one layout gives both threads one word: their sets of blocks
//     share at most one.
//   - f32, and bf16 at head dim 8: scalar f32 FMAs, one thread per key (dk/dv)
//     or per q row (dq), writing and reading the same mask.
//
// What bounds them on an H100, at B1 H8 S16384 D32 (2.1e9 scores):
//   - dk/dv: four tile products (0.56 ms of tensor cores), one exponential a
//     score (0.51 ms) and, with dropout, one Philox call per four scores
//     (1.28 ms, the largest term); 42 MB of q, k, v, dO, dk, dv and 268 MB of
//     mask written (0.09 ms).
//   - dq: three products (0.42 ms), one exponential a score (0.51 ms, the
//     bound), no Philox; 268 MB of mask read.
// The pair is bound by 1.80 ms with dropout and 1.07 ms without, against
// 2.56 and 1.03 when each kernel drew the mask itself.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_bwd_wgmma.cuh"
#include "hopper.cuh"
#include "philox.cuh"

namespace {

using gaot::DropoutParams;
using gaot::fbwd::B_THREADS;
using gaot::fbwd::LOG2E;
using gaot::fbwd::MASK_WORDS;
using gaot::fbwd::WG;
using gaot::fbwd::allow_smem;
using gaot::fbwd::pack_bf16;
using bf = __nv_bfloat16;

constexpr int TILE = 64;  // rows a scalar CTA owns, rows per step of its loop, a mask tile's side

struct SplitArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;  // [bh, sq, d] in the input type (dq kernel)
  void* dk;  // [bh, skv, d] (dk/dv kernel)
  void* dv;
  int sq, skv;
  float scale;
};

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Cvt<bf> {
  static __device__ __forceinline__ float load(bf x) { return __bfloat162float(x); }
  static __device__ __forceinline__ bf store(float x) { return __float2bfloat16(x); }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

__host__ __device__ __forceinline__ int mask_tiles(int n) { return (n + TILE - 1) / TILE; }

// ---------------------------------------------------------------------------
// Scalar dq body: 64 threads, thread = q row. K and V tiles pass through
// shared memory (every lane reads the same key: a broadcast), with the
// tile's 128 mask words; the thread's q_scaled and dO rows sit in shared
// memory at a stride of D + 1, dq in registers.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(TILE)
    bwd_dq_kernel(SplitArgs a, const uint32_t* __restrict__ keep_mask, float inv_keep) {
  constexpr int RS = D + 1;
  extern __shared__ float smem[];
  float* ks = smem;            // [TILE][D]
  float* vs = ks + TILE * D;   // [TILE][D]
  float* qs = vs + TILE * D;   // [TILE][RS]
  float* dos = qs + TILE * RS; // [TILE][RS]
  uint32_t* mw = reinterpret_cast<uint32_t*>(dos + TILE * RS);  // [MASK_WORDS]

  const int bh = blockIdx.y;
  const int i = threadIdx.x;
  const int q0 = blockIdx.x * TILE;
  const int row = q0 + i;
  const bool row_in = row < a.sq;
  const bool drop = keep_mask != nullptr;
  const int n_q = mask_tiles(a.sq), n_k = mask_tiles(a.skv);
  const T* qb = static_cast<const T*>(a.q) + (size_t)bh * a.sq * D;
  const T* kb = static_cast<const T*>(a.k) + (size_t)bh * a.skv * D;
  const T* vb = static_cast<const T*>(a.v) + (size_t)bh * a.skv * D;
  const T* dob = static_cast<const T*>(a.dout) + (size_t)bh * a.sq * D;

  for (int e = threadIdx.x; e < TILE * D; e += TILE) {
    const int r = e / D, d = e - r * D;
    const bool in = q0 + r < a.sq;
    qs[r * RS + d] =
        in ? Cvt<T>::round(__fmul_rn(Cvt<T>::load(qb[(size_t)(q0 + r) * D + d]), a.scale)) : 0.f;
    dos[r * RS + d] = in ? Cvt<T>::load(dob[(size_t)(q0 + r) * D + d]) : 0.f;
  }
  const float lse = row_in ? a.lse[(size_t)bh * a.sq + row] : 0.f;
  const float delta = row_in ? a.delta[(size_t)bh * a.sq + row] : 0.f;
  // the thread's words and bits in a mask tile: word 4 kp + (qp & 3), nibble
  // qp >> 2, bit (row & 1) * 2 + (key & 1), qp = i >> 1
  const int mword = (i >> 1) & 3;
  const int mbit = 4 * (i >> 3) + (i & 1) * 2;
  float dq[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dq[d] = 0.f;

  for (int kv0 = 0; kv0 < a.skv; kv0 += TILE) {
    __syncthreads();  // every thread is done with the previous tile (and qs, dos are written)
    for (int e = threadIdx.x; e < TILE * D; e += TILE) {
      const int r = e / D, d = e - r * D;
      const bool in = kv0 + r < a.skv;
      ks[e] = in ? Cvt<T>::load(kb[(size_t)(kv0 + r) * D + d]) : 0.f;
      vs[e] = in ? Cvt<T>::load(vb[(size_t)(kv0 + r) * D + d]) : 0.f;
    }
    if (drop) {
      const uint32_t* src =
          keep_mask + (((size_t)bh * n_k + kv0 / TILE) * n_q + blockIdx.x) * MASK_WORDS;
      for (int w = threadIdx.x; w < MASK_WORDS; w += TILE) mw[w] = src[w];
    }
    __syncthreads();

#pragma unroll 1
    for (int j = 0; j < TILE; ++j) {
      const int key = kv0 + j;
      const float km =
          drop ? (((mw[4 * (j >> 1) + mword] >> (mbit + (j & 1))) & 1u) ? inv_keep : 0.f) : 1.f;
      float s = 0.f, dpv = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(qs[i * RS + d], ks[j * D + d], s);
        dpv = fmaf(dos[i * RS + d], vs[j * D + d], dpv);
      }
      const float p = (row_in && key < a.skv) ? expf(s - lse) : 0.f;
      const float ds = Cvt<T>::round(p * (dpv * km - delta));
#pragma unroll
      for (int d = 0; d < D; ++d) dq[d] = fmaf(ds, ks[j * D + d], dq[d]);
    }
  }

  if (row_in) {
    T* dst = static_cast<T*>(a.dq) + ((size_t)bh * a.sq + row) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) dst[d] = Cvt<T>::store(dq[d] * a.scale);
  }
}

template <int D>
constexpr size_t dq_scalar_smem_bytes() {
  return sizeof(float) * (2 * TILE * D + 2 * TILE * (D + 1)) + MASK_WORDS * sizeof(uint32_t);
}

// ---------------------------------------------------------------------------
// Scalar dk/dv body: 64 threads, thread = key. The thread's k and v rows sit
// in shared memory at a stride of D + 1, the q_scaled and dO tiles are read
// by every lane at once, dk and dv rows in registers. Under dropout the
// thread gathers its keep bits of a q tile into the 4 words of its key pair
// and the even key's thread stores them, or-ed with its neighbour's.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(TILE)
    bwd_dkv_kernel(SplitArgs a, bool drop, DropoutParams dp, uint32_t* __restrict__ keep_mask) {
  constexpr int KS = D + 1;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + TILE * KS;
  float* qs = vs + TILE * KS;  // [TILE][D]
  float* dos = qs + TILE * D;
  float* lse_s = dos + TILE * D;
  float* dl_s = lse_s + TILE;

  const int bh = blockIdx.y;
  const int j = threadIdx.x;
  const int key = blockIdx.x * TILE + j;
  const bool key_in = key < a.skv;
  const int n_q = mask_tiles(a.sq), n_k = mask_tiles(a.skv);
  const T* qb = static_cast<const T*>(a.q) + (size_t)bh * a.sq * D;
  const T* kb = static_cast<const T*>(a.k) + (size_t)bh * a.skv * D;
  const T* vb = static_cast<const T*>(a.v) + (size_t)bh * a.skv * D;
  const T* dob = static_cast<const T*>(a.dout) + (size_t)bh * a.sq * D;

  for (int e = threadIdx.x; e < TILE * D; e += TILE) {
    const int r = e / D, d = e - r * D;
    const int kk = blockIdx.x * TILE + r;
    const bool in = kk < a.skv;
    ks[r * KS + d] = in ? Cvt<T>::load(kb[(size_t)kk * D + d]) : 0.f;
    vs[r * KS + d] = in ? Cvt<T>::load(vb[(size_t)kk * D + d]) : 0.f;
  }
  float dk[D], dv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dk[d] = dv[d] = 0.f;
  const float kept = drop ? dp.inv_keep : 1.f;

  for (int q0 = 0; q0 < a.sq; q0 += TILE) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < TILE * D; e += TILE) {
      const int r = e / D, d = e - r * D;
      const int row = q0 + r;
      const bool in = row < a.sq;
      qs[e] = in ? Cvt<T>::round(__fmul_rn(Cvt<T>::load(qb[(size_t)row * D + d]), a.scale)) : 0.f;
      dos[e] = in ? Cvt<T>::load(dob[(size_t)row * D + d]) : 0.f;
    }
    {
      const int row = q0 + threadIdx.x;
      const bool in = row < a.sq;
      lse_s[threadIdx.x] = in ? a.lse[(size_t)bh * a.sq + row] : 0.f;
      dl_s[threadIdx.x] = in ? a.delta[(size_t)bh * a.sq + row] : 0.f;
    }
    __syncthreads();

    uint32_t words[4] = {0u, 0u, 0u, 0u};  // words 4 kp + 0..3 of this key pair
    float km_even = kept, km_odd = kept;  // rows q0 + i, i even / odd
#pragma unroll 1
    for (int i = 0; i < TILE; ++i) {
      const int row = q0 + i;
      if (drop && (i & 1) == 0) {
        uint32_t w[4];
        gaot::dropout_block_bits(dp, bh, row, key, a.sq, a.skv, w);
        const bool even = w[key & 1] >= dp.thresh, odd = w[2 + (key & 1)] >= dp.thresh;
        km_even = even ? kept : 0.f;
        km_odd = odd ? kept : 0.f;
        const int qp = i >> 1, bit = 4 * (qp >> 2) + (key & 1);
        words[qp & 3] |= (uint32_t)(even && key_in && row < a.sq) << bit |
                         (uint32_t)(odd && key_in && row + 1 < a.sq) << (bit + 2);
      }
      const float km = (i & 1) ? km_odd : km_even;
      float s = 0.f, dpv = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(qs[i * D + d], ks[j * KS + d], s);
        dpv = fmaf(dos[i * D + d], vs[j * KS + d], dpv);
      }
      const float p = (key_in && row < a.sq) ? expf(s - lse_s[i]) : 0.f;
      const float pm = Cvt<T>::round(p * km);
      const float ds = Cvt<T>::round(p * (dpv * km - dl_s[i]));
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dv[d] = fmaf(pm, dos[i * D + d], dv[d]);
        dk[d] = fmaf(ds, qs[i * D + d], dk[d]);
      }
    }
    if (drop) {
#pragma unroll
      for (int w = 0; w < 4; ++w) words[w] |= __shfl_xor_sync(0xffffffffu, words[w], 1);
      if ((j & 1) == 0) {
        uint32_t* dst = keep_mask +
                        (((size_t)bh * n_k + blockIdx.x) * n_q + q0 / TILE) * MASK_WORDS +
                        4 * (j >> 1);
        *reinterpret_cast<uint4*>(dst) = make_uint4(words[0], words[1], words[2], words[3]);
      }
    }
  }

  if (key_in) {
    T* dkb = static_cast<T*>(a.dk) + ((size_t)bh * a.skv + key) * D;
    T* dvb = static_cast<T*>(a.dv) + ((size_t)bh * a.skv + key) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dkb[d] = Cvt<T>::store(dk[d]);
      dvb[d] = Cvt<T>::store(dv[d]);
    }
  }
}

template <int D>
constexpr size_t dkv_scalar_smem_bytes() {
  return sizeof(float) * (2 * TILE * (D + 1) + 2 * TILE * D + 2 * TILE);
}

// ---------------------------------------------------------------------------
// bf16 warp-specialized dq body, see the header.
// ---------------------------------------------------------------------------
constexpr int Q_ROWS = 128;   // q rows per CTA, 64 per consumer warpgroup
constexpr int KT = 64;        // keys per tile
constexpr int Q_STAGES = 4;   // K/V (and mask) tiles in flight
constexpr int MASK_BYTES = MASK_WORDS * 4;

// Shared memory of a stage, in bytes from a 1024-byte aligned base: K tile,
// V tile, then (DROP) the mask tiles of the CTA's two q tiles.
template <int D, bool DROP>
struct DqSmem {
  static constexpr int RB = 2 * D;  // bytes of a bf16 row
  static constexpr int KV = KT * RB;
  static constexpr int STAGE = 2 * KV + (DROP ? 2 * MASK_BYTES : 0);
  static constexpr size_t bytes = (size_t)Q_STAGES * STAGE + 1024;
};

// two q elements (row, col..col+1), prescaled in f32 and rounded back to bf16
__device__ __forceinline__ uint32_t load_q_pair(const bf* qb, int row, int col, int sq, int d,
                                                float scale) {
  if (row >= sq) return 0u;
  const float2 x =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qb + (size_t)row * d + col));
  return pack_bf16(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale));
}

template <int D, bool DROP>
__global__ void __launch_bounds__(B_THREADS, 1)
    bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_k,
                        const __grid_constant__ CUtensorMap tmap_v, SplitArgs a,
                        const uint32_t* __restrict__ keep_mask, float inv_keep) {
  using namespace gaot;
  using L = DqSmem<D, DROP>;
  constexpr int RB = L::RB;
  constexpr int NS = KT / 8;  // 8-key blocks of a tile
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[Q_STAGES], empty[Q_STAGES];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const unsigned char* sm = smem_raw + (base - smem_u32(smem_raw));  // the same bytes, generic
  const int bh = blockIdx.y;
  const int n_k = (a.skv + KT - 1) / KT;  // also the mask's key tiles
  const int n_q = mask_tiles(a.sq);
  // the warpgroup's index, read from lane 0 so the compiler knows it is the
  // same across the warp: the branches below, and every wgmma in them, are
  // then not divergent
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / WG, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < Q_STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 8);  // the 4 warps of each consumer
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    regs_dec<24>();
    if (threadIdx.x == 0) {
      const int mtiles = min(2, n_q - 2 * (int)blockIdx.x);  // the CTA's q tiles of the mask
      for (int j = 0; j < n_k; ++j) {
        const int s = j % Q_STAGES;
        mbar_wait(smem_u32(&empty[s]), ((j / Q_STAGES) & 1) ^ 1);
        const uint32_t bar = smem_u32(&full[s]);
        const uint32_t dst = base + s * L::STAGE;
        mbar_expect_tx(bar, 2 * L::KV + (DROP ? mtiles * MASK_BYTES : 0));
        tma_load_3d(dst, &tmap_k, bar, 0, j * KT, bh);
        tma_load_3d(dst + L::KV, &tmap_v, bar, 0, j * KT, bh);
        if constexpr (DROP)
          bulk_load(dst + 2 * L::KV,
                    keep_mask + (((size_t)bh * n_k + j) * n_q + 2 * blockIdx.x) * MASK_WORDS,
                    bar, mtiles * MASK_BYTES);
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
    const int r0 = blockIdx.x * Q_ROWS + c * 64 + warp * 16 + 2 * g;
    const int r1 = r0 + 1;
    const bf* qb = static_cast<const bf*>(a.q) + (size_t)bh * a.sq * D;
    const bf* dob = static_cast<const bf*>(a.dout) + (size_t)bh * a.sq * D;

    // q_scaled and dO rows as A operands (q rows x d), held for the whole loop
    uint32_t qa[D / 16][4], da[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int col = kk * 16 + 2 * t;
      qa[kk][0] = load_q_pair(qb, r0, col, a.sq, D, a.scale);
      qa[kk][1] = load_q_pair(qb, r1, col, a.sq, D, a.scale);
      qa[kk][2] = load_q_pair(qb, r0, col + 8, a.sq, D, a.scale);
      qa[kk][3] = load_q_pair(qb, r1, col + 8, a.sq, D, a.scale);
      da[kk][0] = gaot::fbwd::load_pair(dob, r0, col, a.sq, D);
      da[kk][1] = gaot::fbwd::load_pair(dob, r1, col, a.sq, D);
      da[kk][2] = gaot::fbwd::load_pair(dob, r0, col + 8, a.sq, D);
      da[kk][3] = gaot::fbwd::load_pair(dob, r1, col + 8, a.sq, D);
    }
    // lse * log2(e), +inf past sq so that p = 0 there
    const float l0 = r0 < a.sq ? a.lse[(size_t)bh * a.sq + r0] * LOG2E : INFINITY;
    const float l1 = r1 < a.sq ? a.lse[(size_t)bh * a.sq + r1] * LOG2E : INFINITY;
    const float d0 = r0 < a.sq ? a.delta[(size_t)bh * a.sq + r0] : 0.f;
    const float d1 = r1 < a.sq ? a.delta[(size_t)bh * a.sq + r1] : 0.f;
    // this thread's q pair in the consumer's mask tile is qp = warp * 8 + g:
    // block (qp, key pair nb * 4 + t) is nibble qp >> 2 of word
    // 4 (nb * 4 + t) + (qp & 3)
    const int mword = 4 * t + (g & 3);
    const int mshift = 4 * (warp * 2 + (g >> 2));

    float dq[D / 2];  // [nd * 4 + e]: rows (r0, r1) x columns nd * 8 + 2t + (0, 1)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    float sc[KT / 2], dp[KT / 2];  // S then ds, and dP, of one tile: [nb * 4 + e]
    uint32_t dsa[KT / 16][4];      // ds of the previous tile as the A operand of ds K

    auto issue_sdp = [&](int j) {  // S and dP of tile j
      const uint32_t kt = base + (j % Q_STAGES) * L::STAGE, vt = kt + L::KV;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_rs<0>(sc, qa[kk], wgmma_desc(kt + kk * 32, RB, false), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_rs<0>(dp, da[kk], wgmma_desc(vt + kk * 32, RB, false), kk > 0);
      wgmma_commit();
    };
    auto issue_dq = [&](int j) {  // dq += ds K of tile j, ds in dsa
      const uint32_t kt = base + (j % Q_STAGES) * L::STAGE;
#pragma unroll
      for (int jj = 0; jj < KT / 16; ++jj)
        wgmma_rs<1>(dq, dsa[jj], wgmma_desc(kt + jj * 16 * RB, RB, true), 1);
      wgmma_commit();
    };
    auto compute_ds = [&](int j) {  // sc of tile j -> ds, in place
      const int kv0 = j * KT;
      const uint32_t* mw = reinterpret_cast<const uint32_t*>(
          sm + (j % Q_STAGES) * L::STAGE + 2 * L::KV + c * MASK_BYTES);
#pragma unroll
      for (int nb = 0; nb < NS; ++nb) {
        float* p = sc + nb * 4;
        const float* dv = dp + nb * 4;
        // elements: [0] (r0, c0), [1] (r0, c0 + 1), [2] (r1, c0), [3] (r1, c0 + 1)
        float p0 = ex2_ftz(fmaf(p[0], LOG2E, -l0));
        float p1 = ex2_ftz(fmaf(p[1], LOG2E, -l0));
        float p2 = ex2_ftz(fmaf(p[2], LOG2E, -l1));
        float p3 = ex2_ftz(fmaf(p[3], LOG2E, -l1));
        if (kv0 + KT > a.skv) {  // ragged kv tail
          const int c0 = kv0 + nb * 8 + 2 * t;
          if (c0 >= a.skv) p0 = p2 = 0.f;
          if (c0 + 1 >= a.skv) p1 = p3 = 0.f;
        }
        float m0 = 1.f, m1 = 1.f, m2 = 1.f, m3 = 1.f;
        if constexpr (DROP) {
          const uint32_t b = mw[16 * nb + mword] >> mshift;
          m0 = (b & 1u) ? inv_keep : 0.f;
          m1 = (b & 2u) ? inv_keep : 0.f;
          m2 = (b & 4u) ? inv_keep : 0.f;
          m3 = (b & 8u) ? inv_keep : 0.f;
        }
        p[0] = p0 * (dv[0] * m0 - d0);
        p[1] = p1 * (dv[1] * m1 - d0);
        p[2] = p2 * (dv[2] * m2 - d1);
        p[3] = p3 * (dv[3] * m3 - d1);
      }
    };
    auto pack_ds = [&]() {  // ds rounded to bf16 into dsa
      // k-step jj of ds K covers the key blocks 2jj (columns 0-7) and 2jj + 1 (8-15)
#pragma unroll
      for (int nb = 0; nb < NS; ++nb) {
        dsa[nb / 2][(nb % 2) * 2 + 0] = pack_bf16(sc[nb * 4 + 0], sc[nb * 4 + 1]);
        dsa[nb / 2][(nb % 2) * 2 + 1] = pack_bf16(sc[nb * 4 + 2], sc[nb * 4 + 3]);
      }
    };

    // ping-pong as in K1: consumer c issues its products after named barrier
    // 1 + c, then lets the other one issue (barrier 2 - c); consumer 1 lets
    // consumer 0 go first. Each syncs n_k + 1 times and is arrived at as often.
    if (c == 1) named_arrive(1, 2 * WG);
    mbar_wait(smem_u32(&full[0]), 0);
    named_sync(1 + c, 2 * WG);
    wgmma_fence();
    issue_sdp(0);
    named_arrive(2 - c, 2 * WG);
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    compute_ds(0);
    pack_ds();
    // step j: S, dP of tile j and ds K of tile j - 1 in flight together; the
    // exponentials of tile j run while ds K of tile j - 1 is on the tensor cores
    for (int j = 1; j < n_k; ++j) {
      mbar_wait(smem_u32(&full[j % Q_STAGES]), (j / Q_STAGES) & 1);
      named_sync(1 + c, 2 * WG);
      wgmma_fence();
      issue_sdp(j);
      issue_dq(j - 1);
      named_arrive(2 - c, 2 * WG);
      wgmma_wait<1>();
      fence_regs(sc);
      fence_regs(dp);
      compute_ds(j);
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(dsa);
      if (lane == 0) mbar_arrive(smem_u32(&empty[(j - 1) % Q_STAGES]));
      pack_ds();
    }
    named_sync(1 + c, 2 * WG);
    wgmma_fence();
    issue_dq(n_k - 1);
    if (c == 0) named_arrive(2 - c, 2 * WG);
    wgmma_wait<0>();
    fence_regs(dq);

    bf* dqb = static_cast<bf*>(a.dq) + (size_t)bh * a.sq * D;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const int col = nd * 8 + 2 * t;
      if (r0 < a.sq)
        *reinterpret_cast<uint32_t*>(dqb + (size_t)r0 * D + col) =
            pack_bf16(dq[nd * 4 + 0] * a.scale, dq[nd * 4 + 1] * a.scale);
      if (r1 < a.sq)
        *reinterpret_cast<uint32_t*>(dqb + (size_t)r1 * D + col) =
            pack_bf16(dq[nd * 4 + 2] * a.scale, dq[nd * 4 + 3] * a.scale);
    }
  }
}

template <int D, bool DROP>
int launch_dq_wgmma(const SplitArgs& a, int bh, const uint32_t* keep_mask, float inv_keep,
                    cudaStream_t stream) {
  CUtensorMap tk, tv;
  if (!gaot::bf16_rows_map(&tk, a.k, bh, a.skv, D, KT) ||
      !gaot::bf16_rows_map(&tv, a.v, bh, a.skv, D, KT))
    return (int)cudaErrorInvalidValue;
  constexpr size_t bytes = DqSmem<D, DROP>::bytes;
  auto kern = bwd_dq_wgmma_kernel<D, DROP>;
  const cudaError_t e = allow_smem(kern, bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3((a.sq + Q_ROWS - 1) / Q_ROWS, bh), B_THREADS, bytes, stream>>>(tk, tv, a,
                                                                            keep_mask, inv_keep);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const SplitArgs& a, int bh, const uint32_t* keep_mask, float inv_keep,
              cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf> && D % 16 == 0) {
    if (keep_mask != nullptr) return launch_dq_wgmma<D, true>(a, bh, keep_mask, inv_keep, stream);
    return launch_dq_wgmma<D, false>(a, bh, nullptr, inv_keep, stream);
  } else {
    constexpr size_t bytes = dq_scalar_smem_bytes<D>();
    const cudaError_t e = allow_smem(bwd_dq_kernel<T, D>, bytes);
    if (e != cudaSuccess) return (int)e;
    bwd_dq_kernel<T, D><<<dim3(mask_tiles(a.sq), bh), TILE, bytes, stream>>>(a, keep_mask,
                                                                             inv_keep);
    return (int)cudaGetLastError();
  }
}

template <typename T, int D>
int launch_dkv(const SplitArgs& a, int bh, bool drop, const DropoutParams& dp,
               uint32_t* keep_mask, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf> && D % 16 == 0) {
    const gaot::fbwd::BwdArgs b{a.q, a.k, a.v, a.dout, a.lse, a.delta, nullptr, a.dk, a.dv,
                                a.sq, a.skv, a.scale};
    if (drop) return gaot::fbwd::launch_wgmma<D, true, false>(b, bh, dp, keep_mask, stream);
    return gaot::fbwd::launch_wgmma<D, false, false>(b, bh, dp, nullptr, stream);
  } else {
    constexpr size_t bytes = dkv_scalar_smem_bytes<D>();
    const cudaError_t e = allow_smem(bwd_dkv_kernel<T, D>, bytes);
    if (e != cudaSuccess) return (int)e;
    bwd_dkv_kernel<T, D><<<dim3(mask_tiles(a.skv), bh), TILE, bytes, stream>>>(a, drop, dp,
                                                                               keep_mask);
    return (int)cudaGetLastError();
  }
}

bool valid_sizes(int bh, int sq, int skv) {
  return bh > 0 && bh <= 65535 && sq > 0 && skv > 0;
}

}  // namespace

extern "C" {

// q, dout [bh, sq, d], k, v [bh, skv, d] in one type (dtype 0: float32,
// 1: bfloat16); lse, delta [bh, sq] float32; all contiguous. keep_mask is
// uint32 [bh, ceil(skv / 64), ceil(sq / 64), 128] (flash_bwd_wgmma.cuh), 16-byte
// aligned, when drop != 0, else unused. Each returns its launch's cudaError_t
// (0 on success).

// dk, dv [bh, skv, d] in the input type, every element written; under
// dropout (the arguments of gaot_flash_attn_fwd) every word of keep_mask too.
int gaot_flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dk, void* dv,
                            void* keep_mask, int bh, int sq, int skv, int d, int dtype,
                            float scale, int drop, const void* bits, unsigned int seed_lo,
                            unsigned int seed_hi, unsigned int thresh, float inv_keep,
                            void* stream) {
  if (!valid_sizes(bh, sq, skv) || (drop != 0 && keep_mask == nullptr))
    return (int)cudaErrorInvalidValue;
  const SplitArgs a{q, k, v, dout, static_cast<const float*>(lse),
                    static_cast<const float*>(delta), nullptr, dk, dv, sq, skv, scale};
  const DropoutParams dp{static_cast<const uint32_t*>(bits), seed_lo, seed_hi, thresh,
                         inv_keep};
  uint32_t* m = static_cast<uint32_t*>(keep_mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dr = drop != 0;
#define GAOT_DKV_CASE(T, DIM) \
  case DIM: return launch_dkv<T, DIM>(a, bh, dr, dp, m, s)
  if (dtype == 0) {
    switch (d) {
      GAOT_DKV_CASE(float, 8);
      GAOT_DKV_CASE(float, 16);
      GAOT_DKV_CASE(float, 32);
      GAOT_DKV_CASE(float, 64);
    }
  } else if (dtype == 1) {
    switch (d) {
      GAOT_DKV_CASE(bf, 8);
      GAOT_DKV_CASE(bf, 16);
      GAOT_DKV_CASE(bf, 32);
      GAOT_DKV_CASE(bf, 64);
    }
  }
#undef GAOT_DKV_CASE
  return (int)cudaErrorInvalidValue;
}

// dq [bh, sq, d] in the input type, every element written; drop != 0 reads
// the keep mask the dk/dv kernel wrote, a kept score scaled by inv_keep.
int gaot_flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dq,
                           const void* keep_mask, int bh, int sq, int skv, int d, int dtype,
                           float scale, int drop, float inv_keep, void* stream) {
  if (!valid_sizes(bh, sq, skv) || (drop != 0 && keep_mask == nullptr))
    return (int)cudaErrorInvalidValue;
  const SplitArgs a{q, k, v, dout, static_cast<const float*>(lse),
                    static_cast<const float*>(delta), dq, nullptr, nullptr, sq, skv, scale};
  const uint32_t* m = drop != 0 ? static_cast<const uint32_t*>(keep_mask) : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GAOT_DQ_CASE(T, DIM) \
  case DIM: return launch_dq<T, DIM>(a, bh, m, inv_keep, s)
  if (dtype == 0) {
    switch (d) {
      GAOT_DQ_CASE(float, 8);
      GAOT_DQ_CASE(float, 16);
      GAOT_DQ_CASE(float, 32);
      GAOT_DQ_CASE(float, 64);
    }
  } else if (dtype == 1) {
    switch (d) {
      GAOT_DQ_CASE(bf, 8);
      GAOT_DQ_CASE(bf, 16);
      GAOT_DQ_CASE(bf, 32);
      GAOT_DQ_CASE(bf, 64);
    }
  }
#undef GAOT_DQ_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
