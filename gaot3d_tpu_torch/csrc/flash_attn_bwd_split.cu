// Split flash-attention backward for Hopper (sm_90a): a dq kernel and a dk/dv
// kernel, no shared accumulator, the same bits on every launch.
//
// Replaces gaot3d_tpu/ops/pallas_attention.py `_flash_bwd_impl`, split calls
// (kernels `_make_bwd_dq_kernel` and `_make_bwd_dkv_kernel`). Given q, k, v,
// dO, the forward's lse and delta = rowsum(dO * O) (f32, a plain reduction
// outside, as in the JAX code), per (q tile, key tile) both kernels recompute
//     s   = q_scaled k^T          (q prescaled by 1/sqrt(D) in f32, rounded back)
//     p   = exp(s - lse)          (0 on padded keys and padded q rows)
//     dpv = dO v^T
//     km  = keep ? 1/(1-rate) : 0 (the forward's mask, regenerated; 1 at rate 0)
//     pm  = p km,   ds = p (dpv km - delta)
// and then
//     dq kernel:    dq  = scale * sum over keys of ds k   (ds rounded to the input type)
//     dk/dv kernel: dv  = sum over q rows of pm^T dO      (pm rounded to dO's type)
//                   dk  = sum over q rows of ds^T q_scaled
//
// On the TPU this pair is the fallback for heads whose dq does not fit VMEM.
// Here it is the backward whose results repeat: the fused kernel
// (flash_attn_bwd.cu) adds dq tiles with float atomics in a run-dependent
// order, these two add nothing across CTAs. The dq kernel's CTA owns 64 q
// rows of one (batch, head), walks every key tile and keeps dq in registers,
// rounding it once on the way out; the dk/dv kernel's CTA owns 64 keys, walks
// every q tile and keeps dk and dv in registers. Every sum runs in program
// order. The price is that s, p, dpv and the mask are computed twice.
//
// Each kernel has two bodies, as the fused one:
//   - bf16 with head dim 16/32/64 (the main path), on mma.sync.m16n8k16. The
//     dq kernel takes s and dpv with q rows as the M dimension, so the ds
//     accumulator fragment is directly the A operand of ds k (registers only;
//     K sits in shared memory row-major for s and transposed for dq, V
//     row-major). The dk/dv kernel takes them transposed, keys as M, so pm^T
//     and ds^T are directly the A operands of its two products. In both,
//     fragment rows (g, g + 8) hold rows (2g, 2g + 1) of the warp's 16, so a
//     thread's four scores per 8-column block are one 2x2 block of the
//     dropout stream: one Philox call (philox.cuh), as in the forward.
//   - f32, and bf16 at head dim 8: scalar f32 FMAs, one thread per q row (dq)
//     or per key (dk/dv).
//
// What bounds them on an H100: at B1 H8 S16384 D32 each kernel recomputes
// 2.1e9 exponentials and, with dropout, 5.4e8 Philox calls; the dq kernel does
// three tile products and the dk/dv kernel four (seven against the fused
// kernel's five). Double-buffered loads and wgmma are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "philox.cuh"

namespace {

using gaot::DropoutParams;
using bf = __nv_bfloat16;

constexpr int TILE = 64;  // rows a CTA owns, and rows per step of its loop
constexpr float LOG2E = 1.4426950408889634f;

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

// ---------------------------------------------------------------------------
// Scalar dq body: 64 threads, thread = q row. K and V tiles pass through
// shared memory (every lane reads the same key: a broadcast); the thread's
// q_scaled and dO rows sit in shared memory at a stride of D + 1, dq in
// registers.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(TILE)
    bwd_dq_kernel(SplitArgs a, bool drop, DropoutParams dp) {
  constexpr int RS = D + 1;
  extern __shared__ float smem[];
  float* ks = smem;            // [TILE][D]
  float* vs = ks + TILE * D;   // [TILE][D]
  float* qs = vs + TILE * D;   // [TILE][RS]
  float* dos = qs + TILE * RS; // [TILE][RS]

  const int bh = blockIdx.y;
  const int i = threadIdx.x;
  const int q0 = blockIdx.x * TILE;
  const int row = q0 + i;
  const bool row_in = row < a.sq;
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
  const float kept = drop ? dp.inv_keep : 1.f;
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
    __syncthreads();

    float km_even = kept, km_odd = kept;  // keys kv0 + j, j even / odd
#pragma unroll 1
    for (int j = 0; j < TILE; ++j) {
      const int key = kv0 + j;
      if (drop && (j & 1) == 0) {
        uint32_t w[4];
        gaot::dropout_block_bits(dp, bh, row, key, a.sq, a.skv, w);
        km_even = w[(row & 1) * 2] >= dp.thresh ? kept : 0.f;
        km_odd = w[(row & 1) * 2 + 1] >= dp.thresh ? kept : 0.f;
      }
      const float km = (j & 1) ? km_odd : km_even;
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
  return sizeof(float) * (2 * TILE * D + 2 * TILE * (D + 1));
}

// ---------------------------------------------------------------------------
// Scalar dk/dv body: 64 threads, thread = key. The thread's k and v rows sit
// in shared memory at a stride of D + 1, the q_scaled and dO tiles are read
// by every lane at once, dk and dv rows in registers.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(TILE)
    bwd_dkv_kernel(SplitArgs a, bool drop, DropoutParams dp) {
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

    float km_even = kept, km_odd = kept;  // rows q0 + i, i even / odd
#pragma unroll 1
    for (int i = 0; i < TILE; ++i) {
      const int row = q0 + i;
      if (drop && (i & 1) == 0) {
        uint32_t w[4];
        gaot::dropout_block_bits(dp, bh, row, key, a.sq, a.skv, w);
        km_even = w[key & 1] >= dp.thresh ? kept : 0.f;
        km_odd = w[2 + (key & 1)] >= dp.thresh ? kept : 0.f;
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
// bf16 tensor-core bodies, 4 warps each. See the header for the layouts.
// ---------------------------------------------------------------------------
constexpr int MMA_WARPS = 4;
constexpr int NT = MMA_WARPS * 32;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t load_pair(const bf* base, int row, int col, int rows,
                                              int d) {
  if (row >= rows) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + (size_t)row * d + col);
}

// two q elements (row, col..col+1), prescaled in f32 and rounded back to bf16
__device__ __forceinline__ uint32_t load_q_pair(const bf* qb, int row, int col, int sq, int d,
                                                float scale) {
  if (row >= sq) return 0u;
  const float2 x =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qb + (size_t)row * d + col));
  return pack_bf16(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale));
}

// dq: rows = this warp's 16 q rows, fragment rows (g, g + 8) = q rows
// (r0, r0 + 1); the loop runs over key tiles.
template <int D, bool DROP>
__global__ void __launch_bounds__(NT) bwd_dq_mma_kernel(SplitArgs a, DropoutParams dp) {
  constexpr int RS = D + 8;     // row stride of the row-major k, v tiles
  constexpr int TS = TILE + 8;  // row stride of k^T
  constexpr int CH = D / 8;     // 16-byte chunks per row
  __shared__ __align__(16) bf ks[TILE * RS];
  __shared__ __align__(16) bf vs[TILE * RS];
  __shared__ __align__(16) bf kt[D * TS];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int r0 = blockIdx.x * TILE + warp * 16 + 2 * g;
  const int r1 = r0 + 1;
  const bf* qb = static_cast<const bf*>(a.q) + (size_t)bh * a.sq * D;
  const bf* kb = static_cast<const bf*>(a.k) + (size_t)bh * a.skv * D;
  const bf* vb = static_cast<const bf*>(a.v) + (size_t)bh * a.skv * D;
  const bf* dob = static_cast<const bf*>(a.dout) + (size_t)bh * a.sq * D;

  // q_scaled and dO rows of this warp as A operands (q rows x d), held for the whole loop
  uint32_t qa[D / 16][4], da[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = load_q_pair(qb, r0, c, a.sq, D, a.scale);
    qa[kk][1] = load_q_pair(qb, r1, c, a.sq, D, a.scale);
    qa[kk][2] = load_q_pair(qb, r0, c + 8, a.sq, D, a.scale);
    qa[kk][3] = load_q_pair(qb, r1, c + 8, a.sq, D, a.scale);
    da[kk][0] = load_pair(dob, r0, c, a.sq, D);
    da[kk][1] = load_pair(dob, r1, c, a.sq, D);
    da[kk][2] = load_pair(dob, r0, c + 8, a.sq, D);
    da[kk][3] = load_pair(dob, r1, c + 8, a.sq, D);
  }
  // lse * log2(e), +inf past sq so that p = 0 there
  const float l0 = r0 < a.sq ? a.lse[(size_t)bh * a.sq + r0] * LOG2E : INFINITY;
  const float l1 = r1 < a.sq ? a.lse[(size_t)bh * a.sq + r1] * LOG2E : INFINITY;
  const float d0 = r0 < a.sq ? a.delta[(size_t)bh * a.sq + r0] : 0.f;
  const float d1 = r1 < a.sq ? a.delta[(size_t)bh * a.sq + r1] : 0.f;

  float dq[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) dq[nd][0] = dq[nd][1] = dq[nd][2] = dq[nd][3] = 0.f;

  for (int kv0 = 0; kv0 < a.skv; kv0 += TILE) {
    __syncthreads();  // every warp is done with the previous tile
    for (int c = threadIdx.x; c < TILE * CH; c += NT) {
      const int row = c / CH, ch = c - row * CH;
      const int key = kv0 + row;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
      if (key < a.skv) {
        kx = *reinterpret_cast<const uint4*>(kb + (size_t)key * D + ch * 8);
        vx = *reinterpret_cast<const uint4*>(vb + (size_t)key * D + ch * 8);
      }
      *reinterpret_cast<uint4*>(ks + row * RS + ch * 8) = kx;
      *reinterpret_cast<uint4*>(vs + row * RS + ch * 8) = vx;
      const bf* ke = reinterpret_cast<const bf*>(&kx);
#pragma unroll
      for (int e = 0; e < 8; ++e) kt[(ch * 8 + e) * TS + row] = ke[e];
    }
    __syncthreads();

    // ds (q rows x keys) as the A operand of dq = ds k: k-step j covers the
    // key blocks 2j (columns 0-7) and 2j + 1 (columns 8-15)
    uint32_t dsa[TILE / 16][4];
#pragma unroll
    for (int nb = 0; nb < TILE / 8; ++nb) {
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dpv[4] = {0.f, 0.f, 0.f, 0.f};
      const bf* krow = ks + (nb * 8 + g) * RS + 2 * t;
      const bf* vrow = vs + (nb * 8 + g) * RS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        mma_bf16(s, qa[kk], *reinterpret_cast<const uint32_t*>(krow + kk * 16),
                 *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8));
        mma_bf16(dpv, da[kk], *reinterpret_cast<const uint32_t*>(vrow + kk * 16),
                 *reinterpret_cast<const uint32_t*>(vrow + kk * 16 + 8));
      }
      const int c0 = kv0 + nb * 8 + 2 * t;  // keys c0, c0 + 1
      // elements: [0] (r0, c0), [1] (r0, c0 + 1), [2] (r1, c0), [3] (r1, c0 + 1)
      float p0 = exp2f(fmaf(s[0], LOG2E, -l0));
      float p1 = exp2f(fmaf(s[1], LOG2E, -l0));
      float p2 = exp2f(fmaf(s[2], LOG2E, -l1));
      float p3 = exp2f(fmaf(s[3], LOG2E, -l1));
      if (c0 >= a.skv) p0 = p2 = 0.f;  // padded keys
      if (c0 + 1 >= a.skv) p1 = p3 = 0.f;
      float km[4] = {1.f, 1.f, 1.f, 1.f};
      if constexpr (DROP) gaot::dropout_block_scale(dp, bh, r0, c0, a.sq, a.skv, km);
      dsa[nb / 2][(nb % 2) * 2 + 0] =
          pack_bf16(p0 * (dpv[0] * km[0] - d0), p1 * (dpv[1] * km[1] - d0));
      dsa[nb / 2][(nb % 2) * 2 + 1] =
          pack_bf16(p2 * (dpv[2] * km[2] - d1), p3 * (dpv[3] * km[3] - d1));
    }
#pragma unroll
    for (int j = 0; j < TILE / 16; ++j) {
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const bf* krow = kt + (nd * 8 + g) * TS + j * 16 + 2 * t;
        mma_bf16(dq[nd], dsa[j], *reinterpret_cast<const uint32_t*>(krow),
                 *reinterpret_cast<const uint32_t*>(krow + 8));
      }
    }
  }

  bf* dqb = static_cast<bf*>(a.dq) + (size_t)bh * a.sq * D;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (r0 < a.sq)
      *reinterpret_cast<uint32_t*>(dqb + (size_t)r0 * D + col) =
          pack_bf16(dq[nd][0] * a.scale, dq[nd][1] * a.scale);
    if (r1 < a.sq)
      *reinterpret_cast<uint32_t*>(dqb + (size_t)r1 * D + col) =
          pack_bf16(dq[nd][2] * a.scale, dq[nd][3] * a.scale);
  }
}

// dk/dv: rows = this warp's 16 keys, fragment rows (g, g + 8) = keys
// (k0, k0 + 1); the loop runs over q tiles. The fused kernel's structure
// without its dq product, the ds round trip through shared memory and the
// atomics.
template <int D>
struct DkvSmem {
  static constexpr int RS = D + 8;     // row stride of the row-major q, dO tiles
  static constexpr int TS = TILE + 8;  // row stride of the transposed tiles
  static constexpr int qs = 0;                // [TILE][RS]  q_scaled
  static constexpr int dos = qs + TILE * RS;  // [TILE][RS]  dO
  static constexpr int qt = dos + TILE * RS;  // [D][TS]     q_scaled^T
  static constexpr int dot = qt + D * TS;     // [D][TS]     dO^T
  static constexpr int halves = dot + D * TS;
  static constexpr size_t bytes = halves * sizeof(bf) + 2 * TILE * sizeof(float);
};

template <int D, bool DROP>
__global__ void __launch_bounds__(NT) bwd_dkv_mma_kernel(SplitArgs a, DropoutParams dp) {
  using L = DkvSmem<D>;
  constexpr int RS = L::RS, TS = L::TS;
  constexpr int CH = D / 8;
  __shared__ __align__(16) unsigned char smem_raw[L::bytes];
  bf* sm = reinterpret_cast<bf*>(smem_raw);
  bf* qs = sm + L::qs;
  bf* dos = sm + L::dos;
  bf* qt = sm + L::qt;
  bf* dot = sm + L::dot;
  float* lse_s = reinterpret_cast<float*>(sm + L::halves);  // lse * log2(e), +inf past sq
  float* dl_s = lse_s + TILE;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * TILE + warp * 16 + 2 * g, k1 = k0 + 1;
  const bf* qb = static_cast<const bf*>(a.q) + (size_t)bh * a.sq * D;
  const bf* kb = static_cast<const bf*>(a.k) + (size_t)bh * a.skv * D;
  const bf* vb = static_cast<const bf*>(a.v) + (size_t)bh * a.skv * D;
  const bf* dob = static_cast<const bf*>(a.dout) + (size_t)bh * a.sq * D;

  // k and v rows of this warp as A operands (keys x d), held for the whole loop
  uint32_t ka[D / 16][4], va[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    ka[kk][0] = load_pair(kb, k0, c, a.skv, D);
    ka[kk][1] = load_pair(kb, k1, c, a.skv, D);
    ka[kk][2] = load_pair(kb, k0, c + 8, a.skv, D);
    ka[kk][3] = load_pair(kb, k1, c + 8, a.skv, D);
    va[kk][0] = load_pair(vb, k0, c, a.skv, D);
    va[kk][1] = load_pair(vb, k1, c, a.skv, D);
    va[kk][2] = load_pair(vb, k0, c + 8, a.skv, D);
    va[kk][3] = load_pair(vb, k1, c + 8, a.skv, D);
  }

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    dk[nd][0] = dk[nd][1] = dk[nd][2] = dk[nd][3] = 0.f;
    dv[nd][0] = dv[nd][1] = dv[nd][2] = dv[nd][3] = 0.f;
  }

  for (int q0 = 0; q0 < a.sq; q0 += TILE) {
    __syncthreads();  // every warp is done with the previous tile
    for (int c = threadIdx.x; c < TILE * CH; c += NT) {
      const int row = c / CH, ch = c - row * CH;
      const int qrow = q0 + row;
      uint4 qx = make_uint4(0, 0, 0, 0), dx = make_uint4(0, 0, 0, 0);
      if (qrow < a.sq) {
        qx = *reinterpret_cast<const uint4*>(qb + (size_t)qrow * D + ch * 8);
        dx = *reinterpret_cast<const uint4*>(dob + (size_t)qrow * D + ch * 8);
      }
      bf* qe = reinterpret_cast<bf*>(&qx);
#pragma unroll
      for (int e = 0; e < 8; ++e)  // prescale in f32, round back
        qe[e] = __float2bfloat16(__fmul_rn(__bfloat162float(qe[e]), a.scale));
      const bf* de = reinterpret_cast<const bf*>(&dx);
      *reinterpret_cast<uint4*>(qs + row * RS + ch * 8) = qx;
      *reinterpret_cast<uint4*>(dos + row * RS + ch * 8) = dx;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        qt[(ch * 8 + e) * TS + row] = qe[e];
        dot[(ch * 8 + e) * TS + row] = de[e];
      }
    }
    if (threadIdx.x < TILE) {
      const int qrow = q0 + threadIdx.x;
      const bool in = qrow < a.sq;
      lse_s[threadIdx.x] = in ? a.lse[(size_t)bh * a.sq + qrow] * LOG2E : INFINITY;
      dl_s[threadIdx.x] = in ? a.delta[(size_t)bh * a.sq + qrow] : 0.f;
    }
    __syncthreads();

    // pm^T and ds^T (keys x q rows) as A operands of the dv and dk products
    uint32_t pma[TILE / 16][4], dsa[TILE / 16][4];
#pragma unroll
    for (int nb = 0; nb < TILE / 8; ++nb) {
      float st[4] = {0.f, 0.f, 0.f, 0.f}, dpv[4] = {0.f, 0.f, 0.f, 0.f};
      const bf* qrow = qs + (nb * 8 + g) * RS + 2 * t;
      const bf* drow = dos + (nb * 8 + g) * RS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        mma_bf16(st, ka[kk], *reinterpret_cast<const uint32_t*>(qrow + kk * 16),
                 *reinterpret_cast<const uint32_t*>(qrow + kk * 16 + 8));
        mma_bf16(dpv, va[kk], *reinterpret_cast<const uint32_t*>(drow + kk * 16),
                 *reinterpret_cast<const uint32_t*>(drow + kk * 16 + 8));
      }
      const int ql = nb * 8 + 2 * t;  // q columns ql, ql + 1 of the tile
      const float l0 = lse_s[ql], l1 = lse_s[ql + 1];
      const float d0 = dl_s[ql], d1 = dl_s[ql + 1];
      // elements: [0] (k0, ql), [1] (k0, ql + 1), [2] (k1, ql), [3] (k1, ql + 1)
      float p0 = exp2f(fmaf(st[0], LOG2E, -l0));
      float p1 = exp2f(fmaf(st[1], LOG2E, -l1));
      float p2 = exp2f(fmaf(st[2], LOG2E, -l0));
      float p3 = exp2f(fmaf(st[3], LOG2E, -l1));
      if (k0 >= a.skv) p0 = p1 = 0.f;  // padded keys
      if (k1 >= a.skv) p2 = p3 = 0.f;
      float m0 = 1.f, m1 = 1.f, m2 = 1.f, m3 = 1.f;
      if constexpr (DROP) {
        // the stream's block is (q row, key): words (even q, even key),
        // (even q, odd key), (odd q, even key), (odd q, odd key)
        float km[4];
        gaot::dropout_block_scale(dp, bh, q0 + ql, k0, a.sq, a.skv, km);
        m0 = km[0];
        m2 = km[1];
        m1 = km[2];
        m3 = km[3];
      }
      pma[nb / 2][(nb % 2) * 2 + 0] = pack_bf16(p0 * m0, p1 * m1);
      pma[nb / 2][(nb % 2) * 2 + 1] = pack_bf16(p2 * m2, p3 * m3);
      dsa[nb / 2][(nb % 2) * 2 + 0] =
          pack_bf16(p0 * (dpv[0] * m0 - d0), p1 * (dpv[1] * m1 - d1));
      dsa[nb / 2][(nb % 2) * 2 + 1] =
          pack_bf16(p2 * (dpv[2] * m2 - d0), p3 * (dpv[3] * m3 - d1));
    }

    // dv += pm^T dO, dk += ds^T q_scaled (contraction over the tile's q rows)
#pragma unroll
    for (int j = 0; j < TILE / 16; ++j) {
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const bf* drow = dot + (nd * 8 + g) * TS + j * 16 + 2 * t;
        const bf* qrow = qt + (nd * 8 + g) * TS + j * 16 + 2 * t;
        mma_bf16(dv[nd], pma[j], *reinterpret_cast<const uint32_t*>(drow),
                 *reinterpret_cast<const uint32_t*>(drow + 8));
        mma_bf16(dk[nd], dsa[j], *reinterpret_cast<const uint32_t*>(qrow),
                 *reinterpret_cast<const uint32_t*>(qrow + 8));
      }
    }
  }

  bf* dkb = static_cast<bf*>(a.dk) + (size_t)bh * a.skv * D;
  bf* dvb = static_cast<bf*>(a.dv) + (size_t)bh * a.skv * D;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (k0 < a.skv) {
      *reinterpret_cast<uint32_t*>(dkb + (size_t)k0 * D + col) = pack_bf16(dk[nd][0], dk[nd][1]);
      *reinterpret_cast<uint32_t*>(dvb + (size_t)k0 * D + col) = pack_bf16(dv[nd][0], dv[nd][1]);
    }
    if (k1 < a.skv) {
      *reinterpret_cast<uint32_t*>(dkb + (size_t)k1 * D + col) = pack_bf16(dk[nd][2], dk[nd][3]);
      *reinterpret_cast<uint32_t*>(dvb + (size_t)k1 * D + col) = pack_bf16(dv[nd][2], dv[nd][3]);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D, bool DQ>
int launch(const SplitArgs& a, int bh, bool drop, const DropoutParams& dp,
           cudaStream_t stream) {
  const dim3 grid(((DQ ? a.sq : a.skv) + TILE - 1) / TILE, bh);
  if constexpr (std::is_same_v<T, bf> && D % 16 == 0) {
    if constexpr (DQ) {
      if (drop) bwd_dq_mma_kernel<D, true><<<grid, NT, 0, stream>>>(a, dp);
      else bwd_dq_mma_kernel<D, false><<<grid, NT, 0, stream>>>(a, dp);
    } else {
      if (drop) bwd_dkv_mma_kernel<D, true><<<grid, NT, 0, stream>>>(a, dp);
      else bwd_dkv_mma_kernel<D, false><<<grid, NT, 0, stream>>>(a, dp);
    }
  } else {
    cudaError_t e;
    if constexpr (DQ) {
      constexpr size_t bytes = dq_scalar_smem_bytes<D>();
      if ((e = allow_smem(bwd_dq_kernel<T, D>, bytes)) != cudaSuccess) return (int)e;
      bwd_dq_kernel<T, D><<<grid, TILE, bytes, stream>>>(a, drop, dp);
    } else {
      constexpr size_t bytes = dkv_scalar_smem_bytes<D>();
      if ((e = allow_smem(bwd_dkv_kernel<T, D>, bytes)) != cudaSuccess) return (int)e;
      bwd_dkv_kernel<T, D><<<grid, TILE, bytes, stream>>>(a, drop, dp);
    }
  }
  return (int)cudaGetLastError();
}

template <bool DQ>
int dispatch(const SplitArgs& a, int bh, int d, int dtype, bool drop, const DropoutParams& dp,
             cudaStream_t stream) {
  if (bh <= 0 || bh > 65535 || a.sq <= 0 || a.skv <= 0) return (int)cudaErrorInvalidValue;
#define GAOT_SPLIT_CASE(T, DIM) \
  case DIM: return launch<T, DIM, DQ>(a, bh, drop, dp, stream)
  if (dtype == 0) {
    switch (d) {
      GAOT_SPLIT_CASE(float, 8);
      GAOT_SPLIT_CASE(float, 16);
      GAOT_SPLIT_CASE(float, 32);
      GAOT_SPLIT_CASE(float, 64);
    }
  } else if (dtype == 1) {
    switch (d) {
      GAOT_SPLIT_CASE(bf, 8);
      GAOT_SPLIT_CASE(bf, 16);
      GAOT_SPLIT_CASE(bf, 32);
      GAOT_SPLIT_CASE(bf, 64);
    }
  }
#undef GAOT_SPLIT_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, dout [bh, sq, d], k, v [bh, skv, d] in one type (dtype 0: float32,
// 1: bfloat16); lse, delta [bh, sq] float32; all contiguous. The dropout
// arguments are those of gaot_flash_attn_fwd. Each returns its launch's
// cudaError_t (0 on success).

// dq [bh, sq, d] in the input type, every element written.
int gaot_flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dq, int bh, int sq,
                           int skv, int d, int dtype, float scale, int drop, const void* bits,
                           unsigned int seed_lo, unsigned int seed_hi, unsigned int thresh,
                           float inv_keep, void* stream) {
  const SplitArgs a{q, k, v, dout, static_cast<const float*>(lse),
                    static_cast<const float*>(delta), dq, nullptr, nullptr, sq, skv, scale};
  const DropoutParams dp{static_cast<const uint32_t*>(bits), seed_lo, seed_hi, thresh,
                         inv_keep};
  return dispatch<true>(a, bh, d, dtype, drop != 0, dp, static_cast<cudaStream_t>(stream));
}

// dk, dv [bh, skv, d] in the input type, every element written.
int gaot_flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dk, void* dv, int bh,
                            int sq, int skv, int d, int dtype, float scale, int drop,
                            const void* bits, unsigned int seed_lo, unsigned int seed_hi,
                            unsigned int thresh, float inv_keep, void* stream) {
  const SplitArgs a{q, k, v, dout, static_cast<const float*>(lse),
                    static_cast<const float*>(delta), nullptr, dk, dv, sq, skv, scale};
  const DropoutParams dp{static_cast<const uint32_t*>(bits), seed_lo, seed_hi, thresh,
                         inv_keep};
  return dispatch<false>(a, bh, d, dtype, drop != 0, dp, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
