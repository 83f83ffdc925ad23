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
// running (m, l, acc) in VMEM scratch. Here one CTA owns a 64-row q tile of
// one (batch, head) and walks every key tile in a loop, keeping m, l and acc
// in registers; K and V tiles pass through shared memory. Keys past the
// sequence end are masked to -inf in the last tile, and a row whose keys are
// all masked gets out = 0 instead of NaN. Two bodies share that structure:
//   - bf16 with head dim 16/32/64 (the main path): QK^T and PV on
//     mma.sync.m16n8k16 tensor-core instructions, 4 warps of 16 rows;
//   - f32, and bf16 at head dim 8: one thread per q row, scalar f32 FMAs,
//     every lane of a warp reading the same key (shared-memory broadcast).
//
// What bounds it on an H100: at the main-path shape (B1 H8 S16384 D32) a
// layer is 2.7e11 flops and 2.1e9 exponentials. With head dim 32 the matrix
// work per score is small, so the mma path is bound by the softmax (exp on
// the 16-per-clock special-function unit, max/sum/convert on the FMA pipe),
// not by the tensor cores, so it takes exponentials as exp2 of a fused
// multiply-add (one FFMA and one MUFU op a score). The scalar body is
// FMA-issue bound (about 60 TFLOP/s peak) and serves the f32 reference
// checks. Double-buffered tiles (cp.async or TMA) and wgmma are next.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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
// bf16 tensor-core path (head dims 16, 32, 64): the same algorithm with QK^T
// and PV on mma.sync.m16n8k16 (bf16 in, f32 accumulate). A CTA is 4 warps;
// each warp owns 16 q rows of the 64-row tile. The score fragment of QK^T is
// laid out exactly as the A operand of PV needs it, so P goes from the
// accumulator to the next product in registers. K sits in shared memory
// row-major and V transposed, both padded by 8 elements per row so that the
// fragment loads hit 32 distinct banks. Row max and row sum are reduced over
// the 4 lanes that share a row. Fragment rows (g, g + 8) hold the q rows
// (2g, 2g + 1) of the warp's 16, see the note on dropout above.
// ---------------------------------------------------------------------------
constexpr int MMA_WARPS = 4;
constexpr float LOG2E = 1.4426950408889634f;

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

// two q elements (row, col..col+1), prescaled in f32 and rounded back to bf16
__device__ __forceinline__ uint32_t load_q_pair(const __nv_bfloat16* qb, int row,
                                                int col, int sq, int d, float scale) {
  if (row >= sq) return 0u;
  const float2 x = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(qb + (size_t)row * d + col));
  return pack_bf16(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale));
}

template <int D, bool DROP>
__global__ void __launch_bounds__(MMA_WARPS * 32)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                         int sq, int skv, float scale, DropoutParams dp) {
  constexpr int KS = D + 8;        // K row stride (elements)
  constexpr int VS = BLOCK_N + 8;  // V^T row stride (elements)
  constexpr int NT = MMA_WARPS * 32;
  constexpr int CH = D / 8;        // 16-byte chunks per K/V row
  __shared__ __align__(16) __nv_bfloat16 ks[BLOCK_N * KS];
  __shared__ __align__(16) __nv_bfloat16 vt[D * VS];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row within the 8-row half of the fragment
  const int t = lane & 3;   // column pair
  const int bh = blockIdx.y;
  const int r0 = blockIdx.x * BLOCK_M + warp * 16 + 2 * g;
  const int r1 = r0 + 1;
  const __nv_bfloat16* qb = q + (size_t)bh * sq * D;
  const __nv_bfloat16* kb = k + (size_t)bh * skv * D;
  const __nv_bfloat16* vb = v + (size_t)bh * skv * D;

  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = load_q_pair(qb, r0, kk * 16 + 2 * t, sq, D, scale);
    qa[kk][1] = load_q_pair(qb, r1, kk * 16 + 2 * t, sq, D, scale);
    qa[kk][2] = load_q_pair(qb, r0, kk * 16 + 2 * t + 8, sq, D, scale);
    qa[kk][3] = load_q_pair(qb, r1, kk * 16 + 2 * t + 8, sq, D, scale);
  }
  float o[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float mp0 = -INFINITY, mp1 = -INFINITY;  // m * log2e of the previous tile

  for (int kv0 = 0; kv0 < skv; kv0 += BLOCK_N) {
    __syncthreads();
    for (int c = threadIdx.x; c < BLOCK_N * CH; c += NT) {
      const int row = c / CH;
      const int ch = c - row * CH;
      const int key = kv0 + row;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
      if (key < skv) {
        kx = *reinterpret_cast<const uint4*>(kb + (size_t)key * D + ch * 8);
        vx = *reinterpret_cast<const uint4*>(vb + (size_t)key * D + ch * 8);
      }
      *reinterpret_cast<uint4*>(ks + row * KS + ch * 8) = kx;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vx);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[(ch * 8 + e) * VS + row] = ve[e];
    }
    __syncthreads();

    float s[BLOCK_N / 8][4];
#pragma unroll
    for (int nb = 0; nb < BLOCK_N / 8; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
      const __nv_bfloat16* krow = ks + (nb * 8 + g) * KS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_bf16(s[nb], qa[kk], b0, b1);
      }
    }
    if (kv0 + BLOCK_N > skv) {  // ragged kv tail
#pragma unroll
      for (int nb = 0; nb < BLOCK_N / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (kv0 + nb * 8 + 2 * t + e >= skv) s[nb][e] = s[nb][2 + e] = -INFINITY;
        }
      }
    }
    float mt0 = -INFINITY, mt1 = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < BLOCK_N / 8; ++nb) {
      mt0 = fmaxf(mt0, fmaxf(s[nb][0], s[nb][1]));
      mt1 = fmaxf(mt1, fmaxf(s[nb][2], s[nb][3]));
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
    const float a0 = exp2f(mp0 - ms0), a1 = exp2f(mp1 - ms1);
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      o[nd][0] *= a0;
      o[nd][1] *= a0;
      o[nd][2] *= a1;
      o[nd][3] *= a1;
    }
    // P (rounded to bf16) as the A operand of PV: k-step j covers the score
    // blocks 2j (columns 0-7) and 2j+1 (columns 8-15)
    uint32_t pa[BLOCK_N / 16][4];
#pragma unroll
    for (int nb = 0; nb < BLOCK_N / 8; ++nb) {
      float p0 = exp2f(fmaf(s[nb][0], LOG2E, -ms0));
      float p1 = exp2f(fmaf(s[nb][1], LOG2E, -ms0));
      float p2 = exp2f(fmaf(s[nb][2], LOG2E, -ms1));
      float p3 = exp2f(fmaf(s[nb][3], LOG2E, -ms1));
      l0 += p0 + p1;  // the denominator sums the probabilities before dropout
      l1 += p2 + p3;
      if constexpr (DROP) {
        float km[4];  // (r0, c), (r0, c + 1), (r1, c), (r1, c + 1): one 2x2 block
        gaot::dropout_block_scale(dp, bh, r0, kv0 + nb * 8 + 2 * t, sq, skv, km);
        p0 *= km[0];
        p1 *= km[1];
        p2 *= km[2];
        p3 *= km[3];
      }
      pa[nb / 2][(nb % 2) * 2 + 0] = pack_bf16(p0, p1);
      pa[nb / 2][(nb % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int j = 0; j < BLOCK_N / 16; ++j) {
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const __nv_bfloat16* vrow = vt + (nd * 8 + g) * VS + j * 16 + 2 * t;
        mma_bf16(o[nd], pa[j], *reinterpret_cast<const uint32_t*>(vrow),
                 *reinterpret_cast<const uint32_t*>(vrow + 8));
      }
    }
    m0 = mn0;
    m1 = mn1;
    mp0 = mn0 == -INFINITY ? -INFINITY : ms0;
    mp1 = mn1 == -INFINITY ? -INFINITY : ms1;
  }

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
          pack_bf16(o[nd][0] / ls0, o[nd][1] / ls0);
    if (r1 < sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * D + col) =
          pack_bf16(o[nd][2] / ls1, o[nd][3] / ls1);
  }
  if (t == 0) {
    if (r0 < sq) lse[(size_t)bh * sq + r0] = m0 + logf(ls0);
    if (r1 < sq) lse[(size_t)bh * sq + r1] = m1 + logf(ls1);
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* out, float* lse,
            int bh, int sq, int skv, float scale, bool drop, DropoutParams dp,
            cudaStream_t stream) {
  const dim3 grid((sq + BLOCK_M - 1) / BLOCK_M, bh);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if constexpr (std::is_same_v<T, __nv_bfloat16> && D % 16 == 0) {
    if (drop) {
      flash_fwd_mma_kernel<D, true><<<grid, MMA_WARPS * 32, 0, stream>>>(
          qt, kt, vt, ot, lse, sq, skv, scale, dp);
    } else {
      flash_fwd_mma_kernel<D, false><<<grid, MMA_WARPS * 32, 0, stream>>>(
          qt, kt, vt, ot, lse, sq, skv, scale, dp);
    }
  } else {
    flash_fwd_kernel<T, D><<<grid, BLOCK_M, 0, stream>>>(qt, kt, vt, ot, lse, sq, skv,
                                                         scale, drop, dp);
  }
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out,
               float* lse, int bh, int sq, int skv, int d, float scale, bool drop,
               DropoutParams dp, cudaStream_t stream) {
  switch (d) {
    case 8: launch<T, 8>(q, k, v, out, lse, bh, sq, skv, scale, drop, dp, stream); break;
    case 16: launch<T, 16>(q, k, v, out, lse, bh, sq, skv, scale, drop, dp, stream); break;
    case 32: launch<T, 32>(q, k, v, out, lse, bh, sq, skv, scale, drop, dp, stream); break;
    case 64: launch<T, 64>(q, k, v, out, lse, bh, sq, skv, scale, drop, dp, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [bh, sq, d], k and v [bh, skv, d], out [bh, sq, d] in one type
// (dtype 0: float32, 1: bfloat16), lse [bh, sq] float32; all contiguous.
// drop != 0 applies probability dropout: keep iff bits >= thresh, kept
// probabilities times inv_keep; the bits are `bits` [bh, sq, skv] uint32 when
// given, else drawn from (seed_lo, seed_hi). Returns the launch's cudaError_t
// (0 on success).
int gaot_flash_attn_fwd(const void* q, const void* k, const void* v, void* out,
                        void* lse, int bh, int sq, int skv, int d, int dtype,
                        float scale, int drop, const void* bits, unsigned int seed_lo,
                        unsigned int seed_hi, unsigned int thresh, float inv_keep,
                        void* stream) {
  if (bh <= 0 || bh > 65535 || sq <= 0 || skv <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const DropoutParams dp{static_cast<const uint32_t*>(bits), seed_lo, seed_hi, thresh,
                         inv_keep};
  const bool dr = drop != 0;
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, out, l, bh, sq, skv, d, scale, dr, dp, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, out, l, bh, sq, skv, d, scale, dr, dp, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
