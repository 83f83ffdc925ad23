// Fused single-pass flash-attention backward for Hopper (sm_90a).
//
// Replaces gaot3d_tpu/ops/pallas_attention.py `_flash_bwd_impl`, fused call
// (kernel `_make_bwd_fused_kernel`). Given q, k, v, dO, the forward's lse and
// delta = rowsum(dO * O) (f32, a plain reduction outside, as in the JAX
// code), per (q tile, key tile):
//     s   = q_scaled k^T          (q prescaled by 1/sqrt(D) in f32, rounded back)
//     p   = exp(s - lse)          (0 on padded keys and padded q rows)
//     dpv = dO v^T
//     km  = keep ? 1/(1-rate) : 0 (the forward's mask, regenerated; 1 at rate 0)
//     pm  = p km,   ds = p (dpv km - delta)
//     dv += pm^T dO               (pm rounded to dO's type)
//     dk += ds^T q_scaled         (ds rounded to the input type)
//     dq += scale ds k            (f32 accumulate, rounded once by the caller)
//
// On the TPU the kv-block axis was the outer sequential grid dimension, dk and
// dv sat in VMEM scratch and a whole head's dq [Sq, D] stayed in VMEM across
// the grid. Hopper's blocks run in parallel in no order, so a CTA owns a tile
// of keys of one (batch, head), loops over all q tiles, keeps dk and dv in
// registers, and adds its dq tiles into an f32 [bh, sq, D] buffer. The order
// of those additions changes from run to run, so dq differs in its last f32
// bits between runs (each element is a sum of skv / 64 partial sums; the
// relative spread is about 1e-6, far below the bf16 rounding of the result).
// dk and dv are deterministic.
//
// Two bodies share that structure:
//   - bf16 with head dim 16/32/64 (the main path): the warp-specialized TMA /
//     wgmma body of flash_bwd_wgmma.cuh with DQ = true (its header has the
//     design). The dq partial of each tile is one more wgmma, staged in
//     shared memory and added into dq by one bulk reduce-add
//     (cp.reduce.async.bulk .add.f32) per tile, in place of element atomics.
//     The same body with DQ = false is the dk/dv kernel of the split backward
//     (K3, flash_attn_bwd_split.cu), so the two give the same dk and dv.
//   - f32, and bf16 at head dim 8: scalar f32 FMAs, one thread per key for
//     s, dpv, dk, dv and one thread per q row for dq.
//
// What bounds it on an H100: five tile products where the forward has two
// (6.9e11 flops a layer at B1 H8 S16384 D32, 0.70 ms of tensor cores) and the
// same 2.1e9 exponentials (0.51 ms), plus with dropout one Philox call per
// four scores (20 wide multiplies and 20 xors a call once the key schedule is
// hoisted, so 10 integer operations a score: 1.28 ms, the largest term). As
// in the forward, ptxas allocates every path at the launch bound of 168
// registers; the head-dim-64 bodies spill.
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
using namespace gaot::fbwd;

constexpr int TILE = 64;  // keys per CTA, and q rows per step of its loop

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

// ---------------------------------------------------------------------------
// Scalar body: 64 threads. Phase A, thread = key: s, dpv, p, ds against each
// q row of the tile in turn, dk and dv rows in registers, ds into shared
// memory. Phase B, thread = q row: dq row = ds k, added to the f32 buffer.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(TILE)
    flash_bwd_kernel(BwdArgs a, bool drop, DropoutParams dp) {
  constexpr int KS = D + 1;     // k/v row stride: thread-varying row, no bank conflicts
  constexpr int DS = TILE + 1;  // ds row stride
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + TILE * KS;
  float* qs = vs + TILE * KS;    // [TILE][D], rows read by every thread at once
  float* dos = qs + TILE * D;
  float* dss = dos + TILE * D;   // [TILE q][DS]
  float* lse_s = dss + TILE * DS;
  float* dl_s = lse_s + TILE;

  const int bh = blockIdx.y;
  const int j = threadIdx.x;
  const int key = blockIdx.x * TILE + j;
  const T* qb = static_cast<const T*>(a.q) + (size_t)bh * a.sq * D;
  const T* kb = static_cast<const T*>(a.k) + (size_t)bh * a.skv * D;
  const T* vb = static_cast<const T*>(a.v) + (size_t)bh * a.skv * D;
  const T* dob = static_cast<const T*>(a.dout) + (size_t)bh * a.sq * D;
  const bool key_in = key < a.skv;

  for (int i = threadIdx.x; i < TILE * D; i += TILE) {
    const int r = i / D, d = i - r * D;
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
    for (int i = threadIdx.x; i < TILE * D; i += TILE) {
      const int r = i / D, d = i - r * D;
      const int row = q0 + r;
      const bool in = row < a.sq;
      qs[i] = in ? Cvt<T>::round(__fmul_rn(Cvt<T>::load(qb[(size_t)row * D + d]), a.scale))
                 : 0.f;
      dos[i] = in ? Cvt<T>::load(dob[(size_t)row * D + d]) : 0.f;
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
      dss[i * DS + j] = ds;
    }
    __syncthreads();

    {  // thread = q row q0 + threadIdx.x
      const int i = threadIdx.x;
      const int row = q0 + i;
      float dq[D];
#pragma unroll
      for (int d = 0; d < D; ++d) dq[d] = 0.f;
#pragma unroll 4
      for (int jj = 0; jj < TILE; ++jj) {
        const float ds = dss[i * DS + jj];
#pragma unroll
        for (int d = 0; d < D; ++d) dq[d] = fmaf(ds, ks[jj * KS + d], dq[d]);
      }
      if (row < a.sq) {
        float* dst = a.dq + ((size_t)bh * a.sq + row) * D;
#pragma unroll
        for (int d = 0; d < D; ++d) atomicAdd(dst + d, dq[d] * a.scale);
      }
    }
    // no barrier here: phase B reads dss and ks only, the next step's loads
    // write qs, dos, lse_s and dl_s, and dss is rewritten only after the
    // barrier that follows those loads
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
constexpr size_t scalar_smem_bytes() {
  return sizeof(float) *
         (2 * TILE * (D + 1) + 2 * TILE * D + TILE * (TILE + 1) + 2 * TILE);
}

template <typename T, int D>
int launch(const BwdArgs& a, int bh, bool drop, const DropoutParams& dp,
           cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> && D % 16 == 0) {
    if (drop) return launch_wgmma<D, true, true>(a, bh, dp, nullptr, stream);
    return launch_wgmma<D, false, true>(a, bh, dp, nullptr, stream);
  } else {
    const dim3 grid((a.skv + TILE - 1) / TILE, bh);
    constexpr size_t bytes = scalar_smem_bytes<D>();
    const cudaError_t e = allow_smem(flash_bwd_kernel<T, D>, bytes);
    if (e != cudaSuccess) return (int)e;
    flash_bwd_kernel<T, D><<<grid, TILE, bytes, stream>>>(a, drop, dp);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int dispatch_d(const BwdArgs& a, int bh, int d, bool drop, const DropoutParams& dp,
               cudaStream_t stream) {
  switch (d) {
    case 8: return launch<T, 8>(a, bh, drop, dp, stream);
    case 16: return launch<T, 16>(a, bh, drop, dp, stream);
    case 32: return launch<T, 32>(a, bh, drop, dp, stream);
    case 64: return launch<T, 64>(a, bh, drop, dp, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, dout [bh, sq, d], k, v [bh, skv, d] in one type (dtype 0: float32,
// 1: bfloat16); lse, delta [bh, sq] float32; dq [bh, sq, d] float32, zeroed by
// the caller and accumulated into; dk, dv [bh, skv, d] in the input type; all
// contiguous. The dropout arguments are those of gaot_flash_attn_fwd. Returns
// the launch's cudaError_t (0 on success).
int gaot_flash_attn_bwd(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, void* dk, void* dv,
                        int bh, int sq, int skv, int d, int dtype, float scale, int drop,
                        const void* bits, unsigned int seed_lo, unsigned int seed_hi,
                        unsigned int thresh, float inv_keep, void* stream) {
  if (bh <= 0 || bh > 65535 || sq <= 0 || skv <= 0) return (int)cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), static_cast<float*>(dq), dk, dv,
                  sq, skv, scale};
  const DropoutParams dp{static_cast<const uint32_t*>(bits), seed_lo, seed_hi, thresh,
                         inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(a, bh, d, drop != 0, dp, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(a, bh, d, drop != 0, dp, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
