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
// the grid. Hopper's blocks run in parallel in no order, so one CTA owns a
// 64-key tile of one (batch, head), loops over all q tiles, keeps dk and dv in
// registers, and adds its dq tiles into an f32 [bh, sq, D] buffer with
// atomicAdd. The order of those additions changes from run to run, so dq
// differs in its last f32 bits between runs (each element is a sum of
// skv / 64 partial sums; the relative spread is about 1e-6, far below the
// bf16 rounding of the result). dk and dv are deterministic.
//
// Two bodies share that structure:
//   - bf16 with head dim 16/32/64 (the main path), on mma.sync.m16n8k16. The
//     products are taken transposed, S^T = k q_scaled^T with keys as the M
//     dimension: each warp owns 16 keys, the S^T accumulator fragment is then
//     directly the A operand of dv = pm^T dO and dk = ds^T q (registers
//     only), and only ds crosses shared memory, for dq = ds k. Fragment rows
//     (g, g + 8) hold the keys (2g, 2g + 1) of the warp's 16, so that a
//     thread's four scores per 8-row q block are one 2x2 block of the
//     dropout stream, one Philox call (philox.cuh), as in the forward.
//   - f32, and bf16 at head dim 8: scalar f32 FMAs, one thread per key for
//     s, dpv, dk, dv and one thread per q row for dq.
//
// What bounds it on an H100: five tile products where the forward has two
// (6.9e11 flops a layer at B1 H8 S16384 D32) and the same 2.1e9 exponentials,
// plus with dropout one Philox call per four scores (20 wide multiplies and
// 20 xors a call once the key schedule is hoisted, so 10 integer operations a
// score, the largest single term), plus skv/64 * sq * D float atomics per
// head (1.1e9 a layer, issued as float2). Double-buffered loads and wgmma are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "philox.cuh"

namespace {

using gaot::DropoutParams;

constexpr int TILE = 64;  // keys per CTA, and q rows per step of its loop
constexpr float LOG2E = 1.4426950408889634f;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  float* dq;  // [bh, sq, d] f32, zeroed by the caller, accumulated into
  void* dk;
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

// ---------------------------------------------------------------------------
// bf16 tensor-core body, 4 warps. See the header for the layout.
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

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* base, int row, int col,
                                              int rows, int d) {
  if (row >= rows) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + (size_t)row * d + col);
}

template <int D>
struct MmaSmem {
  static constexpr int RS = D + 8;     // row stride of the row-major q, dO tiles
  static constexpr int TS = TILE + 8;  // row stride of the transposed tiles and of ds
  static constexpr int qs = 0;                   // [TILE][RS]  q_scaled
  static constexpr int dos = qs + TILE * RS;     // [TILE][RS]  dO
  static constexpr int qt = dos + TILE * RS;     // [D][TS]     q_scaled^T
  static constexpr int dot = qt + D * TS;        // [D][TS]     dO^T
  static constexpr int kt = dot + D * TS;        // [D][TS]     k^T
  static constexpr int dss = kt + D * TS;        // [TILE q][TS] ds
  static constexpr int halves = dss + TILE * TS;
  static constexpr size_t bytes = halves * sizeof(__nv_bfloat16) + 2 * TILE * sizeof(float);
};

template <int D, bool DROP>
__global__ void __launch_bounds__(NT) flash_bwd_mma_kernel(BwdArgs a, DropoutParams dp) {
  using L = MmaSmem<D>;
  constexpr int RS = L::RS, TS = L::TS;
  constexpr int CH = D / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* qs = sm + L::qs;
  __nv_bfloat16* dos = sm + L::dos;
  __nv_bfloat16* qt = sm + L::qt;
  __nv_bfloat16* dot = sm + L::dot;
  __nv_bfloat16* kt = sm + L::kt;
  __nv_bfloat16* dss = sm + L::dss;
  float* lse_s = reinterpret_cast<float*>(sm + L::halves);  // lse * log2(e), +inf past sq
  float* dl_s = lse_s + TILE;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int kb0 = blockIdx.x * TILE;
  const int kl = warp * 16 + 2 * g;  // this thread's keys within the tile: kl, kl + 1
  const int k0 = kb0 + kl, k1 = k0 + 1;
  using bf = __nv_bfloat16;
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
  // k^T of the whole tile, keys in their natural order, for dq = ds k
  for (int c = threadIdx.x; c < TILE * CH; c += NT) {
    const int row = c / CH, ch = c - row * CH;
    const int key = kb0 + row;
    uint4 kx = make_uint4(0, 0, 0, 0);
    if (key < a.skv) kx = *reinterpret_cast<const uint4*>(kb + (size_t)key * D + ch * 8);
    const bf* ke = reinterpret_cast<const bf*>(&kx);
#pragma unroll
    for (int e = 0; e < 8; ++e) kt[(ch * 8 + e) * TS + row] = ke[e];
  }

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    dk[nd][0] = dk[nd][1] = dk[nd][2] = dk[nd][3] = 0.f;
    dv[nd][0] = dv[nd][1] = dv[nd][2] = dv[nd][3] = 0.f;
  }

  for (int q0 = 0; q0 < a.sq; q0 += TILE) {
    // the previous tile's dq phase reads dss and kt only, so the loads below
    // may start before every warp has left it; the barrier after them orders
    // them against this tile's products, and the one before the dq phase
    // orders the dss writes
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

    // S^T and dPV^T: rows = this warp's keys, columns = the tile's q rows
    float st[TILE / 8][4], dp_[TILE / 8][4];
#pragma unroll
    for (int nb = 0; nb < TILE / 8; ++nb) {
      st[nb][0] = st[nb][1] = st[nb][2] = st[nb][3] = 0.f;
      dp_[nb][0] = dp_[nb][1] = dp_[nb][2] = dp_[nb][3] = 0.f;
      const bf* qrow = qs + (nb * 8 + g) * RS + 2 * t;
      const bf* drow = dos + (nb * 8 + g) * RS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        mma_bf16(st[nb], ka[kk], *reinterpret_cast<const uint32_t*>(qrow + kk * 16),
                 *reinterpret_cast<const uint32_t*>(qrow + kk * 16 + 8));
        mma_bf16(dp_[nb], va[kk], *reinterpret_cast<const uint32_t*>(drow + kk * 16),
                 *reinterpret_cast<const uint32_t*>(drow + kk * 16 + 8));
      }
    }

    // pm^T and ds^T as A operands (keys x q) of the dv and dk products, and ds
    // into shared memory for dq
    uint32_t pma[TILE / 16][4], dsa[TILE / 16][4];
#pragma unroll
    for (int nb = 0; nb < TILE / 8; ++nb) {
      const int ql = nb * 8 + 2 * t;  // q columns ql, ql + 1 of the tile
      const float l0 = lse_s[ql], l1 = lse_s[ql + 1];
      const float d0 = dl_s[ql], d1 = dl_s[ql + 1];
      // elements: [0] (k0, ql), [1] (k0, ql + 1), [2] (k1, ql), [3] (k1, ql + 1)
      float p0 = exp2f(fmaf(st[nb][0], LOG2E, -l0));
      float p1 = exp2f(fmaf(st[nb][1], LOG2E, -l1));
      float p2 = exp2f(fmaf(st[nb][2], LOG2E, -l0));
      float p3 = exp2f(fmaf(st[nb][3], LOG2E, -l1));
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
      const float s0 = p0 * (dp_[nb][0] * m0 - d0);
      const float s1 = p1 * (dp_[nb][1] * m1 - d1);
      const float s2 = p2 * (dp_[nb][2] * m2 - d0);
      const float s3 = p3 * (dp_[nb][3] * m3 - d1);
      pma[nb / 2][(nb % 2) * 2 + 0] = pack_bf16(p0 * m0, p1 * m1);
      pma[nb / 2][(nb % 2) * 2 + 1] = pack_bf16(p2 * m2, p3 * m3);
      dsa[nb / 2][(nb % 2) * 2 + 0] = pack_bf16(s0, s1);
      dsa[nb / 2][(nb % 2) * 2 + 1] = pack_bf16(s2, s3);
      *reinterpret_cast<uint32_t*>(dss + ql * TS + kl) = pack_bf16(s0, s2);
      *reinterpret_cast<uint32_t*>(dss + (ql + 1) * TS + kl) = pack_bf16(s1, s3);
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
    __syncthreads();

    // dq tile = ds k over the CTA's 64 keys: this warp takes q rows
    // warp * 16 + (g, g + 8)
    float dq[D / 8][4];
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) dq[nd][0] = dq[nd][1] = dq[nd][2] = dq[nd][3] = 0.f;
#pragma unroll
    for (int j = 0; j < TILE / 16; ++j) {
      uint32_t da[4];
      const bf* r0p = dss + (warp * 16 + g) * TS + j * 16 + 2 * t;
      const bf* r1p = r0p + 8 * TS;
      da[0] = *reinterpret_cast<const uint32_t*>(r0p);
      da[1] = *reinterpret_cast<const uint32_t*>(r1p);
      da[2] = *reinterpret_cast<const uint32_t*>(r0p + 8);
      da[3] = *reinterpret_cast<const uint32_t*>(r1p + 8);
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const bf* krow = kt + (nd * 8 + g) * TS + j * 16 + 2 * t;
        mma_bf16(dq[nd], da, *reinterpret_cast<const uint32_t*>(krow),
                 *reinterpret_cast<const uint32_t*>(krow + 8));
      }
    }
    const int qr0 = q0 + warp * 16 + g, qr1 = qr0 + 8;
    float* dq0 = a.dq + ((size_t)bh * a.sq + qr0) * D + 2 * t;
    float* dq1 = a.dq + ((size_t)bh * a.sq + qr1) * D + 2 * t;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      if (qr0 < a.sq)
        atomicAdd(reinterpret_cast<float2*>(dq0 + nd * 8),
                  make_float2(dq[nd][0] * a.scale, dq[nd][1] * a.scale));
      if (qr1 < a.sq)
        atomicAdd(reinterpret_cast<float2*>(dq1 + nd * 8),
                  make_float2(dq[nd][2] * a.scale, dq[nd][3] * a.scale));
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

template <typename T, int D>
int launch(const BwdArgs& a, int bh, bool drop, const DropoutParams& dp,
           cudaStream_t stream) {
  const dim3 grid((a.skv + TILE - 1) / TILE, bh);
  cudaError_t e;
  if constexpr (std::is_same_v<T, __nv_bfloat16> && D % 16 == 0) {
    constexpr size_t bytes = MmaSmem<D>::bytes;
    if (drop) {
      if ((e = allow_smem(flash_bwd_mma_kernel<D, true>, bytes)) != cudaSuccess) return (int)e;
      flash_bwd_mma_kernel<D, true><<<grid, NT, bytes, stream>>>(a, dp);
    } else {
      if ((e = allow_smem(flash_bwd_mma_kernel<D, false>, bytes)) != cudaSuccess) return (int)e;
      flash_bwd_mma_kernel<D, false><<<grid, NT, bytes, stream>>>(a, dp);
    }
  } else {
    constexpr size_t bytes = scalar_smem_bytes<D>();
    if ((e = allow_smem(flash_bwd_kernel<T, D>, bytes)) != cudaSuccess) return (int)e;
    flash_bwd_kernel<T, D><<<grid, TILE, bytes, stream>>>(a, drop, dp);
  }
  return (int)cudaGetLastError();
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
