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
//   - bf16 with head dim 16/32/64 (the main path), warp-specialized for
//     Hopper. A CTA is three warpgroups and owns 128 keys. The producer
//     warpgroup (registers given to the consumers by setmaxnreg) streams 64-row q and dO tiles by TMA into a ring of 3 stages
//     (full, ready and empty mbarriers per stage), prescales each q tile in
//     place (every element the same way, so the swizzle does not matter) and
//     stages the tile's lse * log2(e) and delta. Each consumer warpgroup owns
//     64 keys, held in registers as the wgmma A operands k and v (rows
//     permuted so that fragment rows (g, g + 8) are the keys (2g, 2g + 1),
//     see below), with dk and dv in wgmma accumulators for the whole loop.
//     Per q tile: S^T = k q_s^T and dP^T = v dO^T (wgmma m64n64k16, B the
//     tile K-major), P, the mask and dS^T in registers, then dv += pm^T dO
//     and dk += ds^T q_s with A from registers and B the same tiles read
//     MN-major through the descriptor: no transposed copy of anything. dS
//     goes to shared memory once as bf16 (128-byte swizzle), and the tile's
//     dq partial over the warpgroup's 64 keys is one more wgmma, dS times the
//     CTA's K tile (loaded once by TMA, read MN-major). The f32 partial is
//     staged in shared memory and added into dq by one bulk reduce-add
//     (cp.reduce.async.bulk .add.f32) per tile, in place of element atomics.
//     The dropout stream's 2x2 blocks are (q row, key): a thread's four
//     scores per 8-row q block are one block, one Philox call (philox.cuh),
//     as in the forward; the next tile's calls run while this tile's last
//     products are in flight.
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

#include "hopper.cuh"
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
// bf16 warp-specialized body, see the header.
// ---------------------------------------------------------------------------
constexpr int WG = 128;        // threads of a warpgroup
constexpr int B_KEYS = 128;    // keys per CTA, 64 per consumer warpgroup
constexpr int B_Q = 64;        // q rows per tile
constexpr int B_STAGES = 3;    // q/dO tile pairs in flight
constexpr int B_THREADS = 3 * WG;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* base, int row, int col,
                                              int rows, int d) {
  if (row >= rows) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + (size_t)row * d + col);
}

// Shared memory, in bytes from a 1024-byte aligned base.
template <int D>
struct WgSmem {
  static constexpr int RB = 2 * D;                  // bytes of a bf16 row
  static constexpr int QT = B_Q * RB;               // one q or dO tile
  static constexpr int k_tile = 0;                  // [128 keys][D] bf16, the CTA's K
  static constexpr int stages = B_KEYS * RB;        // per stage: q tile, then dO tile
  static constexpr int ds = stages + B_STAGES * 2 * QT;  // [2 consumers][2][64 q][64 keys] bf16
  static constexpr int DS_BUF = B_Q * 64 * 2;
  static constexpr int dq = ds + 4 * DS_BUF;        // [2 consumers][64 q][D] f32
  static constexpr int stats = dq + 2 * B_Q * D * 4;  // [stage][lse * log2e, delta][64] f32
  static constexpr size_t bytes = stats + B_STAGES * 2 * B_Q * 4 + 1024;
};

template <int D, bool DROP>
__global__ void __launch_bounds__(B_THREADS, 1)
    flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_q,
                           const __grid_constant__ CUtensorMap tmap_do,
                           const __grid_constant__ CUtensorMap tmap_k, BwdArgs a,
                           DropoutParams dp) {
  using namespace gaot;
  using L = WgSmem<D>;
  using bf = __nv_bfloat16;
  constexpr int RB = L::RB;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[B_STAGES], ready[B_STAGES], empty[B_STAGES], kbar;
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - smem_u32(smem_raw));  // the same bytes, generic
  const int bh = blockIdx.y;
  const int n_q = (a.sq + B_Q - 1) / B_Q;
  // the warpgroup's index, read from lane 0 so the compiler knows it is the
  // same across the warp: the branches below are not divergent
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / WG, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < B_STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&ready[s]), 4);  // the producer's 4 warps
      mbar_init(smem_u32(&empty[s]), 8);  // the 4 warps of each consumer
    }
    mbar_init(smem_u32(&kbar), 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    regs_dec<40>();
    const int pt = threadIdx.x;
    if (pt == 0) {
      mbar_expect_tx(smem_u32(&kbar), B_KEYS * RB);
      tma_load_3d(base + L::k_tile, &tmap_k, smem_u32(&kbar), 0, blockIdx.x * B_KEYS, bh);
    }
    // step i issues the loads of tile i, then finishes tile i - 1 (its lse,
    // delta and prescaled q), so the next loads are in flight meanwhile
    for (int i = 0; i <= n_q; ++i) {
      if (i < n_q) {
        const int s = i % B_STAGES;
        mbar_wait(smem_u32(&empty[s]), ((i / B_STAGES) & 1) ^ 1);
        if (pt == 0) {
          const uint32_t bar = smem_u32(&full[s]);
          const uint32_t dst = base + L::stages + s * 2 * L::QT;
          mbar_expect_tx(bar, 2 * L::QT);
          tma_load_3d(dst, &tmap_q, bar, 0, i * B_Q, bh);
          tma_load_3d(dst + L::QT, &tmap_do, bar, 0, i * B_Q, bh);
        }
      }
      if (i > 0) {
        const int j = i - 1, s = j % B_STAGES;
        float* st = reinterpret_cast<float*>(sm + L::stats) + s * 2 * B_Q;
        const int row = j * B_Q + (pt & (B_Q - 1));
        const bool in = row < a.sq;
        if (pt < B_Q)
          st[pt] = in ? a.lse[(size_t)bh * a.sq + row] * LOG2E : INFINITY;
        else
          st[pt] = in ? a.delta[(size_t)bh * a.sq + row] : 0.f;
        mbar_wait(smem_u32(&full[s]), (j / B_STAGES) & 1);
        uint4* qt = reinterpret_cast<uint4*>(sm + L::stages + s * 2 * L::QT);
        for (int ch = pt; ch < L::QT / 16; ch += WG) {  // prescale in f32, round back
          uint4 x = qt[ch];
          uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
            w[e] = pack_bf16(__fmul_rn(f.x, a.scale), __fmul_rn(f.y, a.scale));
          }
          qt[ch] = x;
        }
        fence_proxy_async();
        __syncwarp();
        if ((pt & 31) == 0) mbar_arrive(smem_u32(&ready[s]));
      }
    }
  } else {  // consumers
    regs_inc<232>();
    const int c = wg - 1;  // consumer 0 or 1
    const int ct = threadIdx.x - wg * WG;
    const int warp = ct >> 5;
    const int lane = ct & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int kl = warp * 16 + 2 * g;  // this thread's keys within the consumer's 64: kl, kl + 1
    const int k0 = blockIdx.x * B_KEYS + c * 64 + kl, k1 = k0 + 1;
    const bf* kb = static_cast<const bf*>(a.k) + (size_t)bh * a.skv * D;
    const bf* vb = static_cast<const bf*>(a.v) + (size_t)bh * a.skv * D;

    // k and v rows of this warp as A operands (keys x d), held for the whole loop
    uint32_t ka[D / 16][4], va[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int col = kk * 16 + 2 * t;
      ka[kk][0] = load_pair(kb, k0, col, a.skv, D);
      ka[kk][1] = load_pair(kb, k1, col, a.skv, D);
      ka[kk][2] = load_pair(kb, k0, col + 8, a.skv, D);
      ka[kk][3] = load_pair(kb, k1, col + 8, a.skv, D);
      va[kk][0] = load_pair(vb, k0, col, a.skv, D);
      va[kk][1] = load_pair(vb, k1, col, a.skv, D);
      va[kk][2] = load_pair(vb, k0, col + 8, a.skv, D);
      va[kk][3] = load_pair(vb, k1, col + 8, a.skv, D);
    }
    float dk[D / 2], dv[D / 2];  // [nd * 4 + e]: keys (k0, k1) x columns nd * 8 + 2t + (0, 1)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    float st[B_Q / 2], dpt[B_Q / 2];  // S^T, dP^T: keys (k0, k1) x q columns nb * 8 + 2t + (0, 1)
    float dq[D / 2];  // q rows warp * 16 + (g, g + 8) x columns nd * 8 + 2t + (0, 1)
    uint32_t pma[B_Q / 16][4], dsa[B_Q / 16][4];
    const uint32_t kc = base + L::k_tile + c * 64 * RB;  // this consumer's 64 keys of the K tile
    const uint32_t dq_s = base + L::dq + c * B_Q * D * 4;
    float* dq_g = reinterpret_cast<float*>(sm + L::dq) + c * B_Q * D;
    // The dropout mask depends on positions only: the keep bits of tile i + 1
    // (integer pipe) are drawn while tile i's last products are in flight.
    uint32_t keep[1] = {0u};  // 4 bits per 8-row q block
    auto keep_bits = [&](int i) {
      if constexpr (DROP) {
        uint32_t b = 0u;
#pragma unroll
        for (int nb = 0; nb < B_Q / 8; ++nb)
          b |= gaot::dropout_block_keep(dp, bh, i * B_Q + nb * 8 + 2 * t, k0, a.sq, a.skv)
               << (4 * nb);
        keep[0] = b;
        fence_regs(keep);  // here, before the wait for the products
      }
    };
    keep_bits(0);
    mbar_wait(smem_u32(&kbar), 0);

    for (int i = 0; i < n_q; ++i) {
      const int s = i % B_STAGES;
      const int q0 = i * B_Q;
      const uint32_t qs = base + L::stages + s * 2 * L::QT, dos = qs + L::QT;
      const float* lse_s = reinterpret_cast<const float*>(sm + L::stats) + s * 2 * B_Q;
      const float* dl_s = lse_s + B_Q;
      mbar_wait(smem_u32(&ready[s]), (i / B_STAGES) & 1);

      // S^T and dP^T: rows = this warpgroup's keys, columns = the tile's q rows
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_rs<0>(st, ka[kk], wgmma_desc(qs + kk * 32, RB, false), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_rs<0>(dpt, va[kk], wgmma_desc(dos + kk * 32, RB, false), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // pm^T and ds^T as A operands (keys x q) of the dv and dk products, and
      // ds (q x keys, 128-byte swizzle) into shared memory for dq
      unsigned char* dsb = sm + L::ds + (c * 2 + (i & 1)) * L::DS_BUF;
#pragma unroll
      for (int nb = 0; nb < B_Q / 8; ++nb) {
        const int ql = nb * 8 + 2 * t;  // q columns ql, ql + 1 of the tile
        const float l0 = lse_s[ql], l1 = lse_s[ql + 1];
        const float d0 = dl_s[ql], d1 = dl_s[ql + 1];
        const float* sv = st + nb * 4;
        const float* dv_ = dpt + nb * 4;
        // elements: [0] (k0, ql), [1] (k0, ql + 1), [2] (k1, ql), [3] (k1, ql + 1)
        float p0 = ex2_ftz(fmaf(sv[0], LOG2E, -l0));
        float p1 = ex2_ftz(fmaf(sv[1], LOG2E, -l1));
        float p2 = ex2_ftz(fmaf(sv[2], LOG2E, -l0));
        float p3 = ex2_ftz(fmaf(sv[3], LOG2E, -l1));
        if (k0 >= a.skv) p0 = p1 = 0.f;  // padded keys
        if (k1 >= a.skv) p2 = p3 = 0.f;
        float m0 = 1.f, m1 = 1.f, m2 = 1.f, m3 = 1.f;
        if constexpr (DROP) {
          // the stream's block is (q row, key): words (even q, even key),
          // (even q, odd key), (odd q, even key), (odd q, odd key)
          const uint32_t b = keep[0] >> (4 * nb);
          m0 = (b & 1u) ? dp.inv_keep : 0.f;
          m2 = (b & 2u) ? dp.inv_keep : 0.f;
          m1 = (b & 4u) ? dp.inv_keep : 0.f;
          m3 = (b & 8u) ? dp.inv_keep : 0.f;
        }
        const float s0 = p0 * (dv_[0] * m0 - d0);
        const float s1 = p1 * (dv_[1] * m1 - d1);
        const float s2 = p2 * (dv_[2] * m2 - d0);
        const float s3 = p3 * (dv_[3] * m3 - d1);
        pma[nb / 2][(nb % 2) * 2 + 0] = pack_bf16(p0 * m0, p1 * m1);
        pma[nb / 2][(nb % 2) * 2 + 1] = pack_bf16(p2 * m2, p3 * m3);
        dsa[nb / 2][(nb % 2) * 2 + 0] = pack_bf16(s0, s1);
        dsa[nb / 2][(nb % 2) * 2 + 1] = pack_bf16(s2, s3);
        // (ql, kl..kl+1) and (ql + 1, kl..kl+1): 16-byte chunk kl / 8 of the
        // row, swizzled by the row's index mod 8
        const int col = (kl & 7) << 1;
        *reinterpret_cast<uint32_t*>(dsb + ql * 128 + (((kl >> 3) ^ (ql & 7)) << 4) + col) =
            pack_bf16(s0, s2);
        *reinterpret_cast<uint32_t*>(dsb + (ql + 1) * 128 +
                                     (((kl >> 3) ^ ((ql + 1) & 7)) << 4) + col) =
            pack_bf16(s1, s3);
      }

      // dv += pm^T dO, dk += ds^T q_s (contraction over the tile's q rows)
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < B_Q / 16; ++j) {
        wgmma_rs<1>(dv, pma[j], wgmma_desc(dos + j * 16 * RB, RB, true), 1);
        wgmma_rs<1>(dk, dsa[j], wgmma_desc(qs + j * 16 * RB, RB, true), 1);
      }
      wgmma_commit();
      // ds of every warp written, and the last tile's reduce-add done reading
      // the dq staging buffer
      if (ct == 0) bulk_wait_read();
      fence_proxy_async();
      named_sync(1 + c, WG);

      // dq tile = ds k over this warpgroup's 64 keys
      const uint32_t dsu = base + L::ds + (c * 2 + (i & 1)) * L::DS_BUF;
#pragma unroll
      for (int kk = 0; kk < 64 / 16; ++kk)
        wgmma_ss<1>(dq, wgmma_desc(dsu + kk * 32, 128, false),
                    wgmma_desc(kc + kk * 16 * RB, RB, true), kk > 0);
      wgmma_commit();
      if (i + 1 < n_q) keep_bits(i + 1);
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(pma);
      fence_regs(dsa);
      if (lane == 0) mbar_arrive(smem_u32(&empty[s]));

      const int qr0 = warp * 16 + g;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const int col = nd * 8 + 2 * t;
        *reinterpret_cast<float2*>(dq_g + qr0 * D + col) =
            make_float2(dq[nd * 4 + 0] * a.scale, dq[nd * 4 + 1] * a.scale);
        *reinterpret_cast<float2*>(dq_g + (qr0 + 8) * D + col) =
            make_float2(dq[nd * 4 + 2] * a.scale, dq[nd * 4 + 3] * a.scale);
      }
      fence_proxy_async();
      named_sync(1 + c, WG);
      if (ct == 0) {
        const int rows = min(B_Q, a.sq - q0);  // rows past sq are not added
        bulk_reduce_add_f32(a.dq + ((size_t)bh * a.sq + q0) * D, dq_s, rows * D * 4);
        bulk_commit();
      }
    }
    if (ct == 0) bulk_wait();

    bf* dkb = static_cast<bf*>(a.dk) + (size_t)bh * a.skv * D;
    bf* dvb = static_cast<bf*>(a.dv) + (size_t)bh * a.skv * D;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const int col = nd * 8 + 2 * t;
      if (k0 < a.skv) {
        *reinterpret_cast<uint32_t*>(dkb + (size_t)k0 * D + col) =
            pack_bf16(dk[nd * 4], dk[nd * 4 + 1]);
        *reinterpret_cast<uint32_t*>(dvb + (size_t)k0 * D + col) =
            pack_bf16(dv[nd * 4], dv[nd * 4 + 1]);
      }
      if (k1 < a.skv) {
        *reinterpret_cast<uint32_t*>(dkb + (size_t)k1 * D + col) =
            pack_bf16(dk[nd * 4 + 2], dk[nd * 4 + 3]);
        *reinterpret_cast<uint32_t*>(dvb + (size_t)k1 * D + col) =
            pack_bf16(dv[nd * 4 + 2], dv[nd * 4 + 3]);
      }
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D, bool DROP>
int launch_wgmma(const BwdArgs& a, int bh, const DropoutParams& dp, cudaStream_t stream) {
  CUtensorMap tq, tdo, tk;
  if (!gaot::bf16_rows_map(&tq, a.q, bh, a.sq, D, B_Q) ||
      !gaot::bf16_rows_map(&tdo, a.dout, bh, a.sq, D, B_Q) ||
      !gaot::bf16_rows_map(&tk, a.k, bh, a.skv, D, B_KEYS))
    return (int)cudaErrorInvalidValue;
  constexpr size_t bytes = WgSmem<D>::bytes;
  auto kern = flash_bwd_wgmma_kernel<D, DROP>;
  const cudaError_t e = allow_smem(kern, bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3((a.skv + B_KEYS - 1) / B_KEYS, bh), B_THREADS, bytes, stream>>>(tq, tdo, tk, a,
                                                                             dp);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const BwdArgs& a, int bh, bool drop, const DropoutParams& dp,
           cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> && D % 16 == 0) {
    if (drop) return launch_wgmma<D, true>(a, bh, dp, stream);
    return launch_wgmma<D, false>(a, bh, dp, stream);
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
