// The warp-specialized bf16 body of the flash-attention backward for Hopper
// (sm_90a), shared by the fused backward (K2, flash_attn_bwd.cu, DQ = true)
// and the dk/dv kernel of the split backward (K3, flash_attn_bwd_split.cu,
// DQ = false). One body, so K3's dk and dv come out of K2's arithmetic in
// K2's order, bit for bit.
//
// A CTA is three warpgroups and owns 128 keys of one (batch, head). The
// producer warpgroup (registers given to the consumers by setmaxnreg) streams
// 64-row q and dO tiles by TMA into a ring of 3 stages (full, ready and empty
// mbarriers per stage), prescales each q tile in place (every element the
// same way, so the swizzle does not matter) and stages the tile's
// lse * log2(e) and delta. Each consumer warpgroup owns 64 keys, held in
// registers as the wgmma A operands k and v (rows permuted so that fragment
// rows (g, g + 8) are the keys (2g, 2g + 1)), with dk and dv in wgmma
// accumulators for the whole loop. Per q tile: S^T = k q_s^T and dP^T =
// v dO^T (wgmma m64n64k16, B the tile K-major), P, the mask and dS^T in
// registers, then dv += pm^T dO and dk += ds^T q_s with A from registers and
// B the same tiles read MN-major through the descriptor: no transposed copy
// of anything. The dropout stream's 2x2 blocks are (q row, key): a thread's
// four scores per 8-row q block are one block, one Philox call (philox.cuh);
// the next tile's calls run while this tile's last products are in flight.
//
// DQ = true (K2) adds: dS to shared memory once as bf16 (128-byte swizzle),
// the tile's dq partial over the warpgroup's 64 keys as one more wgmma (dS
// times the CTA's K tile, loaded once by TMA, read MN-major), the f32 partial
// staged in shared memory and added into dq by one bulk reduce-add
// (cp.reduce.async.bulk .add.f32) per tile.
//
// DQ = false (K3's dk/dv kernel) compiles all of that out (the dS staging,
// the K tile, the dq wgmma, its buffer and the reduce-add) and, under
// dropout, writes the keep bits it has drawn into the keep mask (below), one
// 32-bit store a thread a tile, for K3's dq kernel to read.
//
// The keep mask: uint32 [bh][ceil(skv / 64)][ceil(sq / 64)][128], one
// 512-byte tile of 128 words for each (64-key tile, 64-row q tile). In a tile
// the 2x2 block of local q pair qp (rows 2qp, 2qp + 1) and key pair kp (keys
// 2kp, 2kp + 1) is nibble qp >> 2 of word 4 kp + (qp & 3); the nibble's bits
// are (even row, even key), (even row, odd key), (odd row, even key), (odd
// row, odd key), the order of dropout_block_keep. Word 4 kp + (qp & 3) is
// exactly the keep word of consumer thread 4 kp + (qp & 3) of this body, so
// the store is coalesced. Rows past sq and keys past skv read 0.
// kernels/flash_attention.py `pack_keep_mask_reference` is the same packing
// in plain torch.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "philox.cuh"

namespace gaot {
namespace fbwd {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int WG = 128;        // threads of a warpgroup
constexpr int B_KEYS = 128;    // keys per CTA, 64 per consumer warpgroup
constexpr int B_Q = 64;        // q rows per tile
constexpr int B_STAGES = 3;    // q/dO tile pairs in flight
constexpr int B_THREADS = 3 * WG;
constexpr int MASK_TILE = 64;    // rows and keys of a keep-mask tile
constexpr int MASK_WORDS = 128;  // uint32 words of a keep-mask tile

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  float* dq;  // [bh, sq, d] f32, zeroed by the caller, accumulated into (DQ only)
  void* dk;
  void* dv;
  int sq, skv;
  float scale;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* base, int row, int col,
                                              int rows, int d) {
  if (row >= rows) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + (size_t)row * d + col);
}

// A consumer thread's keep word of one q tile with the bits of rows past sq
// and keys past skv cleared (nibble nb: rows q0 + nb * 8 + 2t and + 1, keys
// k0 and k0 + 1).
__device__ __forceinline__ uint32_t keep_in_bounds(uint32_t b, int q0, int t, int k0, int sq,
                                                   int skv) {
  if (k0 >= skv) return 0u;
  if (k0 + 1 >= skv) b &= 0x55555555u;  // the odd key's bits
  if (q0 + B_Q > sq) {
#pragma unroll
    for (int nb = 0; nb < B_Q / 8; ++nb) {
      const int r = q0 + nb * 8 + 2 * t;
      if (r >= sq) b &= ~(0xFu << (4 * nb));
      else if (r + 1 >= sq) b &= ~(0xCu << (4 * nb));
    }
  }
  return b;
}

// Shared memory, in bytes from a 1024-byte aligned base.
template <int D, bool DQ>
struct WgSmem {
  static constexpr int RB = 2 * D;                  // bytes of a bf16 row
  static constexpr int QT = B_Q * RB;               // one q or dO tile
  static constexpr int k_tile = 0;                  // [128 keys][D] bf16, the CTA's K (DQ)
  static constexpr int stages = DQ ? B_KEYS * RB : 0;  // per stage: q tile, then dO tile
  static constexpr int ds = stages + B_STAGES * 2 * QT;  // [2 consumers][2][64 q][64 keys] bf16
  static constexpr int DS_BUF = B_Q * 64 * 2;
  static constexpr int dq = ds + (DQ ? 4 * DS_BUF : 0);  // [2 consumers][64 q][D] f32
  static constexpr int stats = dq + (DQ ? 2 * B_Q * D * 4 : 0);  // [stage][lse * log2e, delta][64]
  static constexpr size_t bytes = stats + B_STAGES * 2 * B_Q * 4 + 1024;
};

template <int D, bool DROP, bool DQ>
__global__ void __launch_bounds__(B_THREADS, 1)
    flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_q,
                           const __grid_constant__ CUtensorMap tmap_do,
                           const __grid_constant__ CUtensorMap tmap_k, BwdArgs a,
                           DropoutParams dp, uint32_t* __restrict__ keep_mask) {
  using L = WgSmem<D, DQ>;
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
    if constexpr (DQ) {
      if (pt == 0) {
        mbar_expect_tx(smem_u32(&kbar), B_KEYS * RB);
        tma_load_3d(base + L::k_tile, &tmap_k, smem_u32(&kbar), 0, blockIdx.x * B_KEYS, bh);
      }
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
    // K3: this consumer's 64-key tile of the keep mask, and its row of tiles
    const int n_k64 = (a.skv + MASK_TILE - 1) / MASK_TILE;
    const int mj = blockIdx.x * 2 + c;
    uint32_t* mrow = (DQ || !DROP) ? nullptr
                                   : keep_mask + ((size_t)bh * n_k64 + mj) * n_q * MASK_WORDS + ct;
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
        if constexpr (!DQ) {
          if (mj < n_k64)
            mrow[(size_t)i * MASK_WORDS] = keep_in_bounds(b, i * B_Q, t, k0, a.sq, a.skv);
        }
        fence_regs(keep);  // here, before the wait for the products
      }
    };
    keep_bits(0);
    if constexpr (DQ) mbar_wait(smem_u32(&kbar), 0);

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
      // (DQ) ds (q x keys, 128-byte swizzle) into shared memory for dq
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
        if constexpr (DQ) {
          // (ql, kl..kl+1) and (ql + 1, kl..kl+1): 16-byte chunk kl / 8 of the
          // row, swizzled by the row's index mod 8
          const int col = (kl & 7) << 1;
          *reinterpret_cast<uint32_t*>(dsb + ql * 128 + (((kl >> 3) ^ (ql & 7)) << 4) + col) =
              pack_bf16(s0, s2);
          *reinterpret_cast<uint32_t*>(dsb + (ql + 1) * 128 +
                                       (((kl >> 3) ^ ((ql + 1) & 7)) << 4) + col) =
              pack_bf16(s1, s3);
        }
      }

      // dv += pm^T dO, dk += ds^T q_s (contraction over the tile's q rows)
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < B_Q / 16; ++j) {
        wgmma_rs<1>(dv, pma[j], wgmma_desc(dos + j * 16 * RB, RB, true), 1);
        wgmma_rs<1>(dk, dsa[j], wgmma_desc(qs + j * 16 * RB, RB, true), 1);
      }
      wgmma_commit();
      if constexpr (DQ) {
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
      }
      if (i + 1 < n_q) keep_bits(i + 1);
      wgmma_wait<0>();
      if constexpr (DQ) fence_regs(dq);
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(pma);
      fence_regs(dsa);
      if (lane == 0) mbar_arrive(smem_u32(&empty[s]));

      if constexpr (DQ) {
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
    }
    if constexpr (DQ) {
      if (ct == 0) bulk_wait();
    }

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

// DQ: a.dq is the f32 accumulator; !DQ: a.dq is unused and, under DROP,
// keep_mask receives the keep bits (nullptr otherwise).
template <int D, bool DROP, bool DQ>
int launch_wgmma(const BwdArgs& a, int bh, const DropoutParams& dp, uint32_t* keep_mask,
                 cudaStream_t stream) {
  CUtensorMap tq, tdo, tk;
  if (!bf16_rows_map(&tq, a.q, bh, a.sq, D, B_Q) ||
      !bf16_rows_map(&tdo, a.dout, bh, a.sq, D, B_Q) ||
      !bf16_rows_map(&tk, a.k, bh, a.skv, D, B_KEYS))
    return (int)cudaErrorInvalidValue;
  constexpr size_t bytes = WgSmem<D, DQ>::bytes;
  auto kern = flash_bwd_wgmma_kernel<D, DROP, DQ>;
  const cudaError_t e = allow_smem(kern, bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3((a.skv + B_KEYS - 1) / B_KEYS, bh), B_THREADS, bytes, stream>>>(tq, tdo, tk, a,
                                                                             dp, keep_mask);
  return (int)cudaGetLastError();
}

}  // namespace fbwd
}  // namespace gaot
