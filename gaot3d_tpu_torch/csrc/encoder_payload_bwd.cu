// Backward of the fused encoder payload + scatter for Hopper (sm_90a), K5b.
//
// Replaces gaot3d_tpu/ops/pallas_encoder.py `_payload_bwd_call` (kernel
// `_bwd_kernel`) together with the backward of the scatter that followed it.
// The forward (encoder_payload.cu) scattered every valid (node, slot) row's
// payload into acc[b, cell, :]; given the accumulator's cotangent
// g [b, m, C+11], each valid row GATHERS gv = g[b, cell, :C] (the 11 moment
// columns depend on positions only and carry no gradient), recomputes the
// kernel MLP on [point | cell] and produces
//     dfeats[node] = sum over the node's slots of gv * mlp_out
//     d_out = gv * feats[node], then per layer from the last to the first
//     dW_l += in_l^T d_l,  db_l += sum d_l,  d_{l-1} = (d_l W_l^T) * gelu'(z_{l-1})
// with the exact-erf GELU derivative, in f32 grade. Masked rows and valid
// rows whose cell is off the grid are skipped exactly as the forward skips
// them (their cotangent is zero). There is no gradient to positions.
//
// Design (encoder_tiles.cuh has the shared machinery): one persistent CTA of
// 8 warps an SM walks node-major tiles of 128 rows. Every product is
// GEMM-shaped over the tile's rows and runs on the tensor cores as 3xTF32:
//  - recompute, one warp per 16 rows, activations in registers; each hidden
//    layer's pre-activation z_l is kept for the tile in shared memory (gelu
//    and gelu' are recomputed from it when the chain needs them);
//  - chain, per warp on its own rows: d_{l-1} = (d_l W_l^T) * gelu'(z_{l-1}),
//    which also overwrites z_{l-1} with gelu(z_{l-1}) for the weight product;
//  - dW_l = in_l^T d_l over the tile's 128 rows: each warp owns a fixed slice
//    of every layer's dW and db and keeps it in registers across all its
//    tiles; a CTA adds its slices into dparams with float atomics once, at
//    the end (about 10.8k for the recipe), so dW and db change in their last
//    bits from run to run.
// Because a tile holds whole nodes, dfeats is summed over a node's slots in
// the tile and stored once with a plain store: no atomics, the same bits on
// every launch (a node with more slots than a tile carries its sum across
// its consecutive tiles). The next tile's slots, mask and points are loaded
// into registers before the chain, which hides their latency; after it,
// [point | cell] goes into the other half of a two-stage ring, and once the
// tile is done with its feature and cotangent rows (after the last layer's
// weight product) `cp.async` fetches the next tile's, the cotangent rows
// g[b, cell, :C] gathered from L2 (the accumulator fits), while the hidden
// layers' products run.
//
// What bounds it on an H100: the 3xTF32 products, 3 x 3 x 2 x 10,624 FLOPs a
// valid row of the recipe's 6-64-64-64-32 MLP on the tensor cores; two erf
// and one exp for each hidden unit on the FP32 and special-function pipes.
// Shared memory (the weights, the hidden layers' split into hi and lo; three
// z tiles; the rows: 211 KiB for the recipe) allows one CTA of 8 warps an SM.
//
// The bf16 body (`kernel_dtype: bfloat16`, this file built with
// -DGAOT_BF16=1) follows the rounding points of jax.grad through the JAX
// package's bf16 kernel MLP (gaot3d_tpu/models/mlp.py `kernel_mlp_apply`):
//  - the recompute takes the forward's products (encoder_payload.cu): inputs,
//    positions included, and weights rounded to bf16, m16n8k16 bf16 passes;
//  - the cotangent is never rounded. The chain takes d_l W_l^T as 2xTF32
//    against the bf16 weights and rounds the product to bf16 before gelu';
//  - dW_l = in_l^T d_l is 2xTF32 too, in_l rounded to bf16 (the activations,
//    and x0 for the first layer) and the f32 cotangent split; db stays f32.
//    dW is flushed in f32 as above: JAX rounds it to bf16 once for each of
//    its node chunks, so the wrapper launches once a chunk, rounds each
//    launch's dW and sums them (kernels/encoder_payload.py).
// The weights are held rounded, as f32, once each (no lo half): 179 KiB of
// shared memory for the recipe.
#include "encoder_tiles.cuh"

#ifndef GAOT_BF16
#define GAOT_BF16 0
#endif

namespace {

using namespace enc;

constexpr size_t MAX_SMEM = 232448;  // per-block limit of sm_90
constexpr bool BF16 = GAOT_BF16 != 0;

template <int HID, int C, int NMID, bool BF = BF16>
struct BwdLayout {
  static constexpr int W0 = 8 * Mat<HID>::S;
  static constexpr int WM = HID * Mat<HID>::S;
  static constexpr int WL = HID * Mat<C>::S;
  static constexpr int BIAS = ((HID * (NMID + 1) + C) + 3) & ~3;
  // f32: the hidden layers as hi and lo; bf16: rounded, once
  static constexpr int WEIGHTS = W0 + (BF ? 1 : 2) * NMID * WM + WL + BIAS;
  static constexpr int Z = R * Mat<HID>::S;   // one hidden layer: z, then gelu(z), then its cotangent
  static constexpr int FG = R * Mat<C>::S;    // F (feats -> d_out), G (gv -> gv * out)
  static constexpr int X = R * X0::S;         // x0, one of a two-stage ring
  static constexpr size_t BYTES =
      (size_t)(WEIGHTS + (NMID + 1) * Z + 2 * X + 2 * FG) * sizeof(float);
};

// How the 8 warps share the weight product of an [MT x 16] x [NT x 8] matrix
// summed over the tile's rows: MT warps a column of n-tiles, NG groups of WN
// n-tiles, and the rows in KS slices.
template <int MT, int NT>
struct Split {
  static constexpr int G = WARPS / MT;
  static constexpr int NG = G < NT ? G : NT;
  static constexpr int KS = G / NG;
  static constexpr int WN = NT / NG;
  static constexpr int KT = R / 8 / KS;
  static_assert(WARPS % MT == 0 && G % NG == 0 && NT % NG == 0, "warps must tile the product");
};

// How a weight product takes its operands: both f32 (3xTF32), or one of them
// rounded to bf16 (exact in TF32) and the other, an f32 cotangent, split
// (2xTF32).
enum class Operands { F32, BF16_X, BF16_Y };

// acc[m][n] += sum_r X[r][m] * Y[r][n] for this warp's slice, with db the
// column sums of Y (DB_Y, this warp's n-tiles, by the warps of m-tile 0) or
// of X (the warp's two m rows g, g+8, by the warps of n group 0). db sums the
// values as stored, never rounded.
template <class XL, class YL, int MT, int NT, bool DB_Y, Operands OP = Operands::F32>
__device__ __forceinline__ void wgrad(const float* X, const float* Y,
                                      float (&acc)[Split<MT, NT>::WN][4],
                                      float (&db)[DB_Y ? Split<MT, NT>::WN : 2], int warp,
                                      int lane) {
  using S = Split<MT, NT>;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp % MT, q = warp / MT, ng = q % S::NG, ks = q / S::NG;
  const int m0 = 16 * mt, n0 = 8 * S::WN * ng;
  const bool do_db = DB_Y ? mt == 0 : ng == 0;
#pragma unroll 2
  for (int kk = 0; kk < S::KT; ++kk) {
    const int r0 = 8 * (ks * S::KT + kk) + 2 * t;
    const float a[4] = {X[XL::at(r0, m0 + g)], X[XL::at(r0, m0 + g + 8)],
                        X[XL::at(r0 + 1, m0 + g)], X[XL::at(r0 + 1, m0 + g + 8)]};
    if (!DB_Y && do_db) {
      db[0] += a[0] + a[2];
      db[1] += a[1] + a[3];
    }
    uint32_t ah[4], al[4];
    if constexpr (OP == Operands::BF16_X) {
#pragma unroll
      for (int i = 0; i < 4; ++i) ah[i] = __float_as_uint(round_bf16(a[i]));
    } else {
      split4(a, ah, al);
    }
#pragma unroll
    for (int j = 0; j < S::WN; ++j) {
      const int c = n0 + 8 * j + g;
      const float y0 = Y[YL::at(r0, c)], y1 = Y[YL::at(r0 + 1, c)];
      if (DB_Y && do_db) db[j] += y0 + y1;
      if constexpr (OP == Operands::F32) {
        mma3(acc[j], ah, al, y0, y1);
      } else if constexpr (OP == Operands::BF16_X) {
        uint32_t yh[2], yl[2];
        split(y0, yh[0], yl[0]);
        split(y1, yh[1], yl[1]);
        mma_tf32(acc[j], ah, yl[0], yl[1]);
        mma_tf32(acc[j], ah, yh[0], yh[1]);
      } else {
        const uint32_t b0 = __float_as_uint(round_bf16(y0)), b1 = __float_as_uint(round_bf16(y1));
        mma_tf32(acc[j], al, b0, b1);
        mma_tf32(acc[j], ah, b0, b1);
      }
    }
  }
}

// Adds a warp's slice of dW (and db) into the packed gradient: `w` at [in][out]
// with `out` columns, `b` the bias. TRANSPOSED: the slice is of dW^T (m the
// output unit, n the input, of which only the first `in_real` exist).
template <int MT, int NT, bool DB_Y, bool TRANSPOSED>
__device__ __forceinline__ void flush(const float (&acc)[Split<MT, NT>::WN][4],
                                      float (&db)[DB_Y ? Split<MT, NT>::WN : 2], float* w,
                                      float* b, int out, int in_real, int warp, int lane) {
  using S = Split<MT, NT>;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp % MT, q = warp / MT, ng = q % S::NG;
  const int m0 = 16 * mt, n0 = 8 * S::WN * ng;
#pragma unroll
  for (int j = 0; j < S::WN; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + g + 8 * (e >> 1), n = n0 + 8 * j + 2 * t + (e & 1);
      if (TRANSPOSED) {
        if (n < in_real) atomicAdd(w + n * out + m, acc[j][e]);
      } else {
        atomicAdd(w + m * out + n, acc[j][e]);
      }
    }
  }
  constexpr int NDB = DB_Y ? S::WN : 2;
#pragma unroll
  for (int j = 0; j < NDB; ++j) {
    float v = db[j];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    const bool do_db = DB_Y ? mt == 0 : ng == 0;
    if (do_db && t == 0) atomicAdd(b + (DB_Y ? n0 + 8 * j + g : m0 + g + 8 * j), v);
  }
}

template <int N>
__device__ __forceinline__ void add_bias(float (&z)[N][4], const float* b, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < N; ++nt) {
    const float b0 = b[8 * nt + 2 * t], b1 = b[8 * nt + 2 * t + 1];
    z[nt][0] += b0;
    z[nt][1] += b1;
    z[nt][2] += b0;
    z[nt][3] += b1;
  }
}

// the warp's 16 rows of an accumulator into a Mat<W>
template <int W>
__device__ __forceinline__ void store_rows(float* M, const float (&v)[W / 8][4], int row0,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < W / 8; ++nt) {
    *reinterpret_cast<float2*>(M + Mat<W>::at(row0 + g, 8 * nt + 2 * t)) =
        make_float2(v[nt][0], v[nt][1]);
    *reinterpret_cast<float2*>(M + Mat<W>::at(row0 + g + 8, 8 * nt + 2 * t)) =
        make_float2(v[nt][2], v[nt][3]);
  }
}

// dz *= gelu'(z) for the warp's rows, z read from Zl, which then holds gelu(z)
template <int HID>
__device__ __forceinline__ void through_gelu(float (&dz)[HID / 8][4], float* Zl, int row0,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
#pragma unroll
    for (int nt = 0; nt < HID / 8; ++nt) {
      float2* p = reinterpret_cast<float2*>(Zl + Mat<HID>::at(row0 + g + 8 * hr, 8 * nt + 2 * t));
      const float2 z = *p;
      float h0, gp0, h1, gp1;
      gelu_and_grad(z.x, h0, gp0);
      gelu_and_grad(z.y, h1, gp1);
      dz[nt][2 * hr] *= gp0;
      dz[nt][2 * hr + 1] *= gp1;
      *p = make_float2(h0, h1);
    }
}

// acc[16 x IN] = d[16 x OUT] * W^T for the warp's rows, W [IN][OUT]
template <int IN, int OUT, class Weights>
__device__ __forceinline__ void chain(const float (&d)[OUT / 8][4], const Weights& w,
                                      float (&acc)[IN / 8][4], int lane) {
  zero(acc);
#pragma unroll
  for (int kt = 0; kt < OUT / 8; ++kt) {
    float a[4];
    as_a(d[kt], a);
    uint32_t ah[4], al[4];
    split4(a, ah, al);
#pragma unroll
    for (int nt = 0; nt < IN / 8; ++nt) {
      uint32_t bh[2], bl[2];
      w.fragment_t(kt, nt, lane, bh, bl);
      mma3(acc[nt], ah, al, bh, bl);
    }
  }
}

// The bf16 chain: acc = bf16(d W^T) for the warp's rows, d the f32 cotangent
// split into hi and lo, W rounded to bf16 (2xTF32), the result rounded to
// bf16 as the cotangent of a bf16 operand is.
template <int IN, int OUT, int ROWS>
__device__ __forceinline__ void chain_bf16(const float (&d)[OUT / 8][4],
                                           const RoundedWeights<OUT, ROWS>& w,
                                           float (&acc)[IN / 8][4], int lane) {
  zero(acc);
#pragma unroll
  for (int kt = 0; kt < OUT / 8; ++kt) {
    float a[4];
    as_a(d[kt], a);
    uint32_t ah[4], al[4];
    split4(a, ah, al);
#pragma unroll
    for (int nt = 0; nt < IN / 8; ++nt) {
      uint32_t b[2];
      w.fragment_t(kt, nt, lane, b);
      mma_tf32(acc[nt], al, b[0], b[1]);
      mma_tf32(acc[nt], ah, b[0], b[1]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < IN / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = round_bf16(acc[nt][e]);
}

template <int HID, int C, int NMID, bool BF>
__global__ void __launch_bounds__(THREADS, 1)
    encoder_backward_kernel(const float* __restrict__ pos, const float* __restrict__ feats,
                            const int32_t* __restrict__ lat_idx,
                            const uint8_t* __restrict__ mask, const float* __restrict__ params,
                            Tiling T, GridSpec grid, const float* __restrict__ gacc,
                            float* __restrict__ dfeats, float* __restrict__ dparams) {
  using L = BwdLayout<HID, C, NMID, BF>;
  constexpr Operands OP_X = BF ? Operands::BF16_X : Operands::F32;  // X: activations
  using SF = Split<HID / 16, 1>;        // dW0^T: m the hidden unit, n the (padded) input
  using SM = Split<HID / 16, HID / 8>;  // hidden -> hidden
  using SL = Split<HID / 16, C / 8>;    // hidden -> output
  constexpr int NM = NMID > 0 ? NMID : 1;
  constexpr int OFF_MID = 7 * HID;                           // packed params offsets
  constexpr int OFF_LAST = OFF_MID + NMID * (HID * HID + HID);

  extern __shared__ float4 smem4[];
  float* sw0 = reinterpret_cast<float*>(smem4);
  // per hidden layer: hi, then lo (f32); the rounded weights (bf16)
  uint32_t* swm = reinterpret_cast<uint32_t*>(sw0 + L::W0);
  float* swl = reinterpret_cast<float*>(swm + (BF ? 1 : 2) * NMID * L::WM);
  float* sb = swl + L::WL;
  float* zs = sw0 + L::WEIGHTS;                 // [NMID + 1] hidden tiles
  float* x0s = zs + (NMID + 1) * L::Z;          // [2] stages of x0
  float* F = x0s + 2 * L::X;
  float* G = F + L::FG;

  {
    const float* p = params;
    stage_weights<HID, BF>(sw0, p, 6, 8);
    p += 6 * HID;
    for (int i = threadIdx.x; i < HID; i += THREADS) sb[i] = p[i];
    p += HID;
#pragma unroll 1
    for (int l = 0; l < NMID; ++l) {
      if constexpr (BF)
        stage_weights<HID, true>(reinterpret_cast<float*>(swm) + l * L::WM, p, HID, HID);
      else
        stage_split_mats<HID>(swm + 2 * l * L::WM, swm + (2 * l + 1) * L::WM, p, HID);
      p += HID * HID;
      for (int i = threadIdx.x; i < HID; i += THREADS) sb[HID * (l + 1) + i] = p[i];
      p += HID;
    }
    stage_weights<C, BF>(swl, p, HID, HID);
    p += HID * C;
    for (int i = threadIdx.x; i < C; i += THREADS) sb[HID * (NMID + 1) + i] = p[i];
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_i = threadIdx.x & (R - 1);
  const int half = threadIdx.x / R;
  const int wrow = 16 * warp;

  auto x0_of = [&](int s) { return x0s + s * L::X; };
  auto z_of = [&](int l) { return zs + l * L::Z; };
  auto mid = [&](int l) { return SplitMats<HID>{swm + 2 * l * L::WM, swm + (2 * l + 1) * L::WM}; };
  auto mid_bf = [&](int l) {
    return RoundedWeights<HID, HID>{reinterpret_cast<const float*>(swm) + l * L::WM};
  };
  const RoundedWeights<HID, 8> first_bf{sw0};
  const RoundedWeights<C, HID> last_bf{swl};

  // the next tile: x0 into stage s, once its loads have landed ...
  auto commit_x0 = [&](RowIn& in, int s) {
    in.settle(T);
    if (half == 0) in.write_x0(grid, x0_of(s), row_i);
  };
  // ... and, once this tile is done with F and G, copies of its feature rows
  // and its cotangent rows (zeros for rows that are not valid) into them
  auto copy_rows = [&](const RowIn& in) {
    const int c0 = half * (C / 2), c1 = c0 + C / 2;
    copy_feats<C>(F, row_i, in, feats, c0, c1);
    const float* src = gacc + (in.valid ? in.acc_row(T) * (C + 11) : 0);
    for (int c = c0; c < c1; ++c) cp_async4(G + Mat<C>::at(row_i, c), src + c, in.valid);
    cp_async_commit();
  };

  // this warp's slices of the gradient, kept across all its tiles
  float dw0[SF::WN][4], db0[2];
  float dwm[NM][SM::WN][4], dbm[NM][SM::WN];
  float dwl[SL::WN][4], dbl[SL::WN];
  zero(dw0);
  zero(dwl);
  db0[0] = db0[1] = 0.f;
#pragma unroll
  for (int l = 0; l < NM; ++l) {
    zero(dwm[l]);
#pragma unroll
    for (int j = 0; j < SM::WN; ++j) dbm[l][j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < SL::WN; ++j) dbl[j] = 0.f;
  float carry = 0.f;  // dfeats of a node whose slots span tiles (k > R)

  Tile tile;
  if (!Tile::make(T, blockIdx.x, gridDim.x, 0, tile)) return;
  RowIn in;
  in.load(T, tile, row_i, pos, lat_idx, mask);
  commit_x0(in, 0);
  copy_rows(in);

  for (long long j = 0;; ++j) {
    const int s = (int)(j & 1);
    cp_async_wait_all();
    __syncthreads();  // x0 stage s, F and G are complete (and the weights are staged)
    Tile next;
    const bool has_next = Tile::make(T, blockIdx.x, gridDim.x, j + 1, next);

    // recompute: z_l of every hidden layer into shared memory
    float h[HID / 8][4];
    if constexpr (BF)
      dense_first_bf16<HID>(x0_of(s), wrow, first_bf, h, lane);
    else
      dense_first<HID>(x0_of(s), wrow, F32Weights<HID>{sw0}, h, lane);
    add_bias(h, sb, lane);
    store_rows<HID>(z_of(0), h, wrow, lane);
#pragma unroll
    for (int nt = 0; nt < HID / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[nt][e] = gelu(h[nt][e]);
#pragma unroll
    for (int l = 0; l < NMID; ++l) {
      float z[HID / 8][4];
      if constexpr (BF)
        dense_bf16<HID, HID>(h, mid_bf(l), z, lane);
      else
        dense<HID, HID>(h, mid(l), z, lane);
      add_bias(z, sb + HID * (l + 1), lane);
      store_rows<HID>(z_of(l + 1), z, wrow, lane);
#pragma unroll
      for (int nt = 0; nt < HID / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) h[nt][e] = gelu(z[nt][e]);
    }
    float o[C / 8][4];
    if constexpr (BF)
      dense_bf16<HID, C>(h, last_bf, o, lane);
    else
      dense<HID, C>(h, F32Weights<C>{swl}, o, lane);
    add_bias(o, sb + HID * (NMID + 1), lane);

    // d_out = gv * feats over F, gv * out (dfeats' terms) over G
    float d[C / 8][4];
    {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int nt = 0; nt < C / 8; ++nt) {
          const int at = Mat<C>::at(wrow + g + 8 * hr, 8 * nt + 2 * t);
          const float2 gv = *reinterpret_cast<const float2*>(G + at);
          const float2 f = *reinterpret_cast<const float2*>(F + at);
          d[nt][2 * hr] = gv.x * f.x;
          d[nt][2 * hr + 1] = gv.y * f.y;
          *reinterpret_cast<float2*>(F + at) = make_float2(d[nt][2 * hr], d[nt][2 * hr + 1]);
          *reinterpret_cast<float2*>(G + at) =
              make_float2(gv.x * o[nt][2 * hr], gv.y * o[nt][2 * hr + 1]);
        }
    }
    // the next tile's inputs land while the chain runs (loaded here, not at
    // the top, to keep them out of the recompute's registers)
    if (has_next) in.load(T, next, row_i, pos, lat_idx, mask);
    float dz[HID / 8][4];
    if constexpr (BF)
      chain_bf16<HID, C>(d, last_bf, dz, lane);
    else
      chain<HID, C>(d, F32Weights<C>{swl}, dz, lane);
    through_gelu<HID>(dz, z_of(NMID), wrow, lane);

    if (has_next) commit_x0(in, s ^ 1);  // x0 stage s^1 was last read before the sync above
    __syncthreads();

    // dfeats: each node's slots are adjacent rows of this tile
    {
      if (T.k <= R) {
        for (int p = threadIdx.x; p < tile.n_nodes * C; p += THREADS) {
          const int nl = p / C, c = p - nl * C;
          float sum = 0.f;
          for (int q = 0; q < T.k; ++q) sum += G[Mat<C>::at(nl * T.k + q, c)];
          dfeats[(tile.node0 + nl) * C + c] = sum;
        }
      } else if (threadIdx.x < C) {
        float sum = 0.f;
        for (int r = 0; r < tile.rows; ++r) sum += G[Mat<C>::at(r, threadIdx.x)];
        carry += sum;
        if (tile.last_chunk) {
          dfeats[tile.node0 * C + threadIdx.x] = carry;
          carry = 0.f;
        }
      }
    }
    wgrad<Mat<HID>, Mat<C>, HID / 16, C / 8, true, OP_X>(z_of(NMID), F, dwl, dbl, warp, lane);
    __syncthreads();
    if (has_next) copy_rows(in);  // F and G are free until the next tile's top

#pragma unroll
    for (int l = NMID; l >= 1; --l) {
      store_rows<HID>(z_of(l), dz, wrow, lane);  // gelu(z_l) there was used above
      float nz[HID / 8][4];
      if constexpr (BF)
        chain_bf16<HID, HID>(dz, mid_bf(l - 1), nz, lane);
      else
        chain<HID, HID>(dz, mid(l - 1), nz, lane);
      through_gelu<HID>(nz, z_of(l - 1), wrow, lane);
      __syncthreads();
      wgrad<Mat<HID>, Mat<HID>, HID / 16, HID / 8, true, OP_X>(z_of(l - 1), z_of(l), dwm[l - 1],
                                                               dbm[l - 1], warp, lane);
      __syncthreads();
#pragma unroll
      for (int nt = 0; nt < HID / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dz[nt][e] = nz[nt][e];
    }
    store_rows<HID>(z_of(0), dz, wrow, lane);
    __syncthreads();
    // X the cotangent, Y the positions (rounded to bf16 in the bf16 body)
    wgrad<Mat<HID>, X0, HID / 16, 1, false, BF ? Operands::BF16_Y : Operands::F32>(
        z_of(0), x0_of(s), dw0, db0, warp, lane);

    if (!has_next) break;
    tile = next;
  }

  flush<HID / 16, 1, false, true>(dw0, db0, dparams, dparams + 6 * HID, HID, 6, warp, lane);
#pragma unroll
  for (int l = 0; l < NMID; ++l) {
    float* w = dparams + OFF_MID + l * (HID * HID + HID);
    flush<HID / 16, HID / 8, true, false>(dwm[l], dbm[l], w, w + HID * HID, HID, HID, warp,
                                          lane);
  }
  flush<HID / 16, C / 8, true, false>(dwl, dbl, dparams + OFF_LAST, dparams + OFF_LAST + HID * C,
                                      C, HID, warp, lane);
}

template <int HID, int C, int NMID>
int occupancy(int& per_sm, int& sms) {
  static LaunchCache cache;
  return cache.get(encoder_backward_kernel<HID, C, NMID, BF16>, BwdLayout<HID, C, NMID>::BYTES,
                   NMID, per_sm, sms);
}

template <int HID, int C, int NMID>
int launch(const float* pos, const float* feats, const int32_t* lat_idx, const uint8_t* mask,
           const float* params, int b, int n, int k, int m, GridSpec g, const float* gacc,
           float* dfeats, float* dparams, cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  const int e = occupancy<HID, C, NMID>(per_sm, sms);
  if (e != 0) return e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const Tiling T = Tiling::make(b, n, k, m);
  const long long cap = (long long)sms * per_sm;
  const int blocks = (int)(T.items < cap ? T.items : cap);
  encoder_backward_kernel<HID, C, NMID, BF16>
      <<<blocks, THREADS, BwdLayout<HID, C, NMID>::BYTES, stream>>>(
          pos, feats, lat_idx, mask, params, T, g, gacc, dfeats, dparams);
  return (int)cudaGetLastError();
}

// A variant whose shared memory is over the block limit is not built.
template <int HID, int C, int NMID>
int built_occupancy() {
  int per_sm = 0, sms = 0;
  if constexpr (BwdLayout<HID, C, NMID>::BYTES <= MAX_SMEM)
    return occupancy<HID, C, NMID>(per_sm, sms) == 0 ? per_sm : 0;
  return 0;
}

template <int HID, int C, int NMID, class... Args>
int built_launch(Args... args) {
  if constexpr (BwdLayout<HID, C, NMID>::BYTES <= MAX_SMEM) return launch<HID, C, NMID>(args...);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The built variants: every width, with 0 to 3 hidden-to-hidden layers where
// the block's shared memory allows.
#define GAOT_K5B_VARIANTS(X)                                                             \
  X(64, 32, 0) X(64, 32, 1) X(64, 32, 2) X(64, 32, 3) X(64, 16, 0) X(64, 16, 1)          \
  X(64, 16, 2) X(64, 16, 3) X(32, 32, 0) X(32, 32, 1) X(32, 32, 2) X(32, 32, 3)          \
  X(32, 16, 0) X(32, 16, 1) X(32, 16, 2) X(32, 16, 3) X(16, 16, 0) X(16, 16, 1)          \
  X(16, 16, 2) X(16, 16, 3) X(16, 8, 0) X(16, 8, 1) X(16, 8, 2) X(16, 8, 3)

extern "C" {

// Shared-memory bytes a block needs for these widths and depth (the wrapper
// raises when it is over the device's limit: such a variant is not built),
// or 0 for widths or depths not built.
long long gaot_encoder_backward_smem(int n_mid, int hid, int c) {
#define GAOT_K5B_SMEM(H, CC, NM) \
  if (hid == H && c == CC && n_mid == NM) return (long long)BwdLayout<H, CC, NM>::BYTES;
  GAOT_K5B_VARIANTS(GAOT_K5B_SMEM)
#undef GAOT_K5B_SMEM
  return 0;
}

// CTAs a multiprocessor holds for this variant (0 when not built or on error).
int gaot_encoder_backward_occupancy(int n_mid, int hid, int c) {
#define GAOT_K5B_OCC(H, CC, NM) \
  if (hid == H && c == CC && n_mid == NM) return built_occupancy<H, CC, NM>();
  GAOT_K5B_VARIANTS(GAOT_K5B_OCC)
#undef GAOT_K5B_OCC
  return 0;
}

// pos [b, n, 3] f32, feats [b, n, c] f32, lat_idx [b, n, k] i32, mask
// [b, n, k] u8, params packed as for gaot_encoder_accumulate, gacc
// [b, m, c + 11] f32 (the accumulator's cotangent); dfeats [b, n, c] f32 is
// written whole (every node, zeros where no slot is valid) and dparams
// [n_params] f32 (packed like params) is accumulated into, so the caller
// zeroes it. All contiguous. Returns the launch's cudaError_t.
int gaot_encoder_backward(const void* pos, const void* feats, const void* lat_idx,
                          const void* mask, const void* params, int n_params, int n_mid,
                          int hid, int c, int b, int n, int k, int m, int d1, int d2,
                          float lo0, float lo1, float lo2, float sp0, float sp1, float sp2,
                          const void* gacc, void* dfeats, void* dparams, void* stream) {
  const int expect = 6 * hid + hid + n_mid * (hid * hid + hid) + hid * c + c;
  if (n_params != expect || n_mid < 0 || b <= 0 || n <= 0 || k <= 0 || m <= 0 ||
      (long long)b * n >= (1LL << 31) || (long long)b * m >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const GridSpec g{d1, d2, lo0, lo1, lo2, sp0, sp1, sp2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pos);
  const float* f = static_cast<const float*>(feats);
  const int32_t* li = static_cast<const int32_t*>(lat_idx);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  const float* w = static_cast<const float*>(params);
  const float* ga = static_cast<const float*>(gacc);
  float* df = static_cast<float*>(dfeats);
  float* dw = static_cast<float*>(dparams);
#define GAOT_K5B_CASE(H, CC, NM)            \
  if (hid == H && c == CC && n_mid == NM) \
    return built_launch<H, CC, NM>(p, f, li, mk, w, b, n, k, m, g, ga, df, dw, s);
  GAOT_K5B_VARIANTS(GAOT_K5B_CASE)
#undef GAOT_K5B_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
