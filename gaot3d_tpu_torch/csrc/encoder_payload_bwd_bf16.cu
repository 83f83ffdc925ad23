// Backward of the fused encoder payload + scatter for Hopper (sm_90a), K5b,
// bf16 body (`kernel_dtype: bfloat16`).
//
// Replaces gaot3d_tpu/ops/pallas_encoder.py `_payload_bwd_call` (kernel
// `_bwd_kernel`) with the backward of the scatter, at the rounding points of
// jax.grad through the JAX package's bf16 kernel MLP
// (gaot3d_tpu/models/mlp.py `kernel_mlp_apply`). For every valid (node, slot)
// row it gathers gv = g[b, cell, :C], recomputes the kernel MLP on
// [point | cell] and produces
//     dfeats[node] = sum over the node's slots of gv * mlp_out
//     d_out = gv * feats[node], then per layer from the last to the first
//     dW_l += bf16(in_l)^T d_l,  db_l += sum d_l,
//     d_{l-1} = bf16(d_l W_l^T) * gelu'(z_{l-1}),
// with weights and inputs (positions included) rounded to bf16 and the f32
// cotangent never rounded. JAX rounds dW to bf16 once for each node chunk:
// the kernel adds each chunk's f32 dW and db into that chunk's slice of
// dparams [n_chunks, P], and the wrapper rounds each slice's weights and sums
// the slices (kernels/encoder_payload.py). One launch serves the whole call.
//
// Design (encoder_tiles.cuh has the machinery). The card's GELU work (erf
// and exp) and the chains of dependent products are latency-bound at one
// CTA of 8 warps an SM, so the body is laid out for two, within 128
// registers a thread and half an SM's shared memory:
//  - valid-row tiles: the CTAs walk the items of the wrapper's tile map
//    (whole nodes of one node chunk, their valid rows only, at most 128), a
//    contiguous range each; a CTA compacts an item's valid slots with a
//    ballot scan of the masks, so masked slots cost one byte read, not a row;
//  - no hidden layer's pre-activation is kept for the tile: on the way down
//    each warp recomputes z_{l-1} for its own 16 rows from x0 (bf16
//    products, a few percent of the tile's), takes gelu and gelu' of it,
//    writes bf16(gelu) as the weight product's X and keeps gelu' in
//    registers for the chain, whose result d_{l-1} also waits in registers
//    until the other warps have read d_l;
//  - shared memory holds the bf16 weights (one [in][out] copy, read both
//    ways), x0, X, one cotangent tile (first the feature and cotangent rows,
//    then d_out and gv * out, then d_l) and the hidden layers' dW slices:
//    108.0 KiB for the recipe's 6-64-64-64-32;
//  - products on the tensor cores with `mma.sync`: the recompute one bf16
//    m16n8k16 pass; the chain's d W^T and the weight products as 2xTF32 (hi
//    and lo of the f32 cotangent against the bf16 value, exact in TF32), the
//    hidden layers' as dW^T = d^T bf16(in), so that a warp splits each
//    cotangent value once for all the n-tiles it covers, and the chain's k
//    loop rolled (two CTAs' register budget).
//    wgmma would want the tile's 128 rows as one operand of every product,
//    where each warp's chain runs on its own 16 rows;
//  - dW and db: each warp owns a fixed slice, the hidden layers' dW in shared
//    memory and the rest in registers, kept while its items
//    stay in one node chunk and added into that chunk's slice of dparams with
//    float atomics when it moves to another chunk and at the end, so dW and
//    db change in their last bits from run to run;
//  - dfeats: a node's rows are adjacent in its item, summed there in a fixed
//    order and stored with a plain store (the caller zeroes dfeats, so nodes
//    without a valid slot stay zero): the same bits on every launch. A node
//    with more than 128 valid rows (K > 128) carries its sum across the
//    passes of its item in one CTA.
//
// What bounds it on an H100: the GELU's erf and exp on the FP32 and
// special-function pipes (3 gelu and 3 gelu with gelu' a hidden unit), then
// the products (one bf16 pass for the recompute, two TF32 passes each for
// the chain and dW); the dW flush's atomics in L2 are small beside them.
#include "encoder_tiles.cuh"

namespace {

using namespace enc;

constexpr size_t MAX_SMEM = 232448;  // per-block limit of sm_90

template <int HID, int C, int NMID>
struct Bf16BwdLayout {
  // the cotangent tile: F | G (Mat<C> each), then d_l (Mat<HID>)
  static constexpr int FG = R * Mat<C>::S;
  static constexpr int YF = R * Mat<HID>::S > 2 * FG ? R * Mat<HID>::S : 2 * FG;
  static constexpr int XF = R * X0::S;  // x0
  // the hidden layers' dW, each warp's slices (MidSlice)
  static constexpr int DWM = NMID * WARPS * Split<HID / 16, HID / 8>::WN * 4 * 32;
  static constexpr int BIAS = ((HID * (NMID + 1) + C) + 3) & ~3;
  static constexpr int FLOATS = YF + XF + DWM + BIAS + C;  // C: the carried dfeats
  // bf16: the weights [in][out] (the first layer padded to 16 rows), then X
  static constexpr int W0 = 16 * HID, WM = HID * HID, WL = HID * C;
  static constexpr int HALVES = W0 + NMID * WM + WL + R * HID;
  static constexpr int INTS = 2 * R + WARPS;  // the rows' slots and nodes, the scan's scratch
  static constexpr size_t BYTES = (size_t)FLOATS * 4 + (size_t)HALVES * 2 + (size_t)INTS * 4;
};

// z -> gelu(z) in place for the warp's rows, gelu'(z) into gp, bf16(gelu(z))
// (the weight product's X, and what the next layer multiplies) into Xb
template <int HID>
__device__ __forceinline__ void gelu_grad_rows(float (&z)[HID / 8][4], float (&gp)[HID / 8][4],
                                               uint16_t* Xb, int row0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < HID / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) gelu_and_grad(z[nt][e], z[nt][e], gp[nt][e]);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<uint32_t*>(Xb + BMat<HID>::at(row0 + g + 8 * hr, 8 * nt + 2 * t)) =
          pack_bf16(z[nt][2 * hr], z[nt][2 * hr + 1]);
  }
}

// acc = bf16(d W^T) * gp for the warp's rows: d the f32 cotangent of the
// warp's rows in a Mat<OUT>, split into hi and lo, W in bf16 (2xTF32: a
// bf16 value is exact in TF32), the product rounded to bf16 as the cotangent
// of a bf16 operand is, then times gelu' in f32
template <int IN, int OUT>
__device__ __forceinline__ void chain_bf16(const float* D, int row0, const Bf16Weights<OUT>& w,
                                           const float (&gp)[IN / 8][4], float (&acc)[IN / 8][4],
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
  zero(acc);
#pragma unroll 1  // rolled: its registers stay within two CTAs' budget
  for (int kt = 0; kt < OUT / 8; ++kt) {
    const float2 top =
        *reinterpret_cast<const float2*>(D + Mat<OUT>::at(row0 + g, 8 * kt + 2 * t));
    const float2 bot =
        *reinterpret_cast<const float2*>(D + Mat<OUT>::at(row0 + g + 8, 8 * kt + 2 * t));
    const float a[4] = {top.x, bot.x, top.y, bot.y};  // the permuted k order
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
    for (int e = 0; e < 4; ++e) acc[nt][e] = round_bf16(acc[nt][e]) * gp[nt][e];
}

// A warp's slice of a hidden layer's dW^T in shared memory, lane-major
// ([j][e][lane]): added to after each tile, taken (and zeroed) at a chunk's
// end.
template <int HID>
struct MidSlice {
  using S = Split<HID / 16, HID / 8>;
  static constexpr int FLOATS = S::WN * 4 * 32;
  float* p;
  __device__ __forceinline__ void add(const float (&acc)[S::WN][4], int lane) const {
#pragma unroll
    for (int j = 0; j < S::WN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[(j * 4 + e) * 32 + lane] += acc[j][e];
  }
  __device__ __forceinline__ void take(float (&acc)[S::WN][4], int lane) const {
#pragma unroll
    for (int j = 0; j < S::WN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[j][e] = p[(j * 4 + e) * 32 + lane];
        p[(j * 4 + e) * 32 + lane] = 0.f;
      }
  }
};

template <int HID, int C, int NMID>
__global__ void __launch_bounds__(THREADS, 2)
    encoder_backward_bf16_kernel(const float* __restrict__ pos, const float* __restrict__ feats,
                                 const int32_t* __restrict__ lat_idx,
                                 const uint8_t* __restrict__ mask,
                                 const float* __restrict__ params, int n_params, Tiling T,
                                 TileMap map, GridSpec grid, const float* __restrict__ gacc,
                                 float* __restrict__ dfeats, float* __restrict__ dparams) {
  using L = Bf16BwdLayout<HID, C, NMID>;
  using SF = Split<HID / 16, 1>;        // dW0^T: m the hidden unit, n the (padded) input
  using SM = Split<HID / 16, HID / 8>;  // hidden -> hidden
  using SL = Split<HID / 16, C / 8>;    // hidden -> output
  constexpr int OFF_MID = 7 * HID;  // packed params offsets
  constexpr int OFF_LAST = OFF_MID + NMID * (HID * HID + HID);
  static_assert(MidSlice<HID>::FLOATS * WARPS * NMID == L::DWM, "the hidden layers' slices");

  extern __shared__ float4 smem4[];
  float* Y = reinterpret_cast<float*>(smem4);  // F | G, then d_l
  float* F = Y;                                // feature rows, then d_out
  float* G = Y + L::FG;                        // cotangent rows, then gv * out
  float* x0 = Y + L::YF;
  float* smid = x0 + L::XF;
  float* sb = smid + L::DWM;
  float* carry = sb + L::BIAS;
  uint16_t* sw0 = reinterpret_cast<uint16_t*>(carry + C);
  uint16_t* swm = sw0 + L::W0;
  uint16_t* swl = swm + NMID * L::WM;
  uint16_t* X = swl + L::WL;
  int* slots = reinterpret_cast<int*>(X + R * HID);
  int* nodes = slots + R;
  int* scratch = nodes + R;

  {
    const float* p = params;
    stage_bf16_mat<HID>(sw0, p, 6, 16);
    p += 6 * HID;
    for (int i = threadIdx.x; i < HID; i += THREADS) sb[i] = p[i];
    p += HID;
#pragma unroll 1
    for (int l = 0; l < NMID; ++l) {
      stage_bf16_mat<HID>(swm + l * L::WM, p, HID, HID);
      p += HID * HID;
      for (int i = threadIdx.x; i < HID; i += THREADS) sb[HID * (l + 1) + i] = p[i];
      p += HID;
    }
    stage_bf16_mat<C>(swl, p, HID, HID);
    p += HID * C;
    for (int i = threadIdx.x; i < C; i += THREADS) sb[HID * (NMID + 1) + i] = p[i];
    for (int i = threadIdx.x; i < L::DWM; i += THREADS) smid[i] = 0.f;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_i = threadIdx.x & (R - 1);
  const int half = threadIdx.x / R;
  const int wrow = 16 * warp;
  const Bf16Weights<HID> w_first{sw0};
  const Bf16Weights<C> w_last{swl};
  auto w_mid = [&](int l) { return Bf16Weights<HID>{swm + l * L::WM}; };
  auto mid_slice = [&](int l) {
    return MidSlice<HID>{smid + (l * WARPS + warp) * MidSlice<HID>::FLOATS};
  };

  // this warp's slices of the first and last layers' gradient and of every
  // db, in registers (the hidden layers' dW in shared memory)
  constexpr int NM = NMID > 0 ? NMID : 1;
  float dw0[SF::WN][4], db0[2];
  float dbm[NM][2];
  float dwl[SL::WN][4], dbl[SL::WN];
  auto zero_slices = [&]() {
    zero(dw0);
    zero(dwl);
    db0[0] = db0[1] = 0.f;
#pragma unroll
    for (int l = 0; l < NM; ++l) dbm[l][0] = dbm[l][1] = 0.f;
#pragma unroll
    for (int j = 0; j < SL::WN; ++j) dbl[j] = 0.f;
  };
  auto flush_slices = [&](int chunk) {
    float* dp = dparams + (long long)chunk * n_params;
    flush<HID / 16, 1, false, true>(dw0, db0, dp, dp + 6 * HID, HID, 6, warp, lane);
#pragma unroll
    for (int l = 0; l < NMID; ++l) {
      float acc[SM::WN][4];
      mid_slice(l).take(acc, lane);
      float* w = dp + OFF_MID + l * (HID * HID + HID);
      flush<HID / 16, HID / 8, false, true>(acc, dbm[l], w, w + HID * HID, HID, HID, warp, lane);
    }
    flush<HID / 16, C / 8, true, false>(dwl, dbl, dp + OFF_LAST, dp + OFF_LAST + HID * C, C,
                                        HID, warp, lane);
    zero_slices();
  };
  zero_slices();
  int cur_chunk = -1;

  // z_upto for the warp's rows, recomputed from x0 (the forward's products)
  auto recompute = [&](float (&z)[HID / 8][4], int upto) {
    dense_first_bf16<HID>(x0, wrow, w_first, z, lane);
    add_bias(z, sb, lane);
#pragma unroll
    for (int l = 0; l < NMID; ++l) {
      if (l >= upto) break;
#pragma unroll
      for (int nt = 0; nt < HID / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) z[nt][e] = gelu(z[nt][e]);
      float nz[HID / 8][4];
      dense_bf16_packed<HID, HID>(z, w_mid(l), nz, lane);
      add_bias(nz, sb + HID * (l + 1), lane);
#pragma unroll
      for (int nt = 0; nt < HID / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) z[nt][e] = nz[nt][e];
    }
  };

  int first, last;
  item_range(map, blockIdx.x, gridDim.x, first, last);
  for (int item = first; item < last; ++item) {
    const int nf = map.node_first[item], ne = map.node_first[item + 1];
    if (nf == ne) continue;
    const int chunk = (nf % T.n) / map.chunk;
    int passes = 1;
    for (int pass = 0; pass < passes; ++pass) {
      __syncthreads();  // the last pass is done with the slots, x0, X and the cotangent tile
      const int count = gather_rows(mask, (long long)nf * T.k, (long long)ne * T.k, pass, slots,
                                    scratch);
      if (count == 0) break;  // nodes without a valid slot: their dfeats stay zero
      passes = (count + R - 1) / R;
      const int rows = count - pass * R < R ? count - pass * R : R;
      if (chunk != cur_chunk) {
        if (cur_chunk >= 0) flush_slices(cur_chunk);
        cur_chunk = chunk;
      }

      // the rows: x0, the feature rows into F, the cotangent rows into G
      {
        RowIn in;
        load_slot_row(in, T, row_i, rows, slots, pos, lat_idx);
        in.settle(T);
        if (half == 0) {
          in.write_x0(grid, x0, row_i);
          nodes[row_i] = in.present ? (int)in.node : -1;
        }
        const int c0 = half * (C / 2), c1 = c0 + C / 2;
        copy_feats<C>(F, row_i, in, feats, c0, c1);
        const float* src = gacc + (in.valid ? in.acc_row(T) * (C + 11) : 0);
        for (int c = c0; c < c1; ++c) cp_async4(G + Mat<C>::at(row_i, c), src + c, in.valid);
        cp_async_commit();
        cp_async_wait_all();
      }
      __syncthreads();

      // up: the warp's rows through the MLP, bf16(h) into X; d_out = gv * feats
      // over F, gv * out (dfeats' terms) over G; d_NMID = bf16(d_out W_L^T) *
      // gelu'(z_NMID), kept in registers until the cotangent tile is free
      float dz[HID / 8][4];
      {
        float h[HID / 8][4], gp[HID / 8][4];
        recompute(h, NMID);
        gelu_grad_rows<HID>(h, gp, X, wrow, lane);
        float o[C / 8][4];
        dense_bf16_packed<HID, C>(h, w_last, o, lane);
        add_bias(o, sb + HID * (NMID + 1), lane);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
#pragma unroll
          for (int nt = 0; nt < C / 8; ++nt) {
            const int at = Mat<C>::at(wrow + g + 8 * hr, 8 * nt + 2 * t);
            const float2 gv = *reinterpret_cast<const float2*>(G + at);
            const float2 f = *reinterpret_cast<const float2*>(F + at);
            *reinterpret_cast<float2*>(F + at) = make_float2(gv.x * f.x, gv.y * f.y);
            *reinterpret_cast<float2*>(G + at) =
                make_float2(gv.x * o[nt][2 * hr], gv.y * o[nt][2 * hr + 1]);
          }
        __syncwarp();
        chain_bf16<HID, C>(F, wrow, w_last, gp, dz, lane);
      }
      __syncthreads();

      wgrad<BMat<HID>, Mat<C>, HID / 16, C / 8, true, Operands::BF16_X, uint16_t>(X, F, dwl, dbl,
                                                                                 warp, lane);
      // dfeats: a node's rows are adjacent; a node's sum carries across the
      // passes of its item only when it has more than R rows (then the item's
      // rows are all its own)
      {
        const int carry_node = pass > 0 ? nodes[0] : -1;
        for (int p = threadIdx.x; p < rows * C; p += THREADS) {
          const int r = p / C, c = p - r * C;
          const int node = nodes[r];
          if (r > 0 && nodes[r - 1] == node) continue;
          float sum = r == 0 && node == carry_node ? carry[c] : 0.f;
          int q = r;
          for (; q < rows && nodes[q] == node; ++q) sum += G[Mat<C>::at(q, c)];
          if (q == rows && pass + 1 < passes)
            carry[c] = sum;
          else
            dfeats[(long long)node * C + c] = sum;
        }
      }
      __syncthreads();
      store_rows<HID>(Y, dz, wrow, lane);  // d_NMID

#pragma unroll
      for (int l = NMID; l >= 1; --l) {
        // z_{l-1} again: bf16(gelu) into X, d_{l-1} = bf16(d_l W_l^T) * gelu' into dz
        {
          float h[HID / 8][4], gp[HID / 8][4];
          recompute(h, l - 1);
          gelu_grad_rows<HID>(h, gp, X, wrow, lane);
          __syncwarp();
          chain_bf16<HID, HID>(Y, wrow, w_mid(l - 1), gp, dz, lane);
        }
        __syncthreads();
        {
          float acc[SM::WN][4];
          zero(acc);
          wgrad<Mat<HID>, BMat<HID>, HID / 16, HID / 8, false, Operands::BF16_Y, float, uint16_t>(
              Y, X, acc, dbm[l - 1], warp, lane);  // dW^T: d_l split once a warp of its columns
          mid_slice(l - 1).add(acc, lane);
        }
        __syncthreads();
        store_rows<HID>(Y, dz, wrow, lane);  // d_{l-1}
      }
      __syncthreads();
      // X the cotangent d_0, Y the positions rounded to bf16
      wgrad<Mat<HID>, X0, HID / 16, 1, false, Operands::BF16_Y>(Y, x0, dw0, db0, warp, lane);
    }
  }
  if (cur_chunk >= 0) flush_slices(cur_chunk);
}

template <int HID, int C, int NMID>
int occupancy(int& per_sm, int& sms) {
  static LaunchCache cache;
  return cache.get(encoder_backward_bf16_kernel<HID, C, NMID>, Bf16BwdLayout<HID, C, NMID>::BYTES,
                   NMID, per_sm, sms);
}

template <int HID, int C, int NMID>
int launch(const float* pos, const float* feats, const int32_t* lat_idx, const uint8_t* mask,
           const float* params, int n_params, int b, int n, int k, int m, GridSpec g,
           TileMap map, int max_items, const float* gacc, float* dfeats, float* dparams,
           cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  const int e = occupancy<HID, C, NMID>(per_sm, sms);
  if (e != 0) return e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const Tiling T = Tiling::make(b, n, k, m);
  const long long cap = (long long)sms * per_sm;
  const int blocks = (int)(max_items < cap ? max_items : cap);
  encoder_backward_bf16_kernel<HID, C, NMID>
      <<<blocks, THREADS, Bf16BwdLayout<HID, C, NMID>::BYTES, stream>>>(
          pos, feats, lat_idx, mask, params, n_params, T, map, g, gacc, dfeats, dparams);
  return (int)cudaGetLastError();
}

// A variant whose shared memory is over the block limit is not built.
template <int HID, int C, int NMID>
int built_occupancy() {
  int per_sm = 0, sms = 0;
  if constexpr (Bf16BwdLayout<HID, C, NMID>::BYTES <= MAX_SMEM)
    return occupancy<HID, C, NMID>(per_sm, sms) == 0 ? per_sm : 0;
  return 0;
}

template <int HID, int C, int NMID, class... Args>
int built_launch(Args... args) {
  if constexpr (Bf16BwdLayout<HID, C, NMID>::BYTES <= MAX_SMEM)
    return launch<HID, C, NMID>(args...);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The built variants: every width, with 0 to 3 hidden-to-hidden layers.
#define GAOT_K5B_VARIANTS(X)                                                             \
  X(64, 32, 0) X(64, 32, 1) X(64, 32, 2) X(64, 32, 3) X(64, 16, 0) X(64, 16, 1)          \
  X(64, 16, 2) X(64, 16, 3) X(32, 32, 0) X(32, 32, 1) X(32, 32, 2) X(32, 32, 3)          \
  X(32, 16, 0) X(32, 16, 1) X(32, 16, 2) X(32, 16, 3) X(16, 16, 0) X(16, 16, 1)          \
  X(16, 16, 2) X(16, 16, 3) X(16, 8, 0) X(16, 8, 1) X(16, 8, 2) X(16, 8, 3)

extern "C" {

// Shared-memory bytes a block needs for these widths and depth, or 0 for
// widths or depths not built.
long long gaot_encoder_backward_smem(int n_mid, int hid, int c) {
#define GAOT_K5B_SMEM(H, CC, NM) \
  if (hid == H && c == CC && n_mid == NM) return (long long)Bf16BwdLayout<H, CC, NM>::BYTES;
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
// [b, m, c + 11] f32 (the accumulator's cotangent); the tile map
// (node_first [max_items + 1] i32 and n_items [1] i32 on the device, chunk
// nodes a chunk); dfeats [b, n, c] f32 (zeroed by the caller: rows of nodes
// with a valid slot are written) and dparams [ceil(n / chunk), n_params] f32,
// each chunk's slice accumulated into (zeroed by the caller). All
// contiguous. Returns the launch's cudaError_t.
int gaot_encoder_backward(const void* pos, const void* feats, const void* lat_idx,
                          const void* mask, const void* params, int n_params, int n_mid,
                          int hid, int c, int b, int n, int k, int m, int d1, int d2,
                          float lo0, float lo1, float lo2, float sp0, float sp1, float sp2,
                          const void* node_first, const void* n_items, int max_items, int chunk,
                          const void* gacc, void* dfeats, void* dparams, void* stream) {
  const int expect = 6 * hid + hid + n_mid * (hid * hid + hid) + hid * c + c;
  if (n_params != expect || n_mid < 0 || b <= 0 || n <= 0 || k <= 0 || m <= 0 ||
      chunk <= 0 || max_items <= 0 || (long long)b * n * k >= (1LL << 31) ||
      (long long)b * m >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const GridSpec g{d1, d2, lo0, lo1, lo2, sp0, sp1, sp2};
  const TileMap map{static_cast<const int32_t*>(node_first), static_cast<const int32_t*>(n_items),
                    chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pos);
  const float* f = static_cast<const float*>(feats);
  const int32_t* li = static_cast<const int32_t*>(lat_idx);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  const float* w = static_cast<const float*>(params);
  const float* ga = static_cast<const float*>(gacc);
  float* df = static_cast<float*>(dfeats);
  float* dw = static_cast<float*>(dparams);
#define GAOT_K5B_CASE(H, CC, NM)                                                            \
  if (hid == H && c == CC && n_mid == NM)                                                   \
    return built_launch<H, CC, NM>(p, f, li, mk, w, n_params, b, n, k, m, g, map, max_items, \
                                   ga, df, dw, s);
  GAOT_K5B_VARIANTS(GAOT_K5B_CASE)
#undef GAOT_K5B_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
