// Fused encoder payload + masked scatter for Hopper (sm_90a), K5, bf16 body
// (`kernel_dtype: bfloat16`).
//
// Replaces gaot3d_tpu/ops/pallas_encoder.py `_payload_fwd_call` (kernel
// `_fwd_kernel` / `_slot_payload`) with the scatter that follows it
// (models/fused_encoder.py `_pass_chunk` + `_reduce`), with the products of
// the JAX package's bf16 kernel MLP (gaot3d_tpu/models/mlp.py
// `kernel_mlp_apply`): every layer's input, the positions [point | cell]
// included, and its weights rounded to bf16 to nearest even, one m16n8k16
// bf16 `mma.sync` pass with an f32 result, bias and GELU in f32; the last
// layer's output and everything after it (the product with the features and
// the 11 moment columns) stay f32. Each valid (node, slot) row adds
//     [ vals (C) | 1 | d | y (3) | yy^T sym 00,01,02,11,12,22 ]
// into acc[b, cell, :]; a valid row whose cell lies outside the grid is
// dropped, masked rows take no work.
//
// Design (encoder_tiles.cuh has the machinery): the CTAs walk the items of
// the wrapper's tile map (whole nodes, their valid rows only, at most 128 a
// tile), a contiguous range each, and compact an item's valid slots with a
// ballot scan of the masks, so masked slots cost one byte read. Each warp
// takes 16 rows through the MLP with the activations in registers; the
// weights are rounded once, when staged, in fragment order (one 8-byte
// shared load a fragment). Two CTAs of 8 warps an SM (67 KiB of shared
// memory each for the recipe), so one CTA's loads and scatter overlap the
// other's products and erf.
//
// The scatter (encoder_tiles.cuh `scatter_rows_v4`, shared with the f32
// body): the accumulator's rows are C+11 floats, so a row starts 16-byte
// aligned one time in four. A warp writes its rows' payloads into shared
// memory shifted by their misalignment, then adds every 16-byte aligned group
// of four columns with one v4 `red.global.add` and the up to three columns
// before and after them one at a time: about 13 reductions a row of the
// recipe's 43 columns, where v2 pairs and scalar moments took 35 (the
// reductions' rate in L2 bounds the scatter; tools/probe_encoder_payload.py
// `red_rates` measures both). The sum order, and so the last bits, change
// from run to run.
//
// What bounds it on an H100: the accumulator's reductions in L2, then the
// GELU's erf on the FP32 pipe (the products are a sixth of it).
#include "encoder_tiles.cuh"

namespace {

using namespace enc;

template <int HID, int C>
struct Bf16FwdLayout {
  // in fragment order, one half float a weight, the first layer padded to 16 rows
  static constexpr int W0 = 16 * HID / 2;
  static constexpr int WM = HID * HID / 2;
  static constexpr int WL = HID * C / 2;
  // a staged payload row: C + 11 floats shifted by up to 3, in 16-byte groups
  static constexpr int ROW = (C + 11 + 3 + 3) & ~3;
  // one of two stages of a tile's inputs: x0, feature rows, acc rows, slots
  static constexpr int STAGE = R * X0::S + R * Mat<C>::S + 2 * R;
  // the two stages, the staged payloads, the scan's scratch
  static constexpr int STAGES = 2 * STAGE + R * ROW + WARPS;
  __host__ __device__ static int bias_floats(int n_mid) {
    return ((HID * (n_mid + 1) + C) + 3) & ~3;
  }
  __host__ __device__ static int weight_floats(int n_mid) {
    return W0 + n_mid * WM + WL + bias_floats(n_mid);
  }
  __host__ __device__ static size_t bytes(int n_mid) {
    return (size_t)(weight_floats(n_mid) + STAGES) * sizeof(float);
  }
};

template <int HID, int C>
__global__ void __launch_bounds__(THREADS, 2)
    encoder_accumulate_bf16_kernel(const float* __restrict__ pos,
                                   const float* __restrict__ feats,
                                   const int32_t* __restrict__ lat_idx,
                                   const uint8_t* __restrict__ mask,
                                   const float* __restrict__ params, int n_mid, Tiling T,
                                   TileMap map, GridSpec grid, float* __restrict__ acc) {
  using L = Bf16FwdLayout<HID, C>;
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  float* sw0 = sw;                   // layer 0, [16][HID] as fragments
  float* swm = sw0 + L::W0;          // the n_mid hidden layers
  float* swl = swm + n_mid * L::WM;  // the last layer, [HID][C]
  float* sb = swl + L::WL;           // biases, in layer order
  float* stages = sw + L::weight_floats(n_mid);
  float* staged = stages + 2 * L::STAGE;  // payloads, 16 rows a warp
  int* scratch = reinterpret_cast<int*>(staged + R * L::ROW);
  auto x0_of = [&](int s) { return stages + s * L::STAGE; };
  auto f_of = [&](int s) { return x0_of(s) + R * X0::S; };
  auto arows_of = [&](int s) { return reinterpret_cast<int*>(f_of(s) + R * Mat<C>::S); };
  auto slots_of = [&](int s) { return arows_of(s) + R; };

  {
    const float* p = params;
    stage_bf16_fragments<HID>(reinterpret_cast<uint2*>(sw0), p, 6, 16);
    p += 6 * HID;
    for (int i = threadIdx.x; i < HID; i += THREADS) sb[i] = p[i];
    p += HID;
    for (int l = 0; l < n_mid; ++l) {
      stage_bf16_fragments<HID>(reinterpret_cast<uint2*>(swm + l * L::WM), p, HID, HID);
      p += HID * HID;
      for (int i = threadIdx.x; i < HID; i += THREADS) sb[HID * (l + 1) + i] = p[i];
      p += HID;
    }
    stage_bf16_fragments<C>(reinterpret_cast<uint2*>(swl), p, HID, HID);
    p += HID * C;
    for (int i = threadIdx.x; i < C; i += THREADS) sb[HID * (n_mid + 1) + i] = p[i];
  }

  const int lane = threadIdx.x & 31;
  const int row_i = threadIdx.x & (R - 1);  // the row this thread loads
  const int half = threadIdx.x / R;          // which half of its feature columns
  const int wrow = 16 * (threadIdx.x >> 5);  // the warp's first row in the tile

  // The CTA's work in units: pass `pass` of item `item`, `count` its valid
  // rows. `gather` finds the next unit with rows from (item, pass) on and
  // compacts its slots into stage s; `load` starts its rows' loads (slots,
  // points into registers, feature rows by cp.async), `commit` writes x0 and
  // the acc rows once they have landed. A unit's loads run while the
  // previous unit's MLP and scatter do.
  int first, last;
  item_range(map, blockIdx.x, gridDim.x, first, last);
  int item = first, pass = 0, count = 0;
  auto gather = [&](int s) {
    for (; item < last; ++item, pass = 0) {
      const int nf = map.node_first[item], ne = map.node_first[item + 1];
      if (nf == ne) continue;
      count = gather_rows(mask, (long long)nf * T.k, (long long)ne * T.k, pass, slots_of(s),
                          scratch);
      if (count > pass * R) return true;
    }
    return false;
  };
  RowIn in;
  auto load = [&](int s) {
    const int rows = count - pass * R < R ? count - pass * R : R;
    load_slot_row(in, T, row_i, rows, slots_of(s), pos, lat_idx);
    copy_feats<C>(f_of(s), row_i, in, feats, half * (C / 2), (half + 1) * (C / 2));
    cp_async_commit();
  };
  auto commit = [&](int s) {
    in.settle(T);
    if (half == 0) {
      in.write_x0(grid, x0_of(s), row_i);
      arows_of(s)[row_i] = in.valid ? (int)in.acc_row(T) : -1;
    }
  };

  bool have = gather(0);
  if (have) {
    load(0);
    commit(0);
  }
  for (int s = 0; have; s ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // stage s is complete, stage s^1 is free
    if ((pass + 1) * R < count) {
      ++pass;
    } else {
      ++item;
      pass = 0;
    }
    const bool next = gather(s ^ 1);
    if (next) load(s ^ 1);

    // the MLP for the warp's 16 rows
    const float* x0 = x0_of(s);
    float h[HID / 8][4];
    dense_first_bf16<HID>(x0, wrow, Bf16Fragments<HID>{reinterpret_cast<const uint2*>(sw0)}, h,
                          lane);
    bias_gelu(h, sb, lane);
    for (int l = 0; l < n_mid; ++l) {
      float z[HID / 8][4];
      dense_bf16_packed<HID, HID>(
          h, Bf16Fragments<HID>{reinterpret_cast<const uint2*>(swm + l * L::WM)}, z, lane);
      bias_gelu(z, sb + HID * (l + 1), lane);
#pragma unroll
      for (int nt = 0; nt < HID / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) h[nt][e] = z[nt][e];
    }
    float o[C / 8][4];
    dense_bf16_packed<HID, C>(h, Bf16Fragments<C>{reinterpret_cast<const uint2*>(swl)}, o,
                              lane);
    scatter_rows_v4<C, L::ROW>(o, sb + HID * (n_mid + 1), f_of(s), x0, arows_of(s),
                               staged + wrow * L::ROW, acc, wrow, lane);
    if (next) commit(s ^ 1);
    have = next;
  }
}

template <int HID, int C>
int occupancy(int n_mid, int& per_sm, int& sms) {
  static LaunchCache cache;
  return cache.get(encoder_accumulate_bf16_kernel<HID, C>, Bf16FwdLayout<HID, C>::bytes(n_mid),
                   n_mid, per_sm, sms);
}

template <int HID, int C>
int launch(const float* pos, const float* feats, const int32_t* lat_idx, const uint8_t* mask,
           const float* params, int n_mid, int b, int n, int k, int m, GridSpec g, TileMap map,
           int max_items, float* acc, cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  const int e = occupancy<HID, C>(n_mid, per_sm, sms);
  if (e != 0) return e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const Tiling T = Tiling::make(b, n, k, m);
  const long long cap = (long long)sms * per_sm;
  const int blocks = (int)(max_items < cap ? max_items : cap);
  encoder_accumulate_bf16_kernel<HID, C>
      <<<blocks, THREADS, Bf16FwdLayout<HID, C>::bytes(n_mid), stream>>>(
          pos, feats, lat_idx, mask, params, n_mid, T, map, g, acc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define GAOT_K5_WIDTHS(X) X(64, 32) X(64, 16) X(32, 32) X(32, 16) X(16, 16) X(16, 8)

// Shared-memory bytes a block needs for these widths and depth (the wrapper
// checks it against the device's limit), or 0 for widths not built.
long long gaot_encoder_accumulate_smem(int n_mid, int hid, int c) {
#define GAOT_K5_SMEM(H, CC) \
  if (hid == H && c == CC) return (long long)Bf16FwdLayout<H, CC>::bytes(n_mid);
  GAOT_K5_WIDTHS(GAOT_K5_SMEM)
#undef GAOT_K5_SMEM
  return 0;
}

// CTAs a multiprocessor holds for these widths and depth (0 when not built
// or on a launch error).
int gaot_encoder_accumulate_occupancy(int n_mid, int hid, int c) {
  int per_sm = 0, sms = 0;
#define GAOT_K5_OCC(H, CC) \
  if (hid == H && c == CC) return occupancy<H, CC>(n_mid, per_sm, sms) == 0 ? per_sm : 0;
  GAOT_K5_WIDTHS(GAOT_K5_OCC)
#undef GAOT_K5_OCC
  return 0;
}

// pos [b, n, 3] f32, feats [b, n, c] f32, lat_idx [b, n, k] i32, mask
// [b, n, k] u8 (torch.bool), the tile map (node_first [max_items + 1] i32
// and n_items [1] i32 on the device, chunk nodes a chunk), acc [b, m, c + 11]
// f32 (accumulated into), all contiguous. params packs the MLP as for the
// f32 body. Returns the launch's cudaError_t (0 on success).
int gaot_encoder_accumulate(const void* pos, const void* feats, const void* lat_idx,
                            const void* mask, const void* params, int n_params, int n_mid,
                            int hid, int c, int b, int n, int k, int m, int d1, int d2,
                            float lo0, float lo1, float lo2, float sp0, float sp1, float sp2,
                            const void* node_first, const void* n_items, int max_items,
                            int chunk, void* acc, void* stream) {
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
  float* a = static_cast<float*>(acc);
#define GAOT_K5_CASE(H, CC)                                                                \
  if (hid == H && c == CC)                                                                 \
    return launch<H, CC>(p, f, li, mk, w, n_mid, b, n, k, m, g, map, max_items, a, s);
  GAOT_K5_WIDTHS(GAOT_K5_CASE)
#undef GAOT_K5_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
