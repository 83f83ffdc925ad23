// Fused encoder payload + masked scatter for Hopper (sm_90a), K5.
//
// Replaces gaot3d_tpu/ops/pallas_encoder.py `_payload_fwd_call` (kernel
// `_fwd_kernel` / `_slot_payload`) together with the scatter that follows it
// (models/fused_encoder.py `_pass_chunk` + `_reduce`). For every (node, slot)
// row whose mask is set, the kernel derives the latent cell centre from the
// flat cell index, runs the kernel MLP on [point | cell] (exact-erf GELU
// between layers, none after the last), multiplies by the lifted features
// and adds the payload
//     [ vals (C) | 1 | d | y (3) | yy^T sym 00,01,02,11,12,22 ]
// into acc[b, cell, :]. The [rows, C+11] payload never reaches device
// memory. Masked rows take no work and their cell index may hold any value;
// a valid row whose cell lies outside the grid is dropped (the model rejects
// such slots before it gets here).
//
// Design (encoder_tiles.cuh has the machinery): the kernel walks the
// wrapper's tile map (kernels/encoder_payload.py `tile_map`: whole nodes,
// their valid rows only, at most 128 an item), as the bf16 body and K9 do.
// A CTA holds the weights once, split into hi and lo when staged, in
// fragment order (one 16-byte shared load a fragment: 85 KiB for the
// recipe's 6-64-64-64-32 MLP), and two groups of 8 warps that share them.
// Each group takes a contiguous range of the map's items, compacts an item's
// valid slots with a ballot scan of the masks (a masked slot costs one byte
// read) and takes them 128 rows a tile, one warp per 16 rows. The layer
// products run on the tensor cores as 3xTF32 (`mma.sync` m16n8k8), which
// keeps f32 grade, with the activations in registers from layer to layer.
// While a group's warps compute a tile, its next tile's slots, points and
// cells are loaded into registers and its feature rows copied by
// `cp.async`. The scatter is the bf16 body's: payloads staged in
// shared memory by their misalignment, every 16-byte aligned group of four
// columns added by one v4 `red.global.add` (`scatter_rows_v4`). The groups
// sync on named barriers of their own, so one group's scan and loads overlap
// the other's products. One CTA of 16 warps an SM (217 KiB of shared memory
// for the recipe, 128 registers a thread, 36 bytes spilled); where two
// groups' stages do not fit beside deeper weights, one group of 8 warps. The
// sum order, and so the last bits, change from run to run.
//
// What bounds it on an H100, a valid row of the recipe's MLP: its products,
// 3 x 2 x 10,624 FLOPs on the tensor cores (2.55 ms for drivaerml's 19.83M
// valid rows at the 495 TFLOP/s TF32 peak); 192 exact-erf GELUs of about 23
// FP32-pipe instructions each (about 2.6 ms for those rows) beside about 800
// ALU instructions splitting the activations into hi and lo; and about 13
// L2 reductions. Only valid rows count: at drivaerml's slot budget 8, with
// 2.36 valid slots a node, 70% of the slots are masked.
//
// The bf16 body (`kernel_dtype: bfloat16`) is encoder_payload_bf16.cu.
#include "encoder_tiles.cuh"

namespace {

using namespace enc;

constexpr size_t SMEM_LIMIT = 232448;  // the shared memory a block of sm_90 may have

template <int HID, int C>
struct FwdLayout {
  // in fragment order, the weights split into hi and lo: two floats a weight
  static constexpr int W0 = 2 * 8 * HID;
  static constexpr int WM = 2 * HID * HID;
  static constexpr int WL = 2 * HID * C;
  // a staged payload row: C + 11 floats shifted by up to 3, in 16-byte groups
  static constexpr int ROW = (C + 11 + 3 + 3) & ~3;
  // one of two stages of a tile's inputs: x0, feature rows, acc rows, slots
  static constexpr int STAGE = R * X0::S + R * Mat<C>::S + 2 * R;
  // a group's two stages, its staged payloads and its scan's scratch
  static constexpr int GROUP = 2 * STAGE + R * ROW + WARPS;
  __host__ __device__ static int bias_floats(int n_mid) {
    return ((HID * (n_mid + 1) + C) + 3) & ~3;
  }
  __host__ __device__ static int weight_floats(int n_mid) {
    return W0 + n_mid * WM + WL + bias_floats(n_mid);
  }
  __host__ __device__ static size_t bytes(int n_mid, int groups) {
    return (size_t)(weight_floats(n_mid) + groups * GROUP) * sizeof(float);
  }
  // two groups where their stages fit beside the weights, else one
  static int groups(int n_mid) { return bytes(n_mid, 2) <= SMEM_LIMIT ? 2 : 1; }
};

template <int HID, int C, int G>
__global__ void __launch_bounds__(THREADS * G, 1)
    encoder_accumulate_kernel(const float* __restrict__ pos, const float* __restrict__ feats,
                              const int32_t* __restrict__ lat_idx,
                              const uint8_t* __restrict__ mask,
                              const float* __restrict__ params, int n_mid, Tiling T,
                              TileMap map, GridSpec grid, float* __restrict__ acc) {
  using L = FwdLayout<HID, C>;
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  float* sw0 = sw;                   // layer 0, [8][HID] as fragments
  float* swm = sw0 + L::W0;          // the n_mid hidden layers
  float* swl = swm + n_mid * L::WM;  // the last layer, [HID][C]
  float* sb = swl + L::WL;           // biases, in layer order

  // stage the weights: the packed params are, per layer, W [in][out] then b
  {
    const float* p = params;
    stage_split_weights<HID>(reinterpret_cast<uint4*>(sw0), p, 6, 8);
    p += 6 * HID;
    for (int i = threadIdx.x; i < HID; i += blockDim.x) sb[i] = p[i];
    p += HID;
    for (int l = 0; l < n_mid; ++l) {
      stage_split_weights<HID>(reinterpret_cast<uint4*>(swm + l * L::WM), p, HID, HID);
      p += HID * HID;
      for (int i = threadIdx.x; i < HID; i += blockDim.x) sb[HID * (l + 1) + i] = p[i];
      p += HID;
    }
    stage_split_weights<C>(reinterpret_cast<uint4*>(swl), p, HID, HID);
    p += HID * C;
    for (int i = threadIdx.x; i < C; i += blockDim.x) sb[HID * (n_mid + 1) + i] = p[i];
  }
  __syncthreads();  // the weights are staged; from here each group syncs alone

  const WarpGroup grp{(int)(threadIdx.x / THREADS)};
  const int tid = grp.rank();
  const int lane = tid & 31;
  const int row_i = tid & (R - 1);  // the row this thread loads
  const int half = tid / R;         // which half of its feature columns
  const int wrow = 16 * (tid >> 5);  // the warp's first row in the tile

  float* stages = sw + L::weight_floats(n_mid) + grp.g * L::GROUP;
  float* staged = stages + 2 * L::STAGE;  // payloads, 16 rows a warp
  int* scratch = reinterpret_cast<int*>(staged + R * L::ROW);
  auto x0_of = [&](int s) { return stages + s * L::STAGE; };
  auto f_of = [&](int s) { return x0_of(s) + R * X0::S; };
  auto arows_of = [&](int s) { return reinterpret_cast<int*>(f_of(s) + R * Mat<C>::S); };
  auto slots_of = [&](int s) { return arows_of(s) + R; };

  // The group's work in units: pass `pass` of item `item`, `count` its valid
  // rows. `gather` finds the next unit with rows from (item, pass) on and
  // compacts its slots into stage s; `load` starts its rows' loads (slots,
  // points into registers, feature rows by cp.async), `commit` writes x0 and
  // the acc rows once they have landed. A unit's loads run while the
  // previous unit's MLP and scatter do.
  int first, last;
  item_range(map, blockIdx.x * G + grp.g, gridDim.x * G, first, last);
  int item = first, pass = 0, count = 0;
  auto gather = [&](int s) {
    for (; item < last; ++item, pass = 0) {
      const int nf = map.node_first[item], ne = map.node_first[item + 1];
      if (nf == ne) continue;
      count = gather_rows(mask, (long long)nf * T.k, (long long)ne * T.k, pass, slots_of(s),
                          scratch, grp);
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
    grp.sync();  // stage s is complete, stage s^1 is free
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
    dense_first<HID>(x0, wrow, SplitWeights<HID>{reinterpret_cast<const uint4*>(sw0)}, h, lane);
    bias_gelu(h, sb, lane);
    for (int l = 0; l < n_mid; ++l) {
      float z[HID / 8][4];
      dense<HID, HID>(h, SplitWeights<HID>{reinterpret_cast<const uint4*>(swm + l * L::WM)}, z,
                      lane);
      bias_gelu(z, sb + HID * (l + 1), lane);
#pragma unroll
      for (int nt = 0; nt < HID / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) h[nt][e] = z[nt][e];
    }
    float o[C / 8][4];
    dense<HID, C>(h, SplitWeights<C>{reinterpret_cast<const uint4*>(swl)}, o, lane);
    scatter_rows_v4<C, L::ROW>(o, sb + HID * (n_mid + 1), f_of(s), x0, arows_of(s),
                               staged + wrow * L::ROW, acc, wrow, lane);
    if (next) commit(s ^ 1);
    have = next;
  }
}

template <int HID, int C, int G>
int group_occupancy(int n_mid, int& per_sm, int& sms) {
  static LaunchCache cache;
  return cache.get(encoder_accumulate_kernel<HID, C, G>, FwdLayout<HID, C>::bytes(n_mid, G),
                   n_mid, per_sm, sms, THREADS * G);
}

template <int HID, int C>
int occupancy(int n_mid, int& per_sm, int& sms) {
  return FwdLayout<HID, C>::groups(n_mid) == 2 ? group_occupancy<HID, C, 2>(n_mid, per_sm, sms)
                                               : group_occupancy<HID, C, 1>(n_mid, per_sm, sms);
}

template <int HID, int C, int G>
int launch_groups(const float* pos, const float* feats, const int32_t* lat_idx,
                  const uint8_t* mask, const float* params, int n_mid, const Tiling& T,
                  GridSpec g, TileMap map, int max_items, float* acc, cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  const int e = group_occupancy<HID, C, G>(n_mid, per_sm, sms);
  if (e != 0) return e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long cap = (long long)sms * per_sm, want = (max_items + G - 1) / G;
  const int blocks = (int)(want < cap ? want : cap);
  encoder_accumulate_kernel<HID, C, G>
      <<<blocks, THREADS * G, FwdLayout<HID, C>::bytes(n_mid, G), stream>>>(
          pos, feats, lat_idx, mask, params, n_mid, T, map, g, acc);
  return (int)cudaGetLastError();
}

template <int HID, int C>
int launch(const float* pos, const float* feats, const int32_t* lat_idx, const uint8_t* mask,
           const float* params, int n_mid, int b, int n, int k, int m, GridSpec g, TileMap map,
           int max_items, float* acc, cudaStream_t stream) {
  const Tiling T = Tiling::make(b, n, k, m);
  return FwdLayout<HID, C>::groups(n_mid) == 2
             ? launch_groups<HID, C, 2>(pos, feats, lat_idx, mask, params, n_mid, T, g, map,
                                        max_items, acc, stream)
             : launch_groups<HID, C, 1>(pos, feats, lat_idx, mask, params, n_mid, T, g, map,
                                        max_items, acc, stream);
}

}  // namespace

extern "C" {

#define GAOT_K5_WIDTHS(X) X(64, 32) X(64, 16) X(32, 32) X(32, 16) X(16, 16) X(16, 8)

// Shared-memory bytes a block needs for these widths and depth (the wrapper
// checks it against the device's limit), or 0 for widths not built.
long long gaot_encoder_accumulate_smem(int n_mid, int hid, int c) {
#define GAOT_K5_SMEM(H, CC)                                                        \
  if (hid == H && c == CC)                                                         \
    return (long long)FwdLayout<H, CC>::bytes(n_mid, FwdLayout<H, CC>::groups(n_mid));
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

// Groups of 8 warps a CTA holds for these widths and depth (0 for widths
// not built).
int gaot_encoder_accumulate_groups(int n_mid, int hid, int c) {
#define GAOT_K5_GROUPS(H, CC) \
  if (hid == H && c == CC) return FwdLayout<H, CC>::groups(n_mid);
  GAOT_K5_WIDTHS(GAOT_K5_GROUPS)
#undef GAOT_K5_GROUPS
  return 0;
}

// pos [b, n, 3] f32, feats [b, n, c] f32, lat_idx [b, n, k] i32, mask
// [b, n, k] u8 (torch.bool), the tile map (node_first [max_items + 1] i32
// and n_items [1] i32 on the device, chunk nodes a chunk), acc [b, m, c + 11]
// f32 (accumulated into), all contiguous. params packs the MLP 6 -> hid
// (-> hid x n_mid) -> c as, per layer, W [in][out] row-major followed by its
// bias. Returns the launch's cudaError_t (0 on success).
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
