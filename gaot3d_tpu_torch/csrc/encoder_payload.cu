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
// memory. Masked rows are skipped without using their cell index, which may
// hold any value; a valid row whose cell lies outside the grid is dropped
// (the model rejects such slots before it gets here).
//
// Design (encoder_tiles.cuh has the shared machinery): one persistent CTA of
// 8 warps an SM walks node-major tiles of 128 rows, one warp per 16 rows.
// The layer products run on the tensor cores as 3xTF32 (`mma.sync` m16n8k8),
// which keeps f32 grade; the weights are split into hi and lo once, when the
// CTA stages them, in fragment order (one 16-byte shared load a fragment),
// and the activations stay in registers from layer to layer.
// While the warps compute a tile, each thread holds the next tile's slot,
// mask and point in registers and, once the MLP is done, writes [point |
// cell] into the other half of a two-stage ring and starts `cp.async` copies
// of the next tile's feature rows. The scatter is `red.global.add` (float
// atomics without a return value): two columns at a time as a v2 reduction
// where the accumulator row is 8-byte aligned (its row stride is C+11 floats,
// so every other cell), one at a time elsewhere. The sum order, and so the
// last bits, change from run to run.
//
// What bounds it on an H100: the 3xTF32 products, 3 x 2 x 10,624 FLOPs a
// valid row of the recipe's 6-64-64-64-32 MLP on the tensor cores; the erf of
// every hidden unit on the FP32 pipe; and the accumulator's reductions in L2.
//
// The bf16 body (`kernel_dtype: bfloat16`) is encoder_payload_bf16.cu.
#include "encoder_tiles.cuh"

namespace {

using namespace enc;

template <int HID, int C>
struct FwdLayout {
  // in fragment order, the weights split into hi and lo: two floats a weight
  static constexpr int W0 = 2 * 8 * HID;
  static constexpr int WM = 2 * HID * HID;
  static constexpr int WL = 2 * HID * C;
  static constexpr int STAGE = R * X0::S + R * Mat<C>::S + R;  // x0, feature rows, acc rows
  __host__ __device__ static int bias_floats(int n_mid) {
    return ((HID * (n_mid + 1) + C) + 3) & ~3;
  }
  __host__ __device__ static int weight_floats(int n_mid) {
    return W0 + n_mid * WM + WL + bias_floats(n_mid);
  }
  __host__ __device__ static size_t bytes(int n_mid) {
    return (size_t)(weight_floats(n_mid) + 2 * STAGE) * sizeof(float);
  }
};

template <int HID, int C>
__global__ void __launch_bounds__(THREADS, 1)
    encoder_accumulate_kernel(const float* __restrict__ pos, const float* __restrict__ feats,
                              const int32_t* __restrict__ lat_idx,
                              const uint8_t* __restrict__ mask,
                              const float* __restrict__ params, int n_mid, Tiling T,
                              GridSpec grid, float* __restrict__ acc) {
  using L = FwdLayout<HID, C>;
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  float* sw0 = sw;                          // layer 0, [8][HID] as fragments
  float* swm = sw0 + L::W0;                 // the n_mid hidden layers
  float* swl = swm + n_mid * L::WM;         // the last layer, [HID][C]
  float* sb = swl + L::WL;                  // biases, in layer order
  float* stages = sw + L::weight_floats(n_mid);

  // stage the weights: the packed params are, per layer, W [in][out] then b
  {
    const float* p = params;
    stage_split_weights<HID>(reinterpret_cast<uint4*>(sw0), p, 6, 8);
    p += 6 * HID;
    for (int i = threadIdx.x; i < HID; i += THREADS) sb[i] = p[i];
    p += HID;
    for (int l = 0; l < n_mid; ++l) {
      stage_split_weights<HID>(reinterpret_cast<uint4*>(swm + l * L::WM), p, HID, HID);
      p += HID * HID;
      for (int i = threadIdx.x; i < HID; i += THREADS) sb[HID * (l + 1) + i] = p[i];
      p += HID;
    }
    stage_split_weights<C>(reinterpret_cast<uint4*>(swl), p, HID, HID);
    p += HID * C;
    for (int i = threadIdx.x; i < C; i += THREADS) sb[HID * (n_mid + 1) + i] = p[i];
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_i = threadIdx.x & (R - 1);  // the row this thread loads
  const int half = threadIdx.x / R;          // which half of its feature columns
  const int wrow = 16 * warp;                // the warp's first row in the tile

  auto x0_of = [&](int s) { return stages + s * L::STAGE; };
  auto f_of = [&](int s) { return stages + s * L::STAGE + R * X0::S; };
  auto rows_of = [&](int s) {
    return reinterpret_cast<int*>(stages + s * L::STAGE + R * X0::S + R * Mat<C>::S);
  };

  // the next tile's inputs, from registers into a stage: x0, the acc row
  // (-1 when the row is not valid) and the feature rows
  auto commit = [&](RowIn& in, int s) {
    in.settle(T);
    if (half == 0) {
      in.write_x0(grid, x0_of(s), row_i);
      rows_of(s)[row_i] = in.valid ? (int)in.acc_row(T) : -1;
    }
    copy_feats<C>(f_of(s), row_i, in, feats, half * (C / 2), (half + 1) * (C / 2));
    cp_async_commit();
  };

  Tile tile;
  if (!Tile::make(T, blockIdx.x, gridDim.x, 0, tile)) return;
  RowIn in;
  in.load(T, tile, row_i, pos, lat_idx, mask);
  commit(in, 0);

  for (long long j = 0;; ++j) {
    const int s = (int)(j & 1);
    cp_async_wait_all();
    __syncthreads();  // stage s is complete (and the weights are staged)
    Tile next;
    const bool has_next = Tile::make(T, blockIdx.x, gridDim.x, j + 1, next);
    if (has_next) in.load(T, next, row_i, pos, lat_idx, mask);

    // the MLP for the warp's 16 rows
    float h[HID / 8][4];
    dense_first<HID>(x0_of(s), wrow, SplitWeights<HID>{reinterpret_cast<const uint4*>(sw0)}, h,
                     lane);
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

    if (has_next) commit(in, s ^ 1);  // stage s^1 was last read before the sync above

    // scatter: vals = (o + b) * feats, then the 11 moment columns
    scatter_rows<C>(o, sb + HID * (n_mid + 1), f_of(s), x0_of(s), rows_of(s), acc, wrow, lane);
    if (!has_next) break;
  }
}

template <int HID, int C>
int occupancy(int n_mid, int& per_sm, int& sms) {
  static LaunchCache cache;
  return cache.get(encoder_accumulate_kernel<HID, C>, FwdLayout<HID, C>::bytes(n_mid), n_mid,
                   per_sm, sms);
}

template <int HID, int C>
int launch(const float* pos, const float* feats, const int32_t* lat_idx, const uint8_t* mask,
           const float* params, int n_mid, int b, int n, int k, int m, GridSpec g, float* acc,
           cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  const int e = occupancy<HID, C>(n_mid, per_sm, sms);
  if (e != 0) return e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const Tiling T = Tiling::make(b, n, k, m);
  const long long cap = (long long)sms * per_sm;
  const int blocks = (int)(T.items < cap ? T.items : cap);
  encoder_accumulate_kernel<HID, C>
      <<<blocks, THREADS, FwdLayout<HID, C>::bytes(n_mid), stream>>>(
          pos, feats, lat_idx, mask, params, n_mid, T, g, acc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define GAOT_K5_WIDTHS(X) X(64, 32) X(64, 16) X(32, 32) X(32, 16) X(16, 16) X(16, 8)

// Shared-memory bytes a block needs for these widths and depth (the wrapper
// checks it against the device's limit), or 0 for widths not built.
long long gaot_encoder_accumulate_smem(int n_mid, int hid, int c) {
#define GAOT_K5_SMEM(H, CC) \
  if (hid == H && c == CC) return (long long)FwdLayout<H, CC>::bytes(n_mid);
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
// [b, n, k] u8 (torch.bool), acc [b, m, c + 11] f32 (accumulated into), all
// contiguous. params packs the MLP 6 -> hid (-> hid x n_mid) -> c as, per
// layer, W [in][out] row-major followed by its bias. Returns the launch's
// cudaError_t (0 on success).
int gaot_encoder_accumulate(const void* pos, const void* feats, const void* lat_idx,
                            const void* mask, const void* params, int n_params, int n_mid,
                            int hid, int c, int b, int n, int k, int m, int d1, int d2,
                            float lo0, float lo1, float lo2, float sp0, float sp1, float sp2,
                            void* acc, void* stream) {
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
  float* a = static_cast<float*>(acc);
#define GAOT_K5_CASE(H, CC) \
  if (hid == H && c == CC) return launch<H, CC>(p, f, li, mk, w, n_mid, b, n, k, m, g, a, s);
  GAOT_K5_WIDTHS(GAOT_K5_CASE)
#undef GAOT_K5_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
