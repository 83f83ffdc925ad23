// The MAGNO decoder's GNO mean in one pass for Hopper (sm_90a), K9.
//
// Replaces no TPU kernel: the JAX package leaves the decoder's GNO
// (gaot3d_tpu/models/integral_transform.py `decoder_chunk` with
// transform_type 'linear' and no attention) to XLA, and the port's plain
// version (models/integral_transform.py `decoder_chunk`) runs it a node
// chunk at a time as a gather, two GEMMs, exact GELU and a masked mean, with
// every slot's intermediates in device memory. For every node n of every
// sample b this kernel computes
//     out[b, n, :] = (1 / max(#valid slots of n, 1))
//                    * sum over valid slots k of
//                      mlp([cell(lat_idx[b,n,k]) | pos[b,n]]) * latent[b, lat_idx[b,n,k], :]
// where the cell's centre is lo + i * h per axis, rounded as the plain
// version rounds it (a product, then a sum, no FMA contraction), and mlp is
// the kernel MLP 6 -> hid (-> hid) x n_mid -> C with exact-erf GELU between
// layers. A node with no valid slot gets 0. A valid slot's cell index reads
// the latent row clipped into the grid and its centre from the index as it
// is, as the plain version does (the model's slots always lie on the grid).
//
// Design (encoder_tiles.cuh has the tile map, the ballot compaction and the
// launch facts): the CTAs walk the items of the wrapper's tile map (whole
// nodes, their valid slots only, at most 128 rows an item), a contiguous
// range each. An item's valid slots are compacted by a ballot scan of its
// masks, so a masked slot costs one byte read. The MLP runs on the FP32
// pipe (FFMA): each layer is a [128 x in] x [in x out] product with the
// activations transposed in shared memory, a thread owning 8 output columns
// of up to 4 rows (one weight row read as two broadcast float4s a step, one
// activation a row), bias and GELU in registers before the activations are
// written back in place. The last layer is multiplied by the gathered latent
// rows (read through L2, 16 MB for the recipe's grid) and staged as rows;
// one warp then sums each node's rows, a lane a column, in eight partial
// sums by slot added pairwise, and writes the node's mean once. No atomics:
// every output is the same bits from run to run. The products are f32 FMAs,
// as the plain version's GEMMs take them; single-pass TF32 would not hold
// the decoder to f32 accuracy. Three CTAs an SM, so one CTA's loads and
// node sums overlap the others' products.
//
// What bounds it on an H100: the FP32 pipe. A valid slot of the recipe's
// 6-64-64-32 MLP takes 6,528 FMAs and 128 erf evaluations; the bytes (masks,
// indices, points, the [N, C] result) are a few hundred MB. Each FMA step
// also issues a shared-memory read for every 5 FMAs, and an item's loads,
// compaction and node sums are a third of the kernel's time.
#include "encoder_tiles.cuh"

namespace {

using namespace enc;

// How the threads share a layer of OUT columns: CG groups of 8 columns, RG
// threads a group each owning rows rg, rg + RG, ... (RPT of them). Threads of
// one warp share a column group, so a weight read is a broadcast and an
// activation read is 32 consecutive floats.
template <int OUT>
struct Cols {
  static constexpr int CG = OUT / 8;
  static constexpr int RG = THREADS / CG;
  static constexpr int RPT = RG >= R ? 1 : R / RG;
  static_assert(OUT % 8 == 0 && RG % 32 == 0, "a warp owns 8 columns of 32 rows");
};

template <int HID, int C>
struct DecLayout {
  // the packed MLP as `_pack_mlp` lays it out: per layer W [in][out], then b
  __host__ __device__ static int param_floats(int n_mid) {
    return 6 * HID + HID + n_mid * (HID * HID + HID) + HID * C + C;
  }
  // activations [HID][R] transposed; later the rows' values [R][C + 4]
  static constexpr int VS = C + 4;
  static constexpr int ACT = HID * R > R * VS ? HID * R : R * VS;
  static constexpr int X = 6 * R;  // the first layer's input [6][R]: cell xyz, point xyz
  static constexpr int INTS = 4 * R + WARPS;  // slots, rows' nodes, parts, latent rows, scan
  __host__ __device__ static int floats(int n_mid) {
    return ((param_floats(n_mid) + 3) & ~3) + ACT + X + INTS;
  }
  __host__ __device__ static size_t bytes(int n_mid) {
    return (size_t)floats(n_mid) * sizeof(float);
  }
};

// acc[i][j] = sum_k act[k][row_i] * W[k][c0 + j], in k order, FFMA
template <int IN, int OUT>
__device__ __forceinline__ void dense_cols(const float* __restrict__ act,
                                           const float* __restrict__ W, int rg, int c0,
                                           float (&acc)[Cols<OUT>::RPT][8]) {
  using M = Cols<OUT>;
#pragma unroll
  for (int i = 0; i < M::RPT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < IN; ++k) {
    const float4 b0 = *reinterpret_cast<const float4*>(W + k * OUT + c0);
    const float4 b1 = *reinterpret_cast<const float4*>(W + k * OUT + c0 + 4);
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < M::RPT; ++i) {
      const float a = act[k * R + ((rg + M::RG * i) & (R - 1))];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
    }
  }
}

// bias + exact GELU, written back transposed into act [OUT][R]
template <int OUT>
__device__ __forceinline__ void bias_gelu_store(const float (&acc)[Cols<OUT>::RPT][8],
                                                const float* __restrict__ bias, float* act,
                                                int rg, int c0) {
  using M = Cols<OUT>;
  if (rg >= R) return;  // OUT = 8: the second half of the threads has no row
#pragma unroll
  for (int i = 0; i < M::RPT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      act[(c0 + j) * R + rg + M::RG * i] = gelu(acc[i][j] + bias[c0 + j]);
}

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return q * b != a && a < 0 ? q - 1 : q;
}

// 80 registers for three CTAs an SM (63 KiB of shared memory each at the
// recipe's widths)
template <int HID, int C>
__global__ void __launch_bounds__(THREADS, 3)
    decoder_payload_kernel(const float* __restrict__ latent, const float* __restrict__ pos,
                           const int32_t* __restrict__ lat_idx,
                           const uint8_t* __restrict__ mask, const float* __restrict__ params,
                           int n_mid, int n, int k, int m, GridSpec grid, TileMap map,
                           float* __restrict__ out) {
  using L = DecLayout<HID, C>;
  using HC = Cols<HID>;
  using OC = Cols<C>;
  extern __shared__ float4 smem4[];
  float* sp = reinterpret_cast<float*>(smem4);  // the packed MLP
  float* act = sp + ((L::param_floats(n_mid) + 3) & ~3);
  float* x0 = act + L::ACT;
  int* slots = reinterpret_cast<int*>(x0 + L::X);
  int* rnode = slots + R;     // each row's node (flat b * n + node), -1 past the rows
  int* rpart = rnode + R;     // each row's partial sum: its slot's place in the node, mod 8
  int* rlat = rpart + R;      // each row's latent row (flat b * m + cell, clipped)
  int* scratch = rlat + R;

  const int np = L::param_floats(n_mid);
  for (int i = threadIdx.x; i < np; i += THREADS) sp[i] = params[i];
  const float* w0 = sp;
  const float* b0 = w0 + 6 * HID;
  const float* wl = b0 + HID + n_mid * (HID * HID + HID);
  const float* bl = wl + HID * C;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hrg = tid % HC::RG, hc0 = 8 * (tid / HC::RG);
  const int orl = tid % OC::RG, oc0 = 8 * (tid / OC::RG);

  int first, last;
  item_range(map, blockIdx.x, gridDim.x, first, last);
  for (int item = first; item < last; ++item) {
    const int nf = map.node_first[item], ne = map.node_first[item + 1];
    if (nf == ne) continue;
    __syncthreads();  // the previous item's rows are done with
    const int count = gather_rows(mask, (long long)nf * k, (long long)ne * k, 0, slots, scratch);

    // nodes without a valid slot get 0
    for (int node = nf + tid; node < ne; node += THREADS) {
      bool any = false;
      for (int s = 0; s < k; ++s) any |= mask[(long long)node * k + s] != 0;
      if (!any)
        for (int c = 0; c < C; ++c) out[(long long)node * C + c] = 0.f;
    }
    if (count == 0) continue;

    // each row's inputs: [cell centre | point] and where its latent row lies
    if (tid < R) {
      float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      int node = -1, part = 0, lrow = 0;
      if (tid < count) {
        const int s = slots[tid];
        node = s / k;
        part = (s - node * k) & 7;
        const int cell = lat_idx[s];
        const int q2 = floor_div(cell, grid.d2);
        const int i2 = cell - q2 * grid.d2;
        const int i1 = q2 - floor_div(q2, grid.d1) * grid.d1;
        const int i0 = floor_div(cell, grid.d1 * grid.d2);
        v[0] = __fadd_rn(grid.lo0, __fmul_rn((float)i0, grid.sp0));
        v[1] = __fadd_rn(grid.lo1, __fmul_rn((float)i1, grid.sp1));
        v[2] = __fadd_rn(grid.lo2, __fmul_rn((float)i2, grid.sp2));
        v[3] = pos[(long long)node * 3 + 0];
        v[4] = pos[(long long)node * 3 + 1];
        v[5] = pos[(long long)node * 3 + 2];
        const int clipped = cell < 0 ? 0 : (cell >= m ? m - 1 : cell);
        lrow = (node / n) * m + clipped;
      }
#pragma unroll
      for (int c = 0; c < 6; ++c) x0[c * R + tid] = v[c];
      rnode[tid] = node;
      rpart[tid] = part;
      rlat[tid] = lrow;
    }
    __syncthreads();

    // the hidden layers, in place in act
    {
      float acc[HC::RPT][8];
      dense_cols<6, HID>(x0, w0, hrg, hc0, acc);
      bias_gelu_store<HID>(acc, b0, act, hrg, hc0);
    }
    for (int l = 0; l < n_mid; ++l) {
      const float* w = b0 + HID + l * (HID * HID + HID);
      __syncthreads();
      float acc[HC::RPT][8];
      dense_cols<HID, HID>(act, w, hrg, hc0, acc);
      __syncthreads();  // every read of act is done before it is overwritten
      bias_gelu_store<HID>(acc, w + HID * HID, act, hrg, hc0);
    }
    __syncthreads();

    // the last layer, times the latent rows, into rows [R][C + 4] over act
    {
      float lat_v[OC::RPT][8];
#pragma unroll
      for (int i = 0; i < OC::RPT; ++i) {
        const int r = (orl + OC::RG * i) & (R - 1);
        const float4* src = reinterpret_cast<const float4*>(latent + (long long)rlat[r] * C + oc0);
        const float4 a = __ldg(src), b = __ldg(src + 1);
        lat_v[i][0] = a.x; lat_v[i][1] = a.y; lat_v[i][2] = a.z; lat_v[i][3] = a.w;
        lat_v[i][4] = b.x; lat_v[i][5] = b.y; lat_v[i][6] = b.z; lat_v[i][7] = b.w;
      }
      float acc[OC::RPT][8];
      dense_cols<HID, C>(act, wl, orl, oc0, acc);
      __syncthreads();
      if (orl < R) {
#pragma unroll
        for (int i = 0; i < OC::RPT; ++i) {
          float o[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) o[j] = (acc[i][j] + bl[oc0 + j]) * lat_v[i][j];
          float4* dst = reinterpret_cast<float4*>(act + (orl + OC::RG * i) * L::VS + oc0);
          dst[0] = make_float4(o[0], o[1], o[2], o[3]);
          dst[1] = make_float4(o[4], o[5], o[6], o[7]);
        }
      }
    }
    __syncthreads();

    // each node's rows summed, a warp a node, a lane a column: slot s into
    // partial sum s % 8, the eight then added pairwise (a long node's sum
    // keeps f32 grade, as PyTorch's split sum over the slot axis does)
    for (int r = warp; r < count; r += WARPS) {
      const int node = rnode[r];
      if (r > 0 && rnode[r - 1] == node) continue;  // not the node's first row
      int e = r + 1;
      while (e < count && rnode[e] == node) ++e;
      if (lane < C) {
        float p[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        for (int q = r; q < e; ++q) {
          const float v = act[q * L::VS + lane];
          const int part = rpart[q];
#pragma unroll
          for (int j = 0; j < 8; ++j) p[j] += part == j ? v : 0.f;
        }
        const float sum = ((p[0] + p[1]) + (p[2] + p[3])) + ((p[4] + p[5]) + (p[6] + p[7]));
        out[(long long)node * C + lane] = sum / (float)(e - r);
      }
    }
  }
}

template <int HID, int C>
int occupancy(int n_mid, int& per_sm, int& sms) {
  static LaunchCache cache;
  return cache.get(decoder_payload_kernel<HID, C>, DecLayout<HID, C>::bytes(n_mid), n_mid,
                   per_sm, sms);
}

template <int HID, int C>
int launch(const float* latent, const float* pos, const int32_t* lat_idx, const uint8_t* mask,
           const float* params, int n_mid, int n, int k, int m, GridSpec g, TileMap map,
           int max_items, float* out, cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  const int e = occupancy<HID, C>(n_mid, per_sm, sms);
  if (e != 0) return e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long cap = (long long)sms * per_sm;
  const int blocks = (int)(max_items < cap ? max_items : cap);
  decoder_payload_kernel<HID, C><<<blocks, THREADS, DecLayout<HID, C>::bytes(n_mid), stream>>>(
      latent, pos, lat_idx, mask, params, n_mid, n, k, m, g, map, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define GAOT_K9_WIDTHS(X) X(64, 32) X(64, 16) X(32, 32) X(32, 16) X(16, 16) X(16, 8)

// Shared-memory bytes a block needs for these widths and depth, or 0 for
// widths not built.
long long gaot_decoder_payload_smem(int n_mid, int hid, int c) {
#define GAOT_K9_SMEM(H, CC) \
  if (hid == H && c == CC) return (long long)DecLayout<H, CC>::bytes(n_mid);
  GAOT_K9_WIDTHS(GAOT_K9_SMEM)
#undef GAOT_K9_SMEM
  return 0;
}

// CTAs a multiprocessor holds for these widths and depth (0 when not built
// or on a launch error).
int gaot_decoder_payload_occupancy(int n_mid, int hid, int c) {
  int per_sm = 0, sms = 0;
#define GAOT_K9_OCC(H, CC) \
  if (hid == H && c == CC) return occupancy<H, CC>(n_mid, per_sm, sms) == 0 ? per_sm : 0;
  GAOT_K9_WIDTHS(GAOT_K9_OCC)
#undef GAOT_K9_OCC
  return 0;
}

// latent [b, m, c] f32, pos [b, n, 3] f32, lat_idx [b, n, k] i32, mask
// [b, n, k] u8 (torch.bool), the tile map of the mask (node_first
// [max_items + 1] i32 and n_items [1] i32 on the device, k <= 128), out
// [b, n, c] f32 (every node written), all contiguous. params packs the MLP
// 6 -> hid (-> hid x n_mid) -> c as, per layer, W [in][out] row-major
// followed by its bias. Returns the launch's cudaError_t (0 on success).
int gaot_decoder_payload(const void* latent, const void* pos, const void* lat_idx,
                         const void* mask, const void* params, int n_params, int n_mid, int hid,
                         int c, int b, int n, int k, int m, int d1, int d2, float lo0, float lo1,
                         float lo2, float sp0, float sp1, float sp2, const void* node_first,
                         const void* n_items, int max_items, void* out, void* stream) {
  const int expect = 6 * hid + hid + n_mid * (hid * hid + hid) + hid * c + c;
  if (n_params != expect || n_mid < 0 || b <= 0 || n <= 0 || k <= 0 || k > R || m <= 0 ||
      d1 <= 0 || d2 <= 0 || max_items <= 0 || (long long)b * n * k >= (1LL << 31) ||
      (long long)b * m >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const GridSpec g{d1, d2, lo0, lo1, lo2, sp0, sp1, sp2};
  const TileMap map{static_cast<const int32_t*>(node_first), static_cast<const int32_t*>(n_items),
                    n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lt = static_cast<const float*>(latent);
  const float* p = static_cast<const float*>(pos);
  const int32_t* li = static_cast<const int32_t*>(lat_idx);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  const float* w = static_cast<const float*>(params);
  float* o = static_cast<float*>(out);
#define GAOT_K9_CASE(H, CC)                                                               \
  if (hid == H && c == CC)                                                                \
    return launch<H, CC>(lt, p, li, mk, w, n_mid, n, k, m, g, map, max_items, o, s);
  GAOT_K9_WIDTHS(GAOT_K9_CASE)
#undef GAOT_K9_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
