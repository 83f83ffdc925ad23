// Backward of the fused encoder payload + scatter for Hopper (sm_90a).
//
// Replaces gaot3d_tpu/ops/pallas_encoder.py `_payload_bwd_call` (kernel
// `_bwd_kernel`) together with the backward of the scatter that followed it.
// The forward (encoder_payload.cu) scattered every valid (node, slot) row's
// payload into acc[b, cell, :]; given the accumulator's cotangent
// g [b, m, C+11], each valid row GATHERS gv = g[b, cell, :C] (the 11 moment
// columns depend on positions only and carry no gradient), recomputes the
// kernel MLP on [point | cell] and produces
//     dfeats[node] += gv * mlp_out
//     d_out = gv * feats[node], then per layer from the last to the first
//     dW_l += in_l^T d_l,  db_l += sum d_l,  d_{l-1} = (d_l W_l^T) * gelu'(z_{l-1})
// with the exact-erf GELU derivative, all in f32 (the TPU's single-bf16-pass
// dots in this chain were a TPU compromise, not the semantics). Masked rows
// and valid rows whose cell is off the grid are skipped exactly as the
// forward skips them. There is no gradient to positions.
//
// On the TPU the grid walked node blocks in order and kept dW/db in VMEM
// scratch across it. dW is a sum of one outer product per row over all rows,
// so a thread per row with global atomics would serialise. Here a persistent
// CTA of 128 threads walks tiles of 64 rows. Per tile, two threads per row
// (each half of a layer's outputs) recompute the MLP and leave every layer's
// activation (feature-major) and GELU derivative (row-major) in shared
// memory; then, layer by layer from the last, the CTA takes dW_l as a small
// [in x 64 rows] x [64 rows x out] product with register-blocked strips, adds
// it into a shared-memory copy of the gradient that each thread owns a fixed
// part of (no atomics), and overwrites the GELU derivative in place with the
// layer's cotangent. After its last tile a CTA adds its copy into the global
// gradient once, with float atomics; dfeats rows take one atomic per row and
// channel (a node's slots may straddle tiles). Both sums therefore change in
// their last bits from run to run.
//
// What bounds it on an H100: about 32k FMAs per row (recompute, chain and
// the dW products, 10.6k each for the 6-64-64-64-32 recipe MLP), 4e10 for
// the 1.25M valid rows of a 524,288-node cloud, as scalar f32 FMAs fed from
// shared memory, with one 128-thread CTA per SM because a tile's activations
// and the two weight-sized arrays fill 200 KB of shared memory.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int R = 64;       // rows per tile; two threads per row
constexpr int RP = R + 1;   // row stride of the feature-major activations

struct GridSpec {
  int d1, d2;
  float lo0, lo1, lo2;
  float sp0, sp1, sp2;
};

// gelu(z) and its derivative from one erf evaluation
__device__ __forceinline__ void gelu_and_grad(float z, float& h, float& gp) {
  const float phi = 0.5f * (1.f + erff(z * 0.70710678118654752f));
  h = z * phi;
  gp = phi + z * expf(-0.5f * z * z) * 0.3989422804014327f;
}

// One thread's half of a layer: acc[j] = sum_i x_i * W[i][j0 + j], x_i read
// from the feature-major array `in` (column r), W row-major in shared memory.
template <int IN, int N>
__device__ __forceinline__ void half_matvec(const float* in, int r, const float* w, int out,
                                            int j0, float* acc) {
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = 0.f;
#pragma unroll 2
  for (int i = 0; i < IN; ++i) {
    const float x = in[i * RP + r];
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const float4 w4 = *reinterpret_cast<const float4*>(w + i * out + j0 + j);
      acc[j] = fmaf(x, w4.x, acc[j]);
      acc[j + 1] = fmaf(x, w4.y, acc[j + 1]);
      acc[j + 2] = fmaf(x, w4.z, acc[j + 2]);
      acc[j + 3] = fmaf(x, w4.w, acc[j + 3]);
    }
  }
}

// Hidden layer forward for thread (r, half): h into `hout` (feature-major),
// gelu' into `gout` (row-major, stride zs).
template <int IN, int HID>
__device__ __forceinline__ void hidden_forward(const float* in, const float* w,
                                               const float* b, int r, int half, float* hout,
                                               float* gout, int zs) {
  constexpr int N = HID / 2;
  const int j0 = half * N;
  float acc[N];
  half_matvec<IN, N>(in, r, w, HID, j0, acc);
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    float4 gp;
    float h;
    gelu_and_grad(acc[j] + b[j0 + j], h, gp.x);
    hout[(j0 + j) * RP + r] = h;
    gelu_and_grad(acc[j + 1] + b[j0 + j + 1], h, gp.y);
    hout[(j0 + j + 1) * RP + r] = h;
    gelu_and_grad(acc[j + 2] + b[j0 + j + 2], h, gp.z);
    hout[(j0 + j + 2) * RP + r] = h;
    gelu_and_grad(acc[j + 3] + b[j0 + j + 3], h, gp.w);
    hout[(j0 + j + 3) * RP + r] = h;
    *reinterpret_cast<float4*>(gout + r * zs + j0 + j) = gp;
  }
}

// sdw[i][j] += sum_r in[i][r] * dz[r][j] and sdb[j] += sum_r dz[r][j] over the
// tile's rows. Each thread owns fixed strips of JC outputs, so the shared
// gradient needs no atomics.
template <int IN, int OUT>
__device__ __forceinline__ void weight_grad(const float* in, const float* dz, int zs,
                                            float* sdw, float* sdb) {
  constexpr int JC = (IN * OUT / THREADS) > 4 ? (IN * OUT / THREADS) : 4;
  static_assert(OUT % JC == 0 && JC % 4 == 0, "strip width must divide the layer");
  constexpr int PER_ROW = OUT / JC;
  for (int c = threadIdx.x; c < IN * PER_ROW; c += THREADS) {
    const int i = c / PER_ROW;
    const int j0 = (c - i * PER_ROW) * JC;
    float acc[JC];
#pragma unroll
    for (int j = 0; j < JC; ++j) acc[j] = 0.f;
#pragma unroll 2
    for (int r = 0; r < R; ++r) {
      const float x = in[i * RP + r];
#pragma unroll
      for (int j = 0; j < JC; j += 4) {
        const float4 d4 = *reinterpret_cast<const float4*>(dz + r * zs + j0 + j);
        acc[j] = fmaf(x, d4.x, acc[j]);
        acc[j + 1] = fmaf(x, d4.y, acc[j + 1]);
        acc[j + 2] = fmaf(x, d4.z, acc[j + 2]);
        acc[j + 3] = fmaf(x, d4.w, acc[j + 3]);
      }
    }
#pragma unroll
    for (int j = 0; j < JC; ++j) sdw[i * OUT + j0 + j] += acc[j];
  }
  if (threadIdx.x < OUT) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += dz[r * zs + threadIdx.x];
    sdb[threadIdx.x] += s;
  }
}

// g[r][i] = (sum_j W[i][j] * dz[r][j]) * g[r][i] for thread (r, half)'s half
// of the IN features: the GELU derivative becomes the layer's cotangent.
template <int IN, int OUT>
__device__ __forceinline__ void chain(const float* w, const float* dz, int zs, int r,
                                      int half, float* g, int gs) {
  float d[OUT];
#pragma unroll
  for (int j = 0; j < OUT; j += 4) {
    const float4 d4 = *reinterpret_cast<const float4*>(dz + r * zs + j);
    d[j] = d4.x;
    d[j + 1] = d4.y;
    d[j + 2] = d4.z;
    d[j + 3] = d4.w;
  }
  constexpr int N = IN / 2;
#pragma unroll 2
  for (int i = half * N; i < (half + 1) * N; ++i) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
    for (int j = 0; j < OUT; j += 4) {
      const float4 w4 = *reinterpret_cast<const float4*>(w + i * OUT + j);
      s0 = fmaf(w4.x, d[j], s0);
      s1 = fmaf(w4.y, d[j + 1], s1);
      s2 = fmaf(w4.z, d[j + 2], s2);
      s3 = fmaf(w4.w, d[j + 3], s3);
    }
    g[r * gs + i] *= (s0 + s1) + (s2 + s3);
  }
}

template <int HID, int C>
struct Layout {
  static constexpr int ZS = HID + 4;  // row stride of the row-major gelu'/cotangent arrays
  static constexpr int OS = C + 4;    // row stride of d_out
  static constexpr int A0 = 392;      // [6][RP] padded to a multiple of 4 floats
  static size_t floats(int n_params, int n_mid) {
    return 2 * (size_t)n_params + (size_t)(n_mid + 1) * (R * ZS + HID * RP) + R * OS + A0;
  }
  static size_t bytes(int n_params, int n_mid) {
    return floats(n_params, n_mid) * sizeof(float) + R * (sizeof(long long) + 2 * sizeof(int));
  }
};

template <int HID, int C>
__global__ void __launch_bounds__(THREADS)
    encoder_backward_kernel(const float* __restrict__ pos, const float* __restrict__ feats,
                            const int32_t* __restrict__ lat_idx,
                            const uint8_t* __restrict__ mask,
                            const float* __restrict__ params, int n_params, int n_mid, int n,
                            int k, int m, long long rows, GridSpec grid,
                            const float* __restrict__ gacc, float* __restrict__ dfeats,
                            float* __restrict__ dparams) {
  using L = Layout<HID, C>;
  constexpr int ZS = L::ZS, OS = L::OS;
  extern __shared__ float4 smem4[];
  float* sp = reinterpret_cast<float*>(smem4);     // weights, packed like `params`
  float* sdw = sp + n_params;                      // this CTA's gradient, same packing
  float* gs = sdw + n_params;                      // [n_mid + 1][R][ZS]
  float* dos = gs + (n_mid + 1) * R * ZS;          // [R][OS]
  float* hs = dos + R * OS;                        // [n_mid + 1][HID][RP]
  float* a0 = hs + (n_mid + 1) * HID * RP;         // [6][RP]
  long long* node_s = reinterpret_cast<long long*>(a0 + L::A0);
  int* cell_s = reinterpret_cast<int*>(node_s + R);
  int* valid_s = cell_s + R;

  for (int i = threadIdx.x; i < n_params; i += THREADS) {
    sp[i] = params[i];
    sdw[i] = 0.f;
  }

  const int r = threadIdx.x & (R - 1);
  const int half = threadIdx.x >> 6;
  // offsets into the packed parameters: layer 0, the n_mid hidden layers, the last
  const int off_mid = 6 * HID + HID;
  const int mid_size = HID * HID + HID;
  const int off_last = off_mid + n_mid * mid_size;

  const long long n_tiles = (rows + R - 1) / R;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    __syncthreads();  // the previous tile is fully consumed (and sp/sdw are set)
    if (half == 0) {
      const long long row = tile * R + r;
      bool valid = row < rows && mask[row];
      int cell = 0;
      long long node = 0;
      if (valid) {
        cell = lat_idx[row];
        node = row / k;
        valid = cell >= 0 && cell < m;  // dropped by the forward as well
      }
      float agg[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (valid) {
        const int plane = grid.d1 * grid.d2;
        const int i0 = cell / plane;
        const int rem = cell - i0 * plane;
        const int i1 = rem / grid.d2;
        const int i2 = rem - i1 * grid.d2;
        agg[0] = pos[node * 3 + 0];
        agg[1] = pos[node * 3 + 1];
        agg[2] = pos[node * 3 + 2];
        agg[3] = __fadd_rn(grid.lo0, __fmul_rn((float)i0, grid.sp0));
        agg[4] = __fadd_rn(grid.lo1, __fmul_rn((float)i1, grid.sp1));
        agg[5] = __fadd_rn(grid.lo2, __fmul_rn((float)i2, grid.sp2));
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) a0[i * RP + r] = agg[i];
      node_s[r] = node;
      cell_s[r] = cell;
      valid_s[r] = valid ? 1 : 0;
    }
    __syncthreads();

    // forward recompute: h_l feature-major into hs[l], gelu'(z_l) into gs[l]
    hidden_forward<6, HID>(a0, sp, sp + 6 * HID, r, half, hs, gs, ZS);
    for (int l = 1; l <= n_mid; ++l) {
      __syncthreads();
      const float* w = sp + off_mid + (l - 1) * mid_size;
      hidden_forward<HID, HID>(hs + (l - 1) * HID * RP, w, w + HID * HID, r, half,
                               hs + l * HID * RP, gs + l * R * ZS, ZS);
    }
    __syncthreads();
    {  // last layer, and the row's cotangent d_out = gv * feats
      constexpr int N = C / 2;
      const int j0 = half * N;
      const float* w = sp + off_last;
      float o[N];
      half_matvec<HID, N>(hs + n_mid * HID * RP, r, w, C, j0, o);
      const bool valid = valid_s[r] != 0;
      const long long node = node_s[r];
      const long long b = node / n;
      const float* gv = gacc + ((long long)b * m + cell_s[r]) * (C + 11) + j0;
      const float* f = feats + node * C + j0;
      float* df = dfeats + node * C + j0;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float d = 0.f;
        if (valid) {
          const float gj = gv[j];
          atomicAdd(df + j, gj * (o[j] + w[HID * C + j0 + j]));
          d = gj * f[j];
        }
        dos[r * OS + j0 + j] = d;
      }
    }
    __syncthreads();

    // backward, last layer first
    weight_grad<HID, C>(hs + n_mid * HID * RP, dos, OS, sdw + off_last,
                        sdw + off_last + HID * C);
    chain<HID, C>(sp + off_last, dos, OS, r, half, gs + n_mid * R * ZS, ZS);
    for (int l = n_mid; l >= 1; --l) {
      __syncthreads();
      const int off = off_mid + (l - 1) * mid_size;
      weight_grad<HID, HID>(hs + (l - 1) * HID * RP, gs + l * R * ZS, ZS, sdw + off,
                            sdw + off + HID * HID);
      chain<HID, HID>(sp + off, gs + l * R * ZS, ZS, r, half, gs + (l - 1) * R * ZS, ZS);
    }
    __syncthreads();
    weight_grad<6, HID>(a0, gs, ZS, sdw, sdw + 6 * HID);
  }

  __syncthreads();
  for (int i = threadIdx.x; i < n_params; i += THREADS) atomicAdd(dparams + i, sdw[i]);
}

template <int HID, int C>
int launch(const float* pos, const float* feats, const int32_t* lat_idx, const uint8_t* mask,
           const float* params, int n_params, int n_mid, int b, int n, int k, int m,
           GridSpec g, const float* gacc, float* dfeats, float* dparams,
           cudaStream_t stream) {
  const size_t smem = Layout<HID, C>::bytes(n_params, n_mid);
  auto kern = encoder_backward_kernel<HID, C>;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)b * n * k;
  const long long need = (rows + R - 1) / R;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(need < cap ? need : cap);
  kern<<<blocks, THREADS, smem, stream>>>(pos, feats, lat_idx, mask, params, n_params, n_mid,
                                          n, k, m, rows, g, gacc, dfeats, dparams);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes a block needs for these widths (the wrapper checks it
// against the device's limit before launching), or 0 for widths not built.
long long gaot_encoder_backward_smem(int n_params, int n_mid, int hid, int c) {
#define GAOT_K5B_SMEM(H, CC) \
  if (hid == H && c == CC) return (long long)Layout<H, CC>::bytes(n_params, n_mid);
  GAOT_K5B_SMEM(64, 32)
  GAOT_K5B_SMEM(64, 16)
  GAOT_K5B_SMEM(32, 32)
  GAOT_K5B_SMEM(32, 16)
  GAOT_K5B_SMEM(16, 16)
  GAOT_K5B_SMEM(16, 8)
#undef GAOT_K5B_SMEM
  return 0;
}

// pos [b, n, 3] f32, feats [b, n, c] f32, lat_idx [b, n, k] i32, mask
// [b, n, k] u8, params packed as for gaot_encoder_accumulate, gacc
// [b, m, c + 11] f32 (the accumulator's cotangent); dfeats [b, n, c] f32 and
// dparams [n_params] f32 (packed like params) are accumulated into, so the
// caller zeroes them. All contiguous. Returns the launch's cudaError_t.
int gaot_encoder_backward(const void* pos, const void* feats, const void* lat_idx,
                          const void* mask, const void* params, int n_params, int n_mid,
                          int hid, int c, int b, int n, int k, int m, int d1, int d2,
                          float lo0, float lo1, float lo2, float sp0, float sp1, float sp2,
                          const void* gacc, void* dfeats, void* dparams, void* stream) {
  const int expect = 6 * hid + hid + n_mid * (hid * hid + hid) + hid * c + c;
  if (n_params != expect || n_mid < 0 || b <= 0 || n <= 0 || k <= 0 || m <= 0)
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
#define GAOT_K5B_CASE(H, CC)                                                       \
  if (hid == H && c == CC)                                                         \
    return launch<H, CC>(p, f, li, mk, w, n_params, n_mid, b, n, k, m, g, ga, df, dw, s);
  GAOT_K5B_CASE(64, 32)
  GAOT_K5B_CASE(64, 16)
  GAOT_K5B_CASE(32, 32)
  GAOT_K5B_CASE(32, 16)
  GAOT_K5B_CASE(16, 16)
  GAOT_K5B_CASE(16, 8)
#undef GAOT_K5B_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
