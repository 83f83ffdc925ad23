// Inclusive prefix sum over the rows of an [E, C] float32 matrix, for Hopper
// (sm_90a).
//
// Replaces gaot3d_tpu/ops/pallas_kernels.py `_prefix_sum_kernel` /
// `prefix_sum`, the cumsum inside the sorted segment folds. The TPU grid runs
// in order on one core, so that kernel carries the running total in scratch
// memory from one block of rows to the next. Here blocks run in no order, so
// the scan takes three passes:
//
//   1. block_sums_kernel: every block adds up the columns of its own tile of
//      rows;
//   2. scan_sums_kernel: one warp per column turns the block sums into
//      exclusive offsets, 32 blocks at a time with warp shuffles;
//   3. scan_rows_kernel: every block scans its tile and adds its offset.
//
// Threads of a block form G = THREADS / C groups of C threads. A group owns
// RPT consecutive rows of the tile and thread c of it owns column c, so the
// threads of a group read neighbouring addresses whatever C is (43 and 32 on
// the model's path; 43 is no multiple of a warp). A thread keeps its RPT
// values in registers and adds them in row order; the groups' totals meet in
// shared memory and are added in group order. out[r] is therefore a fixed
// association of the same additions on every launch: no atomics, bit-identical
// results from run to run.
//
// What bounds it on an H100 is bytes: [E, C] read twice (passes 1 and 3, the
// second mostly from L2) and written once; the block sums are E*C/RPT/G
// floats.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int RPT = 32;  // rows per thread

struct Layout {
  int cols;    // columns a block covers (blockIdx.y selects which)
  int groups;  // row groups of a block
  int rows;    // rows of a block's tile
};

__host__ __device__ inline Layout layout_of(int C) {
  Layout l;
  l.cols = C < THREADS ? C : THREADS;
  l.groups = THREADS / l.cols;
  l.rows = l.groups * RPT;
  return l;
}

// The thread's RPT values (zero past the last row) and their sum in row order.
__device__ inline float load_rows(const float* __restrict__ x, int E, int C, int row0, int c,
                                  float (&v)[RPT]) {
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = row0 + i;
    v[i] = r < E ? x[(size_t)r * C + c] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) total += v[i];
  return total;
}

__global__ void __launch_bounds__(THREADS)
    block_sums_kernel(const float* __restrict__ x, float* __restrict__ sums, int E, int C) {
  __shared__ float part[THREADS];
  const Layout l = layout_of(C);
  const int g = threadIdx.x / l.cols, cl = threadIdx.x % l.cols;
  const int c = blockIdx.y * l.cols + cl;
  const bool active = g < l.groups && c < C;
  float v[RPT];
  if (active) part[threadIdx.x] = load_rows(x, E, C, blockIdx.x * l.rows + g * RPT, c, v);
  __syncthreads();
  if (active && g == 0) {
    float total = 0.f;
    for (int k = 0; k < l.groups; ++k) total += part[k * l.cols + cl];
    sums[(size_t)blockIdx.x * C + c] = total;
  }
}

// sums [nb, C] -> exclusive prefix over nb, in place. One warp per column.
__global__ void __launch_bounds__(THREADS)
    scan_sums_kernel(float* __restrict__ sums, int nb, int C) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (c >= C) return;
  float carry = 0.f;
  for (int base = 0; base < nb; base += 32) {
    const int b = base + lane;
    const float own = b < nb ? sums[(size_t)b * C + c] : 0.f;
    float incl = own;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += up;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    if (b < nb) sums[(size_t)b * C + c] = carry + excl;
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
}

__global__ void __launch_bounds__(THREADS)
    scan_rows_kernel(const float* __restrict__ x, const float* __restrict__ offsets,
                     float* __restrict__ out, int E, int C) {
  __shared__ float part[THREADS];
  const Layout l = layout_of(C);
  const int g = threadIdx.x / l.cols, cl = threadIdx.x % l.cols;
  const int c = blockIdx.y * l.cols + cl;
  const bool active = g < l.groups && c < C;
  const int row0 = blockIdx.x * l.rows + g * RPT;
  float v[RPT];
  if (active) part[threadIdx.x] = load_rows(x, E, C, row0, c, v);
  __syncthreads();
  if (!active) return;
  float base = offsets[(size_t)blockIdx.x * C + c];
  for (int k = 0; k < g; ++k) base += part[k * l.cols + cl];
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    run += v[i];
    const int r = row0 + i;
    if (r < E) out[(size_t)r * C + c] = base + run;
  }
}

}  // namespace

extern "C" {

// Rows of x that one block of the scan covers; `scratch` needs
// ceil(E / rows) * C floats.
int gaot_prefix_sum_block_rows(int C) { return C > 0 ? layout_of(C).rows : 0; }

// x, out [E, C] float32, contiguous; scratch [ceil(E / block_rows), C]
// float32. Returns the last launch's cudaError_t.
int gaot_prefix_sum(const void* x, void* out, void* scratch, int E, int C, void* stream) {
  if (E <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const Layout l = layout_of(C);
  const int nb = (E + l.rows - 1) / l.rows;
  const int ncb = (C + l.cols - 1) / l.cols;
  if (ncb > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(nb, ncb);
  block_sums_kernel<<<grid, THREADS, 0, s>>>(static_cast<const float*>(x),
                                             static_cast<float*>(scratch), E, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int warps = THREADS / 32;
  scan_sums_kernel<<<(C + warps - 1) / warps, THREADS, 0, s>>>(static_cast<float*>(scratch),
                                                                 nb, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_rows_kernel<<<grid, THREADS, 0, s>>>(static_cast<const float*>(x),
                                            static_cast<const float*>(scratch),
                                            static_cast<float*>(out), E, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
