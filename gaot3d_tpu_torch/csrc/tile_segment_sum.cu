// Segment sum of destination-sorted rows from tile boundaries, for Hopper
// (sm_90a).
//
// Replaces gaot3d_tpu/ops/pallas_kernels.py `_tile_segment_sum_kernel` /
// `_tile_segment_sum_call` (reached through `tile_segment_sum`): rows [E, P]
// float32 in ascending segment order, their ids [E], and `ts` [T + 1], the
// row at which each tile of `seg_tile` segments begins (ts[T] is the first
// row to drop: ids of num_segments or more sort last) -> out [S, P].
//
// The TPU grid is static, so that kernel visits a fixed number of row blocks
// per tile, shares boundary blocks between neighbouring tiles with a mask,
// and falls back to a cumsum fold when a tile holds more blocks than the
// grid has. Here a CTA owns a part of a tile: `seg_part` consecutive
// segments, about PART_OUTPUTS floats of output. It
//   1. finds its segments' first rows among the tile's rows [ts[t],
//      ts[t+1]): all threads read the ids side by side (a tile of more than
//      SMALL_TILE rows is first narrowed by a search in which every thread
//      probes one row a round), and the thread of row r marks each segment s
//      with ids[r-1] < s <= ids[r]; an empty segment takes the next start;
//   2. stages its rows, CHUNK_FLOATS at a time, into shared memory: the row
//      of each sorted position (perm[r], or r) first, then every thread
//      issues its loads of the chunk's floats at once (cp.async, 4 bytes
//      each, neighbouring threads on neighbouring columns), with no register
//      held for them;
//   3. adds them: thread f owns output f = k * P + c of the part, adds the
//      chunk's rows of segment k to it in row order, starting from 0.0f, and
//      stores it, neighbouring threads on neighbouring floats; a segment
//      that goes on into the next chunk carries its sum there through its
//      own output (the same thread reads back what it stored);
//   4. writes the zeros of the part's empty segments.
// Every segment is summed in row order from 0, as K6 (segment_sum_sorted.cu)
// does: K8 gives K6's bits on the same sorted rows, and the same bits on
// every launch, without atomics. A segment that holds most rows is one
// part's long chain of chunks; the other CTAs finish long before it.
//
// What bounds it on an H100 is bytes: the valid rows of [E, P], the ids and
// perm read once, [S, P] written once.
#include <climits>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

// What sets the pace is how many parts' loads an SM keeps in flight: the
// kernel is held to 32 registers, so that an SM holds CTAS_PER_SM CTAs.
constexpr int THREADS = 256;
constexpr int CTAS_PER_SM = 8;
constexpr int PART_OUTPUTS = 2048;  // output floats of a part, about
constexpr int CHUNK_FLOATS = 4096;  // floats of rows staged at once, about
constexpr int SMALL_TILE = 2048;    // rows of a tile read whole, without a search
constexpr int IDS_PER_THREAD = 4;   // ids a thread reads a round while marking starts

struct Shape {
  int P, S, seg_tile, seg_part, parts, chunk_rows;
};

size_t smem_bytes(const Shape& sh) {
  return 4 * ((size_t)sh.chunk_rows * sh.P + sh.chunk_rows + sh.seg_part + 1);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
    tile_segment_sum_kernel(const float* __restrict__ data, const int* __restrict__ ids,
                            const int* __restrict__ perm, const int* __restrict__ ts,
                            float* __restrict__ out, const Shape sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = sh.P, tid = threadIdx.x;
  const int t = blockIdx.x / sh.parts, part = blockIdx.x % sh.parts;
  const int tile_hi = (int)min((long long)(t + 1) * sh.seg_tile, (long long)sh.S);
  const int seg_lo = t * sh.seg_tile + part * sh.seg_part;
  if (seg_lo >= tile_hi) return;
  const int seg_hi = min(seg_lo + sh.seg_part, tile_hi);
  const int nseg = seg_hi - seg_lo;
  float* buf = reinterpret_cast<float*>(smem);  // [chunk_rows, P] staged rows
  int* src = reinterpret_cast<int*>(buf + (size_t)sh.chunk_rows * P);  // data row of each
  int* start = src + sh.chunk_rows;     // [nseg + 1] first row of each segment
  const int row_end = ts[t + 1];

  // 1. the first row of each segment (row_end when none follows)
  for (int k = tid; k <= nseg; k += THREADS) start[k] = row_end;
  int lo = ts[t];
  if (row_end - lo > SMALL_TILE)
    lo = gaot::cta_lower_bound<THREADS>(lo, row_end, seg_lo,
                                        [&](int r) { return __ldg(ids + r); });
  __syncthreads();
  for (int base = lo; base < row_end; base += THREADS * IDS_PER_THREAD) {
    int cur[IDS_PER_THREAD], prev[IDS_PER_THREAD];
#pragma unroll
    for (int u = 0; u < IDS_PER_THREAD; ++u) {
      const int r = base + u * THREADS + tid;
      cur[u] = r < row_end ? __ldg(ids + r) : INT_MIN;
      prev[u] = r < row_end && r > lo ? __ldg(ids + r - 1) : INT_MIN;
    }
#pragma unroll
    for (int u = 0; u < IDS_PER_THREAD; ++u) {
      const int r = base + u * THREADS + tid;
      const long long from = max((long long)prev[u] + 1, (long long)seg_lo);
      const long long to = min((long long)cur[u], (long long)seg_hi);
      for (long long s = from; s <= to; ++s) start[s - seg_lo] = r;
    }
    const int next = base + THREADS * IDS_PER_THREAD;
    if (next >= row_end || __ldg(ids + next - 1) >= seg_hi) break;  // the same for all
  }
  __syncthreads();

  // 2-3. the part's rows, a chunk at a time: staged, then added in row order;
  // a segment that goes on into the next chunk leaves its sum in its output
  float* dst = out + (size_t)seg_lo * P;
  const int r_lo = start[0], r_hi = start[nseg];
  for (int r0 = r_lo; r0 < r_hi; r0 += sh.chunk_rows) {
    const int n = min(sh.chunk_rows, r_hi - r0);
    for (int i = tid; i < n; i += THREADS) src[i] = perm ? __ldg(perm + r0 + i) : r0 + i;
    __syncthreads();
    for (int e = tid; e < n * P; e += THREADS) {
      const int i = e / P, c = e - i * P;
      cp_async4(buf + e, data + (size_t)src[i] * P + c);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int f = tid; f < nseg * P; f += THREADS) {
      const int k = f / P, c = f - k * P;
      const int a = max(start[k], r0), z = min(start[k + 1], r0 + n);
      if (a >= z) continue;
      float sum = a == start[k] ? 0.f : dst[f];  // this thread's own earlier store
      for (int r = a; r < z; ++r) sum = __fadd_rn(sum, buf[(size_t)(r - r0) * P + c]);
      dst[f] = sum;
    }
    __syncthreads();
  }

  // 4. the empty segments' zeros
  for (int f = tid; f < nseg * P; f += THREADS) {
    const int k = f / P;
    if (start[k] == start[k + 1]) dst[f] = 0.f;
  }
}

}  // namespace

extern "C" {

// data [E, P] f32 (sorted rows, or unsorted rows read through perm [E] i32
// when perm is not null), ids [E] i32 in sorted order, ts [T + 1] i32 with
// T = ceil(S / seg_tile), out [S, P] f32; all contiguous. Returns the
// launch's cudaError_t.
int gaot_tile_segment_sum(const void* data, const void* ids, const void* perm, const void* ts,
                          void* out, int P, int S, int seg_tile, void* stream) {
  if (P <= 0 || S <= 0 || seg_tile <= 0) return (int)cudaErrorInvalidValue;
  Shape sh;
  sh.P = P;
  sh.S = S;
  sh.seg_tile = seg_tile;
  const int widest = seg_tile < S ? seg_tile : S;  // segments of the widest tile
  sh.seg_part = PART_OUTPUTS / P < 1 ? 1 : PART_OUTPUTS / P;
  if (sh.seg_part > widest) sh.seg_part = widest;
  sh.parts = (widest + sh.seg_part - 1) / sh.seg_part;
  sh.chunk_rows = CHUNK_FLOATS / P < 1 ? 1 : CHUNK_FLOATS / P;
  const long long tiles = (S + (long long)seg_tile - 1) / seg_tile;
  if (tiles * sh.parts > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(sh);
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(tile_segment_sum_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tile_segment_sum_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  tile_segment_sum_kernel<<<(int)(tiles * sh.parts), THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const int*>(ids),
      static_cast<const int*>(perm), static_cast<const int*>(ts), static_cast<float*>(out),
      sh);
  return (int)cudaGetLastError();
}

}  // extern "C"
