// Segment sum of rows that arrive sorted by segment id, for Hopper (sm_90a).
//
// Replaces gaot3d_tpu/ops/pallas_segment.py `_kernel` /
// `segment_sum_sorted_pallas` and the batch wrapper
// gaot3d_tpu/ops/segment.py `_pallas_sum_sorted_b`: data [B, E, P] float32
// with ids [B, E] nondecreasing within a batch -> out [B, M, P]. Rows with a
// negative id (at the head) or an id of M or more (at the tail) are dropped.
//
// The TPU kernel adds rows with a one-hot matrix product because a matrix
// unit is what it has; its lane padding to 128, the ids carried as a float
// channel and the tile-divisibility rule are that compiler's. None of it is
// kept. Here the work is split, not the segments: a batch's E rows and M
// segment boundaries form one merged sequence, boundary s just before the
// rows of segment s (rows with a negative id before boundary 0, rows to drop
// after boundary M - 1), so row r stands at
//   p(r) = r + clamp(ids[r] + 1, 0, M)
// and every CTA takes `share` consecutive items of it (a merge-path split;
// the caller passes `share`). A hot segment or a long run of empty segments
// thus loads no CTA with more than its share, except that the owner of a
// segment reads all its rows. A CTA owns the segments whose boundary falls in
// its share and
//   1. finds where its share begins, r0 = the first row with p(r) >= d0,
//      to within NARROW rows, with all its threads probing at once
//      (gaot::cta_narrow: two rounds of one load a thread at M = 131,072);
//   2. reads the ids of a window of rows there into shared memory, and from
//      them r0, where its share ends, the first row of each segment it owns
//      and where the last of them ends (reading on past its share, with
//      another search when the last segment runs past the window);
//   3. fetches its rows [a, z) into shared memory with one bulk copy
//      (cp.async.bulk, completing on an mbarrier): the 16-byte aligned part
//      of the range, and the at most three floats at each ragged end by
//      threads. A share holds at most `share` rows, so only the last owned
//      segment can have more, which later copies bring;
//   4. adds them: thread f owns output f = k * P + c of the CTA's owned
//      segments, adds segment k's rows in row order starting from 0.0f and
//      stores it, neighbouring threads on neighbouring floats; an owned
//      segment with no row stores its 0 in the same stores. The last
//      segment's further rows are added to what was stored, in order.
// Every segment is summed by one owner in row order from 0, as K8
// (tile_segment_sum.cu) does: K6 gives K8's bits on the same sorted rows,
// kernels/segment_sum_sorted.py `segment_sum_sorted_ordered_reference`
// repeats the split and gives its bits, and two launches give the same bits,
// without atomics.
//
// What bounds it on an H100 is bytes: the valid rows of [E, P] and the ids
// read once, [M, P] written once.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// At P = 43 a share holds up to 190 rows (32.7 KB staged), and an SM holds
// CTAS_PER_SM = 6 CTAs: the kernel's 40 registers a thread, without spills,
// and their shared memory (8 CTAs at 32 registers spilled in the adds and
// ran slower; tools/probe_sorted_kernels.py has both).
constexpr int THREADS = 256;
constexpr int CTAS_PER_SM = 6;
constexpr int NARROW = 1;  // rows from r0 at which the search stops: the window settles them
constexpr unsigned FULL = 0xffffffffu;

struct Shape {
  int E, P, M, share;
  int win;  // ids of the window: NARROW + share + 1 rounded up to THREADS
};

// mbarrier, the staged rows (share * P floats and their ragged ends), the
// window's ids, each owned segment's first row and the end of the last,
// four counters
size_t smem_bytes(const Shape& sh) {
  return 128 + 4 * ((size_t)sh.share * sh.P + 8 + sh.win + sh.share + 1 + 4);
}

// where row r with segment id `id` stands in the merged sequence
__device__ __forceinline__ int merged_pos(int r, int id, int M) {
  return r + (id < 0 ? 0 : id >= M ? M : id + 1);
}

// the sum over the CTA of each thread's v, added into *at (zero beforehand)
__device__ __forceinline__ void cta_add(int* at, int v) {
  v = __reduce_add_sync(FULL, v);
  if ((threadIdx.x & 31) == 0 && v != 0) atomicAdd(at, v);
}

// Rows [c0, c0 + n) of `rows` ([*, P] floats) into shared memory at `buf`
// (16-byte aligned): the 16-byte aligned part of their bytes by one bulk
// copy completing on `bar`, the at most three floats at each end by threads.
// Every thread calls it; on return the rows are in place and visible to the
// CTA. Returns where in `buf` row c0 begins.
__device__ __forceinline__ float* stage_rows(const float* __restrict__ rows, int c0, int n,
                                             int P, float* buf, uint32_t bar,
                                             uint32_t& parity) {
  const int tid = threadIdx.x;
  const float* src = rows + (size_t)c0 * P;
  const uintptr_t g0 = reinterpret_cast<uintptr_t>(src), g1 = g0 + (size_t)n * P * 4;
  const uintptr_t lo16 = (g0 + 15) & ~(uintptr_t)15, hi16 = g1 & ~(uintptr_t)15;
  float* at = buf + (g0 & 15) / 4;  // at[i] holds src[i]
  if (hi16 > lo16) {
    const uint32_t bytes = (uint32_t)(hi16 - lo16);
    if (tid == 0) {
      gaot::mbar_expect_tx(bar, bytes);
      gaot::bulk_load(gaot::smem_u32(buf) + (uint32_t)(lo16 - (g0 & ~(uintptr_t)15)),
                      reinterpret_cast<const void*>(lo16), bar, bytes);
    }
    const int nh = (int)((lo16 - g0) / 4), nt = (int)((g1 - hi16) / 4);
    if (tid < nh) {
      at[tid] = __ldg(src + tid);
    } else if (tid >= 4 && tid < 4 + nt) {
      const int i = n * P - nt + (tid - 4);
      at[i] = __ldg(src + i);
    }
    gaot::mbar_wait(bar, parity);
    parity ^= 1;
  } else {
    for (int i = tid; i < n * P; i += THREADS) at[i] = __ldg(src + i);
  }
  __syncthreads();
  return at;
}

__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
    segment_sum_sorted_kernel(const float* __restrict__ data, const int* __restrict__ ids_all,
                              float* __restrict__ out_all, const Shape sh) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int E = sh.E, P = sh.P, M = sh.M, tid = threadIdx.x;
  const int* ids = ids_all + (size_t)blockIdx.y * E;
  const float* rows = data + (size_t)blockIdx.y * E * P;
  const int d0 = blockIdx.x * sh.share;
  const int d1 = (int)min((long long)d0 + sh.share, (long long)E + M);
  const uint32_t bar = gaot::smem_u32(smem);
  float* buf = reinterpret_cast<float*>(smem + 128);  // staged rows, 16-byte aligned
  int* win = reinterpret_cast<int*>(buf + (size_t)sh.share * P + 8);
  int* start = win + sh.win;  // [owned segments + 1] first row of each, end of the last
  int* count = start + sh.share + 1;
  if (tid == 0) {
    gaot::mbar_init(bar, 1);
    gaot::fence_barrier_init();
    count[0] = count[1] = count[2] = count[3] = 0;
  }

  // 1. where the share begins, r0 = the first row with p(r) >= d0: found
  // to within NARROW rows, which the window's ids then settle
  const int w0 = gaot::cta_narrow<THREADS>(
      max(0, d0 - M), min(E, d0), d0, [&](int r) { return merged_pos(r, __ldg(ids + r), M); },
      NARROW);

  // 2. the window's ids from w0; r0 and r1, where the share begins and ends
  // (r0 rows and s0 boundaries stand before d0, r1 and s1 before d1), the
  // owned rows [a, z), the first row of each owned segment
  const int nwin = min(sh.win, E - w0);
  for (int i = tid; i < nwin; i += THREADS) win[i] = __ldg(ids + w0 + i);
  __syncthreads();
  int before_d0 = 0, before_d1 = 0;
  for (int i = tid; i < nwin; i += THREADS) {
    const int p = merged_pos(w0 + i, win[i], M);
    before_d0 += p < d0;
    before_d1 += p < d1;
  }
  cta_add(count, before_d0);
  cta_add(count + 1, before_d1);
  __syncthreads();
  const int r0 = w0 + count[0], r1 = w0 + count[1];
  const int s0 = d0 - r0, s1 = d1 - r1;
  if (s1 <= s0) return;  // a share inside one segment's rows owns nothing
  const int nseg = s1 - s0;
  // The row at window index i (i = r1 - w0 stands for r1 itself) is the
  // first row of the owned segments in (id of the row before, its own id];
  // every owned segment gets exactly one first row, r1 for those after the
  // share's last row. Rows before r0 have ids below s0.
  int below_s0 = 0, below_s1 = 0;
  for (int i = r0 - w0 + tid; i <= r1 - w0; i += THREADS) {
    const int id = i < r1 - w0 ? win[i] : s1 - 1;
    const int prev = i > r0 - w0 ? win[i - 1] : s0 - 1;
    for (int s = max(prev + 1, s0); s <= min(id, s1 - 1); ++s) start[s - s0] = w0 + i;
  }
  for (int i = tid; i < nwin; i += THREADS) {
    below_s0 += win[i] < s0;
    below_s1 += win[i] < s1;
  }
  cta_add(count + 2, below_s0);
  cta_add(count + 3, below_s1);
  __syncthreads();
  const int a = w0 + count[2];
  // the last owned segment ends at z, the first row with an id of s1 or
  // more, which may lie past the window (and past what one share stages)
  int z = w0 + count[3];
  if (z == w0 + nwin && z < E)
    z = gaot::cta_lower_bound<THREADS>(z, E, s1, [&](int r) { return __ldg(ids + r); });
  const int n = min(sh.share, z - a);  // every segment but the last ends within these rows
  if (tid == 0) start[nseg] = a + n;

  // 3. the rows [a, a + n) into shared memory
  uint32_t parity = 0;
  const float* at = stage_rows(rows, a, n, P, buf, bar, parity) - (size_t)a * P;

  // 4. thread f adds output f = k * P + c: column c of owned segment k, over
  // its rows in row order from 0 (an empty segment's sum is its 0)
  float* dst = out_all + ((size_t)blockIdx.y * M + s0) * P;
  const int step_k = THREADS / P, step_c = THREADS - step_k * P;  // f += THREADS in (k, c)
  int k = tid / P, c = tid - k * P;
  for (int f = tid; f < nseg * P; f += THREADS, k += step_k, c += step_c) {
    if (c >= P) {
      c -= P;
      ++k;
    }
    const int e = start[k + 1];
    float sum = 0.f;
    for (int r = start[k]; r < e; ++r) sum = __fadd_rn(sum, at[(size_t)r * P + c]);
    dst[f] = sum;
  }

  // the last segment's rows past a + n, a share of them at a time, added to
  // what step 4 stored (by any thread: the barrier makes it visible)
  for (int c0 = a + n; c0 < z; c0 += sh.share) {
    const int m = min(sh.share, z - c0);
    gaot::fence_proxy_async();  // the copy overwrites what the threads read
    __syncthreads();
    const float* more = stage_rows(rows, c0, m, P, buf, bar, parity);
    for (int c = tid; c < P; c += THREADS) {
      float sum = dst[(size_t)(nseg - 1) * P + c];
      for (int r = 0; r < m; ++r) sum = __fadd_rn(sum, more[(size_t)r * P + c]);
      dst[(size_t)(nseg - 1) * P + c] = sum;
    }
  }
}

cudaError_t configure(size_t smem) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(segment_sum_sorted_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(segment_sum_sorted_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return err;
}

bool make_shape(int E, int P, int M, int share, Shape* sh) {
  if (E < 0 || P <= 0 || M <= 0 || share <= 0) return false;
  if ((long long)E + M + share > INT_MAX) return false;  // positions in the merged sequence
  sh->E = E;
  sh->P = P;
  sh->M = M;
  sh->share = share;
  sh->win = (NARROW + share + THREADS) / THREADS * THREADS;
  return true;
}

}  // namespace

extern "C" {

// CTAs of the kernel an SM holds at P columns and shares of `share` items
// (-1 on error).
int gaot_segment_sum_sorted_ctas_per_sm(int P, int share) {
  Shape sh;
  int per_sm = 0;
  if (!make_shape(0, P, 1, share, &sh)) return -1;
  const size_t smem = smem_bytes(sh);
  if (configure(smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, segment_sum_sorted_kernel,
                                                    THREADS, smem) != cudaSuccess)
    return -1;
  return per_sm;
}

// data [B, E, P] f32, ids [B, E] i32 nondecreasing within a batch, out
// [B, M, P] f32; all contiguous. Each CTA takes `share` items of a batch's
// merged sequence of E rows and M boundaries. Returns the launch's
// cudaError_t.
int gaot_segment_sum_sorted(const void* data, const void* ids, void* out, int B, int E, int P,
                            int M, int share, void* stream) {
  Shape sh;
  if (B <= 0 || B > 65535 || !make_shape(E, P, M, share, &sh)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(sh);
  const cudaError_t err = configure(smem);
  if (err != cudaSuccess) return (int)err;
  const int ctas = (int)(((long long)E + M + share - 1) / share);
  segment_sum_sorted_kernel<<<dim3(ctas, B), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const int*>(ids), static_cast<float*>(out),
      sh);
  return (int)cudaGetLastError();
}

}  // extern "C"
