// One warp's share of a sorted segment sum, used by segment_sum_sorted.cu
// and tile_segment_sum.cu.
//
// Rows [row_begin, row_end) carry nondecreasing segment ids. The warp owns the
// segments [seg_lo, seg_hi): it finds its first row by a binary search, walks
// its rows once in order with the columns on its lanes, and writes every one
// of its output rows exactly once, zeros for a segment that holds no row. A
// segment's sum is taken in row order starting from 0, so it is the same on
// every launch. Rows whose id lies below seg_lo or at or above seg_hi belong
// to another warp or to nobody (padding carries an id past the last segment)
// and are never read. With `perm` the data row of sorted position r is
// perm[r]; without it the data are already in sorted order.
#pragma once
#include <cuda_runtime.h>

namespace gaot {

constexpr int WALK_COLS = 2;  // columns a lane holds in one pass: 64 a warp

__device__ inline void store_segment(float* __restrict__ out, int seg, int P, int c0, int lane,
                                     const float (&sum)[WALK_COLS]) {
#pragma unroll
  for (int j = 0; j < WALK_COLS; ++j) {
    const int c = c0 + lane + 32 * j;
    if (c < P) out[(size_t)seg * P + c] = sum[j];
  }
}

__device__ inline void warp_segment_walk(const float* __restrict__ data,
                                         const int* __restrict__ ids,
                                         const int* __restrict__ perm, int row_begin,
                                         int row_end, int seg_lo, int seg_hi, int P,
                                         float* __restrict__ out) {
  if (seg_lo >= seg_hi) return;
  const int lane = threadIdx.x & 31;
  // first row of [row_begin, row_end) whose id is >= seg_lo (every lane runs
  // the same search on the same addresses)
  int lo = row_begin, hi = row_end;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (ids[mid] < seg_lo) lo = mid + 1; else hi = mid;
  }
  const int first = lo;
  const float zeros[WALK_COLS] = {};
  for (int c0 = 0; c0 < P; c0 += 32 * WALK_COLS) {
    float sum[WALK_COLS] = {};
    int cur = seg_lo;  // the segment `sum` belongs to; all before it are written
    for (int r = first; r < row_end; ++r) {
      const int id = ids[r];
      if (id >= seg_hi) break;
      if (id != cur) {
        store_segment(out, cur, P, c0, lane, sum);
        for (int s = cur + 1; s < id; ++s) store_segment(out, s, P, c0, lane, zeros);
        cur = id;
#pragma unroll
        for (int j = 0; j < WALK_COLS; ++j) sum[j] = 0.f;
      }
      const size_t src = perm ? (size_t)perm[r] : (size_t)r;
#pragma unroll
      for (int j = 0; j < WALK_COLS; ++j) {
        const int c = c0 + lane + 32 * j;
        if (c < P) sum[j] += data[src * P + c];
      }
    }
    store_segment(out, cur, P, c0, lane, sum);
    for (int s = cur + 1; s < seg_hi; ++s) store_segment(out, s, P, c0, lane, zeros);
  }
}

}  // namespace gaot
