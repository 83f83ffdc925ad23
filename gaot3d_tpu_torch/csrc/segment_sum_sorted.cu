// Segment sum of rows that arrive sorted by segment id, for Hopper (sm_90a).
//
// Replaces gaot3d_tpu/ops/pallas_segment.py `_kernel` /
// `segment_sum_sorted_pallas` and the batch wrapper
// gaot3d_tpu/ops/segment.py `_pallas_sum_sorted_b`: data [B, E, P] float32
// with ids [B, E] nondecreasing within a batch, rows to drop carrying an id
// of num_segments or more at the tail, -> out [B, num_segments, P].
//
// The TPU kernel adds rows with a one-hot matrix product because a matrix
// unit is what it has; its lane padding to 128, the ids carried as a float
// channel and the tile-divisibility rule are that compiler's. None of it is
// kept. Here a CTA owns SEG_TILE consecutive segments of one batch. Each of
// its warps owns SEG_TILE/WARPS segments, finds their first row by a binary
// search over the batch's sorted ids and walks their rows once
// (segment_walk.cuh). Every output row is written once, sums are exact
// float32 in row order, and there is no atomic: two launches give the same
// bits.
//
// What bounds it on an H100 is bytes: [E, P] and the ids read once, [M, P]
// written once.
#include <cuda_runtime.h>

#include "segment_walk.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int SEG_TILE = 64;  // segments a CTA owns

__global__ void __launch_bounds__(WARPS * 32)
    segment_sum_sorted_kernel(const float* __restrict__ data, const int* __restrict__ ids,
                              float* __restrict__ out, int E, int P, int M) {
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int per_warp = SEG_TILE / WARPS;
  const int seg_lo = blockIdx.x * SEG_TILE + warp * per_warp;
  const int seg_hi = min(seg_lo + per_warp, M);
  gaot::warp_segment_walk(data + (size_t)b * E * P, ids + (size_t)b * E, nullptr, 0, E, seg_lo,
                          seg_hi, P, out + (size_t)b * M * P);
}

}  // namespace

extern "C" {

// data [B, E, P] f32, ids [B, E] i32 nondecreasing within a batch, out
// [B, M, P] f32; all contiguous. Returns the launch's cudaError_t.
int gaot_segment_sum_sorted(const void* data, const void* ids, void* out, int B, int E, int P,
                            int M, void* stream) {
  if (B <= 0 || B > 65535 || E < 0 || P <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const int tiles = (M + SEG_TILE - 1) / SEG_TILE;
  segment_sum_sorted_kernel<<<dim3(tiles, B), WARPS * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const int*>(ids), static_cast<float*>(out),
      E, P, M);
  return (int)cudaGetLastError();
}

}  // extern "C"
