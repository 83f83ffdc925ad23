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
// grid has. Here a CTA owns one tile and loops over exactly the rows
// [ts[t], ts[t+1]) the caller says are the tile's, however many: nothing can
// overflow. Each warp owns seg_tile/WARPS segments and walks their rows once
// (segment_walk.cuh). With `perm` the kernel reads row perm[r] of the
// unsorted data itself, which saves writing and reading a sorted copy. Every
// output row is written once, in row order, without atomics: two launches
// give the same bits.
//
// What bounds it on an H100 is bytes: [E, P], the ids (and perm) read once,
// [S, P] written once.
#include <cuda_runtime.h>

#include "segment_walk.cuh"

namespace {

constexpr int WARPS = 16;

__global__ void __launch_bounds__(WARPS * 32)
    tile_segment_sum_kernel(const float* __restrict__ data, const int* __restrict__ ids,
                            const int* __restrict__ perm, const int* __restrict__ ts,
                            float* __restrict__ out, int P, int S, int seg_tile) {
  const int t = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int per_warp = (seg_tile + WARPS - 1) / WARPS;
  const int tile_hi = min((t + 1) * seg_tile, S);
  const int seg_lo = t * seg_tile + warp * per_warp;
  const int seg_hi = min(seg_lo + per_warp, tile_hi);
  gaot::warp_segment_walk(data, ids, perm, ts[t], ts[t + 1], seg_lo, seg_hi, P, out);
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
  const int tiles = (S + seg_tile - 1) / seg_tile;
  tile_segment_sum_kernel<<<tiles, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const int*>(ids),
      static_cast<const int*>(perm), static_cast<const int*>(ts), static_cast<float*>(out), P,
      S, seg_tile);
  return (int)cudaGetLastError();
}

}  // extern "C"
