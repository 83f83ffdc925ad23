// The budgeted slot build in one pass for Hopper (sm_90a), K10.
//
// Replaces no TPU kernel: the JAX package leaves this build to XLA
// (gaot3d_tpu/ops/grid_graph.py `build_edge_slots_batched`, then
// `compact_slots`), and the port's plain version (ops/grid_graph.py
// `build_budgeted_slots` on CPU tensors) makes each point's whole stencil
// window [N, K] in device memory, its d^2, a mask, k argmin passes, and then
// a stable sort of the inverted mask and two gathers to `budget` columns.
// This kernel gives the same bits, a thread a point, and writes only the
// compacted [B, N, budget] lat_idx (int32) and mask (bool):
//   - the window: per axis the cell floor((p - lo) / h) (an IEEE division;
//     0 where h is 0), less w/2 - 1, clamped to [0, max(dim - w, 0)]; slot
//     (a, b, c) of the window is cell base + (a * D1 + b) * D2 + c, slots in
//     that order;
//   - d^2 of a slot: the cell centre lo + i * h per axis (a product, then a
//     sum), its offset from the point squared, the three summed as
//     (d0^2 + d1^2) + d2^2, every operation rounded on its own (the _rn
//     intrinsics, which nvcc never contracts into an FMA);
//   - radius: d^2 <= r^2 (r^2 rounded in f32 by the caller);
//   - kNN: the k slots of lexicographically least (d^2, slot), which is what
//     k passes of a first-occurrence argmin pick; the union with the radius
//     slots under 'bidirectional';
//   - compaction as a stable sort of the inverted mask: the first `budget`
//     valid slots in window order (later valid slots are dropped), then,
//     where a row has fewer, its first invalid slots in window order with
//     their own cells, masked. A row whose point mask is false holds the
//     window's first `budget` slots, all masked.
// The window is never stored and nothing is sorted. Each pass walks the
// window in slot order but skips a slab (a) or row (a, b) of it whose partial
// sum d0^2 (+ d1^2) already exceeds what the pass looks for: each term left is
// a square, so d^2 can only be larger, and the skip drops no slot the pass
// would keep. With k = 1 and the radius test ('bidirectional', the recipe's)
// one pass finds the radius slots and the argmin together, starting the
// argmin from the window's cell nearest the point and skipping what lies
// beyond both r^2 and the best so far: when any slot lies within the radius,
// so does the argmin, and otherwise the argmin is the row's one valid slot.
// At radius 0.033 on the 64x64x32 grid that pass reaches about 4 rows of 4
// of the window's 36, not its 144 slots. The masked fill walks from the
// window's first slot and stops once the row is full, after a few slots in a
// sparse row. A block's rows are staged in shared memory and written out as
// one contiguous range, so the stores coalesce.
//
// What bounds it on an H100: the bytes (the points, the point mask, the
// [N, budget] result: about 0.13 ms at 8,388,608 points and budget 8). A
// walk of all 144 slots with each axis's squared offsets once a point, a sum
// and a compare a slot, would take the FP32 pipe about 0.1 ms; the skips do
// less than that. One launch a build.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int STAGE_BYTES = 48 * 1024;  // a block's rows staged in shared memory

struct Grid {
  int dim[3];
  float lo[3], h[3];
  int w[3];
};

// the cell centre lo + i * h, its offset from the point, squared; each rounded
__device__ __forceinline__ float offset_sq(int i, float h, float lo, float p) {
  const float d = __fsub_rn(__fadd_rn(__fmul_rn(static_cast<float>(i), h), lo), p);
  return __fmul_rn(d, d);
}

// (d, s) strictly after (pd, ps) in the order of k passes of a first-occurrence argmin
__device__ __forceinline__ bool after(float d, int s, float pd, int ps) {
  return d > pd || (d == pd && s > ps);
}

struct Window {
  float p[3];
  int f[3];     // the cell floor((p - lo) / h) on each axis (0 where h is 0)
  int base[3];  // the window's first cell on each axis
  int cell0;    // its flat index
};

// f(slot, cell, d2) in window order, until f returns false, for every slot
// whose d2 can be at most limit(): a slab (a) or row (a, b) whose partial sum
// already exceeds it is skipped, since the terms left are squares and each
// rounded sum of non-negative terms is at least its first term
template <typename L, typename F>
__device__ __forceinline__ void each_slot(const Grid& g, const Window& win, L&& limit, F&& f) {
  for (int a = 0; a < g.w[0]; ++a) {
    const float q0 = offset_sq(win.base[0] + a, g.h[0], g.lo[0], win.p[0]);
    if (q0 > limit()) continue;
    for (int b = 0; b < g.w[1]; ++b) {
      const float q01 = __fadd_rn(q0, offset_sq(win.base[1] + b, g.h[1], g.lo[1], win.p[1]));
      if (q01 > limit()) continue;
      const int s0 = (a * g.w[1] + b) * g.w[2];
      const int row = win.cell0 + (a * g.dim[1] + b) * g.dim[2];
      for (int c = 0; c < g.w[2]; ++c) {
        const float d = __fadd_rn(q01, offset_sq(win.base[2] + c, g.h[2], g.lo[2], win.p[2]));
        if (!f(s0 + c, row + c, d)) return;
      }
    }
  }
}

// the row of one point: its first `budget` slots after compaction, into idx and msk
__device__ void build_row(const Grid& g, const Window& win, bool live, int radius_test,
                          float r2, int knn, int budget, int* idx, bool* msk) {
  const auto all = [] { return INFINITY; };
  int nv = 0;
  float dk = -INFINITY;  // kNN: a slot is a pick exactly when its (d, s) is not after (dk, sk)
  int sk = -1;
  if (live && radius_test && knn == 1) {
    // one pass: the radius slots and the argmin together. Start the argmin
    // from the window's cell nearest the point on each axis, so that the
    // pass skips whatever lies beyond both r^2 and the best so far; the
    // lower slot wins a tie
    int j[3];
    float q[3];
    for (int a = 0; a < 3; ++a) {
      const int lo = win.base[a], hi = win.base[a] + g.w[a] - 1;
      const int j0 = min(max(win.f[a], lo), hi), j1 = min(j0 + 1, hi);
      const float q0 = offset_sq(j0, g.h[a], g.lo[a], win.p[a]);
      const float q1 = offset_sq(j1, g.h[a], g.lo[a], win.p[a]);
      j[a] = q1 < q0 ? j1 : j0;
      q[a] = q1 < q0 ? q1 : q0;
    }
    float bd = __fadd_rn(__fadd_rn(q[0], q[1]), q[2]);
    int bs = ((j[0] - win.base[0]) * g.w[1] + j[1] - win.base[1]) * g.w[2] + j[2] - win.base[2];
    int bc = (j[0] * g.dim[1] + j[1]) * g.dim[2] + j[2];
    each_slot(g, win, [&] { return fmaxf(r2, bd); }, [&](int s, int cell, float d) {
      if (d < bd || (d == bd && s < bs)) { bd = d; bs = s; bc = cell; }
      if (d <= r2) {
        idx[nv] = cell;
        msk[nv] = true;
        return ++nv < budget;  // valid slots past the budget are dropped
      }
      return true;
    });
    if (nv == 0) {  // no slot within the radius: the argmin is the row's one edge
      idx[0] = bc;
      msk[0] = true;
      nv = 1;
    }
    dk = bd;
    sk = bs;
  } else if (live) {
    for (int pass = 0; pass < knn; ++pass) {  // the argmin passes, each after the last pick
      float bd = 0.0f;
      int bs = -1;
      each_slot(g, win, [&] { return bs < 0 ? INFINITY : bd; }, [&](int s, int, float d) {
        if (after(d, s, dk, sk) && (bs < 0 || d < bd)) { bd = d; bs = s; }
        return true;
      });
      dk = bd;
      sk = bs;
    }
    const float bound = fmaxf(radius_test ? r2 : -INFINITY, knn > 0 ? dk : -INFINITY);
    each_slot(g, win, [&] { return bound; }, [&](int s, int cell, float d) {
      if ((radius_test && d <= r2) || (knn > 0 && !after(d, s, dk, sk))) {
        idx[nv] = cell;
        msk[nv] = true;
        return ++nv < budget;
      }
      return true;
    });
  }
  if (nv < budget) {  // the masked fill: the first invalid slots in window order
    each_slot(g, win, all, [&](int s, int cell, float d) {
      if (live && ((radius_test && d <= r2) || (knn > 0 && !after(d, s, dk, sk)))) return true;
      idx[nv] = cell;
      msk[nv] = false;
      return ++nv < budget;
    });
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
slot_build_kernel(const float* __restrict__ pts, const bool* __restrict__ point_mask,
                  long long n_points, Grid g, int radius_test, float r2, int knn, int budget,
                  int* __restrict__ out_idx, bool* __restrict__ out_mask) {
  // the block's rows are staged here and written out as one contiguous range
  extern __shared__ int stage[];
  int* s_idx = stage;
  bool* s_msk = reinterpret_cast<bool*>(stage + blockDim.x * budget);
  const long long row0 = static_cast<long long>(blockIdx.x) * blockDim.x;
  const long long i = row0 + threadIdx.x;
  if (i < n_points) {
    Window win;
    for (int a = 0; a < 3; ++a) {
      const float p = pts[3 * i + a];
      win.p[a] = p;
      win.f[a] = g.h[a] == 0.0f
          ? 0 : static_cast<int>(floorf(__fdiv_rn(__fsub_rn(p, g.lo[a]), g.h[a])));
      win.base[a] = min(max(win.f[a] - (g.w[a] / 2 - 1), 0), max(g.dim[a] - g.w[a], 0));
    }
    win.cell0 = (win.base[0] * g.dim[1] + win.base[1]) * g.dim[2] + win.base[2];
    const bool live = point_mask == nullptr || point_mask[i];
    build_row(g, win, live, radius_test, r2, knn, budget, s_idx + threadIdx.x * budget,
              s_msk + threadIdx.x * budget);
  }
  __syncthreads();
  const long long n = min(static_cast<long long>(blockDim.x), n_points - row0) * budget;
  int* idx = out_idx + row0 * budget;
  for (long long j = threadIdx.x; j < n; j += blockDim.x) idx[j] = s_idx[j];
  // the masks four at a time: row0 * budget is a multiple of 4 (blockDim.x is)
  bool* msk = out_mask + row0 * budget;
  const long long words = n / 4;
  for (long long j = threadIdx.x; j < words; j += blockDim.x)
    reinterpret_cast<int*>(msk)[j] = reinterpret_cast<const int*>(s_msk)[j];
  for (long long j = 4 * words + threadIdx.x; j < n; j += blockDim.x) msk[j] = s_msk[j];
}

}  // namespace

extern "C" {

// The threads a block for `budget`: its rows' slots fit in STAGE_BYTES, a
// multiple of 32, at most MAX_THREADS; 0 if not one warp's rows fit.
int gaot_slot_build_threads(int budget) {
  const int fit = STAGE_BYTES / (budget * (sizeof(int) + sizeof(bool)));
  return min(MAX_THREADS, fit / 32 * 32);
}

// points [n_points, 3] f32 and point_mask [n_points] bool (or null: every
// point live), contiguous; out_idx [n_points, budget] int32, out_mask
// [n_points, budget] bool, 4-byte aligned. 0 < budget < w0 * w1 * w2 and
// gaot_slot_build_threads(budget) > 0. Returns the launch's cudaError_t.
int gaot_slot_build(const float* pts, const bool* point_mask, long long n_points, int dim0,
                    int dim1, int dim2, float lo0, float lo1, float lo2, float h0, float h1,
                    float h2, int w0, int w1, int w2, int radius_test, float r2, int knn,
                    int budget, int* out_idx, bool* out_mask, cudaStream_t stream) {
  if (n_points == 0) return 0;
  Grid g{{dim0, dim1, dim2}, {lo0, lo1, lo2}, {h0, h1, h2}, {w0, w1, w2}};
  const int threads = gaot_slot_build_threads(budget);
  if (threads == 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n_points + threads - 1) / threads;
  const size_t smem = static_cast<size_t>(threads) * budget * (sizeof(int) + sizeof(bool));
  slot_build_kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      pts, point_mask, n_points, g, radius_test, r2, knn, budget, out_idx, out_mask);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
