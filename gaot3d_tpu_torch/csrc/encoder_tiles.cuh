// Tile machinery shared by the encoder payload's forward (K5,
// encoder_payload.cu) and backward (K5b, encoder_payload_bwd.cu) on Hopper
// (sm_90a): node-major tiles, the asynchronous loads of a tile's inputs, the
// shared-memory layout, and the kernel MLP's layer products on the tensor
// cores, at f32 grade (3xTF32) or as the bf16 kernel MLP takes them.
//
// Products: 3xTF32. Each f32 operand x is split as x = hi + lo with hi
// rounded to TF32 (to nearest, ties away from zero, as `cvt.rna.tf32.f32`)
// and lo the rest cut to TF32, and a*b is taken as hi_a*hi_b + hi_a*lo_b +
// lo_a*hi_b on `mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`: each
// product is within about 2^-20 of its f32 value. One warp owns 16 rows of a
// tile. Activations are split in registers once per 8-deep k step; weights
// are split once when staged (K5 in fragment order, K5b's hidden layers as
// hi and lo matrices it reads both ways) or, for K5b's small first and last
// layers, when a fragment is loaded.
//
// Fragments: with g = lane / 4 and t = lane % 4, an m16n8k8 accumulator holds
// rows g, g+8 and columns 2t, 2t+1 of its 8-column tile. The k index inside
// every 8-deep step is permuted (A slot t <-> k 2t, slot t+4 <-> k 2t+1, and
// the B operand read the same way), so one layer's accumulator is the next
// layer's A operand register for register, with no shuffle.
//
// bf16 (`kernel_dtype: bfloat16`): a layer's input and weight are rounded to
// bf16 (to nearest even, `cvt.rn.bf16x2.f32`, as JAX's astype) and the
// product is one `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32` pass
// with an f32 result. Its A fragment holds rows g, g+8 at columns 2t, 2t+1
// and 2t+8, 2t+9 of a 16-deep step, which is the accumulator of two adjacent
// 8-column tiles as it stands: one layer's output packs into the next one's A
// operand without a permutation. The backward's products of an f32 cotangent
// with a bf16 operand are 2xTF32 (hi_d*b + lo_d*b): a bf16 value is exact in
// TF32, so the third pass of 3xTF32 would add zero.
//
// Shared memory: a [rows][W] f32 matrix is stored with a row stride S (W, or
// 24 when W < 32) and the column index XORed in its bits 3-4 with bits of the
// row (`Mat<W>::at`). Both ways the kernels read such a matrix are then free
// of bank conflicts: rows g (0..7) at columns 2t, 2t+1 (an accumulator's
// pattern, as float2), and rows 2t, 2t+1 at column g (a B operand's pattern).
//
// Tiles: a tile holds whole nodes, floor(R / K) of them, with all K slots of
// each (row = node * K + slot), so a node's rows are adjacent and a sum over
// its slots stays inside the tile. When K > R a node takes ceil(K / R)
// consecutive tiles of one CTA. Rows past the tile's nodes are padding and
// count as masked.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace enc {

constexpr int R = 128;          // rows per tile
constexpr int WARPS = R / 16;   // one warp per 16 rows
constexpr int THREADS = 32 * WARPS;

struct GridSpec {
  int d1, d2;
  float lo0, lo1, lo2;
  float sp0, sp1, sp2;
};

// ---- shared-memory matrices -------------------------------------------------
template <int W>
struct Mat {
  static constexpr int S = W >= 32 ? W : 24;
  __device__ __forceinline__ static int at(int r, int c) {
    const int sw = W >= 32 ? ((r ^ (r >> 2)) & 3) << 3 : (r & 4) << 1;
    return r * S + (c ^ sw);
  }
};

// the [R][8] first-layer input [point | cell | 0 0]
struct X0 {
  static constexpr int S = 8;
  __device__ __forceinline__ static int at(int r, int c) { return r * 8 + c; }
};

// ---- bf16 products -------------------------------------------------------------
// Two f32 values rounded to bf16 to nearest even and packed, `lo` in the low
// half (the lower column or k index of a fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// x rounded to bf16 to nearest even, held in an f32 (exact in TF32)
__device__ __forceinline__ float round_bf16(float x) {
  return __uint_as_float(pack_bf16(x, 0.f) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- 3xTF32 products -----------------------------------------------------------
// x = hi + lo: hi rounded to TF32 to nearest, ties away from zero (what
// `cvt.rna.tf32.f32` gives, here as an integer add and mask), lo the exact
// rest cut to TF32 toward zero (the tensor core reads only a TF32's bits).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b at f32 grade: the two small cross terms first, then hi * hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh[2], bl[2];
  split(b0, bh[0], bl[0]);
  split(b1, bh[1], bl[1]);
  mma3(d, ah, al, bh, bl);
}

__device__ __forceinline__ void split4(const float (&a)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], hi[i], lo[i]);
}

// accumulator fragment of k-tile kt -> A fragment (the permuted k order)
__device__ __forceinline__ void as_a(const float (&c)[4], float (&a)[4]) {
  a[0] = c[0];
  a[1] = c[2];
  a[2] = c[1];
  a[3] = c[3];
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// A layer's weights [in][out] as f32 in a Mat<OUT>, split when a fragment is
// loaded. `fragment` reads W for a product x W, `fragment_t` reads W^T for a
// product d W^T (the backward's chain).
template <int OUT>
struct F32Weights {
  const float* w;
  __device__ __forceinline__ void fragment(int kt, int nt, int lane, uint32_t (&bh)[2],
                                           uint32_t (&bl)[2]) const {
    const int g = lane >> 2, t = lane & 3;
    split(w[Mat<OUT>::at(8 * kt + 2 * t, 8 * nt + g)], bh[0], bl[0]);
    split(w[Mat<OUT>::at(8 * kt + 2 * t + 1, 8 * nt + g)], bh[1], bl[1]);
  }
  __device__ __forceinline__ void fragment_t(int kt, int nt, int lane, uint32_t (&bh)[2],
                                             uint32_t (&bl)[2]) const {
    const int g = lane >> 2, t = lane & 3;
    const float2 b = *reinterpret_cast<const float2*>(w + Mat<OUT>::at(8 * nt + g, 8 * kt + 2 * t));
    split(b.x, bh[0], bl[0]);
    split(b.y, bh[1], bl[1]);
  }
};

// A layer's weights split once, when staged, into a hi and a lo Mat<OUT>,
// read both ways like F32Weights (K5b's hidden layers).
template <int OUT>
struct SplitMats {
  const uint32_t* hi;
  const uint32_t* lo;
  __device__ __forceinline__ void fragment(int kt, int nt, int lane, uint32_t (&bh)[2],
                                           uint32_t (&bl)[2]) const {
    const int g = lane >> 2, t = lane & 3;
    const int a0 = Mat<OUT>::at(8 * kt + 2 * t, 8 * nt + g);
    const int a1 = Mat<OUT>::at(8 * kt + 2 * t + 1, 8 * nt + g);
    bh[0] = hi[a0];
    bh[1] = hi[a1];
    bl[0] = lo[a0];
    bl[1] = lo[a1];
  }
  __device__ __forceinline__ void fragment_t(int kt, int nt, int lane, uint32_t (&bh)[2],
                                             uint32_t (&bl)[2]) const {
    const int g = lane >> 2, t = lane & 3;
    const int a = Mat<OUT>::at(8 * nt + g, 8 * kt + 2 * t);
    const uint2 h = *reinterpret_cast<const uint2*>(hi + a);
    const uint2 l = *reinterpret_cast<const uint2*>(lo + a);
    bh[0] = h.x;
    bh[1] = h.y;
    bl[0] = l.x;
    bl[1] = l.y;
  }
};

// A layer's weights split once, when staged, and stored in fragment order:
// lane l of fragment (kt, nt) finds {hi b0, hi b1, lo b0, lo b1} in one
// 16-byte word (K5).
template <int OUT>
struct SplitWeights {
  const uint4* w;
  __device__ __forceinline__ void fragment(int kt, int nt, int lane, uint32_t (&bh)[2],
                                           uint32_t (&bl)[2]) const {
    const uint4 v = w[(kt * (OUT / 8) + nt) * 32 + lane];
    bh[0] = v.x;
    bh[1] = v.y;
    bl[0] = v.z;
    bl[1] = v.w;
  }
};

// acc[16 x OUT] = act[16 x IN] * W[IN][OUT] for one warp's 16 rows: `act` in
// accumulator layout over IN.
template <int IN, int OUT, class Weights>
__device__ __forceinline__ void dense(const float (&act)[IN / 8][4], const Weights& w,
                                      float (&acc)[OUT / 8][4], int lane) {
  zero(acc);
#pragma unroll
  for (int kt = 0; kt < IN / 8; ++kt) {
    float a[4];
    as_a(act[kt], a);
    uint32_t ah[4], al[4];
    split4(a, ah, al);
#pragma unroll
    for (int nt = 0; nt < OUT / 8; ++nt) {
      uint32_t bh[2], bl[2];
      w.fragment(kt, nt, lane, bh, bl);
      mma3(acc[nt], ah, al, bh, bl);
    }
  }
}

// The first layer: the warp's rows of x0 (its columns 6 and 7 are zero) times
// W0 [8][HID] (rows 6 and 7 zero).
template <int HID, class Weights>
__device__ __forceinline__ void dense_first(const float* x0, int row0, const Weights& w,
                                            float (&acc)[HID / 8][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float2 top = *reinterpret_cast<const float2*>(x0 + X0::at(row0 + g, 2 * t));
  const float2 bot = *reinterpret_cast<const float2*>(x0 + X0::at(row0 + g + 8, 2 * t));
  const float a[4] = {top.x, bot.x, top.y, bot.y};
  uint32_t ah[4], al[4];
  split4(a, ah, al);
  zero(acc);
#pragma unroll
  for (int nt = 0; nt < HID / 8; ++nt) {
    uint32_t bh[2], bl[2];
    w.fragment(0, nt, lane, bh, bl);
    mma3(acc[nt], ah, al, bh, bl);
  }
}

// Stage one layer's [in][out] weights (in rows, packed row-major in global
// memory) split into a hi and a lo Mat<OUT>.
template <int OUT>
__device__ __forceinline__ void stage_split_mats(uint32_t* hi, uint32_t* lo, const float* src,
                                                 int in) {
  for (int i = threadIdx.x; i < in * OUT; i += blockDim.x) {
    const int r = i / OUT, c = i - r * OUT;
    split(src[i], hi[Mat<OUT>::at(r, c)], lo[Mat<OUT>::at(r, c)]);
  }
}

// Stage one layer's weights [in][out] (packed row-major in global memory,
// `in_real` rows; rows up to `in_pad` are zero) split, in fragment order.
template <int OUT>
__device__ __forceinline__ void stage_split_weights(uint4* dst, const float* src, int in_real,
                                                    int in_pad) {
  const int n = (in_pad / 8) * (OUT / 8) * 32;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int lane = i & 31, f = i >> 5, kt = f / (OUT / 8), nt = f - kt * (OUT / 8);
    const int r = 8 * kt + 2 * (lane & 3), c = 8 * nt + (lane >> 2);
    uint32_t h0, l0, h1, l1;
    split(r < in_real ? src[r * OUT + c] : 0.f, h0, l0);
    split(r + 1 < in_real ? src[(r + 1) * OUT + c] : 0.f, h1, l1);
    dst[i] = make_uint4(h0, h1, l0, l1);
  }
}

// Stage one layer's weights [in][out] (packed row-major in global memory,
// `in_real` rows; rows up to `in_pad` are zero) into a Mat<OUT>, rounded to
// bf16 when ROUND.
template <int OUT, bool ROUND = false>
__device__ __forceinline__ void stage_weights(float* dst, const float* src, int in_real,
                                              int in_pad) {
  for (int i = threadIdx.x; i < in_pad * OUT; i += blockDim.x) {
    const int r = i / OUT, c = i - r * OUT;
    const float v = r < in_real ? src[i] : 0.f;
    dst[Mat<OUT>::at(r, c)] = ROUND ? round_bf16(v) : v;
  }
}

// ---- bf16 products, staged weights and layers ---------------------------------------
// A layer's weights [in][out] rounded to bf16 once, when staged, in fragment
// order (K5): lane l of fragment (ks, nt) finds {W[16ks+2t][8nt+g],
// W[16ks+2t+1][..]} in .x and {W[16ks+2t+8][..], W[16ks+2t+9][..]} in .y.
template <int OUT>
struct Bf16Fragments {
  const uint2* w;
  __device__ __forceinline__ uint2 fragment16(int ks, int nt, int lane) const {
    return w[(ks * (OUT / 8) + nt) * 32 + lane];
  }
};

// A layer's weights [in][out] rounded to bf16 and held as f32 in a Mat<OUT>
// (K5b): packed into bf16 fragments for the recompute, read as TF32 values of
// W^T (exact) for the chain d W^T. `fragment16` of the first layer reads
// rows < 8 only (its rows 6-15 are zero).
template <int OUT, int ROWS>
struct RoundedWeights {
  const float* w;
  __device__ __forceinline__ float at(int r, int c) const {
    return r < ROWS ? w[Mat<OUT>::at(r, c)] : 0.f;
  }
  __device__ __forceinline__ uint2 fragment16(int ks, int nt, int lane) const {
    const int g = lane >> 2, t = lane & 3;
    const int r = 16 * ks + 2 * t, c = 8 * nt + g;
    return make_uint2(pack_bf16(at(r, c), at(r + 1, c)), pack_bf16(at(r + 8, c), at(r + 9, c)));
  }
  __device__ __forceinline__ void fragment_t(int kt, int nt, int lane, uint32_t (&b)[2]) const {
    const int g = lane >> 2, t = lane & 3;
    const float2 v =
        *reinterpret_cast<const float2*>(w + Mat<OUT>::at(8 * nt + g, 8 * kt + 2 * t));
    b[0] = __float_as_uint(v.x);
    b[1] = __float_as_uint(v.y);
  }
};

// acc[16 x OUT] = bf16(act[16 x IN]) * W for one warp's 16 rows, `act` in
// accumulator layout over IN (a multiple of 16).
template <int IN, int OUT, class Weights>
__device__ __forceinline__ void dense_bf16(const float (&act)[IN / 8][4], const Weights& w,
                                           float (&acc)[OUT / 8][4], int lane) {
  static_assert(IN % 16 == 0, "a bf16 product is 16 deep");
  zero(acc);
#pragma unroll
  for (int ks = 0; ks < IN / 16; ++ks) {
    const uint32_t a[4] = {pack_bf16(act[2 * ks][0], act[2 * ks][1]),
                           pack_bf16(act[2 * ks][2], act[2 * ks][3]),
                           pack_bf16(act[2 * ks + 1][0], act[2 * ks + 1][1]),
                           pack_bf16(act[2 * ks + 1][2], act[2 * ks + 1][3])};
#pragma unroll
    for (int nt = 0; nt < OUT / 8; ++nt) {
      const uint2 b = w.fragment16(ks, nt, lane);
      mma_bf16(acc[nt], a, b.x, b.y);
    }
  }
}

// The first layer in bf16: the warp's rows of x0 [point | cell | 0 0], the
// positions rounded to bf16, padded with zeros to 16 deep, times W0.
template <int HID, class Weights>
__device__ __forceinline__ void dense_first_bf16(const float* x0, int row0, const Weights& w,
                                                 float (&acc)[HID / 8][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float2 top = *reinterpret_cast<const float2*>(x0 + X0::at(row0 + g, 2 * t));
  const float2 bot = *reinterpret_cast<const float2*>(x0 + X0::at(row0 + g + 8, 2 * t));
  const uint32_t a[4] = {pack_bf16(top.x, top.y), pack_bf16(bot.x, bot.y), 0u, 0u};
  zero(acc);
#pragma unroll
  for (int nt = 0; nt < HID / 8; ++nt) mma_bf16(acc[nt], a, w.fragment16(0, nt, lane).x, 0u);
}

// Stage one layer's weights [in][out] (packed row-major in global memory,
// `in_real` rows; rows up to `in_pad`, a multiple of 16, are zero) rounded to
// bf16, in fragment order.
template <int OUT>
__device__ __forceinline__ void stage_bf16_fragments(uint2* dst, const float* src, int in_real,
                                                     int in_pad) {
  const int n = (in_pad / 16) * (OUT / 8) * 32;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int lane = i & 31, f = i >> 5, ks = f / (OUT / 8), nt = f - ks * (OUT / 8);
    const int r = 16 * ks + 2 * (lane & 3), c = 8 * nt + (lane >> 2);
    auto at = [&](int rr) { return rr < in_real ? src[rr * OUT + c] : 0.f; };
    dst[i] = make_uint2(pack_bf16(at(r), at(r + 1)), pack_bf16(at(r + 8), at(r + 9)));
  }
}

// ---- GELU (exact erf) -------------------------------------------------------------
__device__ __forceinline__ float gelu_phi(float z) {
  return 0.5f * (1.f + erff(z * 0.70710678118654752f));
}

__device__ __forceinline__ float gelu(float z) { return z * gelu_phi(z); }

// gelu(z) and its derivative from one erf evaluation
__device__ __forceinline__ void gelu_and_grad(float z, float& h, float& gp) {
  const float phi = gelu_phi(z);
  h = z * phi;
  gp = phi + z * expf(-0.5f * z * z) * 0.3989422804014327f;
}

// ---- asynchronous copies --------------------------------------------------------------
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// ---- node-major tiles --------------------------------------------------------------------
struct Tiling {
  long long nodes;  // B * n
  int n, k, m;      // nodes a batch, slots a node, grid cells
  int npt;          // nodes an item: floor(R / k), or 1 when k > R
  int chunks;       // tiles an item: 1, or ceil(k / R) when k > R
  long long items;

  static Tiling make(int b, int n, int k, int m) {
    Tiling T;
    T.nodes = (long long)b * n;
    T.n = n;
    T.k = k;
    T.m = m;
    T.npt = k <= R ? R / k : 1;
    T.chunks = k <= R ? 1 : (k + R - 1) / R;
    T.items = (T.nodes + T.npt - 1) / T.npt;
    return T;
  }
};

// Tile number j of CTA `cta` (of `ctas`): items cta, cta + ctas, ..., each
// with its chunks in order.
struct Tile {
  long long item;
  int chunk;
  long long node0;  // first node of the item
  int n_nodes;      // nodes of the item
  long long row0;   // first row of the tile
  int rows;         // rows of the tile (<= R)
  bool last_chunk;

  __device__ __forceinline__ static bool make(const Tiling& T, int cta, int ctas, long long j,
                                              Tile& out) {
    const long long item = cta + (j / T.chunks) * ctas;
    if (item >= T.items) return false;
    out.item = item;
    out.chunk = (int)(j % T.chunks);
    out.node0 = item * T.npt;
    const long long left = T.nodes - out.node0;
    out.n_nodes = left < T.npt ? (int)left : T.npt;
    const long long item_rows = (long long)out.n_nodes * T.k;
    out.row0 = out.node0 * T.k + (long long)out.chunk * R;
    const long long rest = item_rows - (long long)out.chunk * R;
    out.rows = rest < R ? (int)rest : R;
    out.last_chunk = out.chunk == T.chunks - 1;
    return true;
  }
};

// One row's inputs, loaded into registers a tile ahead of their use.
struct RowIn {
  long long node;
  int cell;
  bool present;  // the row is one of the tile's (not padding)
  bool valid;    // present, unmasked and on the grid
  float px, py, pz;

  __device__ __forceinline__ void load(const Tiling& T, const Tile& tile, int i,
                                       const float* __restrict__ pos,
                                       const int32_t* __restrict__ lat_idx,
                                       const uint8_t* __restrict__ mask) {
    present = i < tile.rows;
    valid = false;
    node = 0;
    cell = 0;
    px = py = pz = 0.f;
    if (present) {
      const long long r = tile.row0 + i;
      node = r / T.k;
      valid = mask[r] != 0;
      cell = lat_idx[r];
      px = pos[node * 3 + 0];
      py = pos[node * 3 + 1];
      pz = pos[node * 3 + 2];
    }
  }

  // after the loads have landed: a masked row may hold any cell index, a
  // valid row whose cell is off the grid is dropped
  __device__ __forceinline__ void settle(const Tiling& T) {
    valid = valid && cell >= 0 && cell < T.m;
  }

  __device__ __forceinline__ long long acc_row(const Tiling& T) const {
    return (node / T.n) * T.m + cell;
  }

  // [point | cell centre | 0 0] into x0 row i: the centre lo + i * h rounded
  // like the reference (no FMA contraction); zeros for rows that are not valid
  __device__ __forceinline__ void write_x0(const GridSpec& g, float* x0, int i) const {
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (valid) {
      const int plane = g.d1 * g.d2;
      const int i0 = cell / plane;
      const int rem = cell - i0 * plane;
      const int i1 = rem / g.d2;
      const int i2 = rem - i1 * g.d2;
      v[0] = px;
      v[1] = py;
      v[2] = pz;
      v[3] = __fadd_rn(g.lo0, __fmul_rn((float)i0, g.sp0));
      v[4] = __fadd_rn(g.lo1, __fmul_rn((float)i1, g.sp1));
      v[5] = __fadd_rn(g.lo2, __fmul_rn((float)i2, g.sp2));
    }
    float4* d = reinterpret_cast<float4*>(x0 + X0::at(i, 0));
    d[0] = make_float4(v[0], v[1], v[2], v[3]);
    d[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

// The node's features into row i of F (a Mat<C>), columns [c0, c1) in
// 16-byte pieces; zeros for padding rows.
template <int C>
__device__ __forceinline__ void copy_feats(float* F, int i, const RowIn& in,
                                           const float* __restrict__ feats, int c0, int c1) {
  const float* src = feats + (in.present ? in.node * C : 0);
  for (int c = c0; c < c1; c += 4) cp_async16(F + Mat<C>::at(i, c), src + c, in.present);
}

// ---- launch facts, queried once ------------------------------------------------------
// Per device: the shared-memory attribute (set once to the largest size a
// block may have), the SM count, and the CTAs an SM holds at each MLP depth
// up to 7 (deeper ones are queried at every launch).
struct LaunchCache {
  static constexpr int DEVICES = 64, DEPTHS = 8;
  std::atomic<int> attr_set[DEVICES];
  std::atomic<int> sms[DEVICES];
  std::atomic<int> per_sm[DEVICES][DEPTHS];

  template <class Kernel>
  int get(Kernel kern, size_t smem, int n_mid, int& per_sm_out, int& sms_out) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= DEVICES) return (int)cudaErrorInvalidDevice;
    if (!attr_set[dev].load()) {
      int limit = 0;
      e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
      if (e == cudaSuccess) e = cudaDeviceGetAttribute(&limit, cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return (int)e;
      sms[dev].store(limit);
      attr_set[dev].store(1);
    }
    sms_out = sms[dev].load();
    int p = n_mid < DEPTHS ? per_sm[dev][n_mid].load() : 0;
    if (p == 0) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p, kern, THREADS, smem);
      if (e != cudaSuccess) return (int)e;
      if (n_mid < DEPTHS) per_sm[dev][n_mid].store(p);
    }
    per_sm_out = p;
    return 0;
  }
};

}  // namespace enc
