// Inclusive prefix sum over the rows of an [E, C] float32 matrix, for Hopper
// (sm_90a), in one launch.
//
// Replaces gaot3d_tpu/ops/pallas_kernels.py `_prefix_sum_kernel` /
// `prefix_sum`, the cumsum inside the sorted segment folds. The TPU grid runs
// in order on one core, so that kernel carries the running total in scratch
// memory from one block of rows to the next. Here CTAs run side by side, so
// the running total is built by a fixed association that depends on E, C and
// R (the tile's rows, which the caller passes) only:
//
//   - a tile is R consecutive rows; each column of a tile is summed in row
//     order: run[0] = x[0], run[i] = run[i-1] + x[i];
//   - tile totals are scanned in groups of RADIX = 32 by the Hillis-Steele
//     tree of a warp (lane l adds lane l - d for d = 1, 2, 4, 8, 16); a
//     group's total (its lane 31) is an item of the next level, whose groups
//     are scanned the same way, until one group is left (K levels);
//   - an item's offset is its parent's offset plus the inclusive scan of the
//     items before it in its group (0 for the first): O = 0 + ex_K, then
//     O + ex_{K-1}, ..., O + ex_1 for the tile, and out = O + run.
//
// kernels/prefix_sum.py `prefix_sum_ordered_reference` repeats these
// additions in float32 with plain torch ops, and the kernel gives its bits.
//
// A CTA owns a block of RADIX tiles (a level-1 group): it reads the block
// from device memory with one bulk copy into shared memory, runs the
// columns' sums there, publishes the block's total and, when it closes a
// group of a higher level, that group's total, each value in one 8-byte
// word with the launch's epoch (so the scratch needs no clearing between
// launches, and a reader needs no flag). It then reads, as soon as they are
// published, the totals of the items before it in each of its groups, scans
// them, runs each tile's sums once more from its offset, and writes its rows
// once with one bulk copy.
//
// The grid is persistent and launched cooperatively, so every CTA it waits
// on is resident. The blocks do not all fit on the chip at once
// ([163,840, 43] is 28 MB): a CTA holds one at a time, and the blocks past
// the first round are read twice, once early only to publish their totals
// and once more at the end (mostly from L2). So no block's total waits for
// an SM to free. Apart from those early reads, which wait on nothing, a CTA
// takes its blocks in increasing order and only ever waits on lower blocks,
// so the lowest unfinished block always proceeds. Waits are bounded and
// trap. Matrices wider than MAX_COLS go in column slabs, read and written by
// threads instead of bulk copies; so do unaligned pointers and a last block
// whose bytes are no multiple of 16.
//
// What bounds it on an H100 is bytes: [E, C] read once and written once.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int RADIX = 32;       // items of a group at every level: a warp's lanes
constexpr int MAX_LEVELS = 8;   // 32^8 tiles: more than any int32 row count
constexpr int MAX_COLS = 256;   // columns of a slab
constexpr unsigned FULL = 0xffffffffu;
constexpr int LOADS = 8;        // published totals a thread reads at once

struct Plan {
  long long E;
  int C, R, cs, slabs, nb, levels, threads;
  long long count[MAX_LEVELS + 1];    // groups at level k (k >= 1); count[1] = nb
  long long tot_off[MAX_LEVELS + 1];  // T_k, the totals of level-k groups: [count[k], C] words
  long long words;                    // 8-byte words of scratch
};

bool make_plan(long long E, int C, int R, Plan* p) {
  if (E <= 0 || C <= 0 || R <= 0 || R % 4 != 0) return false;
  p->E = E;
  p->C = C;
  p->R = R;
  p->cs = C < MAX_COLS ? C : MAX_COLS;
  p->slabs = (C + p->cs - 1) / p->cs;
  p->threads = 32 * (p->cs < 8 ? p->cs : 8);
  long long n = (E + R - 1) / R;  // tiles
  int K = 0;
  do {
    n = (n + RADIX - 1) / RADIX;
    if (++K > MAX_LEVELS) return false;
    p->count[K] = n;
  } while (n > 1);
  p->levels = K;
  p->nb = (int)p->count[1];
  p->words = 0;
  for (int k = 1; k < K; ++k) {  // the top level's total is never read
    p->tot_off[k] = p->words;
    p->words += p->count[k] * C;
  }
  return true;
}

size_t smem_bytes(const Plan& p) {
  // mbarrier, the block's rows, tile totals and a level's items [cs][RADIX + 1]
  // each, own [cs], ex [levels + 1][cs]
  return 128 + 4 * ((size_t)RADIX * p.R * p.cs + 2 * (size_t)p.cs * (RADIX + 1) + p.cs +
                    (size_t)(p.levels + 1) * p.cs);
}

// A published total is one 8-byte word, the epoch of the launch that wrote
// it above the float's bits: a reader sees both or neither, so no flag and
// no fence stand between them.
__device__ __forceinline__ void publish(unsigned long long* at, float v, unsigned epoch) {
  const unsigned long long word = (unsigned long long)epoch << 32 | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(at), "l"(word) : "memory");
}

__device__ __forceinline__ unsigned long long load_word(const unsigned long long* at) {
  unsigned long long word;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(word) : "l"(at) : "memory");
  return word;
}

// The total at `at` once this launch has published it, read again after
// pauses that double up to MAX_PAUSE_NS: thousands of readers polling at
// once would take the L2 bandwidth the loads and stores need. A wait that
// outlasts about 20 s of clock traps, as gaot::mbar_wait does.
constexpr unsigned MAX_PAUSE_NS = 1024;

__device__ __forceinline__ float await_published(const unsigned long long* at, unsigned epoch) {
  unsigned long long word = load_word(at);
  if ((unsigned)(word >> 32) != epoch) {
    const long long start = clock64();
    unsigned pause = 64;
    do {
      __nanosleep(pause);
      pause = min(2 * pause, MAX_PAUSE_NS);
      word = load_word(at);
      if (clock64() - start > 40000000000LL) __trap();
    } while ((unsigned)(word >> 32) != epoch);
  }
  return __uint_as_float((unsigned)word);
}

// inclusive scan over the warp's lanes, the fixed Hillis-Steele tree
__device__ __forceinline__ float scan32(float v, int lane) {
#pragma unroll
  for (int d = 1; d < RADIX; d <<= 1) {
    const float up = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v = __fadd_rn(v, up);
  }
  return v;
}

__global__ void __launch_bounds__(256)
    prefix_sum_kernel(const float* __restrict__ x, float* __restrict__ out,
                      unsigned long long* __restrict__ totals, const Plan p, unsigned epoch,
                      int aligned) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int cs = p.cs;
  float* tile = reinterpret_cast<float*>(smem + 128);  // rows of the block, cw floats apart
  float* tot = tile + (size_t)RADIX * p.R * cs;        // tot[c * (RADIX + 1) + j]
  float* items = tot + cs * (RADIX + 1);               // a level's items, as tot
  float* own = items + cs * (RADIX + 1);               // this block's item at the level
  float* ex = own + cs;                                // ex[m * cs + c], level m's offset
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const uint32_t bar = gaot::smem_u32(smem);
  if (tid == 0) {
    gaot::mbar_init(bar, 1);
    gaot::fence_barrier_init();
  }
  __syncthreads();
  uint32_t parity = 0;
  // Work items are (block, slab) pairs. Round 0 gives item i to CTA i; round
  // r > 0 gives it item (r + 1) * G - 1 - i, so the CTAs whose round-0 items
  // are highest read the most early: a low item is one that every item above
  // it waits for. A CTA first reads its later items for their totals only
  // (steps 1-3), then takes its items in increasing order.
  const long long work = (long long)p.nb * p.slabs;
  const long long G = gridDim.x, rounds = (work + G - 1) / G;
  for (long long step = 0; step < 2 * rounds - 1; ++step) {
    const bool early = step < rounds - 1;  // a later item, read for its total only
    const long long r = early ? step + 1 : step - (rounds - 1);
    const long long w = r == 0 ? (long long)blockIdx.x : (r + 1) * G - 1 - blockIdx.x;
    if (w >= work) continue;
    const int b = (int)(w / p.slabs), s = (int)(w % p.slabs);
    const int c0 = s * cs, cw = min(cs, p.C - c0);
    const long long row0 = (long long)b * RADIX * p.R;
    const int rows = (int)min((long long)RADIX * p.R, p.E - row0);
    const uint32_t bytes = (uint32_t)rows * (uint32_t)p.C * 4u;
    const bool bulk = aligned && cw == p.C && bytes % 16 == 0;
    // the last block's bulk store has read the tile, and every thread is done with it
    if (tid == 0) gaot::bulk_wait_read();
    gaot::fence_proxy_async();
    __syncthreads();

    // 1. the block's rows into shared memory, read from device memory once
    if (bulk) {
      if (tid == 0) {
        gaot::mbar_expect_tx(bar, bytes);
        gaot::bulk_load(gaot::smem_u32(tile), x + row0 * p.C, bar, bytes);
      }
      gaot::mbar_wait(bar, parity);
      parity ^= 1;
    } else {
      for (int e = tid; e < rows * cw; e += nthreads) {
        const int r = e / cw, c = e - r * cw;
        tile[e] = __ldg(x + (row0 + r) * p.C + c0 + c);
      }
      __syncthreads();
    }

    // 2. each column of each tile summed in row order: the tiles' totals
    const int tiles = (rows + p.R - 1) / p.R;
    for (int q = tid; q < RADIX * cw; q += nthreads) {
      const int j = q / cw, c = q - j * cw;
      float run = 0.f;
      if (j < tiles) {
        const float* col = tile + (size_t)j * p.R * cw + c;
        const int n = min(p.R, rows - j * p.R);
        run = col[0];
        for (int i = 1; i < n; ++i) run = __fadd_rn(run, col[(size_t)i * cw]);
      }
      tot[c * (RADIX + 1) + j] = run;
    }
    __syncthreads();

    // 3. level 1: the block's tiles; its total is its item at level 2
    for (int c = warp; c < cw; c += nwarps) {
      const float v = scan32(tot[c * (RADIX + 1) + lane], lane);
      const float before = __shfl_up_sync(FULL, v, 1);
      tot[c * (RADIX + 1) + lane] = lane == 0 ? 0.f : before;
      if (lane == RADIX - 1) own[c] = v;
    }
    __syncthreads();
    if (early) {  // the block's total, for the blocks above it
      for (int c = tid; c < cw; c += nthreads)
        publish(totals + p.tot_off[1] + (long long)b * p.C + c0 + c, own[c], epoch);
      continue;
    }

    // levels 2..K: at level m the block's item is i = b >> 5(m-2), the total
    // T_{m-1}[i] of its level-(m-1) group, which the group's last block publishes
    for (int m = 2; m <= p.levels; ++m) {
      const int shift = 5 * (m - 2);
      const long long i = (long long)b >> shift;
      const bool closes = (((long long)b + 1) & ((1LL << shift) - 1)) == 0;
      unsigned long long* V = totals + p.tot_off[m - 1] + c0;
      if (closes) {
        for (int c = tid; c < cw; c += nthreads) publish(V + i * p.C + c, own[c], epoch);
        __syncthreads();
      }
      const int li = (int)(i & (RADIX - 1));
      const long long g0 = i - li;
      // the items before this one in its group, every column at once: a
      // thread's loads are all issued before it looks at any
      for (int e0 = tid; e0 < li * cw; e0 += nthreads * LOADS) {
        unsigned long long word[LOADS];
#pragma unroll
        for (int u = 0; u < LOADS; ++u) {
          const int e = e0 + u * nthreads, l = e / cw;
          if (e < li * cw) word[u] = load_word(V + (g0 + l) * p.C + e - l * cw);
        }
#pragma unroll
        for (int u = 0; u < LOADS; ++u) {
          const int e = e0 + u * nthreads, l = e / cw, c = e - l * cw;
          if (e >= li * cw) break;
          items[c * (RADIX + 1) + l] = (unsigned)(word[u] >> 32) == epoch
                                           ? __uint_as_float((unsigned)word[u])
                                           : await_published(V + (g0 + l) * p.C + c, epoch);
        }
      }
      __syncthreads();
      for (int c = warp; c < cw; c += nwarps) {
        float v = 0.f;
        if (lane < li) v = items[c * (RADIX + 1) + lane];
        else if (lane == li && closes) v = own[c];
        v = scan32(v, lane);
        const float before = __shfl_sync(FULL, v, (li + RADIX - 1) & (RADIX - 1));
        if (lane == 0) ex[m * cs + c] = li == 0 ? 0.f : before;
        if (lane == RADIX - 1) own[c] = v;  // the group's total when this block closes it
      }
      __syncthreads();
    }

    // 4. the block's offset, top level first, then each tile's; out = offset + run
    for (int c = tid; c < cw; c += nthreads) {
      float o = 0.f;
      for (int m = p.levels; m >= 2; --m) o = __fadd_rn(o, ex[m * cs + c]);
      own[c] = o;
    }
    __syncthreads();
    for (int q = tid; q < RADIX * cw; q += nthreads) {  // the runs of step 2 once more
      const int j = q / cw, c = q - j * cw;
      if (j >= tiles) continue;
      const float o = __fadd_rn(own[c], tot[c * (RADIX + 1) + j]);
      float* col = tile + (size_t)j * p.R * cw + c;
      const int n = min(p.R, rows - j * p.R);
      float run = col[0];
      col[0] = __fadd_rn(o, run);
      for (int i = 1; i < n; ++i) {
        run = __fadd_rn(run, col[(size_t)i * cw]);
        col[(size_t)i * cw] = __fadd_rn(o, run);
      }
    }
    gaot::fence_proxy_async();
    __syncthreads();

    // 5. the block's rows written once
    if (bulk) {
      if (tid == 0) {
        gaot::bulk_store(out + row0 * p.C, gaot::smem_u32(tile), bytes);
        gaot::bulk_commit();
      }
    } else {
      for (int e = tid; e < rows * cw; e += nthreads) {
        const int r = e / cw, c = e - r * cw;
        out[(row0 + r) * p.C + c0 + c] = tile[e];
      }
    }
  }
  if (tid == 0) gaot::bulk_wait();
}

// CTAs of the kernel an SM holds at once, with as much of the SM's 256 KB
// given to shared memory as it takes
cudaError_t resident_ctas(const Plan& p, size_t smem, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      prefix_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(prefix_sum_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, prefix_sum_kernel, p.threads,
                                                        smem);
  return err;
}

}  // namespace

extern "C" {

// CTAs an SM holds at [E, C] with tiles of R rows (-1 on error): the
// persistent grid is this times the SMs, or the blocks when fewer.
int gaot_prefix_sum_ctas_per_sm(long long E, int C, int R) {
  Plan p;
  int per_sm = 0;
  if (!make_plan(E, C, R, &p) || resident_ctas(p, smem_bytes(p), &per_sm) != cudaSuccess)
    return -1;
  return per_sm;
}

// Bytes of scratch a launch at [E, C] with tiles of R rows needs (-1 when
// the kernel does not take these arguments). Its words must hold no epoch
// of a later launch: zero it once when it is allocated.
long long gaot_prefix_sum_scratch_bytes(long long E, int C, int R) {
  Plan p;
  if (!make_plan(E, C, R, &p)) return -1;
  return 8 * p.words;
}

// x, out [E, C] float32, contiguous; tiles of R rows (a multiple of 4) in
// groups of `radix` (32, the only value the kernel takes); scratch of
// gaot_prefix_sum_scratch_bytes; epoch differs from every earlier launch's
// on this scratch and is not 0. Returns the launch's cudaError_t.
int gaot_prefix_sum(const void* x, void* out, void* scratch, long long E, int C, int R,
                    int radix, unsigned epoch, void* stream) {
  Plan p;
  if (radix != RADIX || epoch == 0 || !make_plan(E, C, R, &p)) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, max_smem = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(p);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  err = resident_ctas(p, smem, &per_sm);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long items = (long long)p.nb * p.slabs;
  const int grid = (int)(items < (long long)per_sm * sms ? items : (long long)per_sm * sms);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  unsigned long long* totals = static_cast<unsigned long long*>(scratch);
  int aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  void* args[] = {&xf, &of, &totals, &p, &epoch, &aligned};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(prefix_sum_kernel), dim3(grid),
                                    dim3(p.threads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  return (int)err;
}

}  // extern "C"
