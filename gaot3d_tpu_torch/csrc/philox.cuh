// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3",
// SC'11), written out, and the attention-dropout stream built on it.
//
// The stream is a pure function of (seed, batch*head, q row, key column): the
// 2x2 block of the probability matrix that holds (row, col) takes the counter
//     (col >> 1, row >> 1, bh0 + batch*head, 0)
// under the key (seed low word, seed high word), and the element reads word
//     (row & 1) * 2 + (col & 1)
// of the four that one Philox call yields. No tile shape enters, so the
// forward, the backward and the exporter regenerate identical bits whatever
// their blocking. kernels/dropout_bits.py holds the same arithmetic in plain
// torch integers.
//
// Keep rule (gaot3d_tpu/ops/pallas_attention.py `_bits_to_keep`): an element
// is kept iff bits >= uint32(rate * (2^32 - 1)); the wrapper passes the
// threshold, and 1/(1-rate) (0 when rate >= 1, which drops everything).
//
// bh0 is the global batch*head index of the launch's first (batch, head):
// a rank that holds rows b0.. of a larger batch passes b0 * heads, so a row
// draws the bits it would draw in one launch over the whole batch. Explicit
// bits are indexed by the launch's own bh and ignore it.
#pragma once
#include <stdint.h>

namespace gaot {

struct DropoutParams {
  const uint32_t* bits;  // explicit [bh, sq, skv] bits, or nullptr: draw from the seed
  uint32_t seed_lo, seed_hi;
  uint32_t thresh;
  float inv_keep;
  uint32_t bh0;  // global batch*head of the launch's bh 0 (the seeded stream only)
};

__host__ __device__ __forceinline__ void philox4x32_10(uint32_t c0, uint32_t c1,
                                                       uint32_t c2, uint32_t c3,
                                                       uint32_t k0, uint32_t k1,
                                                       uint32_t out[4]) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint64_t p0 = (uint64_t)M0 * c0;
    const uint64_t p1 = (uint64_t)M1 * c2;
    const uint32_t n0 = (uint32_t)(p1 >> 32) ^ c1 ^ k0;
    const uint32_t n2 = (uint32_t)(p0 >> 32) ^ c3 ^ k1;
    c1 = (uint32_t)p1;
    c3 = (uint32_t)p0;
    c0 = n0;
    c2 = n2;
    k0 += W0;
    k1 += W1;
  }
  out[0] = c0;
  out[1] = c1;
  out[2] = c2;
  out[3] = c3;
}

// The four words of the 2x2 block whose top-left element is (row & ~1,
// col & ~1): w[0] = (even row, even col), w[1] = (even row, odd col),
// w[2] = (odd row, even col), w[3] = (odd row, odd col).
__device__ __forceinline__ void dropout_block_bits(const DropoutParams& p, int bh,
                                                   int row, int col, int sq, int skv,
                                                   uint32_t w[4]) {
  if (p.bits == nullptr) {
    philox4x32_10((uint32_t)col >> 1, (uint32_t)row >> 1, p.bh0 + (uint32_t)bh, 0u,
                  p.seed_lo, p.seed_hi, w);
    return;
  }
  const int r0 = row & ~1, c0 = col & ~1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + (i >> 1), c = c0 + (i & 1);
    // elements past the edge are never used: their probability is 0
    w[i] = (r < sq && c < skv) ? p.bits[((size_t)bh * sq + r) * skv + c] : 0u;
  }
}

// The keep bits of a block: bit i is word i's (w[i] >= thresh), in the order
// of dropout_block_bits.
__device__ __forceinline__ uint32_t dropout_block_keep(const DropoutParams& p, int bh, int row,
                                                       int col, int sq, int skv) {
  uint32_t w[4];
  dropout_block_bits(p, bh, row, col, sq, skv, w);
  return (uint32_t)(w[0] >= p.thresh) | (uint32_t)(w[1] >= p.thresh) << 1 |
         (uint32_t)(w[2] >= p.thresh) << 2 | (uint32_t)(w[3] >= p.thresh) << 3;
}

}  // namespace gaot
