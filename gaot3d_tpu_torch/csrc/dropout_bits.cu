// Exporter of the attention-dropout bits for Hopper (sm_90a).
//
// Replaces gaot3d_tpu/ops/pallas_attention.py `export_dropout_bits`: it writes
// the uint32 word that the flash forward and backward draw for every
// (batch*head, q row, key column), as a row-major [bh, sq, skv] tensor (the
// JAX layout [bh, nq, nk, bq, bk] with one block). The stream is the
// counter-based one of philox.cuh, so one seed gives these bits whatever the
// attention kernels' tiles are; feeding them back through the kernels'
// explicit-bits input must reproduce the seeded run bit for bit.
//
// One thread writes the four words of one 2x2 block (one Philox call). What
// bounds it on an H100 is the 4 bytes written per element: 2.1e9 bytes for
// one head-batch of 8 at 16,384 tokens squared.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    dropout_bits_kernel(uint32_t* __restrict__ out, int sq, int skv, uint32_t seed_lo,
                        uint32_t seed_hi, uint32_t bh0) {
  const int bh = blockIdx.z;
  const int cb = blockIdx.x * blockDim.x + threadIdx.x;  // column pair
  const int rb = blockIdx.y;                             // row pair
  const int col = 2 * cb, row = 2 * rb;
  if (col >= skv) return;
  uint32_t w[4];
  gaot::philox4x32_10((uint32_t)cb, (uint32_t)rb, bh0 + (uint32_t)bh, 0u, seed_lo, seed_hi,
                      w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row + (i >> 1), c = col + (i & 1);
    if (r < sq && c < skv) out[((size_t)bh * sq + r) * skv + c] = w[i];
  }
}

}  // namespace

extern "C" {

// out [bh, sq, skv] uint32, contiguous: the words of batch*heads bh0 ..
// bh0 + bh - 1. Returns the launch's cudaError_t.
int gaot_dropout_bits(void* out, int bh, int sq, int skv, unsigned int seed_lo,
                      unsigned int seed_hi, unsigned int bh0, void* stream) {
  if (bh <= 0 || bh > 65535 || sq <= 0 || skv <= 0 || (sq + 1) / 2 > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(((skv + 1) / 2 + THREADS - 1) / THREADS, (sq + 1) / 2, bh);
  dropout_bits_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), sq, skv, seed_lo, seed_hi, bh0);
  return (int)cudaGetLastError();
}

}  // extern "C"
