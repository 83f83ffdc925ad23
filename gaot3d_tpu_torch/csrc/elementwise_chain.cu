// Elementwise-chain probe for Hopper (sm_90a): does bf16, packed two to a
// 32-bit register, run the softmax/dropout kind of elementwise chain at twice
// the f32 rate?
//
// Replaces tools/microbench_vpu_bf16.py `make` (T1), which asked the same of
// the TPU's vector unit for the sake of the attention backward's softmax and
// dropout chain. Same work: a [512, 1024] block, one chain repeated `reps`
// times, unrolled, written back; `grid` copies redo the same block, so a
// launch is 524,288 * reps * grid element-steps. The chains:
//   exp:    acc = exp(acc * 0.9) - acc
//   select: acc = where(acc > 0.9, acc * 1.111, acc + 0.9)
// with the constants in the element type (bf16 rounds 0.9 to 0.8984375 and
// 1.111 to 1.109375, as JAX's weakly typed literals do).
//
// Layout: a thread loads 8 elements (two float4 in f32, one uint4 of four
// bf16x2 in bf16), keeps them in registers through the whole chain and stores
// them; block b of the launch works on copy b / blocks_per_copy, and every
// copy reads the same input and writes the same values to the same output.
//
// The exp step takes its exponential in the form the flash kernels (K1, K2)
// use, exp2 of the argument times log2(e), so the answer transfers to them:
//   f32:  ex2.approx.ftz.f32 of (acc * 0.9f) * log2e, one MUFU.EX2 an
//         element-step;
//   bf16: ex2.approx.ftz.bf16x2 of (acc * 0.9) * log2e with packed multiplies,
//         one packed special-function op for two elements.
// The select step is a compare, a multiply, an add and a select (packed ops
// for two elements in bf16).
//
// What bounds it on an H100 (at the defaults reps 64, grid 64: 2.15e9
// element-steps; the block is 2 MB in f32 and stays in L2, so memory is no
// limit) is instruction issue. chip_smoke.py's [t1] counts it in this
// kernel's own SASS: each pipe's instructions an element-step over its rate
// (MUFU 16 lanes an SM a clock, FP32 128, integer and logic 64), and all of
// them over the issue slots (one warp instruction a clock a sub-partition);
// the largest is the bound. bf16's packed instructions get no rate of their
// own there: whether they issue at the f32 rate is what the probe asks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;  // elements a thread
constexpr float LOG2E = 1.4426950408889634f;
constexpr float C_EXP = 0.9f;      // exp chain's factor, select chain's threshold and addend
constexpr float C_SELECT = 1.111f; // select chain's factor

enum Chain { EXP = 0, SELECT = 1 };

__device__ __forceinline__ float ex2_f32(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ __nv_bfloat162 ex2_bf16x2(__nv_bfloat162 x) {
  uint32_t in = *reinterpret_cast<uint32_t*>(&x), out;
  asm("ex2.approx.ftz.bf16x2 %0, %1;" : "=r"(out) : "r"(in));
  return *reinterpret_cast<__nv_bfloat162*>(&out);
}

template <int CHAIN, int REPS>
__device__ __forceinline__ void run_f32(float (&a)[VEC]) {
#pragma unroll
  for (int r = 0; r < REPS; ++r) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if constexpr (CHAIN == EXP) {
        a[i] = ex2_f32((a[i] * C_EXP) * LOG2E) - a[i];
      } else {
        a[i] = a[i] > C_EXP ? a[i] * C_SELECT : a[i] + C_EXP;
      }
    }
  }
}

template <int CHAIN, int REPS>
__device__ __forceinline__ void run_bf16(__nv_bfloat162 (&a)[VEC / 2]) {
  const __nv_bfloat162 c = __float2bfloat162_rn(C_EXP);
  const __nv_bfloat162 s = __float2bfloat162_rn(C_SELECT);
  const __nv_bfloat162 l2e = __float2bfloat162_rn(LOG2E);
#pragma unroll
  for (int r = 0; r < REPS; ++r) {
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      if constexpr (CHAIN == EXP) {
        a[i] = __hsub2(ex2_bf16x2(__hmul2(__hmul2(a[i], c), l2e)), a[i]);
      } else {
        const uint32_t gt = __hgt2_mask(a[i], c);  // 0xffff in each half where a > c
        const __nv_bfloat162 up = __hmul2(a[i], s), on = __hadd2(a[i], c);
        const uint32_t u = *reinterpret_cast<const uint32_t*>(&up);
        const uint32_t o = *reinterpret_cast<const uint32_t*>(&on);
        const uint32_t sel = (u & gt) | (o & ~gt);
        a[i] = *reinterpret_cast<const __nv_bfloat162*>(&sel);
      }
    }
  }
}

template <int CHAIN, int REPS>
__global__ void __launch_bounds__(THREADS)
    chain_f32_kernel(const float* __restrict__ x, float* __restrict__ out, int n_vec,
                     int blocks_per_copy) {
  const int v = (blockIdx.x % blocks_per_copy) * THREADS + threadIdx.x;
  if (v >= n_vec) return;
  const float4* src = reinterpret_cast<const float4*>(x) + 2 * (size_t)v;
  float4 lo = src[0], hi = src[1];
  float a[VEC] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  run_f32<CHAIN, REPS>(a);
  float4* dst = reinterpret_cast<float4*>(out) + 2 * (size_t)v;
  dst[0] = make_float4(a[0], a[1], a[2], a[3]);
  dst[1] = make_float4(a[4], a[5], a[6], a[7]);
}

template <int CHAIN, int REPS>
__global__ void __launch_bounds__(THREADS)
    chain_bf16_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
                      int n_vec, int blocks_per_copy) {
  const int v = (blockIdx.x % blocks_per_copy) * THREADS + threadIdx.x;
  if (v >= n_vec) return;
  const uint4 raw = reinterpret_cast<const uint4*>(x)[v];
  const uint32_t w[VEC / 2] = {raw.x, raw.y, raw.z, raw.w};
  __nv_bfloat162 a[VEC / 2];
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) a[i] = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
  run_bf16<CHAIN, REPS>(a);
  uint32_t r[VEC / 2];
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) r[i] = *reinterpret_cast<const uint32_t*>(&a[i]);
  reinterpret_cast<uint4*>(out)[v] = make_uint4(r[0], r[1], r[2], r[3]);
}

template <int CHAIN, int REPS>
void launch(const void* x, void* out, int dtype, int n_vec, int copies, cudaStream_t s) {
  const int per_copy = (n_vec + THREADS - 1) / THREADS;
  const dim3 grid(per_copy * copies);
  if (dtype == 0)
    chain_f32_kernel<CHAIN, REPS><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n_vec, per_copy);
  else
    chain_bf16_kernel<CHAIN, REPS><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), n_vec,
        per_copy);
}

template <int CHAIN>
int dispatch_reps(const void* x, void* out, int dtype, int n_vec, int reps, int copies,
                  cudaStream_t s) {
  switch (reps) {
    case 1: launch<CHAIN, 1>(x, out, dtype, n_vec, copies, s); break;
    case 2: launch<CHAIN, 2>(x, out, dtype, n_vec, copies, s); break;
    case 4: launch<CHAIN, 4>(x, out, dtype, n_vec, copies, s); break;
    case 8: launch<CHAIN, 8>(x, out, dtype, n_vec, copies, s); break;
    case 16: launch<CHAIN, 16>(x, out, dtype, n_vec, copies, s); break;
    case 32: launch<CHAIN, 32>(x, out, dtype, n_vec, copies, s); break;
    case 64: launch<CHAIN, 64>(x, out, dtype, n_vec, copies, s); break;
    case 128: launch<CHAIN, 128>(x, out, dtype, n_vec, copies, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x and out [n] contiguous, 16-byte aligned, n a multiple of 8 (dtype 0:
// float32, 1: bfloat16); chain 0: exp, 1: select; reps one of 1, 2, 4, ...,
// 128; copies >= 1 redo the block. Returns the launch's cudaError_t.
int gaot_elementwise_chain(const void* x, void* out, long long n, int dtype, int chain,
                           int reps, int copies, void* stream) {
  if (n <= 0 || n % VEC != 0 || n / VEC > (1LL << 30) || copies <= 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int n_vec = (int)(n / VEC);
  if ((long long)((n_vec + THREADS - 1) / THREADS) * copies > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chain == EXP) return dispatch_reps<EXP>(x, out, dtype, n_vec, reps, copies, s);
  if (chain == SELECT) return dispatch_reps<SELECT>(x, out, dtype, n_vec, reps, copies, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
