// Shared helpers for the port's kernels: element types, conversions, and a
// deterministic block reduction.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mvk {

// Element kinds, as the Python wrappers pass them (ops/_kernels.py KINDS).
enum Kind : int { kU8 = 0, kBF16 = 1, kF32 = 2 };

__device__ __forceinline__ float to_f32(uint8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// The MUFU's 2^v and 1/v (a few ulp each; subnormal inputs and results
// flushed to zero).
__device__ __forceinline__ float ex2_approx(float v) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(v));
  return y;
}

__device__ __forceinline__ float rcp_approx(float v) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(v));
  return y;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum of `v` over the block, valid in thread 0. The order is fixed by the
// block size alone, so the result is the same bits on every run.
template <int THREADS>
__device__ __forceinline__ float block_sum(float v) {
  static_assert(THREADS % 32 == 0 && THREADS <= 1024, "block size");
  __shared__ float warp_part[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  v = 0.f;
  if (warp == 0) {
    if (lane < THREADS / 32) v = warp_part[lane];
    v = warp_sum(v);
  }
  return v;
}

}  // namespace mvk
