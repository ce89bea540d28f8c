// Shared by the first conv's forward (conv1.cu) and backward
// (conv1_bwd.cu): the geometry, the staging of input rows in shared memory
// and the tanh-GELU with its derivative.
#pragma once

#include "common.cuh"

namespace mvk {
namespace conv1 {

constexpr int T_IN = 96, P_IN = 128, T_OUT = 48, P_OUT = 64;
constexpr int ROWS = 8;                 // output rows per staged tile
constexpr int IN_ROWS = 2 * ROWS + 1;   // input rows those need
constexpr int TILES = T_OUT / ROWS;     // row tiles per bar
static_assert(T_OUT % ROWS == 0, "row tiling");

constexpr float GELU_K0 = 0.7978845608028654f;  // sqrt(2/pi)
constexpr float GELU_K1 = 0.044715f;

__device__ __forceinline__ float gelu_tanh(float z) {
  return 0.5f * z * (1.0f + tanhf(GELU_K0 * (z + GELU_K1 * (z * z * z))));
}

// d/dz of gelu_tanh
__device__ __forceinline__ float gelu_tanh_grad(float z) {
  const float t = tanhf(GELU_K0 * (z + GELU_K1 * (z * z * z)));
  return 0.5f * (1.0f + t) +
         0.5f * z * (1.0f - t * t) * GELU_K0 * (1.0f + 3.0f * GELU_K1 * z * z);
}

// Input rows 2*i0-1 .. 2*i0+2*ROWS-1 of one bar, as f32, split into even
// and odd pitch planes so neighbouring threads read neighbouring words:
// s_even[r][j] = pitch 2j; s_odd[r][j] = pitch 2j-1 (s_odd[r][0] is the
// zero pad at pitch -1), for staged row r = input row 2*i0 - 1 + r. The
// caller synchronises afterwards.
template <typename TIn, bool ROUND_BF16, int THREADS>
__device__ __forceinline__ void stage_rows(const TIn* __restrict__ xm, int i0,
                                           float (*s_even)[P_OUT],
                                           float (*s_odd)[P_OUT + 1]) {
  const int r0 = 2 * i0 - 1;
  for (int k = threadIdx.x; k < IN_ROWS * P_IN; k += THREADS) {
    const int r = k / P_IN, p = k % P_IN, row = r0 + r;
    // rows past the bottom never occur (2*47+1 = 95); row -1 is the pad
    float v = row >= 0 ? to_f32(xm[row * P_IN + p]) : 0.f;
    if (ROUND_BF16) v = round_bf16(v);
    if (p & 1) s_odd[r][(p >> 1) + 1] = v;
    else s_even[r][p >> 1] = v;
  }
  if (threadIdx.x < IN_ROWS) s_odd[threadIdx.x][0] = 0.f;
}

}  // namespace conv1
}  // namespace mvk
