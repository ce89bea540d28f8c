// K1: the first encoder conv of the parity trunk, forward.
//
// Replaces musicvae_tpu/ops/conv1_pallas.py `_conv1_kernel` (launched from
// `_fwd_impl`): y[m,i,j,c] = gelu(b[c] + sum_{kt,kp} x[m,2i+kt-1,2j+kp-1] *
// w[kt,kp,c]) on a [M,96,128] bar → [M,48,64,C] (NHWC), 3x3 taps, stride 2,
// zero padding at row -1 and pitch -1.
//
// What bounds it on Hopper: bytes. Per bar it reads 12,288 input elements
// (1 byte each as uint8) and writes 49,152·C/16 outputs (2 bytes each in
// bf16): ~8 output bytes per input byte, and 18 FLOPs + one tanh per
// output, far below the ~20 FLOPs/byte where the f32 ALUs would limit.
// The TPU kernel's banded matmul (42x redundant FLOPs to fill a 128x128
// matrix unit) has no use here and is not carried over.
//
// Design: a direct conv. A block owns ROWS output rows of one bar. It
// stages the 2·ROWS+1 input rows those need in shared memory, converting
// uint8/bf16/f32 to f32 as it loads, split into even and odd pitch planes
// so neighbouring threads read neighbouring words (no bank conflicts). Each
// thread computes one output position (i, j) for all C channels in
// registers: 9 taps against weights broadcast from shared memory, then the
// f32 bias and tanh-GELU, then one run of 16-byte stores of its C
// contiguous outputs, so a warp writes a contiguous span. When the output
// is bf16, x and w are rounded to bf16 before the multiply: the contract
// of the TPU kernel (conv1_pallas.py `_fwd_impl`), with f32 accumulation.

#include "conv1.cuh"

namespace mvk {
namespace {

using namespace conv1;
constexpr int THREADS = P_OUT * ROWS;   // one thread per output (i, j)

template <typename TIn, typename TOut, int C, bool ROUND_BF16>
__global__ void __launch_bounds__(THREADS)
conv1_kernel(const TIn* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ b, TOut* __restrict__ out, int gelu) {
  __shared__ float s_even[IN_ROWS][P_OUT];
  __shared__ float s_odd[IN_ROWS][P_OUT + 1];
  __shared__ float s_w[9][C];
  __shared__ float s_b[C];

  const int m = blockIdx.x / TILES;
  const int i0 = (blockIdx.x % TILES) * ROWS;
  stage_rows<TIn, ROUND_BF16, THREADS>(
      x + static_cast<size_t>(m) * T_IN * P_IN, i0, s_even, s_odd);
  for (int k = threadIdx.x; k < 9 * C; k += THREADS) {
    const float v = w[k];
    s_w[k / C][k % C] = ROUND_BF16 ? round_bf16(v) : v;
  }
  if (threadIdx.x < C) s_b[threadIdx.x] = b[threadIdx.x];
  __syncthreads();

  const int j = threadIdx.x % P_OUT;   // output pitch
  const int ti = threadIdx.x / P_OUT;  // output row within the tile
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
#pragma unroll
  for (int kt = 0; kt < 3; ++kt) {
    const int r = 2 * ti + kt;         // staged row of input row 2i+kt-1
    const float xl = s_odd[r][j];      // pitch 2j-1 (kp = 0)
    const float xc = s_even[r][j];     // pitch 2j   (kp = 1)
    const float xr = s_odd[r][j + 1];  // pitch 2j+1 (kp = 2)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      acc[c] = fmaf(xl, s_w[3 * kt + 0][c], acc[c]);
      acc[c] = fmaf(xc, s_w[3 * kt + 1][c], acc[c]);
      acc[c] = fmaf(xr, s_w[3 * kt + 2][c], acc[c]);
    }
  }

  alignas(16) TOut vals[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float z = acc[c] + s_b[c];
    vals[c] = from_f32<TOut>(gelu ? gelu_tanh(z) : z);
  }
  TOut* o = out + ((static_cast<size_t>(m) * T_OUT + i0 + ti) * P_OUT + j) * C;
  constexpr int BYTES = C * static_cast<int>(sizeof(TOut));
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int k = 0; k < BYTES / 16; ++k)
      reinterpret_cast<uint4*>(o)[k] = reinterpret_cast<const uint4*>(vals)[k];
  } else {
#pragma unroll
    for (int k = 0; k < BYTES / 8; ++k)
      reinterpret_cast<uint2*>(o)[k] = reinterpret_cast<const uint2*>(vals)[k];
  }
}

template <typename TIn, typename TOut, bool ROUND_BF16>
cudaError_t launch_c(const void* x, const float* w, const float* b, void* out,
                     int m, int c, int gelu, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(m) * TILES), block(THREADS);
  const TIn* xi = static_cast<const TIn*>(x);
  TOut* o = static_cast<TOut*>(out);
  switch (c) {
    case 4: conv1_kernel<TIn, TOut, 4, ROUND_BF16><<<grid, block, 0, stream>>>(xi, w, b, o, gelu); break;
    case 8: conv1_kernel<TIn, TOut, 8, ROUND_BF16><<<grid, block, 0, stream>>>(xi, w, b, o, gelu); break;
    case 16: conv1_kernel<TIn, TOut, 16, ROUND_BF16><<<grid, block, 0, stream>>>(xi, w, b, o, gelu); break;
    case 32: conv1_kernel<TIn, TOut, 32, ROUND_BF16><<<grid, block, 0, stream>>>(xi, w, b, o, gelu); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename TIn>
cudaError_t launch_in(const void* x, const float* w, const float* b, void* out,
                      int out_kind, int m, int c, int gelu, cudaStream_t stream) {
  if (out_kind == kBF16)
    return launch_c<TIn, __nv_bfloat16, true>(x, w, b, out, m, c, gelu, stream);
  if (out_kind == kF32)
    return launch_c<TIn, float, false>(x, w, b, out, m, c, gelu, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace mvk

// x [m,96,128] of x_kind, w [3,3,c] f32, b [c] f32 → out [m,48,64,c] of
// out_kind. c ∈ {4, 8, 16, 32}. Returns the launch's cudaError_t.
extern "C" int mvk_first_conv_s2(const void* x, int x_kind, const float* w,
                                 const float* b, void* out, int out_kind,
                                 int m, int c, int gelu, cudaStream_t stream) {
  using namespace mvk;
  if (m <= 0) return cudaSuccess;
  switch (x_kind) {
    case kU8: return launch_in<uint8_t>(x, w, b, out, out_kind, m, c, gelu, stream);
    case kBF16: return launch_in<__nv_bfloat16>(x, w, b, out, out_kind, m, c, gelu, stream);
    case kF32: return launch_in<float>(x, w, b, out, out_kind, m, c, gelu, stream);
    default: return cudaErrorInvalidValue;
  }
}
