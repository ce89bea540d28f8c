// K1b: the first encoder conv of the parity trunk, backward.
//
// Replaces the backward of musicvae_tpu/ops/conv1_pallas.py
// `_first_conv_bwd`, which launches the Pallas body `_conv1_kernel` once
// more (through `_fwd_impl` with gelu off, f32) to recompute the
// pre-activation z and leaves dz = dy·gelu'(z), dw and db to XLA, with z and
// dz written to device memory in between. Here one kernel does all of it:
//   dw[kt,kp,c] = Σ_{m,i,j} x[m,2i+kt-1,2j+kp-1] · dz[m,i,j,c]
//   db[c]       = Σ_{m,i,j} dz[m,i,j,c]
// with dz = dy·gelu'(z) (dz = dy when the forward had no GELU). dx is zero
// by contract and is not computed. The recompute is f32 with un-rounded x
// and w even when the forward ran the bf16 contract, as the TPU backward's
// is; dy arrives in the forward's output type and is upcast.
//
// What bounds it on Hopper: bytes, in principle: it reads x (1 byte a cell
// as uint8) and dy (2 bytes an output in bf16) once, 28 MB at 256 bars, and
// writes 10·C floats. Per output it does 2·9 FMAs and one tanh per channel,
// below the f32 rate's limit; the reduction is what a simple kernel pays
// for.
//
// Design: no z or dz in device memory and no atomics. A block owns one bar
// and CH = min(C, 8) of its channels, and walks the bar's six 8-row tiles,
// staging each tile's 17 input rows in shared memory as the forward does. A
// thread owns one pitch column of two of a tile's rows in turn, 24 output
// positions in a bar: it recomputes z for its CH channels in registers,
// reads its CH dy values with one 16-byte load, and accumulates its 9·CH dw
// terms and CH db terms in registers. The block then reduces each term over
// its threads (warp shuffles, then shared memory, a fixed order) into
// `partials[bar][10·C]`, and a second kernel sums the bars in a fixed order.
// The same bits come out on every run: dw feeds Adam.

#include "conv1.cuh"

namespace mvk {
namespace {

using namespace conv1;
constexpr int THREADS = 2 * P_OUT;      // two output rows of 64 pitches
constexpr int WARPS = THREADS / 32;
constexpr int FINISH_THREADS = 128;

template <typename TDy, int CH>
__device__ __forceinline__ void load_dy(const TDy* __restrict__ p, float* out) {
  constexpr int BYTES = CH * static_cast<int>(sizeof(TDy));
  alignas(16) TDy tmp[CH];
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int k = 0; k < BYTES / 16; ++k)
      reinterpret_cast<uint4*>(tmp)[k] = __ldg(reinterpret_cast<const uint4*>(p) + k);
  } else {
    static_assert(BYTES == 8, "dy chunk");
    *reinterpret_cast<uint2*>(tmp) = __ldg(reinterpret_cast<const uint2*>(p));
  }
#pragma unroll
  for (int c = 0; c < CH; ++c) out[c] = to_f32(tmp[c]);
}

template <typename TIn, typename TDy, int C>
__global__ void __launch_bounds__(THREADS)
conv1_bwd_kernel(const TIn* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, const TDy* __restrict__ dy,
                 float* __restrict__ partials, int gelu) {
  constexpr int CH = C < 8 ? C : 8;      // channels per block
  constexpr int NCHUNK = C / CH;
  constexpr int TERMS = 10 * CH;         // 9 taps of dw, then db
  __shared__ float s_even[IN_ROWS][P_OUT];
  __shared__ float s_odd[IN_ROWS][P_OUT + 1];
  __shared__ float s_w[9][CH];
  __shared__ float s_b[CH];
  __shared__ float s_red[WARPS][TERMS];

  const int m = blockIdx.x / NCHUNK;
  const int c0 = (blockIdx.x % NCHUNK) * CH;
  const TIn* xm = x + static_cast<size_t>(m) * T_IN * P_IN;
  const TDy* dym = dy + static_cast<size_t>(m) * T_OUT * P_OUT * C + c0;
  for (int k = threadIdx.x; k < 9 * CH; k += THREADS)
    s_w[k / CH][k % CH] = w[(k / CH) * C + c0 + k % CH];
  if (threadIdx.x < CH) s_b[threadIdx.x] = b[c0 + threadIdx.x];

  const int j = threadIdx.x % P_OUT;    // output pitch
  const int tr = threadIdx.x / P_OUT;   // 0 or 1: row parity within a tile
  float acc[TERMS];
#pragma unroll
  for (int k = 0; k < TERMS; ++k) acc[k] = 0.f;

  for (int tile = 0; tile < TILES; ++tile) {
    const int i0 = tile * ROWS;
    __syncthreads();                    // the previous tile's reads are done
    stage_rows<TIn, false, THREADS>(xm, i0, s_even, s_odd);
    __syncthreads();
#pragma unroll 1
    for (int ti = tr; ti < ROWS; ti += THREADS / P_OUT) {
      float xs[9];
#pragma unroll
      for (int kt = 0; kt < 3; ++kt) {
        const int r = 2 * ti + kt;      // staged row of input row 2i+kt-1
        xs[3 * kt + 0] = s_odd[r][j];       // pitch 2j-1
        xs[3 * kt + 1] = s_even[r][j];      // pitch 2j
        xs[3 * kt + 2] = s_odd[r][j + 1];   // pitch 2j+1
      }
      float dz[CH];
      load_dy<TDy, CH>(dym + (static_cast<size_t>(i0 + ti) * P_OUT + j) * C, dz);
      if (gelu) {
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          float z = 0.f;                // the forward's order of FMAs
#pragma unroll
          for (int k = 0; k < 9; ++k) z = fmaf(xs[k], s_w[k][c], z);
          dz[c] *= gelu_tanh_grad(z + s_b[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < CH; ++c) {
#pragma unroll
        for (int k = 0; k < 9; ++k)
          acc[k * CH + c] = fmaf(xs[k], dz[c], acc[k * CH + c]);
        acc[9 * CH + c] += dz[c];
      }
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < TERMS; ++k) {
    const float v = warp_sum(acc[k]);
    if (lane == 0) s_red[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < TERMS) {
    float v = 0.f;
#pragma unroll
    for (int wp = 0; wp < WARPS; ++wp) v += s_red[wp][threadIdx.x];
    const int k = threadIdx.x / CH, c = threadIdx.x % CH;
    partials[static_cast<size_t>(m) * 10 * C + k * C + c0 + c] = v;
  }
}

// out[e] = Σ_m partials[m][e], one block per e, bars in a fixed order.
__global__ void __launch_bounds__(FINISH_THREADS)
conv1_bwd_finish(const float* __restrict__ partials, int m, int terms,
                 float* __restrict__ out) {
  const int e = blockIdx.x;
  float acc = 0.f;
  for (int i = threadIdx.x; i < m; i += FINISH_THREADS)
    acc += partials[static_cast<size_t>(i) * terms + e];
  acc = block_sum<FINISH_THREADS>(acc);
  if (threadIdx.x == 0) out[e] = acc;
}

template <typename TIn, typename TDy>
cudaError_t launch_c(const void* x, const float* w, const float* b,
                     const void* dy, float* partials, float* out, int m, int c,
                     int gelu, cudaStream_t stream) {
  const TIn* xi = static_cast<const TIn*>(x);
  const TDy* d = static_cast<const TDy*>(dy);
  const unsigned um = static_cast<unsigned>(m);
  switch (c) {
    case 4: conv1_bwd_kernel<TIn, TDy, 4><<<um, THREADS, 0, stream>>>(xi, w, b, d, partials, gelu); break;
    case 8: conv1_bwd_kernel<TIn, TDy, 8><<<um, THREADS, 0, stream>>>(xi, w, b, d, partials, gelu); break;
    case 16: conv1_bwd_kernel<TIn, TDy, 16><<<um * 2, THREADS, 0, stream>>>(xi, w, b, d, partials, gelu); break;
    case 32: conv1_bwd_kernel<TIn, TDy, 32><<<um * 4, THREADS, 0, stream>>>(xi, w, b, d, partials, gelu); break;
    default: return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  conv1_bwd_finish<<<10 * c, FINISH_THREADS, 0, stream>>>(partials, m, 10 * c, out);
  return cudaGetLastError();
}

template <typename TIn>
cudaError_t launch_in(const void* x, const float* w, const float* b,
                      const void* dy, int dy_kind, float* partials, float* out,
                      int m, int c, int gelu, cudaStream_t stream) {
  if (dy_kind == kBF16)
    return launch_c<TIn, __nv_bfloat16>(x, w, b, dy, partials, out, m, c, gelu, stream);
  if (dy_kind == kF32)
    return launch_c<TIn, float>(x, w, b, dy, partials, out, m, c, gelu, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace mvk

// x [m,96,128] of x_kind, w [3,3,c] f32, b [c] f32, dy [m,48,64,c] of
// dy_kind (bf16 or f32); partials [m,10·c] f32 scratch; out [10·c] f32
// receives dw as [3,3,c] then db as [c]. c ∈ {4, 8, 16, 32}, m ≥ 1. Returns
// the cudaError_t of the two launches.
extern "C" int mvk_first_conv_s2_bwd(const void* x, int x_kind, const float* w,
                                     const float* b, const void* dy, int dy_kind,
                                     float* partials, float* out, int m, int c,
                                     int gelu, cudaStream_t stream) {
  using namespace mvk;
  if (m <= 0) return cudaErrorInvalidValue;
  switch (x_kind) {
    case kU8: return launch_in<uint8_t>(x, w, b, dy, dy_kind, partials, out, m, c, gelu, stream);
    case kBF16: return launch_in<__nv_bfloat16>(x, w, b, dy, dy_kind, partials, out, m, c, gelu, stream);
    case kF32: return launch_in<float>(x, w, b, dy, dy_kind, partials, out, m, c, gelu, stream);
    default: return cudaErrorInvalidValue;
  }
}
