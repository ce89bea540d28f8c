// K2: the grad-free masked BCE-with-logits sum.
//
// Replaces musicvae_tpu/ops/fused_elbo.py `_bce_fwd_kernel` (launched from
// `_bce_fwd`): sum over all cells of mask[p] · (max(l,0) − l·x +
// log1p(exp(−|l|))), an f32 scalar, for logits [M,P] (f32 or bf16), targets
// x [M,P] (f32, bf16 or uint8, read as they are: no f32 copy) and a [P] f32
// mask.
//
// What bounds it on Hopper: bytes. Every logit and target is read once and
// the work per cell (one exp, one log1p, a few FLOPs) is far below the
// card's arithmetic rate. At eval batch 64x4 bars it reads 12.6 MB of f32
// logits plus 3.1 MB of uint8 targets.
//
// Design: the TPU kernel's grid runs in order and carries the sum in one
// scratch accumulator; here blocks run in parallel and in no order, so the
// sum is taken in two passes with no atomics. Pass 1 is a grid-stride loop,
// 4 cells per thread per step with one vector load per operand, each
// thread summing in f32 and each block reducing to one partial in
// `partials[blockIdx.x]`. Pass 2 is one block that sums the partials in a
// fixed order. The grid size depends only on the number of cells, so the
// loss is the same bits on every run. Precise expf/log1pf, no fast math.

#include "common.cuh"

namespace mvk {
namespace {

constexpr int THREADS = 256;

template <int VEC, typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = to_f32(p[0]);
  } else {
    static_assert(VEC == 4, "vector width");
    constexpr int BYTES = VEC * static_cast<int>(sizeof(T));
    alignas(16) T tmp[VEC];
    if constexpr (BYTES == 16)
      *reinterpret_cast<uint4*>(tmp) = __ldg(reinterpret_cast<const uint4*>(p));
    else if constexpr (BYTES == 8)
      *reinterpret_cast<uint2*>(tmp) = __ldg(reinterpret_cast<const uint2*>(p));
    else
      *reinterpret_cast<unsigned int*>(tmp) =
          __ldg(reinterpret_cast<const unsigned int*>(p));
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[k] = to_f32(tmp[k]);
  }
}

template <typename TL, typename TX, int VEC>
__global__ void __launch_bounds__(THREADS)
bce_partials(const TL* __restrict__ logits, const TX* __restrict__ x,
             const float* __restrict__ mask, float* __restrict__ partials,
             long long n, int p) {
  float acc = 0.f;
  const long long groups = n / VEC;  // VEC divides p, hence n
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long g = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       g < groups; g += stride) {
    float l[VEC], t[VEC];
    load_vec<VEC>(logits + g * VEC, l);
    load_vec<VEC>(x + g * VEC, t);
    const int col = static_cast<int>((g * VEC) % p);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float bce = fmaxf(l[k], 0.f) - l[k] * t[k] + log1pf(expf(-fabsf(l[k])));
      acc += bce * __ldg(mask + col + k);
    }
  }
  acc = block_sum<THREADS>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(THREADS)
bce_finish(const float* __restrict__ partials, int parts, float* __restrict__ out) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < parts; i += THREADS) acc += partials[i];
  acc = block_sum<THREADS>(acc);
  if (threadIdx.x == 0) out[0] = acc;
}

bool aligned(const void* ptr, size_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

template <typename TL, typename TX>
cudaError_t launch(const void* logits, const void* x, const float* mask,
                   float* partials, float* out, long long n, int p, int blocks,
                   cudaStream_t stream) {
  const TL* l = static_cast<const TL*>(logits);
  const TX* t = static_cast<const TX*>(x);
  const bool vec = p % 4 == 0 && aligned(l, 4 * sizeof(TL)) && aligned(t, 4 * sizeof(TX));
  if (vec)
    bce_partials<TL, TX, 4><<<blocks, THREADS, 0, stream>>>(l, t, mask, partials, n, p);
  else
    bce_partials<TL, TX, 1><<<blocks, THREADS, 0, stream>>>(l, t, mask, partials, n, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bce_finish<<<1, THREADS, 0, stream>>>(partials, blocks, out);
  return cudaGetLastError();
}

template <typename TL>
cudaError_t launch_x(const void* logits, const void* x, int x_kind,
                     const float* mask, float* partials, float* out,
                     long long n, int p, int blocks, cudaStream_t stream) {
  switch (x_kind) {
    case kU8: return launch<TL, uint8_t>(logits, x, mask, partials, out, n, p, blocks, stream);
    case kBF16: return launch<TL, __nv_bfloat16>(logits, x, mask, partials, out, n, p, blocks, stream);
    case kF32: return launch<TL, float>(logits, x, mask, partials, out, n, p, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace mvk

// logits [n/p, p] of l_kind (bf16 or f32), x of x_kind, mask [p] f32;
// partials [blocks] f32 scratch; out: one f32. Returns the cudaError_t of
// the two launches.
extern "C" int mvk_masked_bce_sum(const void* logits, int l_kind, const void* x,
                                  int x_kind, const float* mask, float* partials,
                                  float* out, long long n, int p, int blocks,
                                  cudaStream_t stream) {
  using namespace mvk;
  if (blocks <= 0 || p <= 0) return cudaErrorInvalidValue;
  switch (l_kind) {
    case kBF16: return launch_x<__nv_bfloat16>(logits, x, x_kind, mask, partials, out, n, p, blocks, stream);
    case kF32: return launch_x<float>(logits, x, x_kind, mask, partials, out, n, p, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}
