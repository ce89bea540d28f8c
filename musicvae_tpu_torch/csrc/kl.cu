// K5, K6: the Gaussian KL sum against N(0, I), and its backward.
//
// K5 replaces musicvae_tpu/ops/fused_elbo.py `_kl_fwd_kernel` (launched
// from `_kl_fwd`): −0.5·Σ(1 + lv − mu² − exp(lv)) over all elements, an f32
// scalar. K6 replaces `_kl_bwd_kernel` (launched from `_kl_bwd`): dmu =
// mu·g and dlv = 0.5·(exp(lv) − 1)·g, g a device scalar. mu and lv are f32
// or bf16, the arithmetic is f32, the gradients come back in the inputs'
// type.
//
// What bounds them on Hopper: nothing but the launch. The latents of one
// batch are 64 x 128 = 8192 elements, 64 KB read: ~0.02 µs of memory time
// against a few µs of launch latency. The TPU kernel is one VMEM tile with
// no grid for the same reason.
//
// Design: K5 is one block. Each thread sums a strided share of the
// elements, then the block reduces in a fixed order, so the sum's bits are
// the same on every run. K6 is one elementwise pass. Precise expf.

#include "common.cuh"

namespace mvk {
namespace {

constexpr int SUM_THREADS = 1024;
constexpr int BWD_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(SUM_THREADS)
kl_sum_kernel(const T* __restrict__ mu, const T* __restrict__ lv,
              float* __restrict__ out, long long n) {
  float acc = 0.f;
  for (long long i = threadIdx.x; i < n; i += SUM_THREADS) {
    const float m = to_f32(mu[i]), v = to_f32(lv[i]);
    acc += 1.f + v - m * m - expf(v);
  }
  acc = block_sum<SUM_THREADS>(acc);
  if (threadIdx.x == 0) out[0] = -0.5f * acc;
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
kl_bwd_kernel(const T* __restrict__ mu, const T* __restrict__ lv,
              const float* __restrict__ g_ptr, T* __restrict__ dmu,
              T* __restrict__ dlv, long long n) {
  const float g = __ldg(g_ptr);
  const long long stride = static_cast<long long>(gridDim.x) * BWD_THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * BWD_THREADS + threadIdx.x;
       i < n; i += stride) {
    dmu[i] = from_f32<T>(to_f32(mu[i]) * g);
    dlv[i] = from_f32<T>(0.5f * (expf(to_f32(lv[i])) - 1.f) * g);
  }
}

}  // namespace
}  // namespace mvk

// K5. mu, lv: n elements of `kind` (bf16 or f32); out: one f32.
extern "C" int mvk_kl_sum(const void* mu, const void* lv, int kind, float* out,
                          long long n, cudaStream_t stream) {
  using namespace mvk;
  if (n < 0) return cudaErrorInvalidValue;
  if (kind == kF32)
    kl_sum_kernel<float><<<1, SUM_THREADS, 0, stream>>>(
        static_cast<const float*>(mu), static_cast<const float*>(lv), out, n);
  else if (kind == kBF16)
    kl_sum_kernel<__nv_bfloat16><<<1, SUM_THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(mu),
        static_cast<const __nv_bfloat16*>(lv), out, n);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// K6. dmu, dlv: n elements of `kind`; g: one f32 on the device.
extern "C" int mvk_kl_bwd(const void* mu, const void* lv, int kind,
                          const float* g, void* dmu, void* dlv, long long n,
                          int blocks, cudaStream_t stream) {
  using namespace mvk;
  if (n <= 0) return cudaSuccess;
  if (blocks <= 0) return cudaErrorInvalidValue;
  if (kind == kF32)
    kl_bwd_kernel<float><<<blocks, BWD_THREADS, 0, stream>>>(
        static_cast<const float*>(mu), static_cast<const float*>(lv), g,
        static_cast<float*>(dmu), static_cast<float*>(dlv), n);
  else if (kind == kBF16)
    kl_bwd_kernel<__nv_bfloat16><<<blocks, BWD_THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(mu),
        static_cast<const __nv_bfloat16*>(lv), g,
        static_cast<__nv_bfloat16*>(dmu), static_cast<__nv_bfloat16*>(dlv), n);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
