// K5, K6: the Gaussian KL sum against N(0, I), and its backward.
//
// K5 replaces musicvae_tpu/ops/fused_elbo.py `_kl_fwd_kernel` (launched
// from `_kl_fwd`): −0.5·Σ(1 + lv − mu² − exp(lv)) over all elements, an f32
// scalar. K6 replaces `_kl_bwd_kernel` (launched from `_kl_bwd`): dmu =
// mu·g and dlv = 0.5·(exp(lv) − 1)·g, g a device scalar. mu and lv are f32
// or bf16, the arithmetic is f32, the gradients come back in the inputs'
// type.
//
// What bounds them on Hopper: the launch and latency. The latents of one
// batch are 64 x 128 = 8192 elements, 64 KB read: ~0.02 µs of memory time
// against a launch (~5 µs by CUDA events on an H100) and one memory round
// trip. The TPU kernel is one VMEM tile with no grid for the same reason.
//
// K5 is one block of SUM_THREADS threads. A trip takes a chunk of
// SUM_CHUNK = SUM_THREADS·SUM_GROUP elements, thread t its 8 elements
// 8t..8t+7: every load of the trip is issued before any arithmetic (two
// 16-byte loads of mu and two of lv in f32, one of each in bf16), so the
// [64,128] latents take one trip, one memory round trip. Larger n loops
// over chunks in order. Each thread adds its elements in index order, then
// the block reduces by `block_sum`'s fixed tree, so the sum's bits depend
// on n and the data alone: unaligned pointers and the ragged end take
// scalar loads of the same elements in the same order. The term
// (1 + lv − mu²) − e^lv is written out (no contraction), e^lv by one
// ex2.approx of lv·log2 e instead of precise expf. Measured on an H100
// (PERF.md §6): on one SM the math of 8,192 elements is part of the time.
// One round trip instead of two gained 0.06 µs, the fast exp 0.3 µs; 256
// threads of 32 elements (the same math on fewer warps) took twice as
// long, and 8 blocks with a cross-block finish were slower too. The fast
// exp's error, under 1e-6 relative an element for lv ∈ [−8, 8] (the model
// clamps logvar to 8·tanh(lv/8)), keeps the sum within 1e-5.
//
// K6 is one elementwise pass in K5's shape: thread t of the grid takes
// the 8 elements from 8t, issuing all its loads (two 16-byte loads of each
// of mu and lv in f32, one of each in bf16) before the math, and writes dmu
// and dlv by 16-byte stores; unaligned pointers and the ragged end take
// scalar loads and stores of the same elements. The grid comes from n
// alone: a block of BWD_THREADS threads a chunk of BWD_CHUNK elements (the
// [64,128] latents spread over 8 SMs, as no reduction ties them to one),
// at most BWD_MAX_BLOCKS blocks, striding over the chunks beyond. Measured
// on an H100 (PERF.md §6), 8 blocks of 128 threads beat 4 of 256 and one
// of 1,024 at [64,128]; the kernel alone sits near its launch cost.
// e^lv is precise expf, the bits torch's exp gives: dlv reaches ~27·g with
// randn logvar, where an approximate exp's error would exceed the card's
// check (1e-6·max(1, g) absolute against the plain version). The products
// are written out as the plain version rounds them: mu·g, and
// (0.5·(e^lv − 1))·g.

#include "common.cuh"

namespace mvk {
namespace {

constexpr int SUM_THREADS = 1024;
constexpr int SUM_GROUP = 8;                          // elements a thread takes a trip: load8
constexpr int SUM_CHUNK = SUM_THREADS * SUM_GROUP;    // elements a trip
constexpr int BWD_THREADS = 128;
constexpr int BWD_GROUP = 8;                          // elements a thread: load8
constexpr int BWD_CHUNK = BWD_THREADS * BWD_GROUP;    // elements a block a trip
constexpr int BWD_MAX_BLOCKS = 1024;

// A thread's 8 elements by 16-byte loads, all issued before their use.
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

constexpr float LOG2E = 1.4426950408889634f;

// One element's term, (1 + lv − mu²) − e^lv, written out (no contraction),
// e^lv as 2^(lv·log2 e) by the MUFU's ex2.
__device__ __forceinline__ float kl_term(float m, float v) {
  return __fsub_rn(__fmaf_rn(-m, m, __fadd_rn(1.f, v)), ex2_approx(__fmul_rn(v, LOG2E)));
}

// A thread's SUM_GROUP elements from i added to acc in index order. FULL:
// all lie below n and both pointers are 16-byte aligned, so every load is
// a 16-byte vector issued before the math; otherwise scalar loads of the
// elements below n, added in the same order.
template <bool FULL, typename T>
__device__ __forceinline__ float kl_group(const T* __restrict__ mu, const T* __restrict__ lv,
                                          long long i, long long n, float acc) {
  float m[SUM_GROUP], v[SUM_GROUP];
  if constexpr (FULL) {
    load8(mu + i, m);
    load8(lv + i, v);
  } else {
#pragma unroll
    for (int j = 0; j < SUM_GROUP; ++j) {
      m[j] = i + j < n ? to_f32(mu[i + j]) : 0.f;
      v[j] = i + j < n ? to_f32(lv[i + j]) : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < SUM_GROUP; ++j)
    if (FULL || i + j < n) acc = __fadd_rn(acc, kl_term(m[j], v[j]));
  return acc;
}

// K5: one block; trip c takes elements c·SUM_CHUNK + 8t .. + 7 in thread t.
template <typename T>
__global__ void __launch_bounds__(SUM_THREADS)
kl_sum_kernel(const T* __restrict__ mu, const T* __restrict__ lv,
              float* __restrict__ out, long long n, bool vec) {
  float acc = 0.f;
  for (long long c = 0; c * SUM_CHUNK < n; ++c) {
    const long long i = c * SUM_CHUNK + threadIdx.x * SUM_GROUP;
    acc = vec && i + SUM_GROUP <= n ? kl_group<true>(mu, lv, i, n, acc)
                                    : kl_group<false>(mu, lv, i, n, acc);
  }
  acc = block_sum<SUM_THREADS>(acc);
  if (threadIdx.x == 0) out[0] = __fmul_rn(-0.5f, acc);
}

// 8 results by 16-byte stores.
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// One thread's BWD_GROUP elements from i. FULL: all lie below n and all
// four pointers are 16-byte aligned, so loads and stores are vectors;
// otherwise scalar loads and stores of the elements below n.
template <bool FULL, typename T>
__device__ __forceinline__ void kl_bwd_group(const T* __restrict__ mu, const T* __restrict__ lv,
                                             float g, T* __restrict__ dmu, T* __restrict__ dlv,
                                             long long i, long long n) {
  float m[BWD_GROUP], v[BWD_GROUP];
  if constexpr (FULL) {
    load8(mu + i, m);
    load8(lv + i, v);
  } else {
#pragma unroll
    for (int j = 0; j < BWD_GROUP; ++j) {
      m[j] = i + j < n ? to_f32(mu[i + j]) : 0.f;
      v[j] = i + j < n ? to_f32(lv[i + j]) : 0.f;
    }
  }
  float a[BWD_GROUP], b[BWD_GROUP];
#pragma unroll
  for (int j = 0; j < BWD_GROUP; ++j) {
    a[j] = __fmul_rn(m[j], g);
    b[j] = __fmul_rn(__fmul_rn(0.5f, __fsub_rn(expf(v[j]), 1.f)), g);
  }
  if constexpr (FULL) {
    store8(dmu + i, a);
    store8(dlv + i, b);
  } else {
#pragma unroll
    for (int j = 0; j < BWD_GROUP; ++j)
      if (i + j < n) {
        dmu[i + j] = from_f32<T>(a[j]);
        dlv[i + j] = from_f32<T>(b[j]);
      }
  }
}

// K6: block b takes chunks b, b + gridDim.x, ...; thread t of a chunk
// from c its 8 elements c·BWD_CHUNK + 8t .. + 7.
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
kl_bwd_kernel(const T* __restrict__ mu, const T* __restrict__ lv,
              const float* __restrict__ g_ptr, T* __restrict__ dmu,
              T* __restrict__ dlv, long long n, bool vec) {
  const float g = __ldg(g_ptr);
  const long long stride = static_cast<long long>(gridDim.x) * BWD_CHUNK;
  for (long long i = static_cast<long long>(blockIdx.x) * BWD_CHUNK + threadIdx.x * BWD_GROUP;
       i < n; i += stride) {
    if (vec && i + BWD_GROUP <= n)
      kl_bwd_group<true>(mu, lv, g, dmu, dlv, i, n);
    else
      kl_bwd_group<false>(mu, lv, g, dmu, dlv, i, n);
  }
}

}  // namespace
}  // namespace mvk

// K5. mu, lv: n elements of `kind` (bf16 or f32); out: one f32.
extern "C" int mvk_kl_sum(const void* mu, const void* lv, int kind, float* out,
                          long long n, cudaStream_t stream) {
  using namespace mvk;
  if (n < 0) return cudaErrorInvalidValue;
  const bool vec = reinterpret_cast<uintptr_t>(mu) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(lv) % 16 == 0;
  if (kind == kF32)
    kl_sum_kernel<float><<<1, SUM_THREADS, 0, stream>>>(
        static_cast<const float*>(mu), static_cast<const float*>(lv), out, n, vec);
  else if (kind == kBF16)
    kl_sum_kernel<__nv_bfloat16><<<1, SUM_THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(mu),
        static_cast<const __nv_bfloat16*>(lv), out, n, vec);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// K6. dmu, dlv: n elements of `kind`; g: one f32 on the device. The grid
// comes from n: a block a chunk of BWD_CHUNK elements, at most
// BWD_MAX_BLOCKS.
extern "C" int mvk_kl_bwd(const void* mu, const void* lv, int kind,
                          const float* g, void* dmu, void* dlv, long long n,
                          cudaStream_t stream) {
  using namespace mvk;
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const bool vec = reinterpret_cast<uintptr_t>(mu) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(lv) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dmu) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dlv) % 16 == 0;
  const long long chunks = (n + BWD_CHUNK - 1) / BWD_CHUNK;
  const int blocks = static_cast<int>(chunks < BWD_MAX_BLOCKS ? chunks : BWD_MAX_BLOCKS);
  if (kind == kF32)
    kl_bwd_kernel<float><<<blocks, BWD_THREADS, 0, stream>>>(
        static_cast<const float*>(mu), static_cast<const float*>(lv), g,
        static_cast<float*>(dmu), static_cast<float*>(dlv), n, vec);
  else if (kind == kBF16)
    kl_bwd_kernel<__nv_bfloat16><<<blocks, BWD_THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(mu),
        static_cast<const __nv_bfloat16*>(lv), g,
        static_cast<__nv_bfloat16*>(dmu), static_cast<__nv_bfloat16*>(dlv), n, vec);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
