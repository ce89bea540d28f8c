// K2, K4, K3: the masked BCE-with-logits sum, its dual-output form, and its
// backward.
//
// K2 replaces musicvae_tpu/ops/fused_elbo.py `_bce_fwd_kernel` (launched
// from `_bce_fwd`): sum over all cells of mask[p] · (max(l,0) − l·x +
// log1p(exp(−|l|))), an f32 scalar, for logits [M,P] (f32 or bf16), targets
// x [M,P] (f32, bf16 or uint8, read as they are: no f32 copy) and a [P] f32
// mask.
//
// K4 replaces `_bce_dual_fwd_kernel` (launched from `_bce_dual_fwd`): the
// same sum and, from the same pass over the logits, the gradient tile
// (σ(l) − x)·mask as f32 [M,P]. The training backward is then one scale of
// the saved tile. The tile stays f32 whatever the logits' type: the cast to
// the logits' type comes after the multiply by the upstream gradient.
//
// K3 replaces `_bce_bwd_kernel` (launched from `_bce_bwd`): dl = (σ(l) −
// x)·mask·g, reading the logits again, g a device scalar (no host read of
// the upstream gradient), written in the logits' own type after f32
// arithmetic. The TPU kernel's row-validity mask is a tiling artefact: the
// grid here covers exactly n cells.
//
// What bounds them on Hopper: bytes. Every logit and target is read once
// and the work per cell (one exp, one log1p, one division, a few FLOPs) is
// far below the card's arithmetic rate. At batch 64x4 bars K2 reads 12.6 MB
// of f32 logits plus 3.1 MB of uint8 targets; K4 and K3 also write 12.6 MB.
//
// Design: the TPU kernel's grid runs in order and carries the sum in one
// scratch accumulator; here blocks run in parallel and in no order, so the
// sum is taken in two passes with no atomics. Pass 1 is a grid-stride loop,
// 4 cells per thread per step with one vector load per operand, each
// thread summing in f32 and each block reducing to one partial in
// `partials[blockIdx.x]`. Pass 2 is one block that sums the partials in a
// fixed order. The grid size depends only on the number of cells, so the
// loss is the same bits on every run, and K4, which is pass 1 with one more
// store, returns K2's bits. σ(l) reuses the pass's exp(−|l|): 1/(1+e) for
// l ≥ 0, e/(1+e) below. Precise expf/log1pf and IEEE division, no fast
// math; the fused multiply-adds are written out so that every
// instantiation rounds alike.

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

template <int VEC, typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float* v) {
  if constexpr (VEC == 1) {
    p[0] = from_f32<T>(v[0]);
  } else {
    static_assert(VEC == 4, "vector width");
    constexpr int BYTES = VEC * static_cast<int>(sizeof(T));
    alignas(16) T tmp[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) tmp[k] = from_f32<T>(v[k]);
    if constexpr (BYTES == 16)
      *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(tmp);
    else
      *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(tmp);
  }
}

// e = exp(−|l|), shared by the BCE and the sigmoid of one cell
__device__ __forceinline__ float bce_cell(float l, float t, float e) {
  return __fmaf_rn(-l, t, fmaxf(l, 0.f)) + log1pf(e);
}

__device__ __forceinline__ float sigmoid_from(float l, float e) {
  const float inv = __fdiv_rn(1.f, 1.f + e);
  return l >= 0.f ? inv : e * inv;
}

// Pass 1 of K2 (DUAL = false) and of K4 (DUAL = true: also stores the
// gradient tile).
template <typename TL, typename TX, int VEC, bool DUAL>
__global__ void __launch_bounds__(THREADS)
bce_partials(const TL* __restrict__ logits, const TX* __restrict__ x,
             const float* __restrict__ mask, float* __restrict__ partials,
             float* __restrict__ tile, long long n, int p) {
  float acc = 0.f;
  const long long groups = n / VEC;  // VEC divides p, hence n
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long g = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       g < groups; g += stride) {
    float l[VEC], t[VEC], d[VEC];
    load_vec<VEC>(logits + g * VEC, l);
    load_vec<VEC>(x + g * VEC, t);
    const int col = static_cast<int>((g * VEC) % p);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float mk = __ldg(mask + col + k);
      const float e = expf(-fabsf(l[k]));
      acc = __fmaf_rn(bce_cell(l[k], t[k], e), mk, acc);
      if constexpr (DUAL) d[k] = (sigmoid_from(l[k], e) - t[k]) * mk;
    }
    if constexpr (DUAL) store_vec<VEC>(tile + g * VEC, d);
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

// K3: dl = (σ(l) − x)·mask·g in the logits' type.
template <typename TL, typename TX, int VEC>
__global__ void __launch_bounds__(THREADS)
bce_bwd(const TL* __restrict__ logits, const TX* __restrict__ x,
        const float* __restrict__ mask, const float* __restrict__ g_ptr,
        TL* __restrict__ dl, long long n, int p) {
  const float gs = __ldg(g_ptr);
  const long long groups = n / VEC;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long g = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       g < groups; g += stride) {
    float l[VEC], t[VEC], d[VEC];
    load_vec<VEC>(logits + g * VEC, l);
    load_vec<VEC>(x + g * VEC, t);
    const int col = static_cast<int>((g * VEC) % p);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float e = expf(-fabsf(l[k]));
      d[k] = (sigmoid_from(l[k], e) - t[k]) * __ldg(mask + col + k) * gs;
    }
    store_vec<VEC>(dl + g * VEC, d);
  }
}

bool aligned(const void* ptr, size_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

template <typename TL, typename TX>
bool can_vectorize(const TL* l, const TX* t, int p) {
  return p % 4 == 0 && aligned(l, 4 * sizeof(TL)) && aligned(t, 4 * sizeof(TX));
}

template <typename TL, typename TX, bool DUAL>
cudaError_t launch_sum(const void* logits, const void* x, const float* mask,
                       float* partials, float* out, float* tile, long long n,
                       int p, int blocks, cudaStream_t stream) {
  const TL* l = static_cast<const TL*>(logits);
  const TX* t = static_cast<const TX*>(x);
  if (can_vectorize(l, t, p) && (!DUAL || aligned(tile, 16)))
    bce_partials<TL, TX, 4, DUAL><<<blocks, THREADS, 0, stream>>>(l, t, mask, partials, tile, n, p);
  else
    bce_partials<TL, TX, 1, DUAL><<<blocks, THREADS, 0, stream>>>(l, t, mask, partials, tile, n, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bce_finish<<<1, THREADS, 0, stream>>>(partials, blocks, out);
  return cudaGetLastError();
}

template <typename TL, typename TX>
cudaError_t launch_bwd(const void* logits, const void* x, const float* mask,
                       const float* g, void* dl, long long n, int p, int blocks,
                       cudaStream_t stream) {
  const TL* l = static_cast<const TL*>(logits);
  const TX* t = static_cast<const TX*>(x);
  TL* d = static_cast<TL*>(dl);
  if (can_vectorize(l, t, p) && aligned(d, 4 * sizeof(TL)))
    bce_bwd<TL, TX, 4><<<blocks, THREADS, 0, stream>>>(l, t, mask, g, d, n, p);
  else
    bce_bwd<TL, TX, 1><<<blocks, THREADS, 0, stream>>>(l, t, mask, g, d, n, p);
  return cudaGetLastError();
}

// Calls fn.template operator()<TL, TX>() for the two element kinds.
template <typename F>
cudaError_t dispatch_kinds(int l_kind, int x_kind, F fn) {
  if (l_kind == kBF16) {
    switch (x_kind) {
      case kU8: return fn.template operator()<__nv_bfloat16, uint8_t>();
      case kBF16: return fn.template operator()<__nv_bfloat16, __nv_bfloat16>();
      case kF32: return fn.template operator()<__nv_bfloat16, float>();
    }
  } else if (l_kind == kF32) {
    switch (x_kind) {
      case kU8: return fn.template operator()<float, uint8_t>();
      case kBF16: return fn.template operator()<float, __nv_bfloat16>();
      case kF32: return fn.template operator()<float, float>();
    }
  }
  return cudaErrorInvalidValue;
}

struct SumArgs {
  const void* logits; const void* x; const float* mask;
  float* partials; float* out; float* tile;
  long long n; int p; int blocks; cudaStream_t stream;
  template <typename TL, typename TX> cudaError_t operator()() const {
    if (tile != nullptr)
      return launch_sum<TL, TX, true>(logits, x, mask, partials, out, tile, n, p, blocks, stream);
    return launch_sum<TL, TX, false>(logits, x, mask, partials, out, nullptr, n, p, blocks, stream);
  }
};

struct BwdArgs {
  const void* logits; const void* x; const float* mask; const float* g;
  void* dl; long long n; int p; int blocks; cudaStream_t stream;
  template <typename TL, typename TX> cudaError_t operator()() const {
    return launch_bwd<TL, TX>(logits, x, mask, g, dl, n, p, blocks, stream);
  }
};

}  // namespace
}  // namespace mvk

// K2. logits [n/p, p] of l_kind (bf16 or f32), x of x_kind, mask [p] f32;
// partials [blocks] f32 scratch; out: one f32. Returns the cudaError_t of
// the two launches.
extern "C" int mvk_masked_bce_sum(const void* logits, int l_kind, const void* x,
                                  int x_kind, const float* mask, float* partials,
                                  float* out, long long n, int p, int blocks,
                                  cudaStream_t stream) {
  using namespace mvk;
  if (blocks <= 0 || p <= 0) return cudaErrorInvalidValue;
  return dispatch_kinds(l_kind, x_kind, SumArgs{logits, x, mask, partials, out,
                                                nullptr, n, p, blocks, stream});
}

// K4. As K2, and tile [n] f32 receives (σ(l) − x)·mask.
extern "C" int mvk_masked_bce_sum_dual(const void* logits, int l_kind,
                                       const void* x, int x_kind,
                                       const float* mask, float* partials,
                                       float* out, float* tile, long long n,
                                       int p, int blocks, cudaStream_t stream) {
  using namespace mvk;
  if (blocks <= 0 || p <= 0 || tile == nullptr) return cudaErrorInvalidValue;
  return dispatch_kinds(l_kind, x_kind, SumArgs{logits, x, mask, partials, out,
                                                tile, n, p, blocks, stream});
}

// K3. dl [n] of l_kind receives (σ(l) − x)·mask·g[0]; g: one f32 on the
// device.
extern "C" int mvk_masked_bce_bwd(const void* logits, int l_kind, const void* x,
                                  int x_kind, const float* mask, const float* g,
                                  void* dl, long long n, int p, int blocks,
                                  cudaStream_t stream) {
  using namespace mvk;
  if (blocks <= 0 || p <= 0) return cudaErrorInvalidValue;
  return dispatch_kinds(l_kind, x_kind,
                        BwdArgs{logits, x, mask, g, dl, n, p, blocks, stream});
}
