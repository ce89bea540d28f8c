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
// What bounds them on Hopper: bytes. Every logit and target is read once.
// At batch 64x4 bars K2 reads 12.6 MB of f32 logits plus 3.1 MB of uint8
// targets (4.70 µs at 3.35 TB/s); K4 and K3 also write 12.6 MB (8.45 µs).
//
// K2 and K4 are one kernel, `bce_sum` (K4 = DUAL: one more store), in one
// launch:
// - Geometry (`sum_geometry`, mirrored by ops/fused_elbo.py): a chunk is
//   CHUNK = THREADS·4 consecutive cells, thread t takes its cells 4t..4t+3
//   by one vector load per operand (streaming: the data is read once), and
//   block b takes chunks b, b + blocks, .... The grid is ceil(n / CHUNK)
//   blocks, at most MAX_BLOCKS: a function of n alone. MAX_BLOCKS is about
//   one wave of an H100 (8 blocks of 32 registers on each of 132 SMs).
// - The cross-block sum in the same launch, with the same bits on every
//   run: each thread sums its cells in a fixed order, each block reduces to
//   `partials[blockIdx.x]`, then takes a ticket; the block that takes the
//   last ticket sums the partials in index order and resets the ticket to
//   0 for the next launch on the stream. The atomic picks which block sums,
//   never the order of the additions, so the sum depends on n and the data
//   alone: not on p, the pointers' alignment (vector or scalar loads), the
//   card, or DUAL (K4's sum is K2's bits).
// - The mask: where p divides CHUNK (1024; p = 128 on every main-path
//   call), a thread's 4 columns never change, and it reads its 4 mask
//   values once. Any other p reads mask[cell % p] per cell.
// - Per cell one ex2 and one rcp (MUFU) and a few FMAs instead of precise
//   expf, log1pf and an IEEE division: with e = exp(−|l|), u = 1 + e,
//   w = 2 + e and q = 1/(u·w), σ(l) = w·q for l ≥ 0 and e·w·q below, and
//   log1p(e) = 2·atanh(s) with s = e/(2+e) = e·u·q ∈ [0, 1/3], as s·P(s²)
//   with P of degree 4 (L1P_C*). That keeps log1p(e) within a few ulp
//   relative to itself at every e, so a confident cell (BCE ≈ e ≪ 1) keeps
//   its relative accuracy; lg2.approx would not (its error is absolute). e
//   is flushed to 0 below 2^-126 (|l| > 87.3), an error under 1.2e-38 a
//   cell. The fused multiply-adds are written out and nothing is
//   contracted, so every instantiation rounds alike.
// - Chosen by measurement on an H100 (PERF.md §6) over a thread
//   loading 4 groups before their math (4 blocks an SM) and over persistent
//   blocks streaming chunks through shared memory by TMA bulk copies and an
//   mbarrier ring: both read about 2 µs slower for K2 and no faster for K4,
//   and so did fewer or more blocks. A streaming store of K4's tile gained
//   nothing and is not used (the backward reads the tile next).
//
// K3 (`bce_bwd`) is the same pass in a third mode: K2/K4's geometry, loads
// and mask registers, only σ(l) of `bce_cell` (one ex2, one rcp), and
// d = ((σ − x)·mask)·g in f32 in that order, cast to the logits' type and
// stored as one vector a thread (a default store: the decoder head's
// backward reads dl next). There is no sum and so no partials or ticket.
// Its σ(l) and (σ − x)·mask are K4's very operations, so for every type
// pair dl = (K4's tile · g).to(logits' type) bit for bit: the two
// differentiated paths, `masked_bce_sum` and `masked_bce_sum_dual`, give
// the same gradient bits, which chip_smoke.py checks.

#include "common.cuh"

namespace mvk {
namespace {

constexpr int THREADS = 256;

bool aligned(const void* ptr, size_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// -- K2, K4 and K3 -----------------------------------------------------------

constexpr int GROUP = 4;                            // cells a thread takes a chunk
constexpr int CHUNK = THREADS * GROUP;              // cells a block takes at once
constexpr int MAX_BLOCKS = 1024;                    // partials in the workspace

struct SumGeometry {
  long long chunks;
  int blocks;
  bool fixed_col;    // p divides CHUNK: a thread's columns never change
};

__host__ __device__ inline SumGeometry sum_geometry(long long n, int p) {
  const long long chunks = (n + CHUNK - 1) / CHUNK;
  const int blocks = static_cast<int>(chunks < 1 ? 1 : chunks < MAX_BLOCKS ? chunks : MAX_BLOCKS);
  return {chunks, blocks, CHUNK % p == 0};
}

constexpr float NEG_LOG2E = -1.4426950408889634f;
// log1p(e) = s·P(s²), s = e/(2+e): P(z) ≈ 2·atanh(√z)/√z on [0, 1/9], a
// least-squares fit of the relative error (under 6e-9) with P(0) = 2
constexpr float L1P_C0 = 2.0f;
constexpr float L1P_C1 = 0.6666641235351562f;
constexpr float L1P_C2 = 0.4002161920070648f;
constexpr float L1P_C3 = 0.2800081670284271f;
constexpr float L1P_C4 = 0.28015294671058655f;

// What a pass computes: K2 the sum, K4 the sum and the f32 tile
// (σ − x)·mask, K3 dl = ((σ − x)·mask)·g in the logits' type.
enum Mode : int { kSum, kDual, kBwd };

// One cell: the BCE term into `bce` (K2, K4) and σ(l) into `sig` (K4, K3).
// Both halves share e, u, w and q, and σ's arithmetic exists only here.
template <int MODE>
__device__ __forceinline__ void bce_cell(float l, float t, float& bce, float& sig) {
  const float e = ex2_approx(__fmul_rn(fabsf(l), NEG_LOG2E));
  const float u = __fadd_rn(1.f, e), w = __fadd_rn(2.f, e);
  const float q = rcp_approx(__fmul_rn(u, w));
  if constexpr (MODE != kBwd) {
    const float s = __fmul_rn(e, __fmul_rn(u, q));
    const float z = __fmul_rn(s, s);
    float poly = __fmaf_rn(L1P_C4, z, L1P_C3);
    poly = __fmaf_rn(poly, z, L1P_C2);
    poly = __fmaf_rn(poly, z, L1P_C1);
    poly = __fmaf_rn(poly, z, L1P_C0);
    bce = __fadd_rn(__fmaf_rn(-l, t, fmaxf(l, 0.f)), __fmul_rn(s, poly));
  }
  if constexpr (MODE != kSum) {
    const float r = __fmul_rn(w, q);
    sig = l >= 0.f ? r : __fmul_rn(e, r);
  }
}

// A thread's 4 cells by one streaming (evict-first: read once) vector load:
// 16 bytes of f32, 8 of bf16, 4 of uint8 (bytes to f32 by PRMT + FADD, off
// the conversion pipe).
__device__ __forceinline__ void load_group(const float* p, float* v) {
  const float4 r = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}
__device__ __forceinline__ void load_group(const __nv_bfloat16* p, float* v) {
  const uint2 r = __ldcs(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(r.x << 16); v[1] = __uint_as_float(r.x & 0xffff0000u);
  v[2] = __uint_as_float(r.y << 16); v[3] = __uint_as_float(r.y & 0xffff0000u);
}
__device__ __forceinline__ void load_group(const uint8_t* p, float* v) {
  const unsigned r = __ldcs(reinterpret_cast<const unsigned*>(p));
#pragma unroll
  for (int j = 0; j < GROUP; ++j)
    v[j] = __uint_as_float(__byte_perm(r, 0x4B000000u, 0x7440 + j)) - 8388608.f;
}

// A thread's 4 results by one default vector store (the next kernel reads
// them): K4's f32 tile, K3's dl in f32 or bf16 (round to nearest even, as
// from_f32).
__device__ __forceinline__ void store_group(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_group(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                            *reinterpret_cast<const unsigned*>(&hi));
}

// A thread's 4 cells from cell g: the loads, the math, then (K4, K3) the
// stores. FULL: all 4 cells lie inside [0, n) and every pointer is aligned
// for vector access; otherwise scalar accesses, and cells at or past n
// skipped, in the same order, so no result's bits depend on which. `gs` is
// K3's upstream gradient.
template <typename TL, typename TX, int MODE, bool FIXED, bool FULL, typename TO>
__device__ __forceinline__ void bce_group(const TL* __restrict__ logits, const TX* __restrict__ x,
                                          const float* __restrict__ mask, TO* __restrict__ out,
                                          long long g, long long n, int p, const float* m,
                                          float gs, float& acc) {
  float l[GROUP], t[GROUP], d[GROUP];
  if constexpr (FULL) {
    load_group(logits + g, l);
    load_group(x + g, t);
  } else {
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      l[j] = g + j < n ? to_f32(logits[g + j]) : 0.f;
      t[j] = g + j < n ? to_f32(x[g + j]) : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < GROUP; ++j) {
    if (!FULL && g + j >= n) continue;
    const float mk = FIXED ? m[j] : __ldg(mask + (g + j) % p);
    float bce, sig;
    bce_cell<MODE>(l[j], t[j], bce, sig);
    if constexpr (MODE != kBwd) acc = __fmaf_rn(bce, mk, acc);
    if constexpr (MODE != kSum) d[j] = __fmul_rn(__fsub_rn(sig, t[j]), mk);
    if constexpr (MODE == kBwd) d[j] = __fmul_rn(d[j], gs);
  }
  if constexpr (MODE != kSum) {
    if constexpr (FULL) {
      store_group(out + g, d);
    } else {
#pragma unroll
      for (int j = 0; j < GROUP; ++j)
        if (g + j < n) out[g + j] = from_f32<TO>(d[j]);
    }
  }
}

// The pass of one block: chunks blockIdx.x, + gridDim.x, ... in that
// order, thread t cells 4t..4t+3 of each; returns the thread's sum (K2,
// K4). Where p divides CHUNK a thread's 4 mask values are read once.
template <typename TL, typename TX, int MODE, bool FIXED, typename TO>
__device__ __forceinline__ float bce_pass(const TL* __restrict__ logits, const TX* __restrict__ x,
                                          const float* __restrict__ mask, TO* __restrict__ out,
                                          long long n, int p, long long chunks, bool vec,
                                          float gs) {
  float m[GROUP] = {};
  if constexpr (FIXED) {
#pragma unroll
    for (int j = 0; j < GROUP; ++j) m[j] = __ldg(mask + (threadIdx.x * GROUP + j) % p);
  }
  float acc = 0.f;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    const long long g = c * CHUNK + threadIdx.x * GROUP;
    if (vec && (c + 1) * CHUNK <= n)
      bce_group<TL, TX, MODE, FIXED, true>(logits, x, mask, out, g, n, p, m, gs, acc);
    else
      bce_group<TL, TX, MODE, FIXED, false>(logits, x, mask, out, g, n, p, m, gs, acc);
  }
  return acc;
}

// K2 (DUAL = false) and K4 (DUAL = true): the sum into out[0] in one launch
// of sum_geometry(n, p).blocks blocks; `ticket` is 0 before and after.
template <typename TL, typename TX, bool DUAL, bool FIXED>
__global__ void __launch_bounds__(THREADS)
bce_sum(const TL* __restrict__ logits, const TX* __restrict__ x,
        const float* __restrict__ mask, float* __restrict__ partials,
        unsigned* __restrict__ ticket, float* __restrict__ out,
        float* __restrict__ tile, long long n, int p, long long chunks, bool vec) {
  float acc = bce_pass<TL, TX, DUAL ? kDual : kSum, FIXED>(logits, x, mask, tile, n, p,
                                                           chunks, vec, 0.f);
  acc = block_sum<THREADS>(acc);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = acc;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float total = 0.f;
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += THREADS)
    total += __ldcg(partials + i);
  total = block_sum<THREADS>(total);
  if (threadIdx.x == 0) {
    out[0] = total;
    *ticket = 0u;
  }
}

// K3: dl = ((σ(l) − x)·mask)·g[0] in the logits' type, one launch of
// sum_geometry(n, p).blocks blocks.
template <typename TL, typename TX, bool FIXED>
__global__ void __launch_bounds__(THREADS)
bce_bwd(const TL* __restrict__ logits, const TX* __restrict__ x,
        const float* __restrict__ mask, const float* __restrict__ g_ptr,
        TL* __restrict__ dl, long long n, int p, long long chunks, bool vec) {
  bce_pass<TL, TX, kBwd, FIXED>(logits, x, mask, dl, n, p, chunks, vec, __ldg(g_ptr));
}

template <typename TL, typename TX, bool DUAL>
cudaError_t launch_sum(const void* logits, const void* x, const float* mask,
                       float* partials, unsigned* ticket, float* out, float* tile,
                       long long n, int p, cudaStream_t stream) {
  const TL* l = static_cast<const TL*>(logits);
  const TX* t = static_cast<const TX*>(x);
  const SumGeometry geo = sum_geometry(n, p);
  const bool vec = aligned(l, GROUP * sizeof(TL)) && aligned(t, GROUP * sizeof(TX)) &&
                   (!DUAL || aligned(tile, GROUP * sizeof(float)));
  if (geo.fixed_col)
    bce_sum<TL, TX, DUAL, true><<<geo.blocks, THREADS, 0, stream>>>(
        l, t, mask, partials, ticket, out, tile, n, p, geo.chunks, vec);
  else
    bce_sum<TL, TX, DUAL, false><<<geo.blocks, THREADS, 0, stream>>>(
        l, t, mask, partials, ticket, out, tile, n, p, geo.chunks, vec);
  return cudaGetLastError();
}

template <typename TL, typename TX>
cudaError_t launch_bwd(const void* logits, const void* x, const float* mask,
                       const float* g, void* dl, long long n, int p, cudaStream_t stream) {
  const TL* l = static_cast<const TL*>(logits);
  const TX* t = static_cast<const TX*>(x);
  TL* d = static_cast<TL*>(dl);
  const SumGeometry geo = sum_geometry(n, p);
  const bool vec = aligned(l, GROUP * sizeof(TL)) && aligned(t, GROUP * sizeof(TX)) &&
                   aligned(d, GROUP * sizeof(TL));
  if (geo.fixed_col)
    bce_bwd<TL, TX, true><<<geo.blocks, THREADS, 0, stream>>>(l, t, mask, g, d, n, p,
                                                              geo.chunks, vec);
  else
    bce_bwd<TL, TX, false><<<geo.blocks, THREADS, 0, stream>>>(l, t, mask, g, d, n, p,
                                                               geo.chunks, vec);
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
  float* partials; unsigned* ticket; float* out; float* tile;
  long long n; int p; cudaStream_t stream;
  template <typename TL, typename TX> cudaError_t operator()() const {
    if (tile != nullptr)
      return launch_sum<TL, TX, true>(logits, x, mask, partials, ticket, out, tile, n, p, stream);
    return launch_sum<TL, TX, false>(logits, x, mask, partials, ticket, out, nullptr, n, p,
                                     stream);
  }
};

struct BwdArgs {
  const void* logits; const void* x; const float* mask; const float* g;
  void* dl; long long n; int p; cudaStream_t stream;
  template <typename TL, typename TX> cudaError_t operator()() const {
    return launch_bwd<TL, TX>(logits, x, mask, g, dl, n, p, stream);
  }
};

}  // namespace
}  // namespace mvk

// K2. logits [n/p, p] of l_kind (bf16 or f32), x of x_kind, mask [p] f32;
// the workspace of the launch's stream: partials [MAX_BLOCKS] f32 and one
// unsigned ticket, 0 (zeroed once when the workspace is made; every launch
// leaves it 0); out: one f32. Returns the launch's cudaError_t.
extern "C" int mvk_masked_bce_sum(const void* logits, int l_kind, const void* x,
                                  int x_kind, const float* mask, float* partials,
                                  unsigned* ticket, float* out, long long n, int p,
                                  cudaStream_t stream) {
  using namespace mvk;
  if (n < 0 || p <= 0) return cudaErrorInvalidValue;
  return dispatch_kinds(l_kind, x_kind, SumArgs{logits, x, mask, partials, ticket, out,
                                                nullptr, n, p, stream});
}

// K4. As K2, and tile [n] f32 receives (σ(l) − x)·mask.
extern "C" int mvk_masked_bce_sum_dual(const void* logits, int l_kind,
                                       const void* x, int x_kind,
                                       const float* mask, float* partials,
                                       unsigned* ticket, float* out, float* tile,
                                       long long n, int p, cudaStream_t stream) {
  using namespace mvk;
  if (n < 0 || p <= 0 || tile == nullptr) return cudaErrorInvalidValue;
  return dispatch_kinds(l_kind, x_kind, SumArgs{logits, x, mask, partials, ticket, out,
                                                tile, n, p, stream});
}

// The launch of K2, K4 and K3 (each launches `sum_geometry(n, p)`) for n
// cells of p pitches, for checks against ops/fused_elbo.py `sum_geometry`:
// out = {chunks, blocks, fixed_col, CHUNK, MAX_BLOCKS}.
extern "C" void mvk_masked_bce_sum_geometry(long long n, int p, long long* out) {
  using namespace mvk;
  const SumGeometry geo = sum_geometry(n, p);
  out[0] = geo.chunks;
  out[1] = geo.blocks;
  out[2] = geo.fixed_col;
  out[3] = CHUNK;
  out[4] = MAX_BLOCKS;
}

// K3. dl [n] of l_kind receives ((σ(l) − x)·mask)·g[0]; g: one f32 on the
// device.
extern "C" int mvk_masked_bce_bwd(const void* logits, int l_kind, const void* x,
                                  int x_kind, const float* mask, const float* g,
                                  void* dl, long long n, int p, cudaStream_t stream) {
  using namespace mvk;
  if (n < 0 || p <= 0) return cudaErrorInvalidValue;
  return dispatch_kinds(l_kind, x_kind, BwdArgs{logits, x, mask, g, dl, n, p, stream});
}
