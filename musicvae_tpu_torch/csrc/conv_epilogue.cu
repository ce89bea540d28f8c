// The conv pyramid's epilogue: what follows each cuDNN conv and transposed
// conv of the parity stem and the decoder heads (models/layers.py
// `ConvTrunk`, `_upsample`, `PatchHead`), forward and backward.
//
// No TPU kernel is replaced: the JAX package leaves the bias, the
// transposed conv's crop and the GELU to XLA, which fuses them into the
// conv's own epilogue. On the card cuDNN is called without a bias, and
// this pair does the rest in one pass each way, on channels-last (NHWC)
// tensors:
// - forward (`conv_epilogue_fwd`): y = gelu(round(c + b)) over the kept
//   grid [0, ho) x [0, wo) of the conv output c [n, hc, wc, C] (a
//   transposed conv's [:2t, :2p] crop, or the whole grid), written
//   contiguous [n, ho, wo, C] in the output's type (the head's last layer:
//   no GELU and the f32 logits);
// - backward (`conv_epilogue_bwd`): dc = round(gelu'(round(c + b)) ·
//   round(dy)) over the whole uncropped grid in c's layout (round(dy)
//   without the GELU, reading neither c nor b), zero on the cropped edge,
//   and db = round(Σ dc) per channel in the same pass.
// It replaces ATen's broadcast bias add, the strided GELU and its
// backward, `slice_backward`'s zero fill and copy, the copy of that NCHW
// gradient back to the saved input's layout, the bias gradient's
// reduction and the logits' cast.
//
// Rounding follows ATen's chain, so the forward equals it to 1 bf16 ulp
// (and bit for bit where the compilers contract alike): c + b rounded to
// the compute type (the conv's add_), the tanh-GELU in f32 by ATen's
// formula (`GeluCUDAKernelImpl`, precise tanhf) rounded to the output;
// backward: dy rounded to the compute type (the cast's backward), ATen's
// `gelu_backward` formula in f32, dc rounded, and db the f32 sum of the
// rounded dc, rounded once at the end (as `sum` of a bf16 tensor).
//
// What bounds it on Hopper: bytes. c3's train step (2,048 bars) reads and
// writes ~4.05 GB through the two kernels (each input byte once, each output
// byte once), 1.2 ms at 3.35 TB/s, against a few tens of f32 operations an
// element.
//
// Design:
// - Flat over what a kernel writes (forward: the kept output; backward:
//   the whole grid), a thread takes GROUP = 8 consecutive elements at a
//   time by 16-byte loads and stores where C is a multiple of 8 (VEC), the
//   groups g, g + S, ... of a grid-stride loop (S = blocks·THREADS), a few
//   of them with all their loads issued before the math. With C = 1 (the
//   head's last layer: rows of 129 elements, unaligned), 2 or 4 a warp
//   takes 256 consecutive elements lane by lane instead (scalar accesses,
//   coalesced), walking the rows by increments, not divisions.
// - The wrapper admits C dividing CHUNK = THREADS·GROUP = 2048 (a power of
//   two), so a thread's channels never change: (8·tid + j) mod C on the
//   vector path, lane mod C on the scalar one. Its bias values are loaded
//   once and the backward keeps its bias-gradient sums in registers.
// - The grids are functions of the shape alone (ops/conv_epilogue.py
//   `fwd_blocks`, `bwd_blocks`, passed in), never of the card. The
//   backward takes at most 2 blocks an SM and at least 4 groups a thread,
//   so that its last block has few partials to sum.
// - db with the same bits on every run (K4's ticket pattern, masked_bce.cu):
//   each block sums its threads' registers per channel by a fixed tree in
//   shared memory into partials[block][C], then takes a ticket; the block
//   that takes the last ticket sums each channel's partials in a fixed
//   order (4 channels a thread by 16-byte loads, 8 loads in flight), writes
//   db and resets the ticket to 0 for the next launch on the stream. The
//   order depends on the shape alone, so it holds under
//   torch.use_deterministic_algorithms and in a captured graph.

#include "common.cuh"

namespace mvk {
namespace {

constexpr int THREADS = 256;
constexpr int GROUP = 8;                   // elements a thread takes at a time
constexpr int CHUNK = THREADS * GROUP;     // the channel count divides it
constexpr int SPAN = 32 * GROUP;           // a warp's elements at a time
constexpr int FWD_UNROLL = 4;              // groups whose loads go out together
constexpr int BWD_UNROLL = 4;
constexpr int FINISH_BATCH = 8;            // partials' loads in flight a thread

// ATen's tanh-GELU constants, computed as ATen computes them
constexpr float kBeta = static_cast<float>(1.41421356237309504880 * 1.12837916709551257390 * 0.5);
constexpr float kKappa = 0.044715f;

struct Shape {
  int n, hc, wc, c;   // the conv output c [n, hc, wc, C]
  int ho, wo;         // the kept grid
};

template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return round_bf16(v);
}

// 8 elements by streaming (read-once) 16-byte loads
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 r = __ldcs(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// 8 elements by default 16-byte stores (the next kernel reads them),
// rounded to nearest even
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// ATen's tanh-GELU and its derivative, written in its order (nvcc
// contracts them as it contracts ATen's)
__device__ __forceinline__ float gelu_fwd(float x) {
  const float x_cube = x * x * x;
  const float inner = kBeta * (x + kKappa * x_cube);
  return 0.5f * x * (1.f + tanhf(inner));
}

__device__ __forceinline__ float gelu_bwd(float dy, float x) {
  const float x_sq = x * x;
  const float x_cube = x_sq * x;
  const float inner = kBeta * (x + kKappa * x_cube);
  const float t = tanhf(inner);
  const float left = 0.5f * x;
  const float right = 1.f + t;
  const float left_derivative = 0.5f * right;
  const float tanh_derivative = 1.f - t * t;
  const float inner_derivative = kBeta * (1.f + 3.f * kKappa * x_sq);
  const float right_derivative = left * tanh_derivative * inner_derivative;
  return dy * (left_derivative + right_derivative);
}

// The thread's 8 bias values, in f32: channels (8·tid + j) mod C.
template <typename TC>
__device__ __forceinline__ void thread_bias(const TC* __restrict__ bias, int c, float* bv) {
#pragma unroll
  for (int j = 0; j < GROUP; ++j) bv[j] = to_f32(__ldg(bias + ((threadIdx.x * GROUP + j) & (c - 1))));
}

// rounded to the compute type, as ATen's ops on a compute-type tensor;
// the store rounds to the output type (the cast)
template <typename TC, bool GELU>
__device__ __forceinline__ float fwd_value(float cv, float bv) {
  const float s = round_to<TC>(cv + bv);
  return GELU ? round_to<TC>(gelu_fwd(s)) : s;
}

template <typename TC, bool GELU>
__device__ __forceinline__ float bwd_value(float dy, float cv, float bv) {
  const float g = round_to<TC>(dy);
  return round_to<TC>(GELU ? gelu_bwd(g, round_to<TC>(cv + bv)) : g);
}

// -- forward -----------------------------------------------------------------------

template <typename TC, typename TO, bool GELU, bool VEC>
__global__ void __launch_bounds__(THREADS)
conv_epilogue_fwd(const TC* __restrict__ c, const TC* __restrict__ bias, TO* __restrict__ y,
                  Shape s, int total) {
  const int len = s.wo * s.c;                       // a kept row
  const int stride = gridDim.x * THREADS;
  if constexpr (VEC) {          // C % 8 == 0: a group lies in one row
    const int groups = total / GROUP;
    float bv[GROUP];
    thread_bias(bias, s.c, bv);
    for (int g0 = blockIdx.x * THREADS + threadIdx.x; g0 < groups; g0 += FWD_UNROLL * stride) {
      float v[FWD_UNROLL][GROUP];
#pragma unroll
      for (int u = 0; u < FWD_UNROLL; ++u) {
        const int g = g0 + u * stride;
        if (g >= groups) continue;
        const int e = g * GROUP;
        const int r = e / len, k = e - r * len;
        const int b = r / s.ho, i = r - b * s.ho;
        load8(c + (b * s.hc + i) * s.wc * s.c + k, v[u]);
      }
#pragma unroll
      for (int u = 0; u < FWD_UNROLL; ++u) {
        const int g = g0 + u * stride;
        if (g >= groups) continue;
        float out[GROUP];
#pragma unroll
        for (int j = 0; j < GROUP; ++j) out[j] = fwd_value<TC, GELU>(v[u][j], bv[j]);
        store8(y + g * GROUP, out);
      }
    }
  } else {                      // C < 8: a warp's span, lane-contiguous
    const int lane = threadIdx.x & 31;
    const float bl = to_f32(__ldg(bias + (lane & (s.c - 1))));
    for (int sp = (blockIdx.x * THREADS + threadIdx.x) >> 5; sp * SPAN < total;
         sp += stride >> 5) {
      const int e0 = sp * SPAN + lane;
      int r = e0 / len, k = e0 - r * len;
      int b = r / s.ho, i = r - b * s.ho;
      float v[GROUP];
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {     // every load first
        v[j] = e0 + 32 * j < total ? to_f32(c[(b * s.hc + i) * s.wc * s.c + k]) : 0.f;
        for (k += 32; k >= len; k -= len)
          if (++i == s.ho) { i = 0; ++b; }
      }
#pragma unroll
      for (int j = 0; j < GROUP; ++j)
        if (e0 + 32 * j < total) y[e0 + 32 * j] = from_f32<TO>(fwd_value<TC, GELU>(v[j], bl));
    }
  }
}

// -- backward ----------------------------------------------------------------------

// The last block's sums of partials[blocks][C] per channel, `vc` channels a
// thread by one load: `lanes` threads across the channels, THREADS / lanes
// segments down the blocks, segment q taking blocks q, q + segs, ... in
// order, FINISH_BATCH loads at a time; then a tree over the segments.
template <int VC, typename TC>
__device__ __forceinline__ void finish(const float* __restrict__ partials, int blocks, int c,
                                       float* red, TC* __restrict__ db) {
  const int tid = threadIdx.x;
  const int lanes = min(c / VC, THREADS), segs = THREADS / lanes;
  const int lane = tid % lanes, seg = tid / lanes;
  for (int col = lane * VC; col < c; col += lanes * VC) {
    float sum[VC] = {};
    for (int b0 = seg; b0 < blocks; b0 += FINISH_BATCH * segs) {
      float v[FINISH_BATCH][VC];
#pragma unroll
      for (int u = 0; u < FINISH_BATCH; ++u) {
        const int bi = b0 + u * segs;
        if constexpr (VC == 4) {
          const float4 f = bi < blocks ? __ldcg(reinterpret_cast<const float4*>(
                                             partials + bi * c + col))
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
          v[u][0] = f.x; v[u][1] = f.y; v[u][2] = f.z; v[u][3] = f.w;
        } else {
          v[u][0] = bi < blocks ? __ldcg(partials + bi * c + col) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < FINISH_BATCH; ++u)
#pragma unroll
        for (int q = 0; q < VC; ++q) sum[q] += v[u][q];
    }
#pragma unroll
    for (int q = 0; q < VC; ++q) red[(seg * lanes + lane) * VC + q] = sum[q];
    __syncthreads();
    for (int half = segs / 2; half >= 1; half >>= 1) {
      if (seg < half)
#pragma unroll
        for (int q = 0; q < VC; ++q)
          red[(seg * lanes + lane) * VC + q] += red[((seg + half) * lanes + lane) * VC + q];
      __syncthreads();
    }
    if (seg == 0)
#pragma unroll
      for (int q = 0; q < VC; ++q) db[col + q] = from_f32<TC>(red[lane * VC + q]);
    __syncthreads();
  }
}

// The block's per-channel sums of the threads' `acc` (acc[j] holds channel
// (8·tid + j) mod C) into partials[block][C] by a fixed tree; then the last
// block to finish sums the partials into db and resets the ticket.
template <typename TC>
__device__ __forceinline__ void bias_grad(const float* acc, int c, float* __restrict__ partials,
                                          unsigned* __restrict__ ticket, TC* __restrict__ db) {
  __shared__ float red[CHUNK];
  __shared__ bool last;
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < GROUP; ++j) red[tid * GROUP + j] = acc[j];
  __syncthreads();
  // position p holds channel p mod C; halving keeps that while half >= C
  for (int half = CHUNK / 2; half >= c; half >>= 1) {
    for (int p = tid; p < half; p += THREADS) red[p] += red[p + half];
    __syncthreads();
  }
  for (int ch = tid; ch < c; ch += THREADS) partials[blockIdx.x * c + ch] = red[ch];
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (c % 4 == 0)
    finish<4>(partials, gridDim.x, c, red, db);
  else
    finish<1>(partials, gridDim.x, c, red, db);
  if (tid == 0) *ticket = 0u;
}

template <typename TD, typename TC, bool GELU, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
conv_epilogue_bwd(const TD* __restrict__ dy, const TC* __restrict__ c,
                  const TC* __restrict__ bias, TC* __restrict__ dc,
                  float* __restrict__ partials, unsigned* __restrict__ ticket,
                  TC* __restrict__ db, Shape s, int total) {
  const int len = s.wo * s.c;                       // a kept row of dy
  const int row = s.wc * s.c;                       // a row of the grid
  const int stride = gridDim.x * THREADS;
  float acc[GROUP] = {};
  // without the GELU dc is round(dy) alone: neither c nor the bias is read
  if constexpr (VEC) {          // C % 8 == 0: a group is kept or cropped whole
    const int groups = total / GROUP;
    float bv[GROUP] = {};
    if constexpr (GELU) thread_bias(bias, s.c, bv);
    for (int g0 = blockIdx.x * THREADS + threadIdx.x; g0 < groups; g0 += BWD_UNROLL * stride) {
      float d[BWD_UNROLL][GROUP], v[BWD_UNROLL][GROUP] = {};
      bool keep[BWD_UNROLL];
#pragma unroll
      for (int u = 0; u < BWD_UNROLL; ++u) {
        const int g = g0 + u * stride;
        keep[u] = false;
        if (g >= groups) continue;
        const int e = g * GROUP;
        const int r = e / row, k = e - r * row;
        const int b = r / s.hc, i = r - b * s.hc;
        keep[u] = i < s.ho && k < len;
        if (keep[u]) {
          load8(dy + (b * s.ho + i) * len + k, d[u]);
          if constexpr (GELU) load8(c + e, v[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < BWD_UNROLL; ++u) {
        const int g = g0 + u * stride;
        if (g >= groups) continue;
        float out[GROUP];
#pragma unroll
        for (int j = 0; j < GROUP; ++j) {
          out[j] = keep[u] ? bwd_value<TC, GELU>(d[u][j], v[u][j], bv[j]) : 0.f;
          acc[j] += out[j];
        }
        store8(dc + g * GROUP, out);
      }
    }
  } else {                      // C < 8: a warp's span, lane-contiguous
    const int lane = threadIdx.x & 31;
    const float bl = GELU ? to_f32(__ldg(bias + (lane & (s.c - 1)))) : 0.f;
    float sum = 0.f;            // channel lane mod C
    for (int sp = (blockIdx.x * THREADS + threadIdx.x) >> 5; sp * SPAN < total;
         sp += stride >> 5) {
      const int e0 = sp * SPAN + lane;
      int r = e0 / row, k = e0 - r * row;
      int b = r / s.hc, i = r - b * s.hc;
      float d[GROUP], v[GROUP];
      bool keep[GROUP];
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {     // every load first
        const int e = e0 + 32 * j;
        keep[j] = e < total && i < s.ho && k < len;
        d[j] = keep[j] ? to_f32(dy[(b * s.ho + i) * len + k]) : 0.f;
        v[j] = GELU && keep[j] ? to_f32(c[e]) : 0.f;
        for (k += 32; k >= row; k -= row)
          if (++i == s.hc) { i = 0; ++b; }
      }
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        const int e = e0 + 32 * j;
        if (e >= total) continue;
        const float out = keep[j] ? bwd_value<TC, GELU>(d[j], v[j], bl) : 0.f;
        dc[e] = from_f32<TC>(out);
        sum += out;
      }
    }
    // channel lane mod C is channel j mod C of this thread's slots
#pragma unroll
    for (int j = 0; j < GROUP; ++j) acc[j] = j == (lane & (s.c - 1)) ? sum : 0.f;
  }
  bias_grad(acc, s.c, partials, ticket, db);
}

// -- launches ------------------------------------------------------------------------

template <typename TC, typename TO>
cudaError_t launch_fwd(const void* c, const void* bias, void* y, Shape s, int total, bool gelu,
                       int blocks, cudaStream_t stream) {
  const TC* cp = static_cast<const TC*>(c);
  const TC* bp = static_cast<const TC*>(bias);
  TO* yp = static_cast<TO*>(y);
  const bool vec = s.c % GROUP == 0;
  if (gelu && vec)
    conv_epilogue_fwd<TC, TO, true, true><<<blocks, THREADS, 0, stream>>>(cp, bp, yp, s, total);
  else if (gelu)
    conv_epilogue_fwd<TC, TO, true, false><<<blocks, THREADS, 0, stream>>>(cp, bp, yp, s, total);
  else if (vec)
    conv_epilogue_fwd<TC, TO, false, true><<<blocks, THREADS, 0, stream>>>(cp, bp, yp, s, total);
  else
    conv_epilogue_fwd<TC, TO, false, false><<<blocks, THREADS, 0, stream>>>(cp, bp, yp, s, total);
  return cudaGetLastError();
}

template <typename TD, typename TC>
cudaError_t launch_bwd(const void* dy, const void* c, const void* bias, void* dc,
                       float* partials, unsigned* ticket, void* db, Shape s, int total,
                       bool gelu, int blocks, cudaStream_t stream) {
  const TD* dp = static_cast<const TD*>(dy);
  const TC* cp = static_cast<const TC*>(c);
  const TC* bp = static_cast<const TC*>(bias);
  TC* dcp = static_cast<TC*>(dc);
  TC* dbp = static_cast<TC*>(db);
  const bool vec = s.c % GROUP == 0;
#define MVK_EPI_BWD(G, V)                                                              \
  conv_epilogue_bwd<TD, TC, G, V><<<blocks, THREADS, 0, stream>>>(dp, cp, bp, dcp, partials, \
                                                                  ticket, dbp, s, total)
  if (gelu && vec) MVK_EPI_BWD(true, true);
  else if (gelu) MVK_EPI_BWD(true, false);
  else if (vec) MVK_EPI_BWD(false, true);
  else MVK_EPI_BWD(false, false);
#undef MVK_EPI_BWD
  return cudaGetLastError();
}

// Calls fn.template operator()<TA, TB>() for two kinds, each bf16 or f32.
template <typename F>
cudaError_t dispatch_kinds(int a_kind, int b_kind, F fn) {
  if (a_kind == kBF16 && b_kind == kBF16) return fn.template operator()<__nv_bfloat16, __nv_bfloat16>();
  if (a_kind == kBF16 && b_kind == kF32) return fn.template operator()<__nv_bfloat16, float>();
  if (a_kind == kF32 && b_kind == kBF16) return fn.template operator()<float, __nv_bfloat16>();
  if (a_kind == kF32 && b_kind == kF32) return fn.template operator()<float, float>();
  return cudaErrorInvalidValue;
}

struct FwdArgs {
  const void* c; const void* bias; void* y; Shape s; int total; bool gelu; int blocks;
  cudaStream_t stream;
  template <typename TC, typename TO> cudaError_t operator()() const {
    return launch_fwd<TC, TO>(c, bias, y, s, total, gelu, blocks, stream);
  }
};

struct BwdArgs {
  const void* dy; const void* c; const void* bias; void* dc; float* partials;
  unsigned* ticket; void* db; Shape s; int total; bool gelu; int blocks; cudaStream_t stream;
  template <typename TD, typename TC> cudaError_t operator()() const {
    return launch_bwd<TD, TC>(dy, c, bias, dc, partials, ticket, db, s, total, gelu, blocks,
                              stream);
  }
};

bool valid(const Shape& s, int blocks) {
  return s.n > 0 && s.c > 0 && CHUNK % s.c == 0 && s.ho > 0 && s.wo > 0 && s.ho <= s.hc &&
         s.wo <= s.wc && blocks > 0;
}

}  // namespace
}  // namespace mvk

// Forward. c [n, hc, wc, C] and bias [C] of c_kind, y [n, ho, wo, C] of
// y_kind (bf16 or f32, every pointer 16-byte aligned, C dividing 2,048,
// n·hc·wc·C < 2^31); `blocks` as ops/conv_epilogue.py `fwd_blocks` gives
// it.
extern "C" int mvk_conv_epilogue(const void* c, int c_kind, const void* bias, void* y,
                                 int y_kind, int n, int hc, int wc, int ch, int ho, int wo,
                                 int gelu, int blocks, cudaStream_t stream) {
  using namespace mvk;
  const Shape s{n, hc, wc, ch, ho, wo};
  if (!valid(s, blocks)) return cudaErrorInvalidValue;
  return dispatch_kinds(c_kind, y_kind, FwdArgs{c, bias, y, s, n * ho * wo * ch, gelu != 0,
                                                blocks, stream});
}

// Backward. dy [n, ho, wo, C] of dy_kind; c, bias, dc [n, hc, wc, C] and
// db [C] of c_kind; the workspace: partials [blocks, C] f32 and the
// stream's ticket, 0 before and after every launch; `blocks` as
// ops/conv_epilogue.py `bwd_blocks` gives it.
extern "C" int mvk_conv_epilogue_bwd(const void* dy, int dy_kind, const void* c, int c_kind,
                                     const void* bias, void* dc, float* partials,
                                     unsigned* ticket, void* db, int n, int hc, int wc, int ch,
                                     int ho, int wo, int gelu, int blocks,
                                     cudaStream_t stream) {
  using namespace mvk;
  const Shape s{n, hc, wc, ch, ho, wo};
  if (!valid(s, blocks)) return cudaErrorInvalidValue;
  return dispatch_kinds(dy_kind, c_kind, BwdArgs{dy, c, bias, dc, partials, ticket, db, s,
                                                 n * hc * wc * ch, gelu != 0, blocks, stream});
}
