// K1: the first encoder conv of the parity trunk, forward.
//
// Replaces musicvae_tpu/ops/conv1_pallas.py:112 `_conv1_kernel`, launched
// from `_fwd_impl` (:144): y[m,i,j,c] = gelu(b[c] + sum_{kt,kp}
// x[m,2i+kt-1,2j+kp-1] · w[kt,kp,c]) on a [M,96,128] bar → [M,48,64,C]
// (NHWC), 3x3 taps, stride 2, zero padding at row -1 and pitch -1. The
// TPU kernel's banded matmul (42x redundant FLOPs to fill a 128x128 matrix
// unit) has no use here and is not carried over: this is a direct conv.
//
// What bounds it on the H100 (PERF.md §6 has the numbers): at M=256, C=16
// (uint8 in, bf16 out) it moves 28 MB, 8.45 µs by bytes. It takes ~19.9 µs
// from a cold L2, launch included (~15.6 µs of kernel alone), where a
// memset of its 25 MB output takes ~12.9 µs timed the same way. The split
// by feature (GELU off, stores off, compute off) shows no single pipe
// saturated: what is left is each warp's dependent chain (shared loads,
// mma, ex2, rcp, store) and the GELU's MUFU work (~2.5 µs).
//
// Design:
// - The bf16 contract (x and w rounded to bf16, f32 accumulation: the TPU
//   kernel's bf16 MXU pass) runs on tensor cores at C >= 8
//   (`conv1_tile_mma`, mma.sync m16n8k16, bias as the accumulator's
//   start); the f32 output, and C=4, on FMAs with the thread's 36 weights
//   in registers (`conv1_tile`), from the bias in w's [kt][kp] order, which
//   the backward's f32 recompute repeats.
// - The GELU is conv1.cuh `gelu_tanh2`: ex2.approx, and one rcp.approx for
//   two values, a few ulp from the precise form, which holds the f32 output
//   to 1e-5.
// - Persistent blocks: at most as many as an H100 holds at once (4 an SM),
//   each walking tiles of `rows` output rows. cp.async stages the next
//   tile's input rows while the current one computes; bytes become f32
//   with PRMT and FADD, not the conversion pipe.
// - A warp keeps four 16-position spans in flight, enough to cover its
//   chain's latency.
// - The tiling comes from M and C alone (conv1.cuh `Geometry`): 8 rows,
//   1,536 tiles over 528 blocks at M=256; one row, 192 tiles and blocks at
//   serve's M=4, so that most of the 132 SMs have work.

#include "conv1.cuh"

namespace mvk {
namespace {

using namespace conv1;

template <typename TOut>
__device__ __forceinline__ void store4(TOut* o, const float* v);

template <>
__device__ __forceinline__ void store4<float>(float* o, const float* v) {
  *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
}

template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* o,
                                                      const float* v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(o) = u;
}

// One tile: `rows` output rows of bar m from row i0, from the staged
// planes, with the thread's weights and biases in registers.
template <typename TOut, int C>
__device__ __forceinline__ void conv1_tile(const WorkMap<C>& map,
                                           const float* s_even,
                                           const float* s_odd,
                                           const float4 (&wr)[9],
                                           const float (&br)[CG], int gelu,
                                           TOut* __restrict__ om) {
#pragma unroll 2
  for (int s = map.warp; s < map.slots; s += map.warps) {
    const int ti = map.row(s), j = map.pitch(s);
    float xs[9];
    load_taps(s_even, s_odd, ti, j, xs);
    float acc[CG];
    conv_taps(xs, wr, br, acc);
    if (gelu) {
      gelu_tanh2(acc[0], acc[1]);
      gelu_tanh2(acc[2], acc[3]);
    }
    store4<TOut>(om + (ti * P_OUT + j) * C, acc);
  }
}

// The tensor-core path, for the bf16 contract (x and w rounded to bf16, f32
// accumulation: the TPU kernel's bf16 MXU pass) at C >= 8. A warp takes 16
// neighbouring positions of one row ("an mslot") and computes all C
// channels as C/8 products of mma.sync.m16n8k16: A = the 16 positions' 9
// taps (padded to 16), B = w [16 taps][8 channels] (in registers for the
// whole kernel), C = the bias. Lane (gid = lane/4, tig = lane%4) holds taps
// 2tig, 2tig+1 (and tap 8 when tig = 0) of positions gid and gid+8, and
// ends with channels 8nt+2tig, +1 of the same two positions.
constexpr int MSLOTS_PER_ROW = P_OUT / 16;

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// D = A·B + (bias, bias) for one m16n8k16 tile, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_16816(float (&d)[4], const unsigned (&a)[4],
                                          const unsigned (&b)[2],
                                          const float (&c)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c[0]), "f"(c[1]), "f"(c[0]), "f"(c[1]));
}

// Where tap k of tile row 0, position 0 lies in a plane set (its even plane
// first), and how far one tile row moves it.
struct TapSource {
  int base, step;
  __device__ __forceinline__ TapSource(int k, int rows) {
    const int kt = k / 3, kp = k % 3;
    if (kp == 1) {                       // pitch 2j: the even plane
      base = kt * EVEN_STRIDE;
      step = 2 * EVEN_STRIDE;
    } else {                             // pitch 2j-1 or 2j+1: the odd plane
      base = (2 * rows + 1) * EVEN_STRIDE + kt * ODD_STRIDE + ODD_OFF - 1 + kp / 2;
      step = 2 * ODD_STRIDE;
    }
  }
};

template <int C>
__device__ __forceinline__ void conv1_tile_mma(
    const float* planes, int slots, int warp, int warps, int gid, int tig,
    const TapSource& ta, const TapSource& tb, const TapSource& tc,
    const unsigned (&bw)[C / 8][2], const float (&bb)[C / 8][2], int gelu,
    __nv_bfloat16* __restrict__ om) {
  constexpr int NT = C / 8;
  // four mslots in flight a warp: one mslot's chain (shared loads, mma,
  // GELU, store) is latency, not issue
#pragma unroll 4
  for (int s = warp; s < slots; s += warps) {
    const int ti = s / MSLOTS_PER_ROW;
    const int p0 = (s % MSLOTS_PER_ROW) * 16 + gid;
    const float* pa = planes + ta.base + ti * ta.step + p0;
    const float* pb = planes + tb.base + ti * tb.step + p0;
    unsigned a[4];
    a[0] = pack_bf16(pa[0], pb[0]);
    a[1] = pack_bf16(pa[8], pb[8]);
    a[2] = a[3] = 0u;
    if (tig == 0) {                      // tap 8; taps 9..15 are padding
      const float* pc = planes + tc.base + ti * tc.step + p0;
      a[2] = pack_bf16(pc[0], 0.f);
      a[3] = pack_bf16(pc[8], 0.f);
    }
    __nv_bfloat16* o = om + (ti * P_OUT + p0) * C + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float d[4];
      mma_16816(d, a, bw[nt], bb[nt]);
      if (gelu) {
        gelu_tanh2(d[0], d[1]);
        gelu_tanh2(d[2], d[3]);
      }
      *reinterpret_cast<unsigned*>(o + 8 * nt) = pack_bf16(d[0], d[1]);
      *reinterpret_cast<unsigned*>(o + 8 * C + 8 * nt) =   // position p0+8
          pack_bf16(d[2], d[3]);
    }
  }
}

template <typename TIn, typename TOut, int C, bool ROUND_BF16>
__global__ void __launch_bounds__(MAX_THREADS, 4)
conv1_kernel(const TIn* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ b, TOut* __restrict__ out, int rows,
             int tiles, int gelu) {
  extern __shared__ float4 smem4[];
  const TileSmem<TIn> sm(smem4, rows, C);
  const int per_bar = T_OUT / rows;
  int tile = blockIdx.x;                 // gridDim.x <= tiles
  fetch_rows<TIn>(x, tile / per_bar, (tile % per_bar) * rows, rows, sm.raw);
  cp_async_commit();
  for (int k = threadIdx.x; k < 10 * C; k += blockDim.x) {
    const float v = k < 9 * C ? w[k] : b[k - 9 * C];
    sm.w[k] = ROUND_BF16 && k < 9 * C ? round_bf16(v) : v;
  }
  unpack_rows<TIn, ROUND_BF16>(sm.raw, (tile % per_bar) * rows, rows,
                               sm.even(0), sm.odd(0, rows));
  __syncthreads();

  constexpr bool MMA = ROUND_BF16 && C >= 8;   // the tensor-core path
  const WorkMap<C> map(rows);
  // FMA path: the thread's 4 channels' weights and biases
  float4 wr[9];
  float br[CG];
  // MMA path: B fragments and biases of each 8-channel tile, tap sources
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  unsigned bw[MMA ? C / 8 : 1][2];
  float bb[MMA ? C / 8 : 1][2];
  const TapSource ta(2 * tig, rows), tb(2 * tig + 1, rows), tc(8, rows);
  if constexpr (MMA) {
#pragma unroll
    for (int nt = 0; nt < C / 8; ++nt) {
      const int ch = 8 * nt + gid;
      bw[nt][0] = pack_bf16(sm.w[2 * tig * C + ch], sm.w[(2 * tig + 1) * C + ch]);
      bw[nt][1] = pack_bf16(tig == 0 ? sm.w[8 * C + ch] : 0.f, 0.f);
      bb[nt][0] = sm.w[9 * C + 8 * nt + 2 * tig];
      bb[nt][1] = sm.w[9 * C + 8 * nt + 2 * tig + 1];
    }
  } else {
#pragma unroll
    for (int k = 0; k < 9; ++k)
      wr[k] = reinterpret_cast<const float4*>(sm.w + k * C)[map.g];
    const float4 b4 = reinterpret_cast<const float4*>(sm.w + 9 * C)[map.g];
    br[0] = b4.x; br[1] = b4.y; br[2] = b4.z; br[3] = b4.w;
  }

  for (int n = 0; tile < tiles; tile += gridDim.x, ++n) {
    const int next = tile + gridDim.x;
    if (next < tiles) {                  // lands while this tile computes
      fetch_rows<TIn>(x, next / per_bar, (next % per_bar) * rows, rows, sm.raw);
      cp_async_commit();
    }
    const int m = tile / per_bar, i0 = (tile % per_bar) * rows;
    TOut* ot = out + (static_cast<size_t>(m) * T_OUT + i0) * P_OUT * C;
    if constexpr (MMA)
      conv1_tile_mma<C>(sm.even(n), rows * MSLOTS_PER_ROW, map.warp,
                        map.warps, gid, tig, ta, tb, tc, bw, bb, gelu, ot);
    else
      conv1_tile<TOut, C>(map, sm.even(n), sm.odd(n, rows), wr, br, gelu,
                          ot + CG * map.g);
    if (next < tiles)
      unpack_rows<TIn, ROUND_BF16>(sm.raw, (next % per_bar) * rows, rows,
                                   sm.even(n + 1), sm.odd(n + 1, rows));
    __syncthreads();
  }
}

template <typename TIn, typename TOut, int C, bool ROUND_BF16>
cudaError_t launch_fwd(const Geometry& geo, const TIn* x, const float* w,
                       const float* b, TOut* out, int gelu,
                       cudaStream_t stream) {
  const auto kernel = conv1_kernel<TIn, TOut, C, ROUND_BF16>;
  const size_t smem = smem_bytes<TIn>(geo.rows, C, 0);
  const cudaError_t err = prepare_launch(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<geo.fwd_blocks, geo.threads, smem, stream>>>(x, w, b, out, geo.rows,
                                                        geo.tiles, gelu);
  return cudaGetLastError();
}

template <typename TIn, typename TOut, bool ROUND_BF16>
cudaError_t launch_c(const void* x, const float* w, const float* b, void* out,
                     int m, int c, int gelu, cudaStream_t stream) {
  const Geometry geo(m, c);
  const TIn* xi = static_cast<const TIn*>(x);
  TOut* o = static_cast<TOut*>(out);
  switch (c) {
    case 4: return launch_fwd<TIn, TOut, 4, ROUND_BF16>(geo, xi, w, b, o, gelu, stream);
    case 8: return launch_fwd<TIn, TOut, 8, ROUND_BF16>(geo, xi, w, b, o, gelu, stream);
    case 16: return launch_fwd<TIn, TOut, 16, ROUND_BF16>(geo, xi, w, b, o, gelu, stream);
    case 32: return launch_fwd<TIn, TOut, 32, ROUND_BF16>(geo, xi, w, b, o, gelu, stream);
    default: return cudaErrorInvalidValue;
  }
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
// out_kind. c ∈ {4, 8, 16, 32}; x and out 16-byte aligned. Returns the
// launch's cudaError_t.
extern "C" int mvk_first_conv_s2(const void* x, int x_kind, const float* w,
                                 const float* b, void* out, int out_kind,
                                 int m, int c, int gelu, cudaStream_t stream) {
  using namespace mvk;
  if (!conv1::valid_c(c)) return cudaErrorInvalidValue;
  if (m <= 0) return cudaSuccess;
  switch (x_kind) {
    case kU8: return launch_in<uint8_t>(x, w, b, out, out_kind, m, c, gelu, stream);
    case kBF16: return launch_in<__nv_bfloat16>(x, w, b, out, out_kind, m, c, gelu, stream);
    case kF32: return launch_in<float>(x, w, b, out, out_kind, m, c, gelu, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The launch geometry of both first-conv kernels for m bars of c channels
// (conv1.cuh `Geometry`), written to geo[0..4]: rows a tile, tiles,
// threads a block, forward blocks, backward blocks (= the backward's
// partials per term). For checking ops/conv1.py's mirror on the card; no
// kernel runs.
extern "C" void mvk_first_conv_s2_geometry(int m, int c, int* geo) {
  if (!mvk::conv1::valid_c(c) || m <= 0) return;
  const mvk::conv1::Geometry g(m, c);
  geo[0] = g.rows;
  geo[1] = g.tiles;
  geo[2] = g.threads;
  geo[3] = g.fwd_blocks;
  geo[4] = g.bwd_blocks;
}

// Forward blocks an SM holds at once for m bars of c channels, uint8 x and
// bf16 out (the main path's instantiation), as launched; -1 if the query
// fails. The grid assumes FWD_BLOCKS / 132.
extern "C" int mvk_first_conv_s2_resident(int m, int c) {
  using namespace mvk;
  using namespace mvk::conv1;
  if (!valid_c(c) || m <= 0) return -1;
  const Geometry g(m, c);
  const size_t smem = smem_bytes<uint8_t>(g.rows, c, 0);
  switch (c) {
    case 4: return resident_blocks(conv1_kernel<uint8_t, __nv_bfloat16, 4, true>, g.threads, smem);
    case 8: return resident_blocks(conv1_kernel<uint8_t, __nv_bfloat16, 8, true>, g.threads, smem);
    case 16: return resident_blocks(conv1_kernel<uint8_t, __nv_bfloat16, 16, true>, g.threads, smem);
    case 32: return resident_blocks(conv1_kernel<uint8_t, __nv_bfloat16, 32, true>, g.threads, smem);
    default: return -1;
  }
}
