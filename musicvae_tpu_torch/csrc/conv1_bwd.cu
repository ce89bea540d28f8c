// K1b: the first encoder conv of the parity trunk, backward.
//
// Replaces the backward of musicvae_tpu/ops/conv1_pallas.py:189
// `_first_conv_bwd`, which launches the Pallas body `_conv1_kernel` once
// more (through `_fwd_impl` with gelu off, f32) to recompute the
// pre-activation z and leaves dz = dy·gelu'(z), dw and db to XLA, with z and
// dz written to device memory in between. Here one kernel does all of it:
//   dw[kt,kp,c] = Σ_{m,i,j} x[m,2i+kt-1,2j+kp-1] · dz[m,i,j,c]
//   db[c]       = Σ_{m,i,j} dz[m,i,j,c]
// with dz = dy·gelu'(z) (dz = dy when the forward had no GELU), and a
// second launch sums the blocks' partials. dx is zero by contract and is
// not computed. The recompute is f32 with un-rounded x and w even when the
// forward ran the bf16 contract, as the TPU backward's is, in the forward's
// FMA order (conv1.cuh `conv_taps`); dy arrives in the forward's output
// type and is upcast.
//
// What bounds it on the H100 (PERF.md §6 has the numbers): it reads x (1
// byte a cell as uint8) and dy (2 bytes an output in bf16) once, 28 MB at
// 256 bars, 8.45 µs by bytes; by f32 work (48 operations an output and
// channel) 9.01 µs. It takes ~36 µs of kernel time. Its inner loop is 189
// SASS instructions a position and 4 channels (84 FFMA, 34 FMUL, 6 MUFU),
// so it is bound by issue, at about half the full rate with 16 warps an
// SM; the GELU's share is ~11 µs.
//
// Design:
// - Persistent blocks, at most as many as an H100 holds at once (2 an SM),
//   each walking tiles of `rows` output rows of one bar with all C
//   channels, its sums in registers across tiles. cp.async stages the next
//   tile's input rows and its dy (contiguous in dy) in shared memory while
//   the current tile computes; x is staged once for all channels and each
//   z is recomputed once.
// - Lanes split the channels 4 a lane (conv1.cuh `WorkMap`): a warp reads
//   dy as one contiguous span.
// - A thread keeps 40 accumulators (9 dw + 1 db for each of its 4
//   channels) and its 36 weights and 4 biases in registers: weights read
//   from shared memory at every position cost 4 wavefronts a float4 and
//   made the kernel bound by shared memory.
// - gelu' comes from conv1.cuh `gelu_r2` and `gelu_grad_of`, the
//   forward's fast ex2/rcp form.
// - No atomics on the sums. Lanes of the same channels reduce by shuffles,
//   warps through shared memory in a fixed order, into
//   `partials[10·C][blocks]`; the finish sums each term's blocks in a
//   fixed order. The partition depends on M and C only, so the bits are
//   the same on every run and every card: dw feeds Adam.

#include "conv1.cuh"

namespace mvk {
namespace {

using namespace conv1;
constexpr int FINISH_THREADS = 256;

// 4 channels of dy from the staged tile, as f32
__device__ __forceinline__ void load_dy4(const __nv_bfloat16* p, float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

__device__ __forceinline__ void load_dy4(const float* p, float* v) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}

// Start the copy of a tile's dy (rows·64·C elements, contiguous in dy)
// into shared memory, 16 bytes a cp.async; the caller commits the group.
template <typename TDy>
__device__ __forceinline__ void fetch_dy(const TDy* __restrict__ src, int elems,
                                         TDy* dst) {
  constexpr int E = 16 / static_cast<int>(sizeof(TDy));
  for (int k = threadIdx.x; k < elems / E; k += blockDim.x)
    cp_async16(dst + k * E, src + k * E);
}

// One tile's terms, added to the thread's accumulators: `rows` output
// rows of one bar from the staged planes and the staged dy (`s_dy`, the
// tile's first position, the thread's channel group).
template <typename TDy, int C>
__device__ __forceinline__ void conv1_bwd_tile(const WorkMap<C>& map,
                                               const float* s_even,
                                               const float* s_odd,
                                               const float4 (&wr)[9],
                                               const float (&br)[CG],
                                               const TDy* s_dy, int gelu,
                                               float (&acc)[10][CG]) {
#pragma unroll 1
  for (int s = map.warp; s < map.slots; s += map.warps) {
    const int ti = map.row(s), j = map.pitch(s);
    float dz[CG];
    load_dy4(s_dy + (ti * P_OUT + j) * C, dz);
    float xs[9];
    load_taps(s_even, s_odd, ti, j, xs);
    if (gelu) {
      float z[CG];
      conv_taps(xs, wr, br, z);
      float r[CG], omr[CG];
      gelu_r2(z[0], z[1], r[0], r[1], omr[0], omr[1]);
      gelu_r2(z[2], z[3], r[2], r[3], omr[2], omr[3]);
#pragma unroll
      for (int c = 0; c < CG; ++c) dz[c] *= gelu_grad_of(z[c], r[c], omr[c]);
    }
#pragma unroll
    for (int c = 0; c < CG; ++c) {
#pragma unroll
      for (int k = 0; k < 9; ++k) acc[k][c] = fmaf(xs[k], dz[c], acc[k][c]);
      acc[9][c] += dz[c];
    }
  }
}

template <typename TIn, typename TDy, int C>
__global__ void __launch_bounds__(MAX_THREADS, 2)
conv1_bwd_kernel(const TIn* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, const TDy* __restrict__ dy,
                 float* __restrict__ partials, int rows, int tiles, int gelu) {
  constexpr int TERMS = 10 * C;          // dw [3,3,C], then db [C]
  extern __shared__ float4 smem4[];
  const TileSmem<TIn> sm(smem4, rows, C);
  const int dy_elems = rows * P_OUT * C;             // a tile's dy
  TDy* s_dy = reinterpret_cast<TDy*>(sm.tail);       // two tiles' dy
  float* s_red = reinterpret_cast<float*>(s_dy + 2 * dy_elems);  // [warps][TERMS]
  const int per_bar = T_OUT / rows;
  int tile = blockIdx.x;                 // gridDim.x <= tiles
  fetch_rows<TIn>(x, tile / per_bar, (tile % per_bar) * rows, rows, sm.raw);
  fetch_dy(dy + static_cast<size_t>(tile) * dy_elems, dy_elems, s_dy);
  cp_async_commit();
  for (int k = threadIdx.x; k < TERMS; k += blockDim.x)
    sm.w[k] = k < 9 * C ? w[k] : b[k - 9 * C];
  unpack_rows<TIn, false>(sm.raw, (tile % per_bar) * rows, rows, sm.even(0),
                          sm.odd(0, rows));
  __syncthreads();

  const WorkMap<C> map(rows);
  float4 wr[9];
#pragma unroll
  for (int k = 0; k < 9; ++k)
    wr[k] = reinterpret_cast<const float4*>(sm.w + k * C)[map.g];
  const float4 b4 = reinterpret_cast<const float4*>(sm.w + 9 * C)[map.g];
  const float br[CG] = {b4.x, b4.y, b4.z, b4.w};
  float acc[10][CG];
#pragma unroll
  for (int k = 0; k < 10; ++k)
#pragma unroll
    for (int c = 0; c < CG; ++c) acc[k][c] = 0.f;

  for (int n = 0; tile < tiles; tile += gridDim.x, ++n) {
    const int next = tile + gridDim.x;
    if (next < tiles) {                  // lands while this tile computes
      fetch_rows<TIn>(x, next / per_bar, (next % per_bar) * rows, rows, sm.raw);
      fetch_dy(dy + static_cast<size_t>(next) * dy_elems, dy_elems,
               s_dy + ((n + 1) & 1) * dy_elems);
      cp_async_commit();
    }
    conv1_bwd_tile<TDy, C>(map, sm.even(n), sm.odd(n, rows), wr, br,
                           s_dy + (n & 1) * dy_elems + CG * map.g, gelu, acc);
    if (next < tiles)
      unpack_rows<TIn, false>(sm.raw, (next % per_bar) * rows, rows,
                              sm.even(n + 1), sm.odd(n + 1, rows));
    __syncthreads();
  }

  // lanes g, g+NG, ... hold the same channels: shuffle within them, then
  // lane g < NG writes its warp's 40 terms for channels 4g..4g+3
  const int lane = threadIdx.x & 31;
  float* red = s_red + map.warp * TERMS;
#pragma unroll
  for (int k = 0; k < 10; ++k) {
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      float v = acc[k][c];
#pragma unroll
      for (int off = 16; off >= WorkMap<C>::NG; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane < WorkMap<C>::NG) red[k * C + CG * lane + c] = v;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < TERMS; e += blockDim.x) {
    float v = 0.f;
    for (int wp = 0; wp < map.warps; ++wp) v += s_red[wp * TERMS + e];
    partials[static_cast<size_t>(e) * gridDim.x + blockIdx.x] = v;
  }
}

// out[e] = Σ_blk partials[e][blk], one block per term e, in a fixed order.
__global__ void __launch_bounds__(FINISH_THREADS)
conv1_bwd_finish(const float* __restrict__ partials, int blocks,
                 float* __restrict__ out) {
  const float* p = partials + static_cast<size_t>(blockIdx.x) * blocks;
  float acc = 0.f;
  for (int i = threadIdx.x; i < blocks; i += FINISH_THREADS) acc += p[i];
  acc = block_sum<FINISH_THREADS>(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

// Dynamic shared memory of the backward: the tile staging of conv1.cuh,
// then two tiles' dy and the per-warp sums. Above 48 KB (bf16 dy: 57 KB at
// C=16, 8 rows) the kernel must be allowed it first.
template <typename TIn, typename TDy>
size_t bwd_smem_bytes(const Geometry& geo, int c) {
  const size_t dy_bytes = 2 * sizeof(TDy) * geo.rows * P_OUT * c;
  return smem_bytes<TIn>(geo.rows, c, 0) + dy_bytes +
         sizeof(float) * 10 * c * (geo.threads / 32);
}

template <typename TIn, typename TDy, int C>
cudaError_t launch_bwd(const Geometry& geo, const TIn* x, const float* w,
                       const float* b, const TDy* dy, float* partials,
                       int gelu, cudaStream_t stream) {
  const auto kernel = conv1_bwd_kernel<TIn, TDy, C>;
  const size_t smem = bwd_smem_bytes<TIn, TDy>(geo, C);
  const cudaError_t err = prepare_launch(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<geo.bwd_blocks, geo.threads, smem, stream>>>(
      x, w, b, dy, partials, geo.rows, geo.tiles, gelu);
  return cudaGetLastError();
}

template <typename TIn, typename TDy>
cudaError_t launch_c(const void* x, const float* w, const float* b,
                     const void* dy, float* partials, float* out, int m, int c,
                     int gelu, cudaStream_t stream) {
  const Geometry geo(m, c);
  const TIn* xi = static_cast<const TIn*>(x);
  const TDy* d = static_cast<const TDy*>(dy);
  cudaError_t err;
  switch (c) {
    case 4: err = launch_bwd<TIn, TDy, 4>(geo, xi, w, b, d, partials, gelu, stream); break;
    case 8: err = launch_bwd<TIn, TDy, 8>(geo, xi, w, b, d, partials, gelu, stream); break;
    case 16: err = launch_bwd<TIn, TDy, 16>(geo, xi, w, b, d, partials, gelu, stream); break;
    case 32: err = launch_bwd<TIn, TDy, 32>(geo, xi, w, b, d, partials, gelu, stream); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  conv1_bwd_finish<<<10 * c, FINISH_THREADS, 0, stream>>>(partials,
                                                         geo.bwd_blocks, out);
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
// dy_kind (bf16 or f32); x and dy 16-byte aligned. partials: f32 scratch
// of 10·c × the backward's blocks (conv1.cuh `Geometry`); out
// [10·c] f32 receives dw as [3,3,c] then db as [c]. c ∈ {4, 8, 16, 32},
// m ≥ 1. Returns the cudaError_t of the two launches.
extern "C" int mvk_first_conv_s2_bwd(const void* x, int x_kind, const float* w,
                                     const float* b, const void* dy, int dy_kind,
                                     float* partials, float* out, int m, int c,
                                     int gelu, cudaStream_t stream) {
  using namespace mvk;
  if (m <= 0 || !conv1::valid_c(c)) return cudaErrorInvalidValue;
  switch (x_kind) {
    case kU8: return launch_in<uint8_t>(x, w, b, dy, dy_kind, partials, out, m, c, gelu, stream);
    case kBF16: return launch_in<__nv_bfloat16>(x, w, b, dy, dy_kind, partials, out, m, c, gelu, stream);
    case kF32: return launch_in<float>(x, w, b, dy, dy_kind, partials, out, m, c, gelu, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Backward blocks an SM holds at once for m bars of c channels, uint8 x and
// bf16 dy (the train path's instantiation), as launched; -1 if the query
// fails. The grid assumes BWD_BLOCKS / 132.
extern "C" int mvk_first_conv_s2_bwd_resident(int m, int c) {
  using namespace mvk;
  using namespace mvk::conv1;
  if (!valid_c(c) || m <= 0) return -1;
  const Geometry g(m, c);
  const size_t smem = bwd_smem_bytes<uint8_t, __nv_bfloat16>(g, c);
  switch (c) {
    case 4: return resident_blocks(conv1_bwd_kernel<uint8_t, __nv_bfloat16, 4>, g.threads, smem);
    case 8: return resident_blocks(conv1_bwd_kernel<uint8_t, __nv_bfloat16, 8>, g.threads, smem);
    case 16: return resident_blocks(conv1_bwd_kernel<uint8_t, __nv_bfloat16, 16>, g.threads, smem);
    case 32: return resident_blocks(conv1_bwd_kernel<uint8_t, __nv_bfloat16, 32>, g.threads, smem);
    default: return -1;
  }
}
