// Shared by the first conv's forward (conv1.cu) and backward
// (conv1_bwd.cu): the launch geometry, the staging of input rows in shared
// memory, the per-thread work map and the tanh-GELU with its derivative.
#pragma once

#include "common.cuh"

namespace mvk {
namespace conv1 {

constexpr int T_IN = 96, P_IN = 128, T_OUT = 48, P_OUT = 64;

// Launch geometry, a function of M and C alone (mirrored by ops/conv1.py
// `geometry`, which the CPU tests check, and checked against it on the
// card). A tile is `rows` output rows of one bar, all 64 pitches and all C
// channels: the largest of 8, 4, 2, 1 rows that keeps a thread at no more
// than 8 positions (128/C rows at 256 threads) and still gives
// TARGET_TILES tiles; 1 when none does. Each kernel launches at most as
// many blocks as an H100 holds at once (FWD_BLOCKS, BWD_BLOCKS: blocks a
// SM × 132, constants, not read from the card) and a block walks tiles
// blockIdx.x, blockIdx.x + gridDim.x, ..., staging the next tile's input
// while it computes the current one. At M=256, C=16: 8 rows, 1,536 tiles,
// 528 forward and 264 backward blocks; at serve's M=4: 1 row, 192 tiles
// and blocks.
constexpr int MAX_THREADS = 256;
constexpr int TARGET_TILES = 264;       // two for each of an H100's 132 SMs
constexpr int FWD_BLOCKS = 4 * 132;     // 4 blocks an SM at 64 registers
constexpr int BWD_BLOCKS = 2 * 132;     // 2 blocks an SM at 128 registers
constexpr int CG = 4;                   // channels a thread owns

inline bool valid_c(int c) { return c == 4 || c == 8 || c == 16 || c == 32; }

inline int tile_rows(int m, int c) {
  const int cands[] = {8, 4, 2, 1};
  for (int r : cands)
    if (r <= 128 / c && static_cast<long long>(m) * (T_OUT / r) >= TARGET_TILES)
      return r;
  return 1;
}

inline int block_threads(int rows, int c) {
  const int items = rows * P_OUT * (c / CG);    // (position, channel group)
  return items < MAX_THREADS ? items : MAX_THREADS;
}

struct Geometry {
  int rows, tiles, threads, fwd_blocks, bwd_blocks;
  Geometry(int m, int c)
      : rows(tile_rows(m, c)), tiles(m * (T_OUT / rows)),
        threads(block_threads(rows, c)),
        fwd_blocks(tiles < FWD_BLOCKS ? tiles : FWD_BLOCKS),
        bwd_blocks(tiles < BWD_BLOCKS ? tiles : BWD_BLOCKS) {}
};

// Before a launch: ask for the whole unified L1/shared memory as shared, so
// that the blocks the grid assumes resident (FWD_BLOCKS, BWD_BLOCKS) fit on
// an SM, and allow `smem` dynamic bytes where that is above 48 KB.
template <typename Kernel>
inline cudaError_t prepare_launch(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  return err;
}

// Blocks of `kernel` an SM holds at once (prepared as for its launch).
template <typename Kernel>
inline int resident_blocks(Kernel kernel, int threads, size_t smem) {
  int n = 0;
  if (prepare_launch(kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
}

// Staged input rows in shared memory, as f32 in two pitch planes so that
// neighbouring threads read neighbouring words: even[r][jj] = pitch 2jj,
// odd[r][ODD_OFF + jj] = pitch 2jj+1, odd[r][ODD_OFF - 1] = 0 (the pad at
// pitch -1), for staged row r = input row 2*i0 - 1 + r. The offset keeps
// each plane's rows 16-byte aligned for vector stores.
constexpr int EVEN_STRIDE = P_OUT;
constexpr int ODD_OFF = 4;
constexpr int ODD_STRIDE = P_OUT + ODD_OFF;

__host__ __device__ constexpr int staged_floats(int rows) {
  return (2 * rows + 1) * (EVEN_STRIDE + ODD_STRIDE);
}

// Bytes of a tile's input rows as loaded (the cp.async landing buffer).
template <typename TIn>
__host__ __device__ constexpr int raw_bytes(int rows) {
  return (2 * rows + 1) * P_IN * static_cast<int>(sizeof(TIn));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void store_floats(float* dst, const float* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k)
      reinterpret_cast<float4*>(dst)[k] =
          make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  } else {
    static_assert(N == 2, "chunk");
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  }
}

// Staging of a tile's input rows 2*i0-1 .. 2*i0+2*rows-1 of bar m (row -1
// is the zero pad; rows past the bottom never occur, 2*47+1 = 95), in two
// halves so that the copy overlaps the previous tile's compute:
// `fetch_rows` starts one 16-byte cp.async a chunk into `raw` (the caller
// commits the group); `unpack_rows` waits for all of the calling thread's
// copies and converts its own chunks to f32 in the planes. Both walk the
// same chunks for a thread, so no barrier is needed between them; the
// caller synchronises after unpacking, before the planes are read.
template <typename TIn>
struct Chunks {
  static constexpr int E = 16 / static_cast<int>(sizeof(TIn));  // elements
  static constexpr int PER_ROW = P_IN / E;
};

template <typename TIn>
__device__ __forceinline__ void fetch_rows(const TIn* __restrict__ x, int m,
                                           int i0, int rows, uint4* raw) {
  using K = Chunks<TIn>;
  const TIn* xm = x + static_cast<size_t>(m) * T_IN * P_IN;
  const int r0 = 2 * i0 - 1;
  for (int k = threadIdx.x; k < (2 * rows + 1) * K::PER_ROW; k += blockDim.x) {
    const int row = r0 + k / K::PER_ROW;
    if (row >= 0) cp_async16(raw + k, xm + row * P_IN + (k % K::PER_ROW) * K::E);
  }
}

template <typename TIn, bool ROUND_BF16>
__device__ __forceinline__ void unpack_rows(const uint4* raw, int i0, int rows,
                                            float* s_even, float* s_odd) {
  using K = Chunks<TIn>;
  constexpr int H = K::E / 2;
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  const int r0 = 2 * i0 - 1;
  for (int k = threadIdx.x; k < (2 * rows + 1) * K::PER_ROW; k += blockDim.x) {
    const int r = k / K::PER_ROW, q = k % K::PER_ROW;
    alignas(16) TIn v[K::E];
    *reinterpret_cast<uint4*>(v) =
        r0 + r >= 0 ? raw[k] : make_uint4(0u, 0u, 0u, 0u);
    float ev[H], od[H];
#pragma unroll
    for (int e = 0; e < K::E; ++e) {
      float f;
      if constexpr (sizeof(TIn) == 1)   // 0x4B0000uu is 2^23 + u
        f = __int_as_float(__byte_perm(reinterpret_cast<const unsigned*>(v)[e / 4],
                                       0x4B000000u, 0x7540 + e % 4)) - 8388608.f;
      else
        f = to_f32(v[e]);
      if constexpr (ROUND_BF16 && sizeof(TIn) == 4)   // bytes and bf16 are exact
        f = round_bf16(f);
      if (e & 1) od[e >> 1] = f;
      else ev[e >> 1] = f;
    }
    store_floats<H>(s_even + r * EVEN_STRIDE + q * H, ev);
    store_floats<H>(s_odd + r * ODD_STRIDE + ODD_OFF + q * H, od);
  }
  for (int r = threadIdx.x; r < 2 * rows + 1; r += blockDim.x)
    s_odd[r * ODD_STRIDE + ODD_OFF - 1] = 0.f;
}

// A block's dynamic shared memory: the cp.async landing buffer (first, for
// its 16-byte alignment), the [9][C] weights and the [C] bias, two sets of
// pitch planes (the tile being computed and the next), then `tail` floats
// of the kernel's own. Every part is a multiple of 16 bytes.
template <typename TIn>
__host__ __device__ constexpr size_t smem_bytes(int rows, int c, int tail) {
  return raw_bytes<TIn>(rows) +
         sizeof(float) * (10 * c + 2 * staged_floats(rows) + tail);
}

template <typename TIn>
struct TileSmem {
  uint4* raw;
  float* w;          // [9][C], then b [C]
  float* planes;     // two sets of staged_floats(rows)
  float* tail;
  int set_floats;
  __device__ __forceinline__ TileSmem(float4* base, int rows, int c) {
    raw = reinterpret_cast<uint4*>(base);
    w = reinterpret_cast<float*>(base) + raw_bytes<TIn>(rows) / 4;
    planes = w + 10 * c;
    set_floats = staged_floats(rows);
    tail = planes + 2 * set_floats;
  }
  // plane set n % 2: its even plane, then its odd plane
  __device__ __forceinline__ float* even(int n) const {
    return planes + (n & 1) * set_floats;
  }
  __device__ __forceinline__ float* odd(int n, int rows) const {
    return even(n) + (2 * rows + 1) * EVEN_STRIDE;
  }
};

// The per-thread work map, the same in both kernels (mirrored by the CPU
// tests). Lane l owns channel group g = l % NG (channels 4g..4g+3) of pitch
// offset jj = l / NG, so a warp's lanes cover JW = 32/NG neighbouring
// positions and their NHWC outputs (or dy) form one contiguous span. The
// block's rows·64/JW such spans ("slots") go to its warps in turn.
template <int C>
struct WorkMap {
  static constexpr int NG = C / CG;
  static constexpr int JW = 32 / NG;
  static constexpr int SLOTS_PER_ROW = P_OUT / JW;
  int g, jj, warp, warps, slots;
  __device__ __forceinline__ explicit WorkMap(int rows) {
    const int lane = threadIdx.x & 31;
    g = lane % NG;
    jj = lane / NG;
    warp = threadIdx.x >> 5;
    warps = blockDim.x >> 5;
    slots = rows * SLOTS_PER_ROW;
  }
  __device__ __forceinline__ int row(int s) const { return s / SLOTS_PER_ROW; }
  __device__ __forceinline__ int pitch(int s) const {
    return (s % SLOTS_PER_ROW) * JW + jj;
  }
};

// The 9 taps of output (ti, j) from the staged planes, in w's [kt][kp]
// order: pitches 2j-1, 2j, 2j+1 of input rows 2i-1, 2i, 2i+1.
__device__ __forceinline__ void load_taps(const float* s_even,
                                          const float* s_odd, int ti, int j,
                                          float* xs) {
#pragma unroll
  for (int kt = 0; kt < 3; ++kt) {
    const int r = 2 * ti + kt;
    xs[3 * kt + 0] = s_odd[r * ODD_STRIDE + ODD_OFF - 1 + j];
    xs[3 * kt + 1] = s_even[r * EVEN_STRIDE + j];
    xs[3 * kt + 2] = s_odd[r * ODD_STRIDE + ODD_OFF + j];
  }
}

// z[c] = b[c] + Σ_k x_k·w[k][c] for a thread's 4 channels, in w's [kt][kp]
// order: the forward computes it so and the backward's f32 recompute
// repeats it. `w[k]` yields the 4 channels' weights of tap k as a float4,
// from registers.
__device__ __forceinline__ void conv_taps(const float* xs,
                                          const float4 (&w)[9],
                                          const float* b, float* z) {
#pragma unroll
  for (int c = 0; c < CG; ++c) z[c] = b[c];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float4 wk = w[k];
    z[0] = fmaf(xs[k], wk.x, z[0]);
    z[1] = fmaf(xs[k], wk.y, z[1]);
    z[2] = fmaf(xs[k], wk.z, z[2]);
    z[3] = fmaf(xs[k], wk.w, z[3]);
  }
}

// tanh-GELU, gelu(z) = 0.5·z·(1 + tanh(u)) with u = K0·(z + K1·z³), written
// through r = 1/(1 + e^{2u}), so that tanh(u) = 1 − 2r and gelu(z) = z − z·r:
// ex2.approx and rcp.approx (a few ulp each) and a handful of f32
// operations, instead of libdevice's precise tanhf. Values come in pairs
// that share one reciprocal: 1/d0 = d1·q and 1/d1 = d0·q with q = 1/(d0·d1),
// so a value costs 1.5 MUFU operations. e^{2u} is capped at 2^60 so that
// d0·d1 stays finite; there r < 1e-18 and both forms round alike.
constexpr float GELU_K0 = 0.7978845608028654f;   // sqrt(2/pi)
constexpr float GELU_K1 = 0.044715f;
constexpr float GELU_C0 = 2.302208198144325f;    // 2·K0·log2(e)
constexpr float GELU_C1 = 0.1029432395800235f;   // 2·K0·K1·log2(e)

__device__ __forceinline__ void gelu_tanh2(float& z0, float& z1) {
  const float d0 = 1.0f + ex2_approx(fminf(z0 * fmaf(GELU_C1, z0 * z0, GELU_C0), 60.f));
  const float d1 = 1.0f + ex2_approx(fminf(z1 * fmaf(GELU_C1, z1 * z1, GELU_C0), 60.f));
  const float q = rcp_approx(d0 * d1);
  z0 = fmaf(-z0, d1 * q, z0);
  z1 = fmaf(-z1, d0 * q, z1);
}

// For gelu': r of z0 and z1 as above, but 0 where e^{2u} reached the cap
// (z·r·z² would not vanish there), and 1 − r = e^{2u}·r, which does not
// cancel where r is near 1.
__device__ __forceinline__ void gelu_r2(float z0, float z1, float& r0,
                                        float& r1, float& omr0, float& omr1) {
  const float v0 = fminf(z0 * fmaf(GELU_C1, z0 * z0, GELU_C0), 60.f);
  const float v1 = fminf(z1 * fmaf(GELU_C1, z1 * z1, GELU_C0), 60.f);
  const float e0 = ex2_approx(v0), e1 = ex2_approx(v1);
  const float d0 = 1.0f + e0, d1 = 1.0f + e1;
  const float q = rcp_approx(d0 * d1);
  r0 = d1 * q;
  r1 = d0 * q;
  omr0 = e0 * r0;
  omr1 = e1 * r1;
  if (v0 == 60.f) r0 = 0.f;
  if (v1 == 60.f) r1 = 0.f;
}

// d/dz of gelu_tanh: (1 − r) + 2·K0·z·r·(1 − r)·(1 + 3·K1·z²), with the
// product taken so that no factor overflows where 1 − r or r is 0.
__device__ __forceinline__ float gelu_grad_of(float z, float r, float omr) {
  const float p = (z * r) * omr;
  return fmaf(p * (2.0f * GELU_K0), fmaf(3.0f * GELU_K1, z * z, 1.0f), omr);
}

}  // namespace conv1
}  // namespace mvk
