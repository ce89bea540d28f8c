// The decoder head's last layer (models/layers.py `BarDecoderHead`, its last
// `deconvs`): a stride-2, 3x3, padding-0 transposed conv from Cin channels to
// one, its [:ho, :wo] crop of the [2h+1, 2w+1] output, its bias and the
// logits' cast, forward and backward, on channels-last (NHWC) activations.
//
// No TPU kernel is replaced: the JAX package leaves this layer to XLA, which
// fuses the conv, the crop and the bias. On the card cuDNN has no NHWC
// engine for a transposed conv to one channel: it wraps an NCHW engine in two
// layout transposes of x (201 MB at c3's 2,048 bars), nhwcToNchw in the
// forward and nchwToNhwc for the input gradient, and the conv epilogue's pair
// (csrc/conv_epilogue.cu) adds the bias, crops and casts. This pair takes the
// place of all of it:
// - forward (`head_out_fwd`): y[n, i, j] = round(round(Σ x · W) + b) over
//   the kept grid only, written [n, ho, wo] in the output's type (the f32
//   logits); an output pixel takes 1, 2 or 4 input pixels by the parity of
//   i and j, each with all Cin channels;
// - backward (`head_out_bwd`), one pass: g = round(dy), zero beyond the kept
//   grid; dx[n, a, b, :] = round(Σ over the 3x3 window g[2a+kh, 2b+kw] ·
//   W[:, kh, kw]) in x's layout; dW = round(Σ x · g) and db = round(Σ g)
//   over every pixel.
//
// Rounding is the replaced path's: the conv's sum in f32 rounded to x's
// type (cuDNN's output), the bias added and rounded again (the epilogue),
// then cast; backward, dy rounded to x's type first (the cast's backward),
// every sum in f32, dx, dW and db rounded once. The order of each f32 sum is
// this kernel's own, so values may differ from cuDNN's by an ulp.
//
// What bounds it on Hopper: bytes. c3's step (2,048 bars, Cin 16, bf16 x, f32
// logits) reads x twice (201 MB each way), dy once (101 MB) and writes the
// logits (101 MB) and dx (201 MB): 805 MB, 0.24 ms at 3.35 TB/s, against
// 5.4 GFLOP of f32 multiply-adds (0.08 ms at 67 TFLOP/s). The pair takes
// ~0.43 ms there on an H100 (56 % of the bound): the index and shared-memory
// instructions around the multiply-adds take about as long as the bytes.
//
// Design:
// - A block takes a band of ROWS x rows of one bar ("a unit"). The forward
//   first computes, for each x pixel of the band and the row above it, its
//   9 taps' dot products over the channels (p, in shared memory; each x
//   pixel by 16-byte loads, FWD_ITEMS pixels a thread with their loads in
//   flight together, W broadcast from shared memory as float4), then a
//   thread takes a 2x2 quad of the band's 2·ROWS output rows at a time,
//   whose four pixels share the p values they sum (9 reads for 9 taps in
//   all), and stores them coalesced. The row above is read again by its
//   own band's block: 1/ROWS more of x, mostly from L2.
// - The backward stages the band's 2·ROWS + 1 rows of round(dy), zero
//   outside the kept grid, in shared memory, then a thread takes a quad of
//   channels of one pixel at a time (its quad fixed, its W taps in
//   registers): dx's quad by one 8- or 16-byte store, and the dW terms
//   summed in registers over every unit the block takes (a grid-stride
//   loop over units, at most BWD_MAX_BLOCKS blocks). A thread walks its
//   staged elements and its pixels by increments, with no division in the
//   loops (a division an element made integer instructions, not bytes, the
//   limit).
// - dW and db with the same bits on every run (the epilogue's ticket
//   pattern): each block reduces its threads' sums by a fixed tree (warp
//   shuffles, then the warps in order) into partials[block][9·Cin + 1],
//   takes a ticket, and the block that takes the last one sums the partials
//   in block order (float4 loads, FINISH_BATCH in flight), writes dW and db
//   and resets the ticket. The grid is a function of the shape alone
//   (ops/head_out.py `bwd_blocks`), so the order holds under
//   torch.use_deterministic_algorithms and in a captured graph.

#include "common.cuh"

namespace mvk {
namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 8;            // x rows a unit: 2·ROWS output rows
constexpr int TAPS = 9;
constexpr int FWD_ITEMS = 3;       // x pixels a thread in flight (forward)
constexpr int BWD_ITEMS = 4;       // (pixel, channel quad)s a thread in flight (backward)
constexpr int STAGE_UNROLL = 9;    // dy loads a thread in flight while staging
constexpr int FINISH_BATCH = 8;    // partials' loads in flight a thread
constexpr int SMEM_CAP = 48 * 1024;

struct Shape {
  int n, h, w, cin;   // x [n, h, w, cin]
  int ho, wo;         // the kept grid of the [2h + 1, 2w + 1] output
};

template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return round_bf16(v);
}

// V = 4 or 8 consecutive elements by one 8- or 16-byte load (bf16), or
// V / 4 16-byte loads (f32)
template <int V>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p, float* v) {
  unsigned w[V / 2];
  if constexpr (V == 8) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = r.x; w[1] = r.y; w[2] = r.z; w[3] = r.w;
  } else {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = r.x; w[1] = r.y;
  }
#pragma unroll
  for (int k = 0; k < V / 2; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
template <int V>
__device__ __forceinline__ void load_v(const float* p, float* v) {
#pragma unroll
  for (int k = 0; k < V / 4; ++k) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p) + k);
    v[4 * k] = f.x; v[4 * k + 1] = f.y; v[4 * k + 2] = f.z; v[4 * k + 3] = f.w;
  }
}

// 4 elements by one store, rounded to nearest even
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const unsigned*>(&a),
                                            *reinterpret_cast<const unsigned*>(&b));
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// -- forward -----------------------------------------------------------------------

// Shared memory: W as [cin][3] float4 (taps 0-3, 4-7, 8 and zeros), then p
// [(ROWS + 1) · w][9]: p row r is x row a0 - 1 + r.
template <typename TX, typename TO, int V>
__global__ void __launch_bounds__(THREADS)
head_out_fwd(const TX* __restrict__ x, const TX* __restrict__ wgt, const TX* __restrict__ bias,
             TO* __restrict__ y, Shape s, int bands) {
  extern __shared__ float4 smem[];
  float4* w_s = smem;
  float* p_s = reinterpret_cast<float*>(smem + 3 * s.cin);
  const int n = blockIdx.x / bands, a0 = (blockIdx.x - n * bands) * ROWS;
  for (int i = threadIdx.x; i < 12 * s.cin; i += THREADS) {
    const int c = i / 12, k = i - c * 12;
    reinterpret_cast<float*>(w_s)[i] = k < TAPS ? to_f32(wgt[c * TAPS + k]) : 0.f;
  }
  __syncthreads();

  // p[r][b][k] = Σ_c x[n, a0 - 1 + r, b, c] · W[c, k] (zero outside x)
  const int items = (ROWS + 1) * s.w;
  for (int base = threadIdx.x; base < items; base += FWD_ITEMS * THREADS) {
    const TX* px[FWD_ITEMS];
    bool in[FWD_ITEMS];
#pragma unroll
    for (int u = 0; u < FWD_ITEMS; ++u) {
      const int it = base + u * THREADS;
      const int r = it / s.w, b = it - r * s.w, a = a0 - 1 + r;
      in[u] = it < items && a >= 0 && a < s.h;
      px[u] = x + ((n * s.h + (in[u] ? a : 0)) * s.w + b) * s.cin;
    }
    float p[FWD_ITEMS][TAPS] = {};
    for (int c0 = 0; c0 < s.cin; c0 += V) {
      float v[FWD_ITEMS][V];
#pragma unroll
      for (int u = 0; u < FWD_ITEMS; ++u) {
        if (in[u]) {
          load_v<V>(px[u] + c0, v[u]);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) v[u][j] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float4 w0 = w_s[3 * (c0 + j)], w1 = w_s[3 * (c0 + j) + 1],
                     w2 = w_s[3 * (c0 + j) + 2];
        const float wk[TAPS] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w, w2.x};
#pragma unroll
        for (int u = 0; u < FWD_ITEMS; ++u)
#pragma unroll
          for (int k = 0; k < TAPS; ++k) p[u][k] = fmaf(v[u][j], wk[k], p[u][k]);
      }
    }
#pragma unroll
    for (int u = 0; u < FWD_ITEMS; ++u) {
      const int it = base + u * THREADS;
      if (it < items)
#pragma unroll
        for (int k = 0; k < TAPS; ++k) p_s[it * TAPS + k] = p[u][k];
    }
  }
  __syncthreads();

  // a thread takes a 2x2 quad of outputs at a time: rows 2a0 + 2m (even)
  // and 2a0 + 2m + 1 (odd), columns 2q and 2q + 1. The even row takes p
  // rows m + 1 (kh = 0) and m (kh = 2), the odd one row m + 1 (kh = 1);
  // the even column p columns q (kw = 0) and q - 1 (kw = 2) where they lie
  // in x, the odd one column q (kw = 1). Each sum starts from 0 and adds its
  // taps kh-major.
  const int i0 = 2 * a0, qcols = (s.wo + 1) / 2;
  const float bv = to_f32(bias[0]);
  auto out = [bv](float acc) {
    return from_f32<TO>(round_to<TX>(round_to<TX>(acc) + bv));
  };
  for (int e = threadIdx.x; e < ROWS * qcols; e += THREADS) {
    const int m = e / qcols, q = e - m * qcols, i = i0 + 2 * m, j = 2 * q;
    if (i >= s.ho) break;
    const float* lo = p_s + ((m + 1) * s.w + q) * TAPS;   // p row m + 1, column q
    const float* hi = lo - s.w * TAPS;                    // p row m, column q
    const bool in_q = q < s.w, in_l = q > 0;
    const float a00 = in_q ? lo[0] : 0.f, a01 = in_q ? lo[1] : 0.f;
    const float a10 = in_q ? lo[3] : 0.f, a11 = in_q ? lo[4] : 0.f;
    const float l02 = in_l ? lo[2 - TAPS] : 0.f, l12 = in_l ? lo[5 - TAPS] : 0.f;
    const float h20 = in_q ? hi[6] : 0.f, h21 = in_q ? hi[7] : 0.f;
    const float hl22 = in_l ? hi[8 - TAPS] : 0.f;
    TO* yq = y + (n * s.ho + i) * s.wo + j;
    const bool j1 = j + 1 < s.wo;
    yq[0] = out(((0.f + a00) + l02) + h20 + hl22);
    if (j1) yq[1] = out((0.f + a01) + h21);
    if (i + 1 < s.ho) {
      yq[s.wo] = out((0.f + a10) + l12);
      if (j1) yq[s.wo + 1] = out(0.f + a11);
    }
  }
}

// -- backward ----------------------------------------------------------------------

// Shared memory: W as [9][cin] (a quad of channels at a tap is one float4),
// then the staged g [2·ROWS + 1][2w + 1], which the block's reductions reuse.
template <typename TD, typename TX>
__global__ void __launch_bounds__(THREADS, 2)
head_out_bwd(const TD* __restrict__ dy, const TX* __restrict__ x, const TX* __restrict__ wgt,
             TX* __restrict__ dx, float* __restrict__ partials, unsigned* __restrict__ ticket,
             TX* __restrict__ dw, TX* __restrict__ db, Shape s, int bands) {
  extern __shared__ float4 smem[];
  float* w_s = reinterpret_cast<float*>(smem);
  float* g_s = w_s + TAPS * s.cin;
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int quads = s.cin / 4, q = tid % quads, slot = tid / quads, slots = THREADS / quads;
  const int gw = 2 * s.w + 1, grows = 2 * ROWS + 1, staged = grows * gw;
  for (int i = tid; i < TAPS * s.cin; i += THREADS) {
    const int k = i / s.cin, c = i - k * s.cin;
    w_s[i] = to_f32(wgt[c * TAPS + k]);
  }
  __syncthreads();
  float wq[TAPS][4];
#pragma unroll
  for (int k = 0; k < TAPS; ++k) {
    const float4 f = reinterpret_cast<const float4*>(w_s + k * s.cin)[q];
    wq[k][0] = f.x; wq[k][1] = f.y; wq[k][2] = f.z; wq[k][3] = f.w;
  }
  float acc[TAPS][4] = {};
  float dsum = 0.f;
  // a thread's walks, by increments: its staged elements tid, tid +
  // THREADS, ... at (row, column) (r0, j0) + k (dr, dj), and its pixels
  // slot, slot + slots, ... of a band at (row, column) (ar0, b0) + k
  // (d_ar, d_b), each column wrapping into the next row
  const int r0 = tid / gw, j0 = tid - r0 * gw;
  const int dr = THREADS / gw, dj = THREADS - dr * gw;
  const int ar0 = slot / s.w, b0 = slot - ar0 * s.w;
  const int d_ar = slots / s.w, d_b = slots - d_ar * s.w;

  const int units = s.n * bands;
  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int n = unit / bands, band = unit - n * bands, a0 = band * ROWS;
    // the g rows whose sum is this unit's share of db: its 2·ROWS, and the
    // last band the row below them too
    const int own = (band == bands - 1 ? grows : 2 * ROWS) * gw;
    const TD* dyn = dy + (n * s.ho + 2 * a0) * s.wo;
    const int rows_in = s.ho - 2 * a0;          // staged rows inside the kept grid
    int r = r0, j = j0;
    for (int e0 = tid; e0 < staged; e0 += STAGE_UNROLL * THREADS) {
      float v[STAGE_UNROLL];
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        v[u] = e0 + u * THREADS < staged && r < rows_in && j < s.wo ? to_f32(dyn[r * s.wo + j])
                                                                     : 0.f;
        r += dr;
        j += dj;
        if (j >= gw) { j -= gw; ++r; }
      }
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int e = e0 + u * THREADS;
        if (e < staged) {
          const float g = round_to<TX>(v[u]);
          g_s[e] = g;
          if (e < own) dsum += g;
        }
      }
    }
    __syncthreads();

    const int npix = min(ROWS, s.h - a0) * s.w;
    const TX* xb = x + (n * s.h + a0) * s.w * s.cin + 4 * q;
    TX* dxb = dx + (n * s.h + a0) * s.w * s.cin + 4 * q;
    int pi = slot, ar = ar0, b = b0;
    while (pi < npix) {
      float xv[BWD_ITEMS][4];
      int at[BWD_ITEMS], gat[BWD_ITEMS];
#pragma unroll
      for (int u = 0; u < BWD_ITEMS; ++u) {
        at[u] = pi < npix ? pi : -1;
        gat[u] = 2 * (ar * gw + b);
        if (pi < npix) load_v<4>(xb + pi * s.cin, xv[u]);
        pi += slots;
        ar += d_ar;
        b += d_b;
        if (b >= s.w) { b -= s.w; ++ar; }
      }
#pragma unroll
      for (int u = 0; u < BWD_ITEMS; ++u) {
        if (at[u] < 0) continue;
        const float* gp = g_s + gat[u];
        float g[TAPS];
#pragma unroll
        for (int kh = 0; kh < 3; ++kh)
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) g[kh * 3 + kw] = gp[kh * gw + kw];
        float d[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float t = 0.f;
#pragma unroll
          for (int k = 0; k < TAPS; ++k) t = fmaf(g[k], wq[k][jj], t);
          d[jj] = t;
        }
#pragma unroll
        for (int k = 0; k < TAPS; ++k)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[k][jj] = fmaf(xv[u][jj], g[k], acc[k][jj]);
        store4(dxb + at[u] * s.cin, d);
      }
    }
    __syncthreads();
  }

  // the block's sums: lanes of one quad by a butterfly over the warp, then
  // the warps in order, into partials[block][c · 9 + k], db last
  for (int off = quads; off < 32; off <<= 1)
#pragma unroll
    for (int k = 0; k < TAPS; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[k][j] += __shfl_xor_sync(0xffffffffu, acc[k][j], off);
  const int warp = tid >> 5, lane = tid & 31;
  if (lane < quads)
#pragma unroll
    for (int k = 0; k < TAPS; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) g_s[((warp * quads + lane) * TAPS + k) * 4 + j] = acc[k][j];
  __syncthreads();
  const int cols = TAPS * s.cin, stride = (cols + 4) & ~3;
  float* part = partials + blockIdx.x * stride;
  for (int col = tid; col < stride; col += THREADS) {
    if (col >= cols) {
      if (col > cols) part[col] = 0.f;
      continue;
    }
    const int c = col / TAPS, k = col - c * TAPS;
    float t = 0.f;
    for (int wi = 0; wi < WARPS; ++wi) t += g_s[((wi * quads + (c >> 2)) * TAPS + k) * 4 + (c & 3)];
    part[col] = t;
  }
  const float dball = block_sum<THREADS>(dsum);
  if (tid == 0) part[cols] = dball;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block: each column's sum of the partials in block order,
  // `lanes` threads across the column quads, `segs` down the blocks
  const int cq = stride / 4, lanes = min(cq, THREADS), segs = THREADS / lanes;
  const int ln = tid % lanes, seg = tid / lanes;
  float4* red = reinterpret_cast<float4*>(g_s);
  for (int base = 0; base < cq; base += lanes) {
    const int c4 = base + ln;
    const bool active = c4 < cq && seg < segs;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    if (active) {
      for (int b0 = seg; b0 < gridDim.x; b0 += FINISH_BATCH * segs) {
        float4 v[FINISH_BATCH];
#pragma unroll
        for (int u = 0; u < FINISH_BATCH; ++u) {
          const int bi = b0 + u * segs;
          v[u] = bi < gridDim.x ? __ldcg(reinterpret_cast<const float4*>(partials + bi * stride) + c4)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < FINISH_BATCH; ++u) {
          sum.x += v[u].x; sum.y += v[u].y; sum.z += v[u].z; sum.w += v[u].w;
        }
      }
      red[seg * lanes + ln] = sum;
    }
    __syncthreads();
    if (active && seg == 0) {
      float4 t = red[ln];
      for (int sg = 1; sg < segs; ++sg) {
        const float4 o = red[sg * lanes + ln];
        t.x += o.x; t.y += o.y; t.z += o.z; t.w += o.w;
      }
      const float tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int col = 4 * c4 + m;
        if (col < cols) dw[col] = from_f32<TX>(tv[m]);
        else if (col == cols) db[0] = from_f32<TX>(tv[m]);
      }
    }
    __syncthreads();
  }
  if (tid == 0) *ticket = 0u;
}

// -- launches ------------------------------------------------------------------------

bool valid(const Shape& s) {
  const int quads = s.cin / 4;
  return s.n > 0 && s.h > 0 && s.w > 0 && s.cin >= 4 && s.cin <= 128 && s.cin % 4 == 0 &&
         (quads & (quads - 1)) == 0 && s.ho > 0 && s.ho <= 2 * s.h + 1 && s.wo > 0 &&
         s.wo <= 2 * s.w + 1;
}

size_t fwd_smem(const Shape& s) {
  return sizeof(float4) * 3 * s.cin + sizeof(float) * (ROWS + 1) * s.w * TAPS;
}

size_t bwd_smem(const Shape& s) {
  const int staged = (2 * ROWS + 1) * (2 * s.w + 1);
  const int reduce = WARPS * TAPS * s.cin;
  int g = staged > reduce ? staged : reduce;
  if (g < 4 * THREADS) g = 4 * THREADS;
  return sizeof(float) * (TAPS * s.cin + g);
}

template <typename TX, typename TO>
cudaError_t launch_fwd(const void* x, const void* wgt, const void* bias, void* y, const Shape& s,
                       cudaStream_t stream) {
  const int bands = (s.ho + 2 * ROWS - 1) / (2 * ROWS);
  const size_t smem = fwd_smem(s);
  const TX* xp = static_cast<const TX*>(x);
  const TX* wp = static_cast<const TX*>(wgt);
  const TX* bp = static_cast<const TX*>(bias);
  TO* yp = static_cast<TO*>(y);
  if (s.cin % 8 == 0)
    head_out_fwd<TX, TO, 8><<<s.n * bands, THREADS, smem, stream>>>(xp, wp, bp, yp, s, bands);
  else
    head_out_fwd<TX, TO, 4><<<s.n * bands, THREADS, smem, stream>>>(xp, wp, bp, yp, s, bands);
  return cudaGetLastError();
}

template <typename TD, typename TX>
cudaError_t launch_bwd(const void* dy, const void* x, const void* wgt, void* dx, float* partials,
                       unsigned* ticket, void* dw, void* db, const Shape& s, int blocks,
                       cudaStream_t stream) {
  const int bands = (s.h + ROWS - 1) / ROWS;
  head_out_bwd<TD, TX><<<blocks, THREADS, bwd_smem(s), stream>>>(
      static_cast<const TD*>(dy), static_cast<const TX*>(x), static_cast<const TX*>(wgt),
      static_cast<TX*>(dx), partials, ticket, static_cast<TX*>(dw), static_cast<TX*>(db), s,
      bands);
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
  const void* x; const void* wgt; const void* bias; void* y; Shape s; cudaStream_t stream;
  template <typename TX, typename TO> cudaError_t operator()() const {
    return launch_fwd<TX, TO>(x, wgt, bias, y, s, stream);
  }
};

struct BwdArgs {
  const void* dy; const void* x; const void* wgt; void* dx; float* partials; unsigned* ticket;
  void* dw; void* db; Shape s; int blocks; cudaStream_t stream;
  template <typename TD, typename TX> cudaError_t operator()() const {
    return launch_bwd<TD, TX>(dy, x, wgt, dx, partials, ticket, dw, db, s, blocks, stream);
  }
};

}  // namespace
}  // namespace mvk

// Forward. x [n, h, w, cin], W [cin, 1, 3, 3] and the bias [1] of x_kind, y
// [n, ho, wo] of y_kind (bf16 or f32; x 16-byte aligned; cin 4 to 128, 4
// times a power of two; ho <= 2h + 1, wo <= 2w + 1; each tensor under 2^31
// elements).
extern "C" int mvk_head_out_fwd(const void* x, int x_kind, const void* wgt, const void* bias,
                                void* y, int y_kind, int n, int h, int w, int cin, int ho,
                                int wo, cudaStream_t stream) {
  using namespace mvk;
  const Shape s{n, h, w, cin, ho, wo};
  if (!valid(s) || fwd_smem(s) > SMEM_CAP) return cudaErrorInvalidValue;
  return dispatch_kinds(x_kind, y_kind, FwdArgs{x, wgt, bias, y, s, stream});
}

// Backward. dy [n, ho, wo] of dy_kind; x, W, dx [n, h, w, cin], dW
// [cin, 1, 3, 3] and db [1] of x_kind; the workspace: partials [blocks,
// (9·cin + 4) & ~3] f32 (16-byte aligned) and the stream's ticket, 0 before
// and after every launch; `blocks` as ops/head_out.py `bwd_blocks` gives it.
extern "C" int mvk_head_out_bwd(const void* dy, int dy_kind, const void* x, int x_kind,
                                const void* wgt, void* dx, float* partials, unsigned* ticket,
                                void* dw, void* db, int n, int h, int w, int cin, int ho, int wo,
                                int blocks, cudaStream_t stream) {
  using namespace mvk;
  const Shape s{n, h, w, cin, ho, wo};
  if (!valid(s) || blocks <= 0 || bwd_smem(s) > SMEM_CAP) return cudaErrorInvalidValue;
  return dispatch_kinds(dy_kind, x_kind, BwdArgs{dy, x, wgt, dx, partials, ticket, dw, db, s,
                                                 blocks, stream});
}
