// 4-bit K-major quantized matmul (i4t), with an optional SiLU·mul epilogue.
//
// Replaces the Pallas kernels of booster_tpu/ops/pallas_qmm.py:
//   _tqmm_i4_gd_kernel   (M = 1, group-dot form)           -> qmm_kernel<G, 1, false>
//   _tqmm_i4_kernel      (M > 1, dequantize then dot)      -> qmm_kernel<G, kRowsTile, false>
//   _gateup_i4_gd_kernel (M = 1, fused gate+up, silu·mul)  -> qmm_kernel<G, 1, true>
//   _gateup_i4_kernel    (M > 1, fused gate+up, silu·mul)  -> qmm_kernel<G, kRowsTile, true>
//
// y[m, n] = sum_k x[m, k] * W[n, k],  W = (q - zero) * s - mins, group G along k.
// Payload qw [K/2, N] u8: byte row r holds element r (low nibble) and element
// r + K/2 (high nibble) of every column.  Scale planes s [R, K/(2G), N] bf16:
// rows 0/1 scale the two halves, rows 2/3 (R = 4) hold their affine mins.
//
// Numerics (the plain versions in ops/qmm.py repeat them):
//   M = 1:  per half h and group g, p = sum bf16(x)·q (raw nibble, f32),
//           xs = sum f32(bf16 x), p -= zero·xs, c = f32(bf16 s)·p - f32(bf16 m)·xs,
//           y = sum of c over groups and halves.
//   M > 1:  w = bf16(bf16(q - zero)·bf16(s)); y = sum bf16(x)·w in f32, minus
//           the min term sum_g xs_g·f32(bf16 m_g) with f32 group sums xs.
//   gate-up: g, u = bf16 of the f32 sums of columns n and ff + n;
//           out = bf16(bf16(g·bf16(sigmoid_f32(g)))·u) — torch's own op
//           sequence for x·sigmoid(x) then ·u, so the fused kernel equals
//           qmm + act + mul bit for bit.  Both forms run the same per-column
//           code with the same K split and the same reduction order (the
//           split depends on K only).
//
// What bounds it on the H100: at decode (M = 1) the payload and scale bytes
// (half a byte of payload and 1/16 byte of bf16 scale per weight at G = 32)
// over 3.35 TB/s — a matvec does four FLOPs per payload byte.  The matrices
// of a 1.1B model are 2-30 MB, so the whole matrix should be in flight at
// once.  Design: one thread per output column, so the 32 lanes of a warp read
// 32 consecutive bytes of a payload row (one full sector); one warp per group
// of G payload rows issues all G loads before using any; a block is 8 warps
// (8 consecutive groups) over 32 columns, and K is split across blocks
// (gridDim.y), so N = 2048, K = 2048 runs 256 blocks.  The 8 warps reduce
// through shared memory, the blocks of a column tile write f32 partials, and
// the last block to finish (an atomic ticket) sums them in split order and
// applies the epilogue: one launch, a fixed summation order.  x for the
// block's rows is staged in shared memory as f32 and read as broadcasts.
// Nibbles become floats with the 0x4B000000 trick (an OR and an FADD, full
// rate).  At M > 1 each block takes kRowsTile rows of x and re-uses each
// dequantized weight for all of them; tensor cores (wgmma) are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "bf16_ops.cuh"

namespace {

constexpr int kWarps = 8;     // groups per block (one per warp)
constexpr int kRowsTile = 8;  // rows of x per block at M > 1

// exact float of a small unsigned integer (< 2^23): an OR and an FADD
__device__ __forceinline__ float u2f(uint32_t v) {
  return __fsub_rn(__uint_as_float(0x4B000000u | v), 8388608.0f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct Params {
  const uint16_t* x;   // [M, K] bf16
  const uint8_t* qw;   // [K/2, N]
  const uint16_t* s;   // [R, K/(2G), N] bf16
  void* out;           // [M, N] f32, or [M, N/2] bf16 for gate-up
  float* part;         // [KS, NC, M, ncols] f32 partials (KS > 1), else null
  int* tickets;        // [gridDim.z * gridDim.x] zeros, reset by the last block
  int M, K, N, R, zero, ff;
};

// One warp's sums of column `col` over group `g` for rows m0.. of x (in
// shared memory, f32 [MT][2][kWarps·G], the block's groups).  M = 1 takes the
// group-dot form, M > 1 dequantizes.
template <int G, int MT>
__device__ __forceinline__ void group_sums(const Params& p, const float* xsm, int col, int g,
                                           int gl, float* acc) {
  const int half = p.K >> 1;
  const size_t plane = static_cast<size_t>(half / G) * p.N;
  const size_t so = static_cast<size_t>(g) * p.N + col;
  const uint8_t* w = p.qw + static_cast<size_t>(g) * G * p.N + col;
  const int lane = threadIdx.x & 31;
  constexpr int XS = 2 * kWarps * G;  // floats per row of x in shared memory
  uint32_t b[G];
#pragma unroll
  for (int c = 0; c < G; ++c) b[c] = __ldg(w + static_cast<size_t>(c) * p.N);
  const float s0 = bf16f(__ldg(p.s + so));
  const float s1 = bf16f(__ldg(p.s + plane + so));
  const bool mins = p.R == 4;
  const float mn0 = mins ? bf16f(__ldg(p.s + 2 * plane + so)) : 0.f;
  const float mn1 = mins ? bf16f(__ldg(p.s + 3 * plane + so)) : 0.f;
  if (MT == 1) {
    const float* x0 = xsm + gl * G;
    const float* x1 = xsm + kWarps * G + gl * G;
    // group sums of x: lane c adds x[c] (G <= 32), one butterfly per half
    const float xs0 = warp_sum(lane < G ? x0[lane] : 0.f);
    const float xs1 = warp_sum(lane < G ? x1[lane] : 0.f);
    float p0 = 0.f, p1 = 0.f;
#pragma unroll
    for (int c = 0; c < G; ++c) {
      p0 = __fmaf_rn(x0[c], u2f(b[c] & 15u), p0);
      p1 = __fmaf_rn(x1[c], u2f(b[c] >> 4), p1);
    }
    if (p.zero) {
      const float zf = static_cast<float>(p.zero);
      p0 = __fsub_rn(p0, __fmul_rn(zf, xs0));
      p1 = __fsub_rn(p1, __fmul_rn(zf, xs1));
    }
    float c0 = __fmul_rn(s0, p0);
    float c1 = __fmul_rn(s1, p1);
    if (mins) {
      c0 = __fsub_rn(c0, __fmul_rn(mn0, xs0));
      c1 = __fsub_rn(c1, __fmul_rn(mn1, xs1));
    }
    acc[0] = __fadd_rn(c0, c1);
  } else {
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[m] = 0.f;
#pragma unroll
    for (int c = 0; c < G; ++c) {
      const float wl = round_bf16(__fmul_rn(static_cast<float>(static_cast<int>(b[c] & 15u) - p.zero), s0));
      const float wh = round_bf16(__fmul_rn(static_cast<float>(static_cast<int>(b[c] >> 4) - p.zero), s1));
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        acc[m] = __fmaf_rn(xsm[m * XS + gl * G + c], wl, acc[m]);
        acc[m] = __fmaf_rn(xsm[m * XS + kWarps * G + gl * G + c], wh, acc[m]);
      }
    }
    if (mins) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xs0 = warp_sum(lane < G ? xsm[m * XS + gl * G + lane] : 0.f);
        const float xs1 = warp_sum(lane < G ? xsm[m * XS + kWarps * G + gl * G + lane] : 0.f);
        acc[m] = __fsub_rn(acc[m], __fadd_rn(__fmul_rn(xs0, mn0), __fmul_rn(xs1, mn1)));
      }
    }
  }
}

template <int G, int MT, bool GATEUP>
__global__ void __launch_bounds__(kWarps * 32) qmm_kernel(Params p) {
  constexpr int NC = GATEUP ? 2 : 1;
  constexpr int XS = 2 * kWarps * G;
  __shared__ float xsm[MT * XS];
  __shared__ float red[kWarps][NC][MT][32];
  __shared__ int last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int half = p.K >> 1;
  const int ngh = half / G;
  const int ks = blockIdx.y;
  const int KS = gridDim.y;
  const int ncols = GATEUP ? p.ff : p.N;
  const int col = blockIdx.x * 32 + lane;
  const int m0 = blockIdx.z * MT;
  const int g0 = ks * kWarps;  // the block's first group

  // stage x rows [m0, m0 + MT) of the block's groups, both halves, as f32
  for (int i = threadIdx.x; i < MT * XS; i += blockDim.x) {
    const int m = i / XS, r = i - m * XS;
    const int h = r / (kWarps * G), k = r - h * (kWarps * G);
    const int row = min(m0 + m, p.M - 1);
    const int kk = g0 * G + k;
    xsm[i] = kk < half ? bf16f(__ldg(p.x + static_cast<size_t>(row) * p.K + h * half + kk)) : 0.f;
  }
  __syncthreads();

  // whole warps take the branch (the shuffles inside need every lane); lanes
  // past the last column read the last column and are not stored
  const int g = g0 + warp;
  const int lcol = min(col, ncols - 1);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float acc[MT];
    if (g < ngh) {
      group_sums<G, MT>(p, xsm, lcol + c * p.ff, g, warp, acc);
    } else {
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[m] = 0.f;
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) red[warp][c][m][lane] = acc[m];
  }
  __syncthreads();

  // block sums in warp order: thread i takes (m, lane) = (i / 32, i % 32)
  const int i = threadIdx.x;
  const int m = i >> 5, ln = i & 31;
  const int cc = blockIdx.x * 32 + ln;
  const int row = m0 + m;
  const bool live = i < MT * 32 && cc < ncols && row < p.M;
  float t[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float s = 0.f;
    if (i < MT * 32) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, red[w][c][m][ln]);
    }
    t[c] = s;
  }
  if (KS > 1) {
    // cross-block: write the partial, take a ticket; the last block of this
    // column tile sums every split's partial in split order
    if (live) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        p.part[((static_cast<size_t>(ks) * NC + c) * p.M + row) * ncols + cc] = t[c];
    }
    __threadfence();
    __syncthreads();
    int* ticket = p.tickets + blockIdx.z * gridDim.x + blockIdx.x;
    if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == KS - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (live) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float s = 0.f;
        for (int k = 0; k < KS; ++k)
          s = __fadd_rn(s, __ldcg(p.part + ((static_cast<size_t>(k) * NC + c) * p.M + row) * ncols + cc));
        t[c] = s;
      }
    }
    if (threadIdx.x == 0) *ticket = 0;  // zeros again for the next launch
  }
  if (!live) return;
  if (GATEUP) {
    static_cast<uint16_t*>(p.out)[static_cast<size_t>(row) * p.ff + cc] = silu_mul(t[0], t[NC - 1]);
  } else {
    static_cast<float*>(p.out)[static_cast<size_t>(row) * p.N + cc] = t[0];
  }
}

template <int G>
cudaError_t launch(const Params& p, int gateup, cudaStream_t st) {
  const int ncols = gateup ? p.N / 2 : p.N;
  const int ngh = (p.K / 2) / G;
  const int KS = (ngh + kWarps - 1) / kWarps;
  const dim3 block(kWarps * 32);
  if (p.M == 1) {
    const dim3 grid((ncols + 31) / 32, KS, 1);
    if (gateup) qmm_kernel<G, 1, true><<<grid, block, 0, st>>>(p);
    else qmm_kernel<G, 1, false><<<grid, block, 0, st>>>(p);
  } else {
    const dim3 grid((ncols + 31) / 32, KS, (p.M + kRowsTile - 1) / kRowsTile);
    if (gateup) qmm_kernel<G, kRowsTile, true><<<grid, block, 0, st>>>(p);
    else qmm_kernel<G, kRowsTile, false><<<grid, block, 0, st>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// The number of K splits (blocks along y) of a launch: the f32 partial buffer
// holds KS·(gateup ? 2 : 1)·M·ncols floats, the ticket buffer
// ceil(ncols/32)·ceil(M/tile) ints (tile = 1 at M = 1, else 8).
extern "C" int bt_qmm_i4t_splits(int K, int G) {
  return ((K / 2) / G + kWarps - 1) / kWarps;
}

// y = x @ W^T for an i4t weight.  gateup = 0: out f32 [M, N].  gateup = 1:
// W holds gate columns [0, N/2) and up columns [N/2, N); out bf16 [M, N/2].
// G must be 32 (Q4_0's group, the only one ported yet).  Returns the CUDA
// error of the launch (0 on success).
extern "C" int bt_qmm_i4t(const void* x, const void* qw, const void* s, void* out,
                          void* part, void* tickets, int M, int K, int N, int R, int zero,
                          int G, int gateup, void* stream) {
  Params p{static_cast<const uint16_t*>(x), static_cast<const uint8_t*>(qw),
           static_cast<const uint16_t*>(s), out, static_cast<float*>(part),
           static_cast<int*>(tickets), M, K, N, R, zero, gateup ? N / 2 : 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (G == 32) e = launch<32>(p, gateup, st);
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
