// The ring and the mma.sync warp tile shared by the quantized matmuls of
// qmm_i4t.cu (M > 1) and qmm_lane.cu.
//
// A block of 8 warps owns a BM x 128 output tile (BM 32, 64 or 128) and
// walks its range of K in stages: cp.async (cp_async.cuh) copies each
// stage's raw bytes (payload, scales, x) into a ring of shared memory,
// stages ahead, and the stage in use is dequantized from there
// (dq_nibbles, dq_bytes) into a bf16 tile on which the warps run mma.sync
// m16n8k16 (bf16 in, f32 accumulate) over ldmatrix fragments, 16 columns of
// K a step, in order.  Warps tile the block as WM along M by WN along N;
// each owns MI m16 tiles and NI n8 tiles.  Where K is split over blocks,
// the last block adds the splits' partials (reduce_splits).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_ops.cuh"
#include "cp_async.cuh"
#include "i8t_tile.cuh"  // ldmatrix_x4, mma_bf16, arrive_last

namespace qring {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBN = 128;       // output columns per tile

template <int BM>
struct Warps {
  static_assert(BM == 32 || BM == 64 || BM == 128, "a tile has 32, 64 or 128 rows");
  static constexpr int WM = BM == 32 ? 2 : BM / 32;  // warps along M
  static constexpr int WN = 8 / WM;                  // warps along N
  static constexpr int MI = BM / (16 * WM);          // m16 tiles of a warp
  static constexpr int NI = kBN / (8 * WN);          // n8 tiles of a warp
};

using cpasync::cp_async16;
using cpasync::cp_async4;
using cpasync::cp_commit;
using cpasync::cp_wait;

// bf16 bits of 128 + zero in both halves of a word (zero < 128: exact)
__host__ __device__ inline uint32_t nibble_bias(int zero) {
  const uint32_t b = 0x4300u | static_cast<uint32_t>(zero);  // 128 + zero: mantissa bits
  return b | (b << 16);
}

// Two payload bytes (bits 0-15 of h) → the bf16 pairs bf16((nibble - zero)·s)
// of their low nibbles (lo, scale pair sl) and high nibbles (hi, pair sh).
// 0x4300 | nibble is the bf16 128 + nibble; less 128 + zero it is nibble -
// zero, exactly; a bf16x2 FMA with a -0 addend rounds the exact product
// once (the fastest unpack of the nibble_probe tool's ladder; the same
// numbers as round_bf16 of the f32 product).
__device__ __forceinline__ void dq_nibbles(uint32_t h, uint32_t bias, uint32_t sl, uint32_t sh,
                                           uint32_t& lo, uint32_t& hi) {
  const uint32_t t = __byte_perm(h, 0u, 0x4140);  // byte 0 in bits 0-7, byte 1 in 16-23
  const uint32_t l = (t & 0x000f000fu) | 0x43004300u;
  const uint32_t u = ((t >> 4) & 0x000f000fu) | 0x43004300u;
  const __nv_bfloat162 nz = __halves2bfloat162(__ushort_as_bfloat16(0x8000),
                                               __ushort_as_bfloat16(0x8000));
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&bias);
  const __nv_bfloat162 wl = __hfma2(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&l), b),
                                    *reinterpret_cast<const __nv_bfloat162*>(&sl), nz);
  const __nv_bfloat162 wh = __hfma2(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&u), b),
                                    *reinterpret_cast<const __nv_bfloat162*>(&sh), nz);
  lo = *reinterpret_cast<const uint32_t*>(&wl);
  hi = *reinterpret_cast<const uint32_t*>(&wh);
}

// Two int8 payload bytes, spread to bits 0-7 and 16-23 of t (bits 8-15 and
// 24-31 are not read) → the bf16 pair of the exact integers, or bf16(q·s)
// (scale pair sp) when kScaled, with no conversion instructions: each byte
// is 16·hi + lo, its low nibble lo (0x4300 | lo is the bf16 128 + lo) and
// its signed high nibble hi ((hi ^ 8) - 8); both are exact in bf16, 16·hi +
// lo is exact in a bf16 FMA (|q| <= 128), and the product is rounded once.
template <bool kScaled = true>
__device__ __forceinline__ uint32_t dq_spread(uint32_t t, uint32_t sp) {
  const uint32_t l = (t & 0x000f000fu) | 0x43004300u;
  const uint32_t u = (((t >> 4) & 0x000f000fu) ^ 0x00080008u) | 0x43004300u;
  const __nv_bfloat162 c128 = __halves2bfloat162(__ushort_as_bfloat16(0x4300),
                                                 __ushort_as_bfloat16(0x4300));
  const __nv_bfloat162 c136 = __halves2bfloat162(__ushort_as_bfloat16(0x4308),
                                                 __ushort_as_bfloat16(0x4308));
  const __nv_bfloat162 c16 = __halves2bfloat162(__ushort_as_bfloat16(0x4180),
                                                __ushort_as_bfloat16(0x4180));
  const __nv_bfloat162 lo = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&l), c128);
  const __nv_bfloat162 hi = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&u), c136);
  __nv_bfloat162 w = __hfma2(hi, c16, lo);
  if constexpr (kScaled) w = __hmul2(w, *reinterpret_cast<const __nv_bfloat162*>(&sp));
  return *reinterpret_cast<const uint32_t*>(&w);
}

// Two int8 payload bytes (bits 0-15 of h) → the bf16 pair bf16(q·s) (scale
// pair sp).
__device__ __forceinline__ uint32_t dq_bytes(uint32_t h, uint32_t sp) {
  return dq_spread(__byte_perm(h, 0u, 0x4140), sp);  // byte 0 in bits 0-7, byte 1 in 16-23
}

// bf16 pair w less the min pair m (qmm_lane.cu, qmm_lane_i8.cu): the difference of two bf16 values
// rounded to bf16 once (a bf16x2 subtraction).  The plain version rounds it
// to f32 first, which is the same number: f32 holds the difference exactly
// unless the exponents are 16 or more apart, and then it lies within
// 2^-15 of the larger, far from a bf16 rounding tie.  The explicit .rn keeps
// ptxas from contracting it with the product that formed w (i8's
// dq_bytes, a bf16x2 multiply) into one fma, which would skip w's rounding
// (__hsub2 carries no rounding modifier).
__device__ __forceinline__ uint32_t sub_min(uint32_t w, uint32_t m) {
  uint32_t r;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(w), "r"(m));
  return r;
}

// The A fragments of a warp's MI m16 tiles at columns k0 .. k0 + 15 of a
// row-major bf16 x tile (row stride xs elements), rows from r0.
template <int MI>
__device__ __forceinline__ void a_frags(uint32_t (&a)[MI][4], const uint16_t* x, int xs, int r0,
                                        int k0) {
  const int lane = threadIdx.x & 31, mat = lane >> 3, r = lane & 7;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
    i8t::ldmatrix_x4(a[mi], x + (r0 + mi * 16 + (mat & 1) * 8 + r) * xs + k0 + (mat >> 1) * 8,
                     false);
}

// acc[mi][2j], acc[mi][2j + 1] += A · B for the two n8 tiles of 16 columns
// whose B fragments are b (ldmatrix_x4: n8 tile 0 in b[0..1], 1 in b[2..3])
template <int MI, int NI>
__device__ __forceinline__ void mma_pair(float (&acc)[MI][NI][4], const uint32_t (&a)[MI][4],
                                         const uint32_t (&b)[4], int j) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    i8t::mma_bf16(acc[mi][2 * j], a[mi], b[0], b[1]);
    i8t::mma_bf16(acc[mi][2 * j + 1], a[mi], b[2], b[3]);
  }
}

template <int MI, int NI>
__device__ __forceinline__ void zero_acc(float (&acc)[MI][NI][4]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
}

// The last block's split sums of a tile of `rows` (<= ROWS) x `cols` (<=
// COLS, a multiple of 4) floats, over a block of THREADS threads:
// (r, c) = ((0 + p0) + p1) + ... over KS partials `plane` floats apart (the
// order of i8t::sum_splits), rows `ld` floats apart from part.  A thread
// takes four columns at a time and issues the loads of up to INFLIGHT
// float4 (CH columns of R splits) before adding them in split order, so
// the latency of L2 is paid once for R splits, not once an element;
// put(r, c, float4) takes the sums of columns c .. c + 3.
template <int ROWS, int COLS, int THREADS = kThreads, int INFLIGHT = 8, typename F>
__device__ __forceinline__ void reduce_splits(const float* part, size_t plane, int KS, int ld,
                                              int rows, int cols, F put) {
  constexpr int V = ROWS * COLS / 4 / THREADS;  // float4 of a thread
  constexpr int CH = V < INFLIGHT ? V : INFLIGHT;
  constexpr int R = INFLIGHT / CH;  // splits a round
  static_assert(V >= 1 && V % CH == 0, "whole float4 chunks a thread");
#pragma unroll
  for (int c0 = 0; c0 < V; c0 += CH) {
    float4 acc[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k0 = 0; k0 < KS; k0 += R) {
      float4 v[R][CH];
#pragma unroll
      for (int q = 0; q < R; ++q)
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          const int e = threadIdx.x + (c0 + j) * THREADS, r = e / (COLS / 4);
          v[q][j] = k0 + q < KS && r < rows && e % (COLS / 4) * 4 < cols
                        ? __ldcg(reinterpret_cast<const float4*>(
                              part + (k0 + q) * plane + static_cast<size_t>(r) * ld)
                              + e % (COLS / 4))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        if (k0 + q >= KS) break;
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          acc[j].x = __fadd_rn(acc[j].x, v[q][j].x);
          acc[j].y = __fadd_rn(acc[j].y, v[q][j].y);
          acc[j].z = __fadd_rn(acc[j].z, v[q][j].z);
          acc[j].w = __fadd_rn(acc[j].w, v[q][j].w);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int e = threadIdx.x + (c0 + j) * THREADS, r = e / (COLS / 4);
      if (r < rows && e % (COLS / 4) * 4 < cols) put(r, e % (COLS / 4) * 4, acc[j]);
    }
  }
}

// Raise a kernel's dynamic shared memory limit once (its first launch).
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             bytes);
  done = e == cudaSuccess;
  return e;
}

}  // namespace qring
