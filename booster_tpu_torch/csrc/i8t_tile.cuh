// The mma.sync warp tile and the split helpers that several kernels share:
//   - ldmatrix_x4, mma_bf16 (m16n8k16, bf16 in, f32 accumulate) and
//     pack_bf16x2: the tensor-core rings (qmm_ring.cuh, attn_mma.cuh),
//     i4mv.cuh and probe_i8.cu;
//   - arrive_last and sum_splits: the last block of a K split's tickets
//     (qmm_lane.cu, decode_attn.cu, qmm_ring.cuh, i8k_tile.cuh, the probes);
//   - Smem, mma_stage and for_tile: a 64 x 128 tile of 8 warps (2 along M x 4
//     along N, each 32 x 32) over 64-row stages of K in shared memory (x
//     [64 m][64 k] and w [64 k][128 n], padded rows), which probe_i4.cu's
//     rungs reproduce as fixed forms.
// The int8 K-major matmuls moved to i8k_tile.cuh (a cp.async ring, wgmma).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_ops.cuh"

namespace i8t {

constexpr int kBM = 64;        // rows of x per tile
constexpr int kBN = 128;       // output columns per tile
constexpr int kBK = 64;        // rows of K per stage
constexpr int kThreads = 256;  // 8 warps: 2 along M x 4 along N
constexpr int kXS = kBK + 8;   // bf16 per x row in shared memory (pad: no ldmatrix bank conflicts)
constexpr int kWS = kBN + 8;   // bf16 per weight row in shared memory

struct alignas(16) Smem {  // 16-byte rows: uint4 stores and ldmatrix
  uint16_t x[kBM * kXS];
  uint16_t w[kBK * kWS];
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(bf16_bits(lo)) | (static_cast<uint32_t>(bf16_bits(hi)) << 16);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p, bool trans) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  if (trans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += this stage's x tile @ w tile, the 4 steps of 16 rows of K in order.
// Warp (wm, wn) owns rows wm·32 + [0, 32) and columns wn·32 + [0, 32):
// acc[mi][ni] is the m16n8 fragment of rows wm·32 + mi·16, columns
// wn·32 + ni·8.
__device__ __forceinline__ void mma_stage(const Smem& sm, float (&acc)[2][4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int mat = lane >> 3, r = lane & 7;  // the 8x8 matrix and row this lane addresses
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldmatrix_x4(a[mi], &sm.x[(wm * 32 + mi * 16 + (mat & 1) * 8 + r) * kXS + kk * 16 + (mat >> 1) * 8],
                  false);
    uint32_t b[4][2];
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      uint32_t t[4];
      ldmatrix_x4(t, &sm.w[(kk * 16 + (mat & 1) * 8 + r) * kWS + wn * 32 + nj * 16 + (mat >> 1) * 8],
                  true);
      b[2 * nj][0] = t[0];
      b[2 * nj][1] = t[1];
      b[2 * nj + 1][0] = t[2];
      b[2 * nj + 1][1] = t[3];
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
  }
}

// Calls f(row, col, v) for each element of the tile this thread holds.
template <typename F>
__device__ __forceinline__ void for_tile(int m0, int n0, const float (&acc)[2][4][4], F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(m0 + wm * 32 + mi * 16 + gid + (e >> 1) * 8, n0 + wn * 32 + ni * 8 + tig * 2 + (e & 1),
          acc[mi][ni][e]);
}

// The split sum of one element: s = ((0 + p0) + p1) + ... over KS partials
// `stride` floats apart.
__device__ __forceinline__ float sum_splits(const float* part, size_t stride, int KS) {
  float s = 0.f;
  for (int k = 0; k < KS; ++k) s = __fadd_rn(s, __ldcg(part + static_cast<size_t>(k) * stride));
  return s;
}

// After this block's partials are stored: true in the block that arrives
// last of `expect` at `ticket` (which it resets to zero for the next launch).
__device__ __forceinline__ bool arrive_last(int* ticket, int expect) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool l = atomicAdd(ticket, 1) == expect - 1;
    if (l) *ticket = 0;
    last = l;
  }
  __syncthreads();
  const bool l = last;
  if (l) __threadfence();
  return l;
}

}  // namespace i8t
