// The int8 K-major dequantize-then-multiply tile shared by qmm_i8t.cu (the
// M > 1 matmul and the fused gate-up) and mlp_i8t.cu (the whole MLP).
//
// y[M, N] = x[M, K] @ W[K, N], W = bf16(f32(q) · f32(bf16 s)) with q the int8
// payload [K, ldq] and s the bf16 scale plane [K/G, ldq] (symmetric: Q8_0's
// group G = 32, Q6_K's G = 16; the group is a template parameter).  A block of 256 threads owns a 64 x 128 output tile and one
// contiguous range of K (its split).  Each 64-row stage of K goes global →
// registers (16-byte loads, the next stage in flight while the tensor cores
// work on this one) → shared memory: x as it is, the payload dequantized to
// bf16 with the reference's rounding.  The 8 warps (2 along M x 4 along N)
// then run warp-level mma.sync m16n8k16 (bf16 in, f32 accumulate) on
// ldmatrix fragments, 8 per warp per 16 rows of K.
//
// qmm_i8c.cu takes the same tile with no group scales (kScaled = false:
// w = bf16(q), exact) and applies its per-column scale after the sum.
//
// Bit-exactness between the three kernels rests on this file: a split's sum
// is the same chain of mma instructions from zero over the same stages, and
// the splits are added in split order, s = ((0 + p0) + p1) + ..., by the
// block that arrives last (an atomic ticket, reset by that block) or, at one
// split, by the block itself.  The split count is a function of (M, K, N)
// chosen by the Python wrappers (ops/qmm.py dq_splits), so the gate-up, the
// matmul and the whole MLP split alike at one M and add in one order.
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
constexpr int kGroup = 32;     // Q8_0's group (the default; Q6_K's is 16)
constexpr int kXS = kBK + 8;   // bf16 per x row in shared memory (pad: no ldmatrix bank conflicts)
constexpr int kWS = kBN + 8;   // bf16 per weight row in shared memory

struct alignas(16) Smem {  // 16-byte rows: uint4 stores and ldmatrix
  uint16_t x[kBM * kXS];
  uint16_t w[kBK * kWS];
};

// One matmul's operands.  x rows may be written by an earlier phase of the
// same launch (the MLP's mid), so they are read through L2 (ld.global.cg);
// payload and scales are read-only.
struct Operand {
  const uint16_t* x;  // bf16, row stride ldx
  const int8_t* q;    // [K, ldq] int8
  const uint16_t* s;  // [K / G, ldq] bf16
  int ldx, ldq, M;
};

// A 64-row stage on its way from device memory to shared memory.
struct Stage {
  uint4 x[2];
  uint4 q[2];
  uint4 s[2][2];
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(bf16_bits(lo)) | (static_cast<uint32_t>(bf16_bits(hi)) << 16);
}

// K rows [kb, ke) of split s of KS over K (whole stages).
__device__ __forceinline__ void split_range(int K, int KS, int s, int& kb, int& ke) {
  const int nk = K / kBK;
  kb = static_cast<int>(static_cast<long long>(s) * nk / KS) * kBK;
  ke = static_cast<int>(static_cast<long long>(s + 1) * nk / KS) * kBK;
}

// kScaled = false: a payload with no group scales (i8c: one scale per
// column, applied by the caller's epilogue); op.s is not read and w = bf16(q).
// G: the rows of K that share a scale row.
template <bool kScaled = true, int G = kGroup>
__device__ __forceinline__ void load_stage(const Operand& op, int m0, int n0, int k, Stage& st) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * kThreads;  // 64 rows x 8 chunks of 16 bytes
    const int r = idx >> 3, c = idx & 7;
    const int row = m0 + r;
    st.x[i] = row < op.M
        ? __ldcg(reinterpret_cast<const uint4*>(op.x + static_cast<size_t>(row) * op.ldx + k + c * 8))
        : make_uint4(0u, 0u, 0u, 0u);
    const size_t qo = static_cast<size_t>(k + r) * op.ldq + n0 + c * 16;
    st.q[i] = __ldg(reinterpret_cast<const uint4*>(op.q + qo));
    if constexpr (kScaled) {
      const uint4* sp = reinterpret_cast<const uint4*>(
          op.s + static_cast<size_t>((k + r) / G) * op.ldq + n0 + c * 16);
      st.s[i][0] = __ldg(sp);
      st.s[i][1] = __ldg(sp + 1);
    }
  }
}

// x as it is; w = bf16(f32(q) · f32(s)) (the product is exact in f32: an
// int8 times an 8-bit mantissa), or w = bf16(q) (exact) when not kScaled, 16
// columns per chunk.
template <bool kScaled = true>
__device__ __forceinline__ void store_stage(const Stage& st, Smem& sm) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 3, c = idx & 7;
    *reinterpret_cast<uint4*>(&sm.x[r * kXS + c * 8]) = st.x[i];
    const uint32_t qv[4] = {st.q[i].x, st.q[i].y, st.q[i].z, st.q[i].w};
    uint32_t o[8];
    if constexpr (kScaled) {
      const uint32_t sv[8] = {st.s[i][0].x, st.s[i][0].y, st.s[i][0].z, st.s[i][0].w,
                              st.s[i][1].x, st.s[i][1].y, st.s[i][1].z, st.s[i][1].w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // columns 2j, 2j + 1 of the chunk
        const uint32_t word = qv[j >> 1] >> ((j & 1) * 16);
        const float q0 = static_cast<float>(static_cast<int8_t>(word & 0xffu));
        const float q1 = static_cast<float>(static_cast<int8_t>((word >> 8) & 0xffu));
        o[j] = pack_bf16x2(__fmul_rn(q0, bf16f(sv[j] & 0xffffu)), __fmul_rn(q1, bf16f(sv[j] >> 16)));
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t word = qv[j >> 1] >> ((j & 1) * 16);
        o[j] = pack_bf16x2(static_cast<float>(static_cast<int8_t>(word & 0xffu)),
                           static_cast<float>(static_cast<int8_t>((word >> 8) & 0xffu)));
      }
    }
    uint4* dst = reinterpret_cast<uint4*>(&sm.w[r * kWS + c * 16]);
    dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
    dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
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

// The 64 x 128 tile at (m0, n0) of x @ W over K rows [kb, ke), from zero.
template <bool kScaled = true, int G = kGroup>
__device__ __forceinline__ void dq_tile(const Operand& op, int m0, int n0, int kb, int ke, Smem& sm,
                                        float (&acc)[2][4][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  Stage st;
  load_stage<kScaled, G>(op, m0, n0, kb, st);
  for (int k = kb; k < ke; k += kBK) {
    __syncthreads();  // the last stage's fragments are read
    store_stage<kScaled>(st, sm);
    __syncthreads();
    if (k + kBK < ke) load_stage<kScaled, G>(op, m0, n0, k + kBK, st);
    mma_stage(sm, acc);
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

// One item of y = x @ W split KS ways over K: column tile j, split s, M
// tile mt.  Writes y (f32, or bf16 when OUT_BF16) [M, N] at once when KS is
// 1; else its partial into part [KS, M, N], and the last split's block adds
// them in split order.  tickets: [M tiles, N / 128] zeros.
template <bool OUT_BF16, int G = kGroup>
__device__ void dq_item(const Operand& op, int N, int K, int KS, int j, int s, int mt, void* out,
                        float* part, int* tickets, Smem& sm) {
  const int m0 = mt * kBM, n0 = j * kBN, M = op.M;
  int kb, ke;
  split_range(K, KS, s, kb, ke);
  float acc[2][4][4];
  dq_tile<true, G>(op, m0, n0, kb, ke, sm, acc);
  auto put = [&](int row, int col, float v) {
    const size_t o = static_cast<size_t>(row) * N + col;
    if (OUT_BF16) static_cast<uint16_t*>(out)[o] = bf16_bits(v);
    else static_cast<float*>(out)[o] = v;
  };
  if (KS == 1) {
    for_tile(m0, n0, acc, [&](int row, int col, float v) {
      if (row < M) put(row, col, __fadd_rn(0.f, v));
    });
    return;
  }
  const size_t plane = static_cast<size_t>(M) * N;
  for_tile(m0, n0, acc, [&](int row, int col, float v) {
    if (row < M) part[s * plane + static_cast<size_t>(row) * N + col] = v;
  });
  if (!arrive_last(tickets + mt * (N / kBN) + j, KS)) return;
  for (int e = threadIdx.x; e < kBM * kBN; e += kThreads) {
    const int row = m0 + e / kBN, col = n0 + e % kBN;
    if (row < M) put(row, col, sum_splits(part + static_cast<size_t>(row) * N + col, plane, KS));
  }
}

// One item of the fused gate-up over the [K, 2ff] payload: column tile j
// (gate tiles 0 .. ff/128 - 1, then up tiles), split s, M tile mt; its
// partial goes to part [KS, M, 2ff].  The last of the 2·KS items of column
// pair j mod (ff / 128) writes mid [M, ff] = silu(g) · u in bf16 and returns
// true.  tickets: [M tiles, ff / 128] zeros.
template <int G = kGroup>
__device__ bool gateup_item(const Operand& op, int ff, int K, int KS, int j, int s, int mt,
                            float* part, uint16_t* mid, int* tickets, Smem& sm) {
  const int nF = ff / kBN, N = 2 * ff, m0 = mt * kBM, M = op.M;
  int kb, ke;
  split_range(K, KS, s, kb, ke);
  float acc[2][4][4];
  dq_tile<true, G>(op, m0, j * kBN, kb, ke, sm, acc);
  const size_t plane = static_cast<size_t>(M) * N;
  for_tile(m0, j * kBN, acc, [&](int row, int col, float v) {
    if (row < M) part[s * plane + static_cast<size_t>(row) * N + col] = v;
  });
  const int fj = j % nF;
  if (!arrive_last(tickets + mt * nF + fj, 2 * KS)) return false;
  for (int e = threadIdx.x; e < kBM * kBN; e += kThreads) {
    const int row = m0 + e / kBN, col = fj * kBN + e % kBN;
    if (row >= M) continue;
    const float* pr = part + static_cast<size_t>(row) * N + col;
    mid[static_cast<size_t>(row) * ff + col] = silu_mul(sum_splits(pr, plane, KS),
                                                        sum_splits(pr + ff, plane, KS));
  }
  return true;
}

}  // namespace i8t
