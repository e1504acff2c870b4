// The scale-expansion and i4 probes' kernels: what a 4-bit weight stream
// costs between its raw read and a fused dequantize-matmul, and what the
// scale expansion costs alone (booster_tpu_torch/tools: expander_probe,
// tqmm_probe, nibble_probe, groupdot_probe; ops/probes_i4.py wraps them).
// The int8 rungs of those tools are forms of probe_i8.cu.
//
// Replaces these Pallas functions of the JAX package's tools:
//
// E. expand_kernel<TILE, ROUND>: s [R, C] f32 → [R, W]: column c takes
//    s[:, c / g] (repeat) or s[:, c % C] (TILE), rounded to bf16 first when
//    ROUND.  tools/expander_probe.py:74 part1_semantics's kernel: bodies
//    reshape :84, jrepeat :91 and take :97 (repeat; take's static gather
//    does not trace in the reference), ptile :103 (pltpu.repeat: tile),
//    dot16 :110 (a one-hot bf16 dot: repeat of bf16(s)).  Exact.
//
// F. nibble_kernel<MODE>: the dequantized tiles alone, w_lo and w_hi as f32
//    [rows, cols] from a split-half u8 payload and f32 scale rows [R,
//    rows/32, cols] (tools/nibble_probe.py:187, the check kernel `k`, once
//    per unpack).  Exact.
//
// G. i4mm_kernel<MODE, UNPACK>: y [M, N] f32 = sum_h x3[:, h] @ w_h, x3
//    [M, 2, K/2] bf16, the payload u8 [K/2, N] whose byte row r holds k = r
//    (low nibble) and r + K/2 (high), f32 scale rows [R, K/2/32, N] rounded
//    to bf16.  MODE kCurrent: w_h = bf16(bf16(nib_h - 8) · bf16(s_h))
//    (tools/tqmm_probe.py:127 make_tqmm_i4; nibble_probe.py:70 make_step
//    with mkw_current :106).  kI8Mask: the byte ^ 0x80 as int8, w_lo =
//    bf16((lo - 8)·bf16(r0)), w_hi = bf16(16(hi - 8)·bf16(r1)) with rows
//    [s0, s1/16] (mkw_i8mask_sub :113): the same numbers as kCurrent, since
//    16(hi - 8) and s1/16 are exact.  kAffine: rows [s0, s1/16, 8·s0],
//    w_lo = bf16(bf16(lo·bf16(s0)) - bf16(8·s0)) with lo unsigned
//    (mkw_i8mask_affine :121): other roundings.  UNPACK, the point of the
//    nibble probe, picks the instructions that take kCurrent's nibbles to
//    bf16 (one rung each, every one the same numbers): kI32 (mask, shift,
//    subtract in i32, then I2F), kXor88 (the word ^ 0x88888888, each nibble
//    sign-extended by two shifts: nibble_probe.py:142 unpack_i8_shift's
//    sequence), kMagicF32 (0x4B000000 | nibble as a float less 2^23 + 8,
//    qmm_i4t.cu's trick), kMagicBf16 (two nibbles at once: 0x4300 | nibble
//    as a bf16 pair less 136, then a bf16x2 fused multiply by the scales
//    with a -0 addend, i.e. the product rounded once).
//
// H. gd_kernel<FMT>: the M = 1 group-dot with unrounded f32 scales,
//    tools/groupdot_probe.py.  kGdI4 (_gd_i4_kernel :53): out_n =
//    sum_{h,g} s[h,g,n]·(p_hgn - 8·xs_hg), p the f32 dot of bf16 x with the
//    raw nibbles over group g of half h, xs the f32 sum of bf16 x over it;
//    kGdI4M (_gd_i4m_kernel :87): s[h]·p - s[2+h]·xs (mins); kGdI8
//    (_gd_i8_kernel :120, raw False and True, one function): sum_g
//    s[g,n]·p_gn over an int8 [K, N].  qmm_i4t.cu's M = 1 kernel computes
//    another function: it rounds its scale planes to bf16.
//
// What bounds them on the H100: bytes.  tqmm_probe's payload is 8.4 MB
// (4096 x 4096 at half a byte) and 2.1 MB of f32 scale rows (an f32 scale
// per 32 weights is 1/8 byte a weight, a quarter of the payload);
// nibble_probe's 11.5 MB (11264 x 2048) and 2.9-4.3 MB; groupdot_probe's
// 1B shapes 11.5 + 2.9 / 5.8 MB: 2-6 us at 3.35 TB/s.  At M = 64 the dot is
// 2·64·4096² = 2.1 GFLOP, 2 us of bf16 tensor-core time.  The designs:
// - G takes probe_i8.cu's tile (64 x 128 outputs, 8 warps of mma.sync
//   m16n8k16 on ldmatrix fragments, i8t_tile.cuh's shared layout and
//   mma_stage), with a stage of one group: 32 payload rows, which are 64
//   rows of K (32 of each half), so all rows of a stage share one scale row
//   per half.  The payload goes global → registers (the next stage in
//   flight while the tensor cores work) → unpacked, scaled and rounded into
//   the bf16 [k][n] tile; the scale rows are staged in shared memory first
//   (a third barrier per stage).  K splits on whole groups, about two
//   blocks per SM, the partials added in split order by the last block.
// - H takes qmm_i4t.cu's M = 1 shape: a warp per group of 32 rows issues
//   its 32 loads before using any, each lane owns 4 columns (one 32-bit
//   word a row, 128 bytes a warp), 8 warps a block over 128 columns, K
//   split across blocks, the 8 warps reduced in warp order through shared
//   memory and the splits by the last block in split order.
// - E and F are elementwise, one thread an output (at the tools' sizes a
//   launch costs more than their bytes).
// Making G and H fast (wgmma, TMA, a deeper ring) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "i8t_tile.cuh"

namespace {

constexpr int kG = 32;  // rows of a group (Q4_0's and the probes')

enum { kCurrent = 0, kI8Mask = 1, kAffine = 2 };            // MODE
enum { kI32 = 0, kXor88 = 1, kMagicF32 = 2, kMagicBf16 = 3 };  // UNPACK
enum { kGdI4 = 0, kGdI4M = 1, kGdI8 = 2 };                   // FMT

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ------------------------------------------------------------- E. expand

template <bool TILE, bool ROUND>
__global__ void expand_kernel(const float* s, float* out, int R, int C, int W, int g) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R * W) return;
  const int r = i / W, c = i - r * W;
  const float v = __ldg(s + static_cast<size_t>(r) * C + (TILE ? c % C : c / g));
  out[i] = ROUND ? round_bf16(v) : v;
}

// ------------------------------------------------------- F. nibble tiles

// One payload byte → (w_lo, w_hi) under MODE, scales already bf16 (f32 of
// bf16).  Every product is exact in f32 (a 4-bit or 8-bit integer times an
// 8-bit mantissa) and rounded once, as bf16 · bf16 rounds in the reference.
template <int MODE>
__device__ __forceinline__ void dq_byte(uint32_t b, float s0, float s1, float s2, float& wl,
                                        float& wh) {
  if constexpr (MODE == kCurrent) {
    wl = round_bf16(__fmul_rn(static_cast<float>(static_cast<int>(b & 15u) - 8), s0));
    wh = round_bf16(__fmul_rn(static_cast<float>(static_cast<int>(b >> 4) - 8), s1));
  } else {  // the byte ^ 0x80 as int8: v & 0xf0 is 16·(hi - 8)
    const uint32_t v = b ^ 0x80u;
    wh = round_bf16(__fmul_rn(static_cast<float>(static_cast<int8_t>(v & 0xf0u)), s1));
    if constexpr (MODE == kI8Mask)
      wl = round_bf16(__fmul_rn(static_cast<float>(static_cast<int>(v & 15u) - 8), s0));
    else  // lo unsigned, the 8·s0 of the zero subtracted after the rounded product
      wl = round_bf16(__fsub_rn(round_bf16(__fmul_rn(static_cast<float>(v & 15u), s0)), s2));
  }
}

template <int MODE>
__global__ void nibble_kernel(const uint8_t* q, const float* s, float* lo, float* hi, int rows,
                              int cols) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * cols) return;
  const int r = i / cols, n = i - r * cols;
  const size_t plane = static_cast<size_t>(rows / kG) * cols;
  const size_t so = static_cast<size_t>(r / kG) * cols + n;
  const float s0 = round_bf16(__ldg(s + so));
  const float s1 = round_bf16(__ldg(s + plane + so));
  const float s2 = MODE == kAffine ? round_bf16(__ldg(s + 2 * plane + so)) : 0.f;
  float wl, wh;
  dq_byte<MODE>(__ldg(q + i), s0, s1, s2, wl, wh);
  lo[i] = wl;
  hi[i] = wh;
}

// -------------------------------------------------- G. the i4 tensor-core tile

constexpr int kBM = i8t::kBM;            // 64 rows of x per tile
constexpr int kBN = i8t::kBN;            // 128 output columns per tile
constexpr int kThreads = i8t::kThreads;  // 256
constexpr int kStageRows = kG;           // payload rows per stage: 64 rows of K
static_assert(2 * kStageRows == i8t::kBK, "a stage fills i8t_tile.cuh's 64 rows of K");

struct I4Params {
  const uint16_t* x;  // [M, K] bf16 (x3 [M, 2, K/2])
  const uint8_t* q;   // [K/2, N]
  const float* s;     // [R, K/2/32, N]
  float* out;         // [M, N]
  float* part;        // [KS, M, N] when KS > 1
  int* tickets;       // [ceil(M/64), N/128] zeros, reset by the last blocks
  int M, K, N, KS;
};

struct I4Smem {
  i8t::Smem t;           // x [64][72]: k < 32 meet the low nibbles; w [64][136] as [k][n]
  uint16_t s[3][kBN];    // the stage's scale rows, bf16
};

struct I4Stage {
  uint4 x[2];
  uint4 q;
  float4 s;
};

template <int R>
__device__ __forceinline__ void i4_load(const I4Params& p, int m0, int n0, int r0, I4Stage& st) {
  const int t = threadIdx.x, half = p.K >> 1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // 64 rows x 8 chunks of 8 bf16: 4 chunks a half
    const int idx = t + i * kThreads, r = idx >> 3, c = idx & 7, row = m0 + r;
    const int k = (c < 4 ? 0 : half) + r0 + (c & 3) * 8;
    st.x[i] = row < p.M
        ? __ldg(reinterpret_cast<const uint4*>(p.x + static_cast<size_t>(row) * p.K + k))
        : make_uint4(0u, 0u, 0u, 0u);
  }
  st.q = __ldg(reinterpret_cast<const uint4*>(p.q + static_cast<size_t>(r0 + (t >> 3)) * p.N
                                              + n0 + (t & 7) * 16));
  if (t < R * 32) {  // scale row h = t / 32 of the stage's group, 4 columns a thread
    const int h = t >> 5;
    st.s = __ldg(reinterpret_cast<const float4*>(
        p.s + (static_cast<size_t>(h) * (half / kG) + r0 / kG) * p.N + n0 + (t & 31) * 4));
  }
}

// Bytes b0, b1 (bits 0-15 of h) of one payload row → the bf16 pairs of their
// low and high nibbles' weights, scale pairs s0, s1, s2 (bf16 bits, column
// 2j in the low half).
template <int MODE, int UNPACK>
__device__ __forceinline__ void dq_pair(uint32_t h, uint32_t s0, uint32_t s1, uint32_t s2,
                                        uint32_t& lo, uint32_t& hi) {
  if constexpr (MODE == kCurrent && UNPACK == kMagicBf16) {
    const uint32_t t = __byte_perm(h, 0u, 0x4140);  // b0 in bits 0-7, b1 in 16-23
    const uint32_t l = (t & 0x000f000fu) | 0x43004300u;  // 128 + nibble, as bf16
    const uint32_t u = ((t >> 4) & 0x000f000fu) | 0x43004300u;
    const __nv_bfloat162 bias = __halves2bfloat162(__ushort_as_bfloat16(0x4308),
                                                   __ushort_as_bfloat16(0x4308));  // 136
    const __nv_bfloat162 nz = __halves2bfloat162(__ushort_as_bfloat16(0x8000),
                                                 __ushort_as_bfloat16(0x8000));  // -0
    const __nv_bfloat162 wl = __hfma2(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&l), bias),
                                      *reinterpret_cast<const __nv_bfloat162*>(&s0), nz);
    const __nv_bfloat162 wh = __hfma2(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&u), bias),
                                      *reinterpret_cast<const __nv_bfloat162*>(&s1), nz);
    lo = *reinterpret_cast<const uint32_t*>(&wl);
    hi = *reinterpret_cast<const uint32_t*>(&wh);
  } else if constexpr (MODE == kCurrent) {
    float l[2], u[2];  // nibble - 8, exact
    if constexpr (UNPACK == kI32) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int b = static_cast<int>((h >> (8 * j)) & 0xffu);
        l[j] = static_cast<float>((b & 15) - 8);
        u[j] = static_cast<float>((b >> 4) - 8);
      }
    } else if constexpr (UNPACK == kXor88) {
      const uint32_t v = h ^ 0x8888u;  // each nibble ^ 8: its sign-extension is nibble - 8
      l[0] = static_cast<float>(static_cast<int>(v << 28) >> 28);
      u[0] = static_cast<float>(static_cast<int>(v << 24) >> 28);
      l[1] = static_cast<float>(static_cast<int>(v << 20) >> 28);
      u[1] = static_cast<float>(static_cast<int>(v << 16) >> 28);
    } else {  // kMagicF32: 2^23 + nibble, less 2^23 + 8
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        l[j] = __fsub_rn(__uint_as_float(0x4B000000u | ((h >> (8 * j)) & 15u)), 8388616.0f);
        u[j] = __fsub_rn(__uint_as_float(0x4B000000u | ((h >> (8 * j + 4)) & 15u)), 8388616.0f);
      }
    }
    lo = i8t::pack_bf16x2(__fmul_rn(l[0], bf16f(s0 & 0xffffu)), __fmul_rn(l[1], bf16f(s0 >> 16)));
    hi = i8t::pack_bf16x2(__fmul_rn(u[0], bf16f(s1 & 0xffffu)), __fmul_rn(u[1], bf16f(s1 >> 16)));
  } else {
    float wl[2], wh[2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      dq_byte<MODE>((h >> (8 * j)) & 0xffu, bf16f((s0 >> (16 * j)) & 0xffffu),
                    bf16f((s1 >> (16 * j)) & 0xffffu), bf16f((s2 >> (16 * j)) & 0xffffu), wl[j],
                    wh[j]);
    lo = i8t::pack_bf16x2(wl[0], wl[1]);  // already bf16 values: exact
    hi = i8t::pack_bf16x2(wh[0], wh[1]);
  }
}

// Block (j, split, mt): the 64 x 128 tile of rows mt·64, columns j·128 over
// the payload rows of one split (whole groups).
template <int MODE, int UNPACK>
__global__ void __launch_bounds__(kThreads) i4mm_kernel(I4Params p) {
  constexpr int R = MODE == kAffine ? 3 : 2;
  __shared__ I4Smem sm;
  const int t = threadIdx.x;
  const int n0 = blockIdx.x * kBN, split = blockIdx.y, mt = blockIdx.z, m0 = mt * kBM;
  const int ns = (p.K >> 1) / kStageRows;
  const int kb = static_cast<int>(static_cast<long long>(split) * ns / p.KS) * kStageRows;
  const int ke = static_cast<int>(static_cast<long long>(split + 1) * ns / p.KS) * kStageRows;
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  I4Stage st;
  if (kb < ke) i4_load<R>(p, m0, n0, kb, st);
  for (int r0 = kb; r0 < ke; r0 += kStageRows) {
    __syncthreads();  // the last stage's fragments are read
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = t + i * kThreads;
      *reinterpret_cast<uint4*>(&sm.t.x[(idx >> 3) * i8t::kXS + (idx & 7) * 8]) = st.x[i];
    }
    if (t < R * 32) {
      uint16_t* d = &sm.s[t >> 5][(t & 31) * 4];
      *reinterpret_cast<uint2*>(d) = make_uint2(i8t::pack_bf16x2(st.s.x, st.s.y),
                                                i8t::pack_bf16x2(st.s.z, st.s.w));
    }
    __syncthreads();  // the scale rows are staged
    {
      const int r = t >> 3, c = t & 7;  // payload row r of the stage, columns c·16 + [0, 16)
      const uint32_t qv[4] = {st.q.x, st.q.y, st.q.z, st.q.w};
      uint32_t lo[8], hi[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * 16 + 2 * j;
        const uint32_t s0 = *reinterpret_cast<const uint32_t*>(&sm.s[0][col]);
        const uint32_t s1 = *reinterpret_cast<const uint32_t*>(&sm.s[1][col]);
        const uint32_t s2 = R == 3 ? *reinterpret_cast<const uint32_t*>(&sm.s[R - 1][col]) : 0u;
        dq_pair<MODE, UNPACK>(qv[j >> 1] >> ((j & 1) * 16), s0, s1, s2, lo[j], hi[j]);
      }
      uint4* dl = reinterpret_cast<uint4*>(&sm.t.w[r * i8t::kWS + c * 16]);
      uint4* dh = reinterpret_cast<uint4*>(&sm.t.w[(kStageRows + r) * i8t::kWS + c * 16]);
      dl[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      dl[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      dh[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      dh[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    }
    if (r0 + kStageRows < ke) i4_load<R>(p, m0, n0, r0 + kStageRows, st);
    __syncthreads();  // the tile is dequantized
    i8t::mma_stage(sm.t, acc);
  }
  const size_t plane = static_cast<size_t>(p.M) * p.N;
  if (p.KS == 1) {
    i8t::for_tile(m0, n0, acc, [&](int row, int col, float v) {
      if (row < p.M) p.out[static_cast<size_t>(row) * p.N + col] = v;
    });
    return;
  }
  i8t::for_tile(m0, n0, acc, [&](int row, int col, float v) {
    if (row < p.M) p.part[split * plane + static_cast<size_t>(row) * p.N + col] = v;
  });
  if (!i8t::arrive_last(p.tickets + mt * gridDim.x + blockIdx.x, p.KS)) return;
  for (int e = t; e < kBM * kBN; e += kThreads) {
    const int row = m0 + e / kBN, col = n0 + e % kBN;
    if (row >= p.M) continue;
    const size_t o = static_cast<size_t>(row) * p.N + col;
    p.out[o] = i8t::sum_splits(p.part + o, plane, p.KS);
  }
}

template <int MODE, int UNPACK>
int launch_i4mm(const I4Params& p, void* stream) {
  const dim3 grid(p.N / kBN, p.KS, (p.M + kBM - 1) / kBM);
  i4mm_kernel<MODE, UNPACK><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------ H. M = 1 group-dot

constexpr int kGdWarps = 8;           // groups per block, one a warp
constexpr int kGdCols = 128;          // columns per block, 4 a lane
constexpr int kGdRows = kGdWarps * kG;  // payload rows per block

struct GdParams {
  const uint16_t* x;  // [1, K] bf16 (i4: x3 [1, 2, K/2])
  const uint8_t* q;   // i4: [K/2, N] u8; i8: [K, N] int8
  const float* s;     // i4: [2 or 4, K/2/32, N]; i8: [1, K/32, N]
  float* out;         // [1, N]
  float* part;        // [KS, N] when KS > 1
  int* tickets;       // [N / 128] zeros, reset by the last blocks
  int K, N;
};

// Block (j, split): columns j·128 + [0, 128) over the groups split·8 + [0, 8).
template <int FMT>
__global__ void __launch_bounds__(kGdWarps * 32) gd_kernel(GdParams p) {
  constexpr bool I4 = FMT != kGdI8;
  constexpr int H = I4 ? 2 : 1;
  __shared__ float xsm[H][kGdRows];
  __shared__ float red[kGdWarps][kGdCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rows = I4 ? p.K >> 1 : p.K;  // payload rows
  const int ng = rows / kG, KS = gridDim.y;
  const int g0 = blockIdx.y * kGdWarps, n0 = blockIdx.x * kGdCols;
  for (int i = threadIdx.x; i < H * kGdRows; i += kGdWarps * 32) {
    const int h = i / kGdRows, k = g0 * kG + i % kGdRows;
    xsm[h][i % kGdRows] = k < rows ? bf16f(__ldg(p.x + static_cast<size_t>(h) * rows + k)) : 0.f;
  }
  __syncthreads();
  const int g = g0 + warp, col = n0 + lane * 4;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  if (g < ng) {  // whole warps: the shuffles need every lane
    uint32_t b[kG];
#pragma unroll
    for (int i = 0; i < kG; ++i)
      b[i] = __ldg(reinterpret_cast<const uint32_t*>(p.q + static_cast<size_t>(g * kG + i) * p.N
                                                     + col));
    const float* x0 = xsm[0] + warp * kG;
    const size_t plane = static_cast<size_t>(ng) * p.N, so = static_cast<size_t>(g) * p.N + col;
    if constexpr (I4) {
      const float* x1 = xsm[H - 1] + warp * kG;
      const float xs0 = warp_sum(x0[lane]), xs1 = warp_sum(x1[lane]);
      float pl[4] = {0.f, 0.f, 0.f, 0.f}, ph[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kG; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t v = (b[i] >> (8 * j)) & 0xffu;
          pl[j] = __fmaf_rn(x0[i], static_cast<float>(v & 15u), pl[j]);
          ph[j] = __fmaf_rn(x1[i], static_cast<float>(v >> 4), ph[j]);
        }
      const float4 s0 = __ldg(reinterpret_cast<const float4*>(p.s + so));
      const float4 s1 = __ldg(reinterpret_cast<const float4*>(p.s + plane + so));
      const float a0[4] = {s0.x, s0.y, s0.z, s0.w}, a1[4] = {s1.x, s1.y, s1.z, s1.w};
      if constexpr (FMT == kGdI4) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          c[j] = __fadd_rn(__fmul_rn(a0[j], __fsub_rn(pl[j], __fmul_rn(8.f, xs0))),
                           __fmul_rn(a1[j], __fsub_rn(ph[j], __fmul_rn(8.f, xs1))));
      } else {
        const float4 m0 = __ldg(reinterpret_cast<const float4*>(p.s + 2 * plane + so));
        const float4 m1 = __ldg(reinterpret_cast<const float4*>(p.s + 3 * plane + so));
        const float b0[4] = {m0.x, m0.y, m0.z, m0.w}, b1[4] = {m1.x, m1.y, m1.z, m1.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          c[j] = __fadd_rn(__fsub_rn(__fmul_rn(a0[j], pl[j]), __fmul_rn(b0[j], xs0)),
                           __fsub_rn(__fmul_rn(a1[j], ph[j]), __fmul_rn(b1[j], xs1)));
      }
    } else {
      float pp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kG; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pp[j] = __fmaf_rn(
              x0[i], static_cast<float>(static_cast<int8_t>((b[i] >> (8 * j)) & 0xffu)), pp[j]);
      const float4 s0 = __ldg(reinterpret_cast<const float4*>(p.s + so));
      c[0] = __fmul_rn(s0.x, pp[0]);
      c[1] = __fmul_rn(s0.y, pp[1]);
      c[2] = __fmul_rn(s0.z, pp[2]);
      c[3] = __fmul_rn(s0.w, pp[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) red[warp][lane * 4 + j] = c[j];
  __syncthreads();
  const int n = threadIdx.x;  // threads 0-127 sum column n0 + n over the warps, in order
  float tot = 0.f;
  if (n < kGdCols) {
#pragma unroll
    for (int w = 0; w < kGdWarps; ++w) tot = __fadd_rn(tot, red[w][n]);
  }
  if (KS == 1) {
    if (n < kGdCols) p.out[n0 + n] = tot;
    return;
  }
  if (n < kGdCols) p.part[static_cast<size_t>(blockIdx.y) * p.N + n0 + n] = tot;
  if (!i8t::arrive_last(p.tickets + blockIdx.x, KS)) return;
  if (n < kGdCols) p.out[n0 + n] = i8t::sum_splits(p.part + n0 + n, p.N, KS);
}

}  // namespace

// out [R, W] f32 from s [R, C] f32: column c takes s[:, c / g] (tile 0; W
// at most C·g) or s[:, c % C] (tile 1), rounded to bf16 when round_bf16.
extern "C" int bt_probe_expand(const void* s, void* out, int R, int C, int W, int g, int tile,
                               int round, void* stream) {
  const int n = R * W, threads = 256, blocks = (n + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* in = static_cast<const float*>(s);
  float* o = static_cast<float*>(out);
  switch (tile * 2 + round) {
    case 0: expand_kernel<false, false><<<blocks, threads, 0, st>>>(in, o, R, C, W, g); break;
    case 1: expand_kernel<false, true><<<blocks, threads, 0, st>>>(in, o, R, C, W, g); break;
    case 2: expand_kernel<true, false><<<blocks, threads, 0, st>>>(in, o, R, C, W, g); break;
    case 3: expand_kernel<true, true><<<blocks, threads, 0, st>>>(in, o, R, C, W, g); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// lo, hi [rows, cols] f32: the dequantized tiles of q [rows, cols] u8 under
// mode (0 current, 1 i8mask, 2 affine) with f32 scale rows [R, rows/32,
// cols] (R = 3 for affine, else 2); rows a multiple of 32.
extern "C" int bt_probe_nibble(const void* q, const void* s, void* lo, void* hi, int rows,
                               int cols, int mode, void* stream) {
  const int n = rows * cols, threads = 256, blocks = (n + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* qq = static_cast<const uint8_t*>(q);
  const float* ss = static_cast<const float*>(s);
  float *l = static_cast<float*>(lo), *h = static_cast<float*>(hi);
  switch (mode) {
    case kCurrent:
      nibble_kernel<kCurrent><<<blocks, threads, 0, st>>>(qq, ss, l, h, rows, cols);
      break;
    case kI8Mask:
      nibble_kernel<kI8Mask><<<blocks, threads, 0, st>>>(qq, ss, l, h, rows, cols);
      break;
    case kAffine:
      nibble_kernel<kAffine><<<blocks, threads, 0, st>>>(qq, ss, l, h, rows, cols);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// y [M, N] f32 = the split-half i4 dequant matmul (ops/probes_i4.py i4mm)
// split KS ways over whole groups of 32 payload rows: mode 0 current, 1
// i8mask, 2 affine; unpack 0-3 (kI32, kXor88, kMagicF32, kMagicBf16: the
// current mode only).  K a multiple of 64, N of 128.  part: KS·M·N floats
// (null when KS = 1); tickets: ceil(M/64)·N/128 zeros.
extern "C" int bt_probe_i4mm(const void* x, const void* q, const void* s, void* out, void* part,
                             void* tickets, int M, int K, int N, int KS, int mode, int unpack,
                             void* stream) {
  const I4Params p{static_cast<const uint16_t*>(x), static_cast<const uint8_t*>(q),
                   static_cast<const float*>(s), static_cast<float*>(out),
                   static_cast<float*>(part), static_cast<int*>(tickets), M, K, N, KS};
  switch (mode * 4 + unpack) {
    case kCurrent * 4 + kI32: return launch_i4mm<kCurrent, kI32>(p, stream);
    case kCurrent * 4 + kXor88: return launch_i4mm<kCurrent, kXor88>(p, stream);
    case kCurrent * 4 + kMagicF32: return launch_i4mm<kCurrent, kMagicF32>(p, stream);
    case kCurrent * 4 + kMagicBf16: return launch_i4mm<kCurrent, kMagicBf16>(p, stream);
    case kI8Mask * 4 + kI32: return launch_i4mm<kI8Mask, kI32>(p, stream);
    case kAffine * 4 + kI32: return launch_i4mm<kAffine, kI32>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out [1, N] f32 = the M = 1 group-dot (ops/probes_i4.py groupdot), fmt 0
// i4, 1 i4 with mins, 2 i8: the payload's rows a multiple of 32, N of 128.
// part: KS·N floats (null when KS = 1), KS = ceil(rows / 256); tickets:
// N / 128 zeros.
extern "C" int bt_probe_gd(const void* x, const void* q, const void* s, void* out, void* part,
                           void* tickets, int K, int N, int fmt, void* stream) {
  const GdParams p{static_cast<const uint16_t*>(x), static_cast<const uint8_t*>(q),
                   static_cast<const float*>(s), static_cast<float*>(out),
                   static_cast<float*>(part), static_cast<int*>(tickets), K, N};
  const int rows = fmt == kGdI8 ? K : K / 2;
  const dim3 grid(N / kGdCols, (rows + kGdRows - 1) / kGdRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case kGdI4: gd_kernel<kGdI4><<<grid, kGdWarps * 32, 0, st>>>(p); break;
    case kGdI4M: gd_kernel<kGdI4M><<<grid, kGdWarps * 32, 0, st>>>(p); break;
    case kGdI8: gd_kernel<kGdI8><<<grid, kGdWarps * 32, 0, st>>>(p); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
