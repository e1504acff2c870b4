// The i8 stream probes' kernels: where the bandwidth of an int8 weight
// stream goes between its raw read and a fused dequantize-matmul
// (booster_tpu_torch/tools: kernel_micro, cast_probe, mmq_probe, qmm_gap,
// qmm_probe, and the int8 rungs of expander_probe and tqmm_probe;
// ops/probes.py wraps them).
//
// Replaces the 21 Pallas functions of the JAX package's i8 probe tools and
// the int8 ones of tools/expander_probe.py and tools/tqmm_probe.py, which
// compute four functions of the data (B's int8 x int8 N-major form has a
// kernel of its own, E):
//
// A. colsum_kernel<MODE, SIGNED>: column sums of a u8 or i8 [R, C] array
//    into f32 [1, C].  tools/kernel_micro.py:71 _read_kernel (u8, i32 per
//    1024-row block), tools/cast_probe.py:82 k_sum_i32, :96 k_sum_f32 and
//    :109 k_sum_bf16 (each 1024-row block's sum rounded to bf16, the block
//    sums added in f32).  Every mode is exact on int8 inputs up to 2^24 /
//    255 rows (the sums are integers below 2^24, bf16-rounded block sums
//    integers too), so the kernel equals its plain version bit for bit.
//
// B. i8mm_kernel<XI8, NMAJ, SCALE, SF32, OUT_I32>: y [M, N] = x [M, K] @ W
//    for an int8 weight stored K-major [K, N] or N-major [N, K].
//    bf16 x: w = bf16(q), or bf16(f32(q) · f32(bf16 s)) under a scale
//    (rounded once, as bf16 · bf16 rounds in the reference), then
//    mma.sync m16n8k16 with an f32 accumulator; int8 x (the K-major form,
//    mmq_probe's int_mm (a)): mma.sync m16n8k32 s8 · s8 → s32 (exact), kept
//    in i32.  int8 x against an N-major weight is E.
//    Scales: none; a full bf16 [K, N] plane (qmm_gap v2); bf16 group
//    scales [K/32, N], row k taking s[k / 32] (v3); v5's K-reordered rows
//    (row r of K block b takes scale row b·bk/32 + r % (bk/32)); periodic
//    ("tile") scales, row k taking scale row k % (K/32); f32 group or
//    periodic scales, [N, K/32] over an N-major weight or [K/32, N] over a
//    K-major one, rounded to bf16 first.  Replaces cast_probe.py:125 k_dot,
//    :144 k_dot_sub, :190 k_dot_mixed; mmq_probe.py:37 (int_mm's kern, (a)
//    i8 → i32 and (b) bf16 → f32); qmm_gap.py:86 v0, :94 v1, :107 v2, :120
//    v3, :157 v5; qmm_probe.py:82 v_current, :93 v_cast_only;
//    expander_probe.py:152 make_qmm's kernel
//    (dot_f32, dot_bf16, reshape, jrepeat and take: N-major f32 group
//    scales; ptile: periodic; noscale); tqmm_probe.py:79 make_tqmm_i8's
//    kernel (sub_reshape and sub_repeat: K-major f32 group scales;
//    sub_ptile: periodic; noscale).  The TPU's whole-K / sub-tiled /
//    mixed-dot variants (k_dot and k_dot_sub, k_dot_mixed; v0 and v1;
//    v_current's three sub widths; expander_probe's five ways of expanding
//    one scale row, the TPU lowerings that tool compares) are one function
//    and one kernel here: Hopper has no
//    bf16 x int8 MMA, so every bf16 form converts the int8 tile to bf16 on
//    its way to shared memory.
//
// C. i8mm_group_kernel<XI8, NMAJ, G, SF32>: per-group partial products, each
//    group of G rows of K summed from zero on the tensor cores (s32 for
//    int8 x, f32 for bf16 x), multiplied by its group's scale (the scale
//    row of its first 32 rows: row 4g for G = 128) and added in f32.
//    Replaces qmm_gap.py:137 v4 (int8 x, bf16 [K/32, N]), :172 v6 (bf16 x),
//    :189 v7 (bf16 x, G 128); qmm_probe.py:116 v_group_dots (int8 x,
//    N-major, f32 [N, K/32] scales); expander_probe.py:154 make_qmm's gloop
//    (bf16 x, N-major, f32 scales pre-transposed to [K/32, N]).  The scales
//    are read through their two strides, so one form takes either layout.
//    int8 group sums are at most 32·127² = 516,128: exact in f32 before the
//    rescale.
//
// D. blocksum_kernel: expander_probe.py:200-205 make_qmm's castonly, whose
//    every output of N tile t (bn rows of the N-major weight) is
//    sum over K pieces j (sub columns) of f32(S_tj) · f32(1e-9), added in
//    piece order, S_tj the tile's sum over the piece.  S_tj is summed in
//    i32 (exact: bn·sub·127 < 2^31) with __dp4a, so the result depends on
//    no summation order; the reference's f32 sum equals it wherever the
//    sums stay below 2^24 (the tests' sizes) and rounds otherwise.
//
// E. s8mm_kernel<BM, OUT_I32>: y [M, N] = x [M, K] @ q^T for int8 x and an
//    N-major int8 weight q [N, K], exact in i32, kept in i32 or converted to
//    f32 once at the end.  Replaces qmm_probe.py:104 v_dot_only (i32 out)
//    and cast_probe.py:168 k_dot_i8 (f32 out).  Both operands are K-major,
//    the only layout 8-bit wgmma reads, so wgmma.mma_async m64nBMk32
//    .s32.s8.s8 takes the weight as A and x as B (y^T = q x^T: BM, the rows
//    of x, is wgmma's N, 8 to 64) straight from shared memory through
//    descriptors: no registers staged, no byte moved by a thread.
//
// Saturation: int_mm (a) at K = 14336 sums up to 14336·127² ≈ 2.3e8 in
// i32, below 2^31, so the s32 accumulators and split sums never wrap.
//
// What bounds them on the H100.  The bytes at every tool shape: the weight
// stream (11.5 MB for the u8 read, 46.1 MB for cast_probe's [11264, 4096],
// 16.8 MB for qmm_gap's [4096, 4096] and 33.6 MB more for its v2 plane,
// 23.1 MB for qmm_probe's [11264, 2048], 25.2 / 117.4 / 58.7 MB for
// mmq_probe's 7B-shape qkv / gate-up / down) over 3.35 TB/s: 3.4-35 us.
// At M = 64 the operations are at most 2·64·28672·4096 = 15 GFLOP, under
// 16 us at 989 TFLOP/s bf16 and half that at the int8 rate.  So the design
// is about keeping enough bytes in flight on 132 SMs:
// - A: 1024 columns per block, 16 bytes a thread (64 threads a row, 4 rows
//   at a time), batches of 32 rows with all 8 of a thread's loads issued
//   before the first is summed, as many batches a block as still give 264
//   blocks: 352 blocks of 32 rows at [11264, 1024], 352 of 128 rows at
//   [11264, 4096].  Per-block partials are reduced in shared memory, then
//   added with integer (or exact f32) atomics into per-1024-row-block
//   sums; the last block of a column chunk (an atomic ticket) adds the
//   block sums in block order (bf16-rounded in the bf16 mode) and resets
//   them to zero for the next launch.
// - B and C: one tiling for every rung of a tool (the point of the
//   ladder: only the stage under test differs).  A block of 256 threads
//   owns a 64 x 128 output tile and one contiguous range of K, its split;
//   split boundaries fall on multiples of 128 rows of K (a group of 128
//   never straddles two), and the split count is a function of (M, K, N)
//   alone (ops/probes.py splits) that gives about two blocks per SM: at
//   N = 4096, M = 64 the 32 column tiles run 9 splits each.  Each 64-row
//   stage of K goes global → registers (16-byte loads; the next stage in
//   flight while the tensor cores work) → shared memory, where the 8
//   warps (2 along M x 4 along N) take ldmatrix fragments.  int8 mma.sync
//   wants B with K contiguous for each n: an N-major weight has that and
//   is stored as it is; a K-major one is byte-transposed in 4 x 4 blocks
//   with __byte_perm while it is staged.  The bf16 forms store the
//   dequantized tile [k][n] (K-major, ldmatrix .trans) or [n][k] (N-major).
//   The splits' partials are added in split order by the block that
//   arrives last at its tile's ticket, so a result repeats bit for bit.
// Making them fast (wgmma, TMA, a deeper pipeline) is later work: they are
// right and comparable rung against rung.
// - E: one block a tile of 128 weight rows and BM rows of x, over all of K
//   (88 blocks at the tools' 11264 columns, 176 at a ragged M of 100), two
//   blocks an SM.  A ring of 4 stages (128 x 128 weight bytes and BM x 128
//   of x a stage, cp.async, 128-byte swizzle; 3 in flight) feeds the tensor
//   cores; one barrier a stage; no partial sum leaves the block.  Measured
//   on the H100 (tools' shapes): splitting K over more blocks, as stream-K
//   over 132 blocks with partial tiles met in device memory, or as
//   thread-block clusters of 2-4 that meet in distributed shared memory,
//   was slower than whole tiles at every split, and so was one block an SM
//   with twice the bytes of K a stage; the stream of whole tiles runs at
//   about the library call's rate (ops/probes.py s8_rows, PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "i8k_tile.cuh"  // align_1k, desc, cp_async, allow_smem
#include "i8t_tile.cuh"

namespace {

// ------------------------------------------------------------ A. colsum

constexpr int kCsThreads = 256;
constexpr int kCsCols = 1024;                     // columns (bytes of a row) per block
constexpr int kCsLanes = kCsCols / 16;            // threads along a row, 16 bytes each
constexpr int kCsRowsIn = kCsThreads / kCsLanes;  // rows per pass: 4
constexpr int kCsRows = 32;                       // rows per batch of loads
constexpr int kCsPasses = kCsRows / kCsRowsIn;    // 16-byte loads per thread per batch: 8
constexpr int kCsBlocks = 264;                    // blocks wanted: two for each of 132 SMs

enum { kSumI32 = 0, kSumF32 = 1, kSumBF16 = 2 };

struct CsParams {
  const uint8_t* q;  // [R, C] bytes (int8 when signed)
  float* out;        // [1, C]
  uint32_t* acc;     // [R / block_rows, C] zeros (int32, or f32 bits), reset by the last blocks
  int* tickets;      // [C / 1024] zeros, reset by the last blocks
  int R, C, block_rows;
  int rows;          // rows per block: a multiple of 32 that divides block_rows
};

template <bool SIGNED>
__device__ __forceinline__ int byte_at(uint32_t w, int b) {
  const uint32_t v = (w >> (8 * b)) & 0xffu;
  return SIGNED ? static_cast<int>(static_cast<int8_t>(v)) : static_cast<int>(v);
}

// Block (x, y): columns x·1024 + [0, 1024) over rows y·rows + [0, rows),
// in batches of 32 rows whose 8 loads a thread issues before it sums them.
template <int MODE, bool SIGNED>
__global__ void __launch_bounds__(kCsThreads) colsum_kernel(CsParams p) {
  using Acc = typename std::conditional<MODE == kSumI32, int, float>::type;
  __shared__ Acc red[kCsRowsIn][kCsCols];
  const int lc = threadIdx.x % kCsLanes, lr = threadIdx.x / kCsLanes;
  const int c0 = blockIdx.x * kCsCols;
  const int r0 = blockIdx.y * p.rows;
  Acc a[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) a[j] = 0;
  for (int rb = r0; rb < r0 + p.rows; rb += kCsRows) {
    uint4 v[kCsPasses];
#pragma unroll
    for (int i = 0; i < kCsPasses; ++i)
      v[i] = __ldg(reinterpret_cast<const uint4*>(
          p.q + static_cast<size_t>(rb + lr + i * kCsRowsIn) * p.C + c0 + lc * 16));
#pragma unroll
    for (int i = 0; i < kCsPasses; ++i) {
      const uint32_t w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int b = byte_at<SIGNED>(w[j >> 2], j & 3);
        if constexpr (MODE == kSumI32) {
          a[j] += b;
        } else if constexpr (MODE == kSumF32) {
          a[j] = __fadd_rn(a[j], static_cast<float>(b));
        } else {  // the cast to bf16 (exact for a byte), summed in f32
          a[j] = __fadd_rn(a[j], bf16f(bf16_bits(static_cast<float>(b))));
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) red[lr][lc * 16 + j] = a[j];
  __syncthreads();
  Acc* blk = reinterpret_cast<Acc*>(p.acc) + static_cast<size_t>(r0 / p.block_rows) * p.C + c0;
  for (int c = threadIdx.x; c < kCsCols; c += kCsThreads) {
    Acc s = red[0][c];
#pragma unroll
    for (int r = 1; r < kCsRowsIn; ++r) s += red[r][c];
    atomicAdd(blk + c, s);  // integers below 2^24: exact in either type, in any order
  }
  if (!i8t::arrive_last(p.tickets + blockIdx.x, gridDim.y)) return;
  const int nb = p.R / p.block_rows;
  for (int c = threadIdx.x; c < kCsCols; c += kCsThreads) {
    float t = 0.f;
#pragma unroll 4
    for (int b = 0; b < nb; ++b) {  // loads with no store between them: in flight together
      const uint32_t bits = __ldcg(p.acc + static_cast<size_t>(b) * p.C + c0 + c);
      float s = MODE == kSumI32 ? static_cast<float>(static_cast<int>(bits))
                                : __uint_as_float(bits);
      if (MODE == kSumBF16) s = round_bf16(s);
      t = __fadd_rn(t, s);
    }
    p.out[c0 + c] = t;
  }
  for (int c = threadIdx.x; c < kCsCols; c += kCsThreads)  // zeros for the next launch
    for (int b = 0; b < nb; ++b) p.acc[static_cast<size_t>(b) * p.C + c0 + c] = 0u;
}

// ------------------------------------------------------ B, C. int8 weights

constexpr int kBM = 64;         // rows of x per tile
constexpr int kBN = 128;        // output columns per tile
constexpr int kBK = 64;         // rows of K per stage
constexpr int kThreads = 256;   // 8 warps: 2 along M x 4 along N
constexpr int kUnit = 128;      // split boundaries fall on multiples of this many rows of K
constexpr int kSRows = 32;      // rows of K per scale row
constexpr int kX16 = kBK + 8;   // bf16 per x row in shared memory (pads: no ldmatrix conflicts)
constexpr int kWk16 = kBN + 8;  // bf16 per weight row, K-major tile [k][n]
constexpr int kWn16 = kBK + 8;  // bf16 per weight row, N-major tile [n][k]
constexpr int kS8 = kBK + 16;   // bytes per int8 row, [m][k] and [n][k]
constexpr int kSmemBytes = kBM * kX16 * 2 + kBN * kWn16 * 2;  // the largest form

enum { kNone = 0, kPlane = 1, kGroup = 2, kReorder = 3, kTile = 4 };

// The forms of bt_probe_i8mm (ops/probes.py _mm_form) and
// bt_probe_i8mm_group (_group_form).
constexpr int mm_form(bool xi8, bool nmaj, int sc, bool sf32, bool oi32) {
  return int(xi8) | int(nmaj) << 1 | int(sf32) << 2 | int(oi32) << 3 | sc << 4;
}
constexpr int group_form(bool xi8, bool nmaj, bool sf32, int g) {
  return int(xi8) | int(nmaj) << 1 | int(sf32) << 2 | int(g == 128) << 3;
}

struct MmParams {
  const void* x;     // [M, K] bf16 or int8
  const int8_t* q;   // [K, N] (K-major) or [N, K] (N-major)
  const void* s;     // scales (see SCALE), or null
  void* out;         // [M, N] f32 or i32
  void* part;        // [KS, M, N] partials (f32 or i32) when KS > 1
  int* tickets;      // [ceil(M / 64), N / 128] zeros, reset by the last blocks
  int M, K, N, KS;
  int bk;            // kReorder: the rows of K per reorder block
  int sn, sg;        // C: the scales' strides (elements) along N and along the groups
};

__device__ __forceinline__ uint16_t* x16(uint8_t* sm) { return reinterpret_cast<uint16_t*>(sm); }
__device__ __forceinline__ uint16_t* w16(uint8_t* sm) {
  return reinterpret_cast<uint16_t*>(sm + kBM * kX16 * 2);
}
__device__ __forceinline__ uint8_t* x8(uint8_t* sm) { return sm; }
__device__ __forceinline__ uint8_t* w8(uint8_t* sm) { return sm + kBM * kS8; }

// A 64-row stage of K on its way from device memory to shared memory.
struct Stage {
  uint4 x[2];
  uint4 q[2];
  uint4 s[2][2];
};

__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// 16 f32 scales at p (64 bytes, aligned) → 16 bf16 (rounded to nearest
// even), two per word in column order.
__device__ __forceinline__ void ld_scales16(const float* p, uint4 (&s)[2]) {
  const float4* v = reinterpret_cast<const float4*>(p);
  const float4 a = __ldg(v), b = __ldg(v + 1), c = __ldg(v + 2), d = __ldg(v + 3);
  s[0] = make_uint4(i8t::pack_bf16x2(a.x, a.y), i8t::pack_bf16x2(a.z, a.w),
                    i8t::pack_bf16x2(b.x, b.y), i8t::pack_bf16x2(b.z, b.w));
  s[1] = make_uint4(i8t::pack_bf16x2(c.x, c.y), i8t::pack_bf16x2(c.z, c.w),
                    i8t::pack_bf16x2(d.x, d.y), i8t::pack_bf16x2(d.z, d.w));
}

// Two int8 (the low 16 bits of h) → a bf16 pair: bf16(q), or bf16(q · s)
// with the product exact in f32 and rounded once.
template <bool SCALED>
__device__ __forceinline__ uint32_t dq2(uint32_t h, float s0, float s1) {
  const float q0 = static_cast<float>(static_cast<int8_t>(h & 0xffu));
  const float q1 = static_cast<float>(static_cast<int8_t>((h >> 8) & 0xffu));
  if constexpr (SCALED) return i8t::pack_bf16x2(__fmul_rn(q0, s0), __fmul_rn(q1, s1));
  else return i8t::pack_bf16x2(q0, q1);
}

// Four rows of 4 bytes (w[i] = row i, columns 0-3) → four columns of 4
// bytes, stored at dst + c·stride (column c: rows 0-3 in byte order).
__device__ __forceinline__ void transpose4x4(const uint32_t (&w)[4], uint8_t* dst, int stride) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);  // r0b0 r1b0 r0b1 r1b1
  const uint32_t t1 = __byte_perm(w[2], w[3], 0x5140);  // r2b0 r3b0 r2b1 r3b1
  const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362);  // r0b2 r1b2 r0b3 r1b3
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  *reinterpret_cast<uint32_t*>(dst) = __byte_perm(t0, t1, 0x5410);
  *reinterpret_cast<uint32_t*>(dst + stride) = __byte_perm(t0, t1, 0x7632);
  *reinterpret_cast<uint32_t*>(dst + 2 * stride) = __byte_perm(t2, t3, 0x5410);
  *reinterpret_cast<uint32_t*>(dst + 3 * stride) = __byte_perm(t2, t3, 0x7632);
}

// The scale row of K row kr under a K-major scale mode.
template <int SC>
__device__ __forceinline__ int scale_row(int kr, const MmParams& p) {
  if constexpr (SC == kPlane) return kr;
  else if constexpr (SC == kGroup) return kr / kSRows;
  else if constexpr (SC == kTile) return kr % (p.K / kSRows);
  else return (kr / p.bk) * (p.bk / kSRows) + (kr % p.bk) % (p.bk / kSRows);
}

template <bool XI8, bool NMAJ, int SC, bool SF32>
__device__ __forceinline__ void load_stage(const MmParams& p, int m0, int n0, int k, Stage& st) {
  const int t = threadIdx.x;
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (XI8) {  // 64 rows x 4 chunks of 16 int8
    const int r = t >> 2, c = t & 3, row = m0 + r;
    st.x[0] = row < p.M
        ? ld16(static_cast<const int8_t*>(p.x) + static_cast<size_t>(row) * p.K + k + c * 16)
        : z;
  } else {  // 64 rows x 8 chunks of 8 bf16
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = t + i * kThreads, r = idx >> 3, c = idx & 7, row = m0 + r;
      st.x[i] = row < p.M
          ? ld16(static_cast<const uint16_t*>(p.x) + static_cast<size_t>(row) * p.K + k + c * 8)
          : z;
    }
  }
  if constexpr (NMAJ) {  // 128 weight rows x 4 chunks of 16 int8 along K
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = t + i * kThreads, n = idx >> 2, c = idx & 3;
      st.q[i] = ld16(p.q + static_cast<size_t>(n0 + n) * p.K + k + c * 16);
      if constexpr (SC == kGroup) {  // one scale for the chunk's 16 rows of K
        const size_t so = static_cast<size_t>(n0 + n) * (p.K / kSRows) + (k + c * 16) / kSRows;
        st.s[i][0].x = SF32 ? __float_as_uint(__ldg(static_cast<const float*>(p.s) + so))
                            : static_cast<uint32_t>(__ldg(static_cast<const uint16_t*>(p.s) + so))
                                  << 16;
      } else if constexpr (SC == kTile) {  // f32: 16 consecutive scales of row n, mod K/32
        const int sgn = p.K / kSRows;
        ld_scales16(static_cast<const float*>(p.s) + static_cast<size_t>(n0 + n) * sgn
                        + (k + c * 16) % sgn,
                    st.s[i]);
      }
    }
  } else if constexpr (XI8) {  // K-major for s8: 16 quads of rows x 16 octets of columns
    const int no = t & 15, kq = t >> 4;
    const int8_t* src = p.q + static_cast<size_t>(k + kq * 4) * p.N + n0 + no * 8;
    uint2 r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = __ldg(reinterpret_cast<const uint2*>(src + static_cast<size_t>(i) * p.N));
    st.q[0] = make_uint4(r[0].x, r[0].y, r[1].x, r[1].y);
    st.q[1] = make_uint4(r[2].x, r[2].y, r[3].x, r[3].y);
  } else {  // K-major for bf16: 64 rows x 8 chunks of 16 columns
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = t + i * kThreads, r = idx >> 3, c = idx & 7;
      st.q[i] = ld16(p.q + static_cast<size_t>(k + r) * p.N + n0 + c * 16);
      if constexpr (SC != kNone) {
        const size_t so = static_cast<size_t>(scale_row<SC>(k + r, p)) * p.N + n0 + c * 16;
        if constexpr (SF32) {
          ld_scales16(static_cast<const float*>(p.s) + so, st.s[i]);
        } else {
          const uint16_t* sp = static_cast<const uint16_t*>(p.s) + so;
          st.s[i][0] = ld16(sp);
          st.s[i][1] = ld16(sp + 8);
        }
      }
    }
  }
}

template <bool XI8, bool NMAJ, int SC, bool SF32>
__device__ __forceinline__ void store_stage(const Stage& st, uint8_t* sm) {
  const int t = threadIdx.x;
  if constexpr (XI8) {
    const int r = t >> 2, c = t & 3;
    *reinterpret_cast<uint4*>(x8(sm) + r * kS8 + c * 16) = st.x[0];
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = t + i * kThreads, r = idx >> 3, c = idx & 7;
      *reinterpret_cast<uint4*>(x16(sm) + r * kX16 + c * 8) = st.x[i];
    }
  }
  if constexpr (NMAJ) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = t + i * kThreads, n = idx >> 2, c = idx & 3;
      if constexpr (XI8) {
        *reinterpret_cast<uint4*>(w8(sm) + n * kS8 + c * 16) = st.q[i];
      } else {
        const float sc = SC == kGroup ? round_bf16(__uint_as_float(st.s[i][0].x)) : 1.f;
        const uint32_t qv[4] = {st.q[i].x, st.q[i].y, st.q[i].z, st.q[i].w};
        uint32_t o[8];
        if constexpr (SC == kTile) {  // rows 2j, 2j + 1 of the chunk's 16 rows of K
          const uint32_t sv[8] = {st.s[i][0].x, st.s[i][0].y, st.s[i][0].z, st.s[i][0].w,
                                  st.s[i][1].x, st.s[i][1].y, st.s[i][1].z, st.s[i][1].w};
#pragma unroll
          for (int j = 0; j < 8; ++j)
            o[j] = dq2<true>(qv[j >> 1] >> ((j & 1) * 16), bf16f(sv[j] & 0xffffu),
                             bf16f(sv[j] >> 16));
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            o[j] = dq2<SC == kGroup>(qv[j >> 1] >> ((j & 1) * 16), sc, sc);
        }
        uint4* dst = reinterpret_cast<uint4*>(w16(sm) + n * kWn16 + c * 16);
        dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
        dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
      }
    }
  } else if constexpr (XI8) {
    const int no = t & 15, kq = t >> 4;
    const uint32_t lo[4] = {st.q[0].x, st.q[0].z, st.q[1].x, st.q[1].z};  // columns 0-3
    const uint32_t hi[4] = {st.q[0].y, st.q[0].w, st.q[1].y, st.q[1].w};  // columns 4-7
    uint8_t* dst = w8(sm) + (no * 8) * kS8 + kq * 4;
    transpose4x4(lo, dst, kS8);
    transpose4x4(hi, dst + 4 * kS8, kS8);
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = t + i * kThreads, r = idx >> 3, c = idx & 7;
      const uint32_t qv[4] = {st.q[i].x, st.q[i].y, st.q[i].z, st.q[i].w};
      uint32_t o[8];
      if constexpr (SC != kNone) {
        const uint32_t sv[8] = {st.s[i][0].x, st.s[i][0].y, st.s[i][0].z, st.s[i][0].w,
                                st.s[i][1].x, st.s[i][1].y, st.s[i][1].z, st.s[i][1].w};
#pragma unroll
        for (int j = 0; j < 8; ++j)  // columns 2j, 2j + 1 of the chunk
          o[j] = dq2<true>(qv[j >> 1] >> ((j & 1) * 16), bf16f(sv[j] & 0xffffu),
                           bf16f(sv[j] >> 16));
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) o[j] = dq2<false>(qv[j >> 1] >> ((j & 1) * 16), 0.f, 0.f);
      }
      uint4* dst = reinterpret_cast<uint4*>(w16(sm) + r * kWk16 + c * 16);
      dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
      dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
    }
  }
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += one step of K of the staged tile: 32 rows (int8) or 16 (bf16).
// Warp (wm, wn) owns rows wm·32 + [0, 32), columns wn·32 + [0, 32):
// acc[mi][ni] is the m16n8 fragment at rows wm·32 + mi·16, columns
// wn·32 + ni·8.
template <bool XI8, bool NMAJ, typename A>
__device__ __forceinline__ void mma_step(uint8_t* sm, int kk, A (&acc)[2][4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int mat = lane >> 3, r = lane & 7;  // the 8x8 matrix and row this lane addresses
  uint32_t a[2][4];
  uint32_t b[4][2];
  if constexpr (XI8) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      i8t::ldmatrix_x4(a[mi], x8(sm) + (wm * 32 + mi * 16 + (mat & 1) * 8 + r) * kS8 + kk * 32
                                  + (mat >> 1) * 16,
                       false);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      uint32_t t4[4];
      i8t::ldmatrix_x4(t4, w8(sm) + (wn * 32 + nj * 16 + (mat >> 1) * 8 + r) * kS8 + kk * 32
                               + (mat & 1) * 16,
                       false);
      b[2 * nj][0] = t4[0];
      b[2 * nj][1] = t4[1];
      b[2 * nj + 1][0] = t4[2];
      b[2 * nj + 1][1] = t4[3];
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
  } else {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      i8t::ldmatrix_x4(a[mi], x16(sm) + (wm * 32 + mi * 16 + (mat & 1) * 8 + r) * kX16 + kk * 16
                                  + (mat >> 1) * 8,
                       false);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      uint32_t t4[4];
      if constexpr (NMAJ)
        i8t::ldmatrix_x4(t4, w16(sm) + (wn * 32 + nj * 16 + (mat >> 1) * 8 + r) * kWn16 + kk * 16
                                 + (mat & 1) * 8,
                         false);
      else
        i8t::ldmatrix_x4(t4, w16(sm) + (kk * 16 + (mat & 1) * 8 + r) * kWk16 + wn * 32 + nj * 16
                                 + (mat >> 1) * 8,
                         true);
      b[2 * nj][0] = t4[0];
      b[2 * nj][1] = t4[1];
      b[2 * nj + 1][0] = t4[2];
      b[2 * nj + 1][1] = t4[3];
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) i8t::mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
  }
}

// K rows [kb, ke) of split s of KS (whole units of 128 rows).
__device__ __forceinline__ void split_rows(int K, int KS, int s, int& kb, int& ke) {
  const int nu = K / kUnit;
  kb = static_cast<int>(static_cast<long long>(s) * nu / KS) * kUnit;
  ke = static_cast<int>(static_cast<long long>(s + 1) * nu / KS) * kUnit;
}

template <typename A>
__device__ __forceinline__ void zero(A (&acc)[2][4][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
}

// Writes the tile through put(row, col, v): at once when KS is 1; else the
// partial goes to part [KS, M, N] and the block that arrives last at the
// tile's ticket adds the partials in split order (exact for i32).
template <typename A, typename Put>
__device__ __forceinline__ void finish(const MmParams& p, int m0, int n0, int split,
                                       const A (&acc)[2][4][4], Put put) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1, gid = lane >> 2, tig = lane & 3;
  const size_t plane = static_cast<size_t>(p.M) * p.N;
  A* part = static_cast<A*>(p.part);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * 32 + mi * 16 + gid + (e >> 1) * 8;
        const int col = n0 + wn * 32 + ni * 8 + tig * 2 + (e & 1);
        if (row >= p.M) continue;
        if (p.KS == 1) put(row, col, acc[mi][ni][e]);
        else part[split * plane + static_cast<size_t>(row) * p.N + col] = acc[mi][ni][e];
      }
  if (p.KS == 1) return;
  if (!i8t::arrive_last(p.tickets + blockIdx.z * gridDim.x + blockIdx.x, p.KS)) return;
  for (int e = threadIdx.x; e < kBM * kBN; e += kThreads) {
    const int row = m0 + e / kBN, col = n0 + e % kBN;
    if (row >= p.M) continue;
    const A* pr = part + static_cast<size_t>(row) * p.N + col;
    A s = 0;
    for (int k = 0; k < p.KS; ++k) {
      const A v = __ldcg(pr + k * plane);
      if constexpr (std::is_same<A, float>::value) s = __fadd_rn(s, v);
      else s += v;
    }
    put(row, col, s);
  }
}

// B. Block (j, split, mt): the 64 x 128 tile of rows mt·64, columns j·128
// over one split of K.
template <bool XI8, bool NMAJ, int SC, bool SF32, bool OUT_I32>
__global__ void __launch_bounds__(kThreads) i8mm_kernel(MmParams p) {
  __shared__ __align__(16) uint8_t sm[kSmemBytes];
  using A = typename std::conditional<XI8, int, float>::type;
  const int n0 = blockIdx.x * kBN, split = blockIdx.y, m0 = blockIdx.z * kBM;
  int kb, ke;
  split_rows(p.K, p.KS, split, kb, ke);
  A acc[2][4][4];
  zero(acc);
  Stage st;
  if (kb < ke) load_stage<XI8, NMAJ, SC, SF32>(p, m0, n0, kb, st);
  for (int k = kb; k < ke; k += kBK) {
    __syncthreads();  // the last stage's fragments are read
    store_stage<XI8, NMAJ, SC, SF32>(st, sm);
    __syncthreads();
    if (k + kBK < ke) load_stage<XI8, NMAJ, SC, SF32>(p, m0, n0, k + kBK, st);
#pragma unroll
    for (int kk = 0; kk < (XI8 ? kBK / 32 : kBK / 16); ++kk) mma_step<XI8, NMAJ>(sm, kk, acc);
  }
  finish(p, m0, n0, split, acc, [&](int row, int col, A v) {
    const size_t o = static_cast<size_t>(row) * p.N + col;
    if constexpr (OUT_I32) static_cast<int*>(p.out)[o] = static_cast<int>(v);
    else if constexpr (XI8) static_cast<float*>(p.out)[o] = __int2float_rn(static_cast<int>(v));
    else static_cast<float*>(p.out)[o] = static_cast<float>(v);
  });
}

// The scales of this thread's 8 columns for the group whose first row of K
// is k0: sc[ni][c] for column n0 + wn·32 + ni·8 + tig·2 + c, read through the
// scales' strides (either layout).
template <bool SF32>
__device__ __forceinline__ void group_scales(const MmParams& p, int n0, int k0, float (&sc)[4][2]) {
  const int lane = threadIdx.x & 31, wn = (threadIdx.x >> 5) >> 1, tig = lane & 3;
  const int g = k0 / kSRows;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = n0 + wn * 32 + ni * 8 + tig * 2 + c;
      const size_t o = static_cast<size_t>(col) * p.sn + static_cast<size_t>(g) * p.sg;
      sc[ni][c] = SF32 ? __ldg(static_cast<const float*>(p.s) + o)
                       : bf16f(__ldg(static_cast<const uint16_t*>(p.s) + o));
    }
}

// C. As B, but each group of G rows of K is summed from zero and added to
// the f32 accumulator times its scale.
template <bool XI8, bool NMAJ, int G, bool SF32>
__global__ void __launch_bounds__(kThreads) i8mm_group_kernel(MmParams p) {
  __shared__ __align__(16) uint8_t sm[kSmemBytes];
  using A = typename std::conditional<XI8, int, float>::type;
  constexpr int kStep = XI8 ? 32 : 16;
  static_assert(G % kStep == 0 && kUnit % G == 0, "a group is whole steps inside a split unit");
  const int n0 = blockIdx.x * kBN, split = blockIdx.y, m0 = blockIdx.z * kBM;
  int kb, ke;
  split_rows(p.K, p.KS, split, kb, ke);
  float acc[2][4][4];
  A g[2][4][4];
  float sc[4][2];
  zero(acc);
  zero(g);
  Stage st;
  if (kb < ke) {
    load_stage<XI8, NMAJ, kNone, SF32>(p, m0, n0, kb, st);
    group_scales<SF32>(p, n0, kb, sc);
  }
  for (int k = kb; k < ke; k += kBK) {
    __syncthreads();
    store_stage<XI8, NMAJ, kNone, SF32>(st, sm);
    __syncthreads();
    if (k + kBK < ke) load_stage<XI8, NMAJ, kNone, SF32>(p, m0, n0, k + kBK, st);
#pragma unroll
    for (int kk = 0; kk < kBK / kStep; ++kk) {
      mma_step<XI8, NMAJ>(sm, kk, g);
      const int kd = k + (kk + 1) * kStep;
      if (kd % G == 0) {  // the group ends: acc += f32(g) · s, in f32
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float gv = XI8 ? __int2float_rn(static_cast<int>(g[mi][ni][e]))
                                   : static_cast<float>(g[mi][ni][e]);
              acc[mi][ni][e] = __fadd_rn(acc[mi][ni][e], __fmul_rn(gv, sc[ni][e & 1]));
              g[mi][ni][e] = 0;
            }
        if (kd < ke) group_scales<SF32>(p, n0, kd, sc);
      }
    }
  }
  finish(p, m0, n0, split, acc, [&](int row, int col, float v) {
    static_cast<float*>(p.out)[static_cast<size_t>(row) * p.N + col] = v;
  });
}

// ---------------------------------------------------------- D. blocksum

constexpr int kBsThreads = 256;

struct BsParams {
  const int8_t* q;  // [N, K], N-major
  float* out;       // [M, N]
  int* part;        // [N / bn, K / sub] i32 zeros, reset by the last blocks
  int* tickets;     // [N / bn] zeros, reset by the last blocks
  int M, N, K, bn, sub;
  int rows;         // weight rows per block (divides bn)
};

// Block (j, t·(bn / rows) + c): rows t·bn + c·rows + [0, rows) of piece j
// (columns j·sub + [0, sub)) summed in i32, added to S_tj with an integer
// atomic (exact, in any order); the block that arrives last at tile t's
// ticket adds f32(S_tj)·f32(1e-9) over j in order and writes the tile's
// M x bn outputs.
__global__ void __launch_bounds__(kBsThreads) blocksum_kernel(BsParams p) {
  __shared__ int red[kBsThreads / 32];
  __shared__ float val;
  const int j = blockIdx.x, nj = gridDim.x;
  const int chunks = p.bn / p.rows;
  const int t = blockIdx.y / chunks, c = blockIdx.y % chunks;
  const int r0 = t * p.bn + c * p.rows, k0 = j * p.sub;
  const int per_row = p.sub / 16;  // 16-byte loads per row
  int acc = 0;
  for (int i = threadIdx.x; i < p.rows * per_row; i += kBsThreads) {
    const int r = i / per_row, cc = i - r * per_row;
    const uint4 v = ld16(p.q + static_cast<size_t>(r0 + r) * p.K + k0 + cc * 16);
    acc = __dp4a(static_cast<int>(v.x), 0x01010101, acc);  // four signed bytes, each times 1
    acc = __dp4a(static_cast<int>(v.y), 0x01010101, acc);
    acc = __dp4a(static_cast<int>(v.z), 0x01010101, acc);
    acc = __dp4a(static_cast<int>(v.w), 0x01010101, acc);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kBsThreads / 32; ++w) sum += red[w];
    atomicAdd(p.part + t * nj + j, sum);
  }
  if (!i8t::arrive_last(p.tickets + t, nj * chunks)) return;
  if (threadIdx.x == 0) {
    float a = 0.f;
    for (int jj = 0; jj < nj; ++jj) {
      int* sp = p.part + t * nj + jj;
      a = __fadd_rn(a, __fmul_rn(__int2float_rn(__ldcg(sp)), 1e-9f));
      *sp = 0;  // zeros for the next launch
    }
    val = a;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < p.M * p.bn; i += kBsThreads)
    p.out[static_cast<size_t>(i / p.bn) * p.N + t * p.bn + i % p.bn] = val;
}

// ------------------------------------------------ E. s8mm on wgmma

constexpr int kS8Rows = 128;          // weight rows (output columns) of a tile: 64 a warpgroup
constexpr int kS8RingBytes = 98304;   // the ring: 96 KB, two blocks an SM

// A stage: 128 bytes of K (one 128-byte swizzle row) of the BM rows of x,
// then of the tile's 128 weight rows.
template <int BM>
struct S8Cfg {
  static_assert(BM == 8 || BM == 16 || BM == 32 || BM == 64, "a tile has 8, 16, 32 or 64 rows");
  static constexpr int kXB = BM * 128;                   // x bytes of a stage (1 KB or more)
  static constexpr int kSlot = kXB + kS8Rows * 128;      // a multiple of 1024
  static constexpr int kRing = kS8RingBytes / kSlot < 8 ? kS8RingBytes / kSlot : 8;
  static constexpr int kSmem = kRing * kSlot + 1024;     // + slack to align on 1 KB
  static_assert(kRing >= 3, "the ring holds three stages or more");
};

struct S8Params {
  const int8_t* x;  // [M, K]
  const int8_t* q;  // [N, K], N-major
  void* out;        // [M, N] i32 or f32
  int M, K, N;
};

// d (64 x N, s32) += A (64 x 32 int8, K-major at descriptor a) · B (N x 32
// int8, K-major at descriptor b)^T
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_s8<8>(int (&d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<16>(int (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// E. Block (j, mt): output columns j·128 + [0, 128) (weight rows) of x rows
// mt·BM + [0, BM), over all of K in stages of 128 bytes through the ring;
// warpgroup g runs wgmma m64nBMk32 on weight rows 64g + [0, 64) (A)
// against the x rows (B), both through descriptors, and writes its i32
// sums (or their f32) straight from the accumulators.
template <int BM, bool OUT_I32>
__global__ void __launch_bounds__(kThreads, 2) s8mm_kernel(S8Params p) {
  using C = S8Cfg<BM>;
  constexpr int S = C::kRing;
  extern __shared__ uint8_t s8_smem[];
  uint8_t* sm = i8k::align_1k(s8_smem);
  const int t = threadIdx.x, wg = t >> 7, w = (t >> 5) & 3, l = t & 31;
  const int n = p.K / 128, m0 = blockIdx.y * BM, n0 = blockIdx.x * kS8Rows;
  auto load = [&](int st, uint8_t* slot) {
    const int k = st * 128;
#pragma unroll
    for (int i = 0; i < kS8Rows * 8 / kThreads; ++i) {  // 128 rows x 8 chunks of 16 bytes
      const int v = t + i * kThreads, r = v >> 3, c = v & 7;
      cpasync::cp_async16(slot + C::kXB + r * 128 + ((c ^ (r & 7)) << 4),
                          p.q + static_cast<size_t>(n0 + r) * p.K + k + c * 16, true);
    }
#pragma unroll
    for (int i = 0; i < (BM * 8 + kThreads - 1) / kThreads; ++i) {  // BM rows, zeros past M
      const int v = t + i * kThreads, r = v >> 3, c = v & 7;
      if (BM * 8 % kThreads == 0 || v < BM * 8) {
        const int row = m0 + r;
        const bool live = row < p.M;
        cpasync::cp_async16(slot + r * 128 + ((c ^ (r & 7)) << 4),
                            live ? p.x + static_cast<size_t>(row) * p.K + k + c * 16 : p.x, live);
      }
    }
  };
  int acc[BM / 2];
#pragma unroll
  for (int j = 0; j < BM / 2; ++j) acc[j] = 0;
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < n) load(i, sm + i * C::kSlot);
    cpasync::cp_commit();
  }
  for (int i = 0; i < n; ++i) {
    cpasync::cp_wait<S - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma
    __syncthreads();  // stage i is in; every wgmma of stage i - 1 is done
    if (i + S - 1 < n) load(i + S - 1, sm + ((i + S - 1) % S) * C::kSlot);
    cpasync::cp_commit();
    const uint8_t* slot = sm + (i % S) * C::kSlot;
    const uint64_t da = i8k::desc(slot + C::kXB + wg * 64 * 128), db = i8k::desc(slot);
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_s8<BM>(acc, da + 2 * kk, db + 2 * kk);  // 32 bytes each
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
  }
  cpasync::cp_wait<0>();
  // acc[i]: output column n0 + 64·wg + 16·w + l/4 + 8·((i/2) % 2), row m0 +
  // 8·(i/4) + 2·(l % 4) + i % 2 (wgmma's accumulator layout)
  const int c0 = n0 + 64 * wg + 16 * w + (l >> 2), r0 = m0 + 2 * (l & 3);
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) {
    const int row = r0 + 8 * (i >> 2) + (i & 1);
    if (row >= p.M) continue;
    const size_t o = static_cast<size_t>(row) * p.N + c0 + 8 * ((i >> 1) & 1);
    if constexpr (OUT_I32) static_cast<int*>(p.out)[o] = acc[i];
    else static_cast<float*>(p.out)[o] = __int2float_rn(acc[i]);
  }
}

template <int BM, bool OUT_I32>
cudaError_t launch_s8(const S8Params& p, cudaStream_t st) {
  static bool ready = false;
  const cudaError_t e = qring::allow_smem(s8mm_kernel<BM, OUT_I32>, S8Cfg<BM>::kSmem, ready);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.N / kS8Rows, (p.M + BM - 1) / BM);
  s8mm_kernel<BM, OUT_I32><<<grid, kThreads, S8Cfg<BM>::kSmem, st>>>(p);
  return cudaGetLastError();
}

template <typename Kernel>
int launch(Kernel kernel, const MmParams& p, void* stream) {
  const dim3 grid(p.N / kBN, p.KS, (p.M + kBM - 1) / kBM);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out [1, C] f32 = column sums of q [R, C] (u8, or int8 when is_signed) by
// mode (0: i32 per block of block_rows, 1: f32, 2: each block's sum rounded
// to bf16), R a multiple of block_rows and block_rows of 32, C of 1024.
// acc: (R / block_rows)·C 4-byte zeros; tickets: C / 1024 zeros (both left
// zero).  Each block takes the most rows (32 doubled while it divides
// block_rows) that still give 264 blocks.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int bt_probe_colsum(const void* q, void* out, void* acc, void* tickets, int R, int C,
                               int block_rows, int mode, int is_signed, void* stream) {
  int rows = kCsRows;
  while (block_rows % (2 * rows) == 0 && (C / kCsCols) * (R / (2 * rows)) >= kCsBlocks) rows *= 2;
  const CsParams p{static_cast<const uint8_t*>(q), static_cast<float*>(out),
                   static_cast<uint32_t*>(acc), static_cast<int*>(tickets), R, C, block_rows,
                   rows};
  const dim3 grid(C / kCsCols, R / rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode * 2 + (is_signed ? 1 : 0)) {
    case 0: colsum_kernel<kSumI32, false><<<grid, kCsThreads, 0, s>>>(p); break;
    case 1: colsum_kernel<kSumI32, true><<<grid, kCsThreads, 0, s>>>(p); break;
    case 2: colsum_kernel<kSumF32, false><<<grid, kCsThreads, 0, s>>>(p); break;
    case 3: colsum_kernel<kSumF32, true><<<grid, kCsThreads, 0, s>>>(p); break;
    case 4: colsum_kernel<kSumBF16, false><<<grid, kCsThreads, 0, s>>>(p); break;
    case 5: colsum_kernel<kSumBF16, true><<<grid, kCsThreads, 0, s>>>(p); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// y [M, N] = x [M, K] @ W split KS ways over K (ops/probes.py i8mm).
// form: mm_form(x_i8, n_major, scale, s_f32, out_i32), one of the forms
// instantiated below.  K a multiple of 128 (and of bk for the reordered
// scales, of 512 for the periodic ones), N of 128.  part: KS·M·N 4-byte
// (null when KS = 1); tickets: ceil(M/64)·N/128 zeros.
extern "C" int bt_probe_i8mm(const void* x, const void* q, const void* s, void* out, void* part,
                             void* tickets, int M, int K, int N, int KS, int bk, int form,
                             void* stream) {
  const MmParams p{x, static_cast<const int8_t*>(q), s, out, part, static_cast<int*>(tickets),
                   M, K, N, KS, bk, 0, 0};
  switch (form) {
    case mm_form(false, true, kNone, false, false):
      return launch(i8mm_kernel<false, true, kNone, false, false>, p, stream);
    case mm_form(true, false, kNone, false, true):
      return launch(i8mm_kernel<true, false, kNone, false, true>, p, stream);
    case mm_form(false, false, kNone, false, false):
      return launch(i8mm_kernel<false, false, kNone, false, false>, p, stream);
    case mm_form(false, false, kPlane, false, false):
      return launch(i8mm_kernel<false, false, kPlane, false, false>, p, stream);
    case mm_form(false, false, kGroup, false, false):
      return launch(i8mm_kernel<false, false, kGroup, false, false>, p, stream);
    case mm_form(false, false, kReorder, false, false):
      return launch(i8mm_kernel<false, false, kReorder, false, false>, p, stream);
    case mm_form(false, true, kGroup, true, false):
      return launch(i8mm_kernel<false, true, kGroup, true, false>, p, stream);
    case mm_form(false, true, kTile, true, false):
      return launch(i8mm_kernel<false, true, kTile, true, false>, p, stream);
    case mm_form(false, false, kGroup, true, false):
      return launch(i8mm_kernel<false, false, kGroup, true, false>, p, stream);
    case mm_form(false, false, kTile, true, false):
      return launch(i8mm_kernel<false, false, kTile, true, false>, p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// y [M, N] = x [M, K] @ q^T for int8 x and an N-major int8 q [N, K], exact,
// in i32 (out_i32) or converted to f32 (ops/probes.py i8mm, its s8 forms):
// tiles of bm rows (8, 16, 32 or 64: ops/probes.py s8_rows), one block a
// tile.  K and N multiples of 128.  Returns the CUDA error of the launch (0
// on success).
extern "C" int bt_probe_s8mm(const void* x, const void* q, void* out, int M, int K, int N,
                             int bm, int out_i32, void* stream) {
  const S8Params p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(q), out, M, K, N};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bm * 2 + (out_i32 ? 1 : 0)) {
    case 16: return static_cast<int>(launch_s8<8, false>(p, s));
    case 17: return static_cast<int>(launch_s8<8, true>(p, s));
    case 32: return static_cast<int>(launch_s8<16, false>(p, s));
    case 33: return static_cast<int>(launch_s8<16, true>(p, s));
    case 64: return static_cast<int>(launch_s8<32, false>(p, s));
    case 65: return static_cast<int>(launch_s8<32, true>(p, s));
    case 128: return static_cast<int>(launch_s8<64, false>(p, s));
    case 129: return static_cast<int>(launch_s8<64, true>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory bytes a block of the s8 kernel takes at tiles of bm
// rows (its ring and 1 KB of alignment slack); -1 for another bm.
extern "C" int bt_probe_s8_smem(int bm) {
  switch (bm) {
    case 8: return S8Cfg<8>::kSmem;
    case 16: return S8Cfg<16>::kSmem;
    case 32: return S8Cfg<32>::kSmem;
    case 64: return S8Cfg<64>::kSmem;
    default: return -1;
  }
}

// y [M, N] f32 = sum over groups of G rows of K of (x @ W over the group) ·
// the group's scale (ops/probes.py i8mm_group).  form: group_form(x_i8,
// n_major, s_f32, G); scale (g, n) at s + n·sn + g·sg (elements).  Shapes as
// bt_probe_i8mm.
extern "C" int bt_probe_i8mm_group(const void* x, const void* q, const void* s, void* out,
                                   void* part, void* tickets, int M, int K, int N, int KS,
                                   int sn, int sg, int form, void* stream) {
  const MmParams p{x, static_cast<const int8_t*>(q), s, out, part, static_cast<int*>(tickets),
                   M, K, N, KS, 0, sn, sg};
  switch (form) {
    case group_form(true, false, false, 32):
      return launch(i8mm_group_kernel<true, false, 32, false>, p, stream);
    case group_form(true, true, true, 32):
      return launch(i8mm_group_kernel<true, true, 32, true>, p, stream);
    case group_form(false, false, false, 32):
      return launch(i8mm_group_kernel<false, false, 32, false>, p, stream);
    case group_form(false, false, false, 128):
      return launch(i8mm_group_kernel<false, false, 128, false>, p, stream);
    case group_form(false, true, true, 32):
      return launch(i8mm_group_kernel<false, true, 32, true>, p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out [M, N] f32: expander_probe's castonly over the N-major int8 q [N, K]
// (ops/probes.py blocksum): N a multiple of bn, K of sub, sub of 16.  part:
// (N / bn)·(K / sub) int32 zeros, tickets: N / bn zeros (both left zero).
// Each block takes the most rows (bn halved while even) that still give 264
// blocks.
extern "C" int bt_probe_blocksum(const void* q, void* out, void* part, void* tickets, int M,
                                 int N, int K, int bn, int sub, void* stream) {
  int rows = bn;
  while (rows % 2 == 0 && (K / sub) * (N / rows) < kCsBlocks) rows /= 2;
  const BsParams p{static_cast<const int8_t*>(q), static_cast<float*>(out),
                   static_cast<int*>(part), static_cast<int*>(tickets), M, N, K, bn, sub, rows};
  blocksum_kernel<<<dim3(K / sub, N / rows), kBsThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
