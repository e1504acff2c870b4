// The M = 1 4-bit K-major matvec: qmm_i4t.cu's group-dot matvec and its
// fused gate-up, on i8mv.cuh's block (a lane 4 columns, a warp a group at a
// time, 8 warps a 128-column tile over one K split, a tile's splits one
// cluster) with each group's dots on the tensor cores.
//
// y[n] = sum_k x[k] · W[k, n] from a 4-bit payload q [K/2, N] u8: byte row
// r holds k = r in its low nibble and k = r + K/2 in its high nibble, for
// every column.  Scale planes s [R, K/(2G), N] bf16: rows 0 and 1 scale the
// low and the high half, rows 2 and 3 (R = 4) hold their mins.
//   Per half h and group g of G rows: p = the f32 sum of the G exact
//   products bf16(x)·q over the raw nibbles (mma.sync m16n8k16, bf16 in, f32
//   accumulate: the group's G/16 k16 steps in order, each summed inside the
//   tensor core); xs = the f32 sum of the group's bf16(x) (a lane's 2G/16
//   rows in order, then a butterfly over the 4 lanes of its quad); p -=
//   zero·xs when zero != 0; c_h = f32(bf16 s_h)·p - f32(bf16 m_h)·xs
//   (mins); the group adds c_lo + c_hi.  y = the f32 sum of the groups in a
//   fixed order: a warp's groups in turn, then the block's 8 warps in order,
//   then the K splits in order (booster_tpu_torch/testing.py
//   qmm_i4t_mv_split mirrors it, the tensor cores' k16 sums by torch's).
//
// What bounds it on the H100: the payload and scale bytes (half a byte and,
// at G = 32, 1/16 byte of bf16 scale a weight) over 3.35 TB/s.  Two things
// kept i8mv.cuh's CUDA-core block on this layout at about half that bound on
// the 28-37 MB rows (PERF.md §6): a nibble costs a byte permute, a
// subtraction and an FMA (about 40 instructions a payload word), and a
// warp waits on its next group's loads (a register ring of one group ahead
// holds 4 KB a warp).  So:
//   - The products go to mma.sync: a byte permute, two masks, a shift and
//     two bf16x2 subtractions give two fragment registers of exact nibbles
//     (0x4300 | q is the bf16 128 + q), about 12 instructions a word.  A lane
//     (4gq + t of its warp) feeds, of each 32-column block b of the tile,
//     columns 32b + 4gq .. + 3 at rows {2t, 2t + 1, 2t + 8, 2t + 9} of each
//     k16 step: exactly its A fragments (W^T: rows the columns, k the payload
//     rows) of the m16 tiles (b, 0) and (b, 1), whose rows gq and gq + 8 are
//     columns 32b + 4gq + 2u and + 1.  B is x (rows 16s + 2t, + 1 and + 8,
//     + 9 of each half, in every column of the n8 tile), so D's rows hold
//     each column's p; of the 16 columns a quad holds alike, lane t keeps
//     block t's (columns 32t + 4gq .. + 3) and scales and adds them.
//   - A warp copies its groups' payload rows into stages of its own in
//     shared memory with cp.async (no registers held in flight), kStages - 1
//     groups ahead, 16-byte chunks swizzled so that its reads hit 32
//     distinct banks; the scales come two groups ahead and x one group ahead
//     in registers.  No block barrier before the stream.  At G = 16 (Q2_K,
//     Q3_K) a group is one k16 step a half and a stage holds 2 KB, half
//     its bytes at G = 32: the same swizzle gives a warp's reads of a
//     16-row stage 32 distinct banks (it depends on the row within a k16
//     step only), and two stages in flight hold half the bytes; a deeper
//     ring for the small groups is speed work still to do (PERF.md §6).
//   - A tile's KS splits (at most 8) form one thread-block cluster and add
//     in split order in the writing block's shared memory (i8mv::finish): no
//     partials in device memory, no ticket, no workspace, and every launch
//     repeats the last bit for bit.
//   - The fused gate-up's block is two such halves (gate tile j and up tile
//     ff/128 + j, the same split); its cluster writes silu(g)·u (OUT
//     kGateUp) or gelu(g)·u (kGateUpGelu, Gemma's gated tanh-GELU).  Each half
//     runs the code of a matvec block, so the gate-up equals the matvec on
//     its fused weight + silu·mul bit for bit.
// ops/qmm.py i4t_mv_plan gives KS from (K, N, G) alone (K/(2G) groups): the
// matvec and the gate-up on one fused weight take one plan.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "i8mv.cuh"
#include "i8t_tile.cuh"  // mma_bf16

namespace i4mv {

using i8mv::kBN;
using i8mv::kWarps;
constexpr int kStages = 3;  // a warp's groups in shared memory: two in flight, one in use

struct Op {
  const uint16_t* x;  // [K] bf16, on 4 bytes
  const uint8_t* q;   // [K/2, N]
  const uint16_t* s;  // [R, K/(2G), N] bf16: scales of the two halves, then (R = 4) mins
  void* out;          // f32 [N], or bf16 [N/2] for the gate-up
  int K, N, KS, zero;
};

// A group's G payload rows of the tile live in a stage of shared memory of
// G·128 bytes: row r's 16-byte chunk c (columns 16c .. + 15) at chunk
// position c ^ swz(r), so that a warp's 16-byte reads of 4 rows 2 apart
// (below) touch 32 distinct banks.
__device__ __forceinline__ int swz(int r) { return ((r >> 1) & 3) << 1; }

template <int G>
constexpr int kStageBytes = G * kBN;

// The warp's cp.async copies of group g's payload rows (columns col .. +
// 127) into a stage: lane l copies chunks l, l + 32, ... (row q / 8, chunk
// q % 8), a warp's copy 4 whole rows.
template <int G>
__device__ __forceinline__ void copy_group(uint8_t* stage, const Op& op, int col, int g) {
  const int lane = threadIdx.x & 31;
  const uint8_t* src = op.q + static_cast<size_t>(g) * G * op.N + col;
#pragma unroll
  for (int i = 0; i < G * 8 / 32; ++i) {
    const int q = lane + 32 * i, r = q >> 3, c = q & 7;
    cpasync::cp_async16(stage + r * kBN + ((c ^ swz(r)) << 4),
                        src + static_cast<size_t>(r) * op.N + 16 * c, true);
  }
}

// The lane's words of column block b of a stage: w[s][i] holds columns 32b
// + 4gq .. + 3 of row 16s + 2t + (i & 1) + 8(i >> 1) (lane = 4gq + t):
// word gq % 4 of chunk 2b + gq / 4, whose swizzled positions put a warp's
// 32 reads on 32 distinct banks.
template <int G>
__device__ __forceinline__ void read_block(uint32_t (&w)[G / 16][4], const uint8_t* stage, int b) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < G / 16; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 16 * s + 2 * t + (i & 1) + 8 * (i >> 1);
      w[s][i] = *reinterpret_cast<const uint32_t*>(
          stage + r * kBN + (((2 * b + (gq >> 2)) ^ swz(r)) << 4) + 4 * (gq & 3));
    }
}

// The scales (and mins) of the lane's 4 columns col + 32t + 4gq .. + 3.
template <bool MINS>
struct Scales {
  uint2 s[2];  // low half, high half
  uint2 m[2];
};

template <int G, bool MINS>
__device__ __forceinline__ void load_scales(Scales<MINS>& d, const Op& op, int col, int g) {
  const int lane = threadIdx.x & 31, half = op.K >> 1;
  const size_t plane = static_cast<size_t>(half / G) * op.N;
  const uint16_t* s = op.s + static_cast<size_t>(g) * op.N + col + 32 * (lane & 3) + 4 * (lane >> 2);
  d.s[0] = i8mv::ld64(s);
  d.s[1] = i8mv::ld64(s + plane);
  if constexpr (MINS) {
    d.m[0] = i8mv::ld64(s + 2 * plane);
    d.m[1] = i8mv::ld64(s + 3 * plane);
  }
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// Group g's x at the lane's rows of each half, as mma B fragments:
// x[h][s] = (x[16s + 2t], + 1) and (x[16s + 2t + 8], + 9) of half h.
template <int G>
__device__ __forceinline__ void load_x(uint32_t (&x)[2][G / 16][2], const Op& op, int g) {
  const int t = threadIdx.x & 3, half = op.K >> 1;
  const uint16_t* p = op.x + g * G + 2 * t;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int s = 0; s < G / 16; ++s) {
      x[h][s][0] = ld32(p + h * half + 16 * s);
      x[h][s][1] = ld32(p + h * half + 16 * s + 8);
    }
}

// (a & 0x000f000f) | c in one instruction (the compiler splits the C form
// into two when both masks are constants).
__device__ __forceinline__ uint32_t nibbles_or(uint32_t a, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, 0x000f000f, %2, 0xEA;\n" : "=r"(d) : "r"(a), "r"(c));
  return d;
}

// The A fragment registers of one column for two payload rows: byte j of w0
// and of w1 (rows k and k + 1) → the bf16 pairs of their low nibbles (lo)
// and high nibbles (hi), exact: 0x4300 | q is the bf16 128 + q, less 128.
__device__ __forceinline__ void frag(uint32_t w0, uint32_t w1, int j, uint32_t bias,
                                     uint32_t& lo, uint32_t& hi) {
  const uint32_t sel = (j | j << 4 | (4 + j) << 8 | (4 + j) << 12);
  const uint32_t t = __byte_perm(w0, w1, sel);  // w0's byte j in bits 0-7, w1's in 16-23
  const uint32_t l = nibbles_or(t, bias);
  const uint32_t h = nibbles_or(t >> 4, bias);
  const __nv_bfloat162 b128 = *reinterpret_cast<const __nv_bfloat162*>(&bias);
  const __nv_bfloat162 ql = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&l), b128);
  const __nv_bfloat162 qh = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&h), b128);
  lo = *reinterpret_cast<const uint32_t*>(&ql);
  hi = *reinterpret_cast<const uint32_t*>(&qh);
}

// Column block b (the lane's words w of it) on the tensor cores: p of the 8
// columns of the quad's block, each half's G/16 k16 steps in order; lane t
// keeps block t's (columns 32t + 4gq .. + 3).
template <int G>
__device__ __forceinline__ void block_dots(const uint32_t (&w)[G / 16][4],
                                           const uint32_t (&x)[2][G / 16][2], int b,
                                           uint32_t bias, float (&pl)[4], float (&ph)[4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int u = 0; u < 2; ++u) {  // m16 tile (b, u): columns 32b + 4gq + 2u and + 1
    float dl[4] = {0.f, 0.f, 0.f, 0.f}, dh[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < G / 16; ++s) {
      uint32_t al[4], ah[4];
      frag(w[s][0], w[s][1], 2 * u, bias, al[0], ah[0]);
      frag(w[s][0], w[s][1], 2 * u + 1, bias, al[1], ah[1]);
      frag(w[s][2], w[s][3], 2 * u, bias, al[2], ah[2]);
      frag(w[s][2], w[s][3], 2 * u + 1, bias, al[3], ah[3]);
      i8t::mma_bf16(dl, al, x[0][s][0], x[0][s][1]);
      i8t::mma_bf16(dh, ah, x[1][s][0], x[1][s][1]);
    }
    if (b == t) {
      pl[2 * u] = dl[0];
      pl[2 * u + 1] = dl[2];
      ph[2 * u] = dh[0];
      ph[2 * u + 1] = dh[2];
    }
  }
}

// The group's c_lo + c_hi of the lane's 4 columns added to acc.  Every lane
// of the warp takes part (the shuffles).
template <int G, bool MINS>
__device__ __forceinline__ void group_sum(const Scales<MINS>& d, const uint32_t (&x)[2][G / 16][2],
                                          const float (&pl)[4], const float (&ph)[4], float zero,
                                          float (&acc)[4]) {
  float sl = 0.f, sh = 0.f;  // the group sums of bf16 x, where the zero or the mins need them
  if (MINS || zero != 0.f) {
#pragma unroll
    for (int s = 0; s < G / 16; ++s)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sl = __fadd_rn(__fadd_rn(sl, i8mv::bf16_lo(x[0][s][i])), i8mv::bf16_hi(x[0][s][i]));
        sh = __fadd_rn(__fadd_rn(sh, i8mv::bf16_lo(x[1][s][i])), i8mv::bf16_hi(x[1][s][i]));
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sl = __fadd_rn(sl, __shfl_xor_sync(0xffffffffu, sl, o));
      sh = __fadd_rn(sh, __shfl_xor_sync(0xffffffffu, sh, o));
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float a = pl[j], b = ph[j];
    if (zero != 0.f) {
      a = __fsub_rn(a, __fmul_rn(zero, sl));
      b = __fsub_rn(b, __fmul_rn(zero, sh));
    }
    float cl = __fmul_rn(i8mv::bf16_of(d.s[0], j), a);
    float ch = __fmul_rn(i8mv::bf16_of(d.s[1], j), b);
    if constexpr (MINS) {
      cl = __fsub_rn(cl, __fmul_rn(i8mv::bf16_of(d.m[0], j), sl));
      ch = __fsub_rn(ch, __fmul_rn(i8mv::bf16_of(d.m[1], j), sh));
    }
    acc[j] = __fadd_rn(acc[j], __fadd_rn(cl, ch));
  }
}

template <int G, int H>
constexpr int kSmemBytes = kWarps * H * kStages * kStageBytes<G>;

// Block (j, s) of a launch over (N / 128 tiles (gate-up: ff / 128 pairs),
// KS splits): H halves of 8 warps, half h on tile j + h·ff/128, warp w on
// groups c0 + w, c0 + w + 8, ... of split s.  A warp keeps kStages - 1
// groups' payload in flight in its own stages of shared memory, the scales
// of the next two groups and the x of the next one in registers.
template <int G, bool MINS, i8mv::Out OUT>
__global__ void __launch_bounds__(32 * kWarps * (i8mv::gate_up(OUT) ? 2 : 1),
                                  i8mv::gate_up(OUT) ? 1 : 2) mv_kernel(Op op) {
  static_assert(G % 16 == 0 && G <= 32, "a group is one or two k16 steps");
  constexpr int H = i8mv::gate_up(OUT) ? 2 : 1;
  constexpr int S = G / 16;
  extern __shared__ __align__(16) uint8_t stages[];
  __shared__ i8mv::Sums<H> sm;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int half = wid / kWarps, w = wid % kWarps;
  const int j = blockIdx.x, s = blockIdx.y, KS = op.KS;
  if (KS > 1) i8mv::cluster_arrive_relaxed();  // this block has started
  const int col = j * kBN + (H == 2 ? half * (op.N / 2) : 0);  // the tile's first column
  int c0, c1;
  i8mv::split_chunks((op.K >> 1) / G, KS, s, c0, c1);
  const int ng = c1 - c0 > w ? (c1 - c0 - w + kWarps - 1) / kWarps : 0;  // the warp's groups
  const int g0 = c0 + w;  // group gi of the warp is g0 + 8·gi
  uint8_t* mine = stages + wid * kStages * kStageBytes<G>;
  const float zero = static_cast<float>(op.zero);
  const uint32_t bias = 0x43004300u;  // the bf16 pair 128, 128
  float acc[4] = {0.f, 0.f, 0.f, 0.f}, pl[4] = {}, ph[4] = {};
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < ng) copy_group<G>(mine + i * kStageBytes<G>, op, col, g0 + kWarps * i);
    cpasync::cp_commit();
  }
  Scales<MINS> s0, s1, s2;  // groups gi, gi + 1, gi + 2
  uint32_t xc[2][S][2], xn[2][S][2];  // x of groups gi, gi + 1
  if (ng > 0) {
    load_scales<G>(s0, op, col, g0);
    load_x<G>(xc, op, g0);
  }
  if (ng > 1) load_scales<G>(s1, op, col, g0 + kWarps);
  for (int gi = 0; gi < ng; ++gi) {
    const int g = g0 + kWarps * gi;
    if (gi + kStages - 1 < ng)
      copy_group<G>(mine + (gi + kStages - 1) % kStages * kStageBytes<G>, op, col,
                    g + kWarps * (kStages - 1));
    cpasync::cp_commit();
    if (gi + 2 < ng) load_scales<G>(s2, op, col, g + 2 * kWarps);
    if (gi + 1 < ng) load_x<G>(xn, op, g + kWarps);
    cpasync::cp_wait<kStages - 1>();  // this lane's copies of group gi are in
    __syncwarp();                      // and every lane's
    const uint8_t* stage = mine + gi % kStages * kStageBytes<G>;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      uint32_t wv[S][4];
      read_block<G>(wv, stage, b);
      block_dots<G>(wv, xc, b, bias, pl, ph);
    }
    __syncwarp();  // the stage is read: the next round's copy may refill it
    group_sum<G>(s0, xc, pl, ph, zero, acc);
    s0 = s1;
    s1 = s2;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < S; ++k) {
        xc[h][k][0] = xn[h][k][0];
        xc[h][k][1] = xn[h][k][1];
      }
  }
  i8mv::finish<H, OUT>(sm, acc, 32 * (lane & 3) + 4 * (lane >> 2), half, w, j, s, KS, op.out,
                       nullptr);
}

// Launches mv_kernel over (tiles, KS): ops/qmm.py i4t_mv_plan's KS (1-8), a
// tile's splits as one cluster, the stages in dynamic shared memory.
template <int G, bool MINS, i8mv::Out OUT>
cudaError_t run(const Op& op, cudaStream_t st) {
  constexpr int H = i8mv::gate_up(OUT) ? 2 : 1;
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        mv_kernel<G, MINS, OUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes<G, H>);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  return i8mv::launch<H>(mv_kernel<G, MINS, OUT>, op, op.N, op.KS, st, kSmemBytes<G, H>);
}

}  // namespace i4mv
