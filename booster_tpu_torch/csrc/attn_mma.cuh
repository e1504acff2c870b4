// The tensor-core attention step shared by decode_attn.cu and prefill_attn.cu.
//
// A block of 8 warps walks a range of cache columns in stages of 128 columns
// (K and V rows, for an int8 cache their scales too) that cp.async brings
// into a 2-stage ring of shared memory, so the next stage's copy overlaps
// this stage's products.  The tiles stay in their storage type there (bf16,
// or int8 cast to bf16 as the fragments are built: exact); the block's q
// rows come in with the first stage and the A fragments are read from
// shared memory at each step, which keeps a thread within 128 registers
// (two blocks an SM where the shared memory allows).  Each warp owns 16
// query rows (an m16 tile) and takes 16-column sub-blocks of a stage in the
// FlashAttention-2 pattern, with its own (l, acc):
//   S = Q · K^T by mma.sync m16n8k16 (bf16 in, f32 accumulate), the int8
//   scale after the dot, softcap, mask; the row max of the stage, by quad
//   shuffles and, where several warps share rows, through shared memory;
//   p = exp(s - m) (l sums the unrounded p); the PV weights bf16(p), or
//   bf16(p · vs) for int8, packed straight into the A fragments of
//   acc += P · V, a second m16n8k16 with V as B.
// A bf16 × bf16 product is exact in f32 and an int8 value is exact in bf16,
// so the tensor cores form the same sums as the f32 CUDA-core loop did, in
// another order.  The running max m moves once a stage and is the same in
// every warp that shares the rows, so each bf16(p) is rounded against the
// max of the columns up to its stage; after the last stage those warps add
// their (l, acc) in shared memory (f32, in warp order).
//
// The storage head dim D is a template parameter: 128 (head dims up to 128,
// lane-padded) or 256 (head dims 129-256: Gemma's 256).  At D = 256 a K or
// V row is 512 bytes of bf16 (272 with padding at int8), so a bf16 stage
// holds 64 columns (two such stages and the merge area fit the 227 KB of a
// block; an int8 stage keeps 128), and the accumulator a warp holds doubles
// to D/8 n-tiles (128 f32 a thread): the D = 256 forms run one block an SM.
//
// Fragment layouts.  The dot over the head dim may take its dims in any
// order, as long as A (q) and B (K) agree: k-step s gives lane (gid, tig)
// dims 16s + 4·tig .. + 3, so a lane reads one word (int8) or 8 bytes
// (bf16) of a K row per step.  PV's B fragment pairs two V rows at one dim;
// the output dims are permuted so that lane gid of n-tile 4q + i holds dim
// 32q + 4·gid + i, and a lane reads one word (int8) or 8 bytes (bf16) of a V
// row for four n-tiles.  The accumulator's C fragment then gives lane tig
// the 8 contiguous dims 32q + 8·tig .. + 7 of its rows.  Row strides in
// shared memory are padded so that these reads hit 32 distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_ops.cuh"
#include "cp_async.cuh"
#include "i8t_tile.cuh"  // mma_bf16, pack_bf16x2

namespace attn {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 16;           // columns per warp step
constexpr float kNeg = -1e30f;
constexpr int kMaxRows = 128;       // query rows of a block (8 m16 tiles) at D = 128
constexpr int kMaxSplits = 128;     // decode: slices of a (slot, kv head)

template <int D>
constexpr int kAccStride = D + 4;  // f32 per row of the merge buffer
template <int D>
constexpr int kRowsOf = D > 128 ? 64 : kMaxRows;  // prefill: query rows of a block

// One stage in shared memory: kCols K rows, kCols V rows (bytes per row
// padded), and for an int8 cache the kCols k and v scales.
template <bool I8, int D>
struct Tile {
  static_assert(D == 128 || D == 256, "the storage widths ported: 128 and 256 lanes");
  static constexpr int kCols = !I8 && D > 128 ? 64 : 128;  // cache columns per stage
  static constexpr int kSubs = kCols / kSub;
  static constexpr int kRow = I8 ? D + 16 : 2 * D + 32;
  static constexpr int vRow = I8 ? D + 16 : 2 * D + 16;
  static constexpr int kOff = 0;
  static constexpr int vOff = kCols * kRow;
  static constexpr int ksOff = vOff + kCols * vRow;
  static constexpr int vsOff = ksOff + (I8 ? kCols * 4 : 0);
  static constexpr int bytes = vsOff + (I8 ? kCols * 4 : 0);
};

// The merge area, which reuses the ring once the stages are done: each
// warp's 16 rows of acc, m and l; per block row the merged M and L; the
// decode's factors of its slices (the prefill ends its area at `fac`).
template <int D>
struct Merge {
  static constexpr int acc = 0;
  static constexpr int m = acc + kWarps * 16 * kAccStride<D> * 4;
  static constexpr int l = m + kWarps * 16 * 4;
  static constexpr int rowM = l + kWarps * 16 * 4;
  static constexpr int rowL = rowM + kMaxRows * 4;
  static constexpr int fac = rowL + kMaxRows * 4;
  static constexpr int bytes = fac + kMaxSplits * 16 * 4;
};

using cpasync::cp_async16;
using cpasync::cp_async4;
using cpasync::cp_commit;
using cpasync::cp_wait;

// four int8 (one word, byte 0 first) as exact f32: (x + 128) placed in the
// mantissa of 2^23, then 2^23 + 128 taken off
__device__ __forceinline__ void i8x4_f32(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
}

// two f32 holding small integers (|x| <= 128: 8 significant bits) as bf16x2,
// lo in the low half; the bf16 is the f32's upper half, exactly
__device__ __forceinline__ uint32_t int_bf16x2(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Issue the copies of one stage: columns c0 .. c0 + kCols - 1 of the range,
// those below `end` live (the rest zero-filled); rowof(c) is column c's row
// in the layer's K/V rows of D values and in its scale planes.
template <bool I8, int D, typename RowOf>
__device__ __forceinline__ void load_stage(uint8_t* st, const void* k, const void* v,
                                           const float* ks, const float* vs, int c0, int end,
                                           RowOf rowof) {
  using T = Tile<I8, D>;
  constexpr int kCols = T::kCols;
  constexpr int kRowBytes = I8 ? D : 2 * D;
  constexpr int kVec = kRowBytes / 16;  // 16-byte vectors per row
  constexpr int kIters = kCols * kVec / kThreads;
  static_assert(kCols * kVec % kThreads == 0 && (!I8 || 2 * kCols == kThreads),
                "whole copies a thread; an int8 stage's scales one a thread");
  const uint8_t* kb = static_cast<const uint8_t*>(k);
  const uint8_t* vb = static_cast<const uint8_t*>(v);
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int j = i / kVec, e = i % kVec;
    const bool live = c0 + j < end;
    const size_t off = (live ? rowof(c0 + j) : 0) * kRowBytes + e * 16;
    cp_async16(st + T::kOff + j * T::kRow + e * 16, kb + off, live);
    cp_async16(st + T::vOff + j * T::vRow + e * 16, vb + off, live);
  }
  if constexpr (I8) {  // 256 threads: k scales, then v scales
    const int j = threadIdx.x % kCols;
    const bool live = c0 + j < end;
    const size_t r = live ? rowof(c0 + j) : 0;
    if (threadIdx.x < kCols) cp_async4(st + T::ksOff + 4 * j, ks + r, live);
    else cp_async4(st + T::vsOff + 4 * j, vs + r, live);
  }
}

// q rows in shared memory: bf16, kQRow bytes a row (padded: the A
// fragments' 8-byte reads hit 32 distinct banks).  load_q issues the copy
// of row r from src(r) for rows [0, rows); a null src(r) is a zero row (its
// copy reads nothing; `any` is some valid address for it).
template <int D>
constexpr int kQRow = 2 * D + 32;

template <int D, typename Src>
__device__ __forceinline__ void load_q(uint8_t* qs, int rows, const uint16_t* any, Src src) {
  for (int i = threadIdx.x; i < rows * (D / 8); i += kThreads) {
    const int r = i / (D / 8), e = i % (D / 8);
    const uint16_t* row = src(r);
    cp_async16(qs + r * kQRow<D> + e * 16, row != nullptr ? row + e * 8 : any, row != nullptr);
  }
}

// A stage in two phases, so that every column of a stage is weighed
// against one running max, whatever warp takes it (as the chunked kernels
// before this one did, and as the plain version does within a stage).  The
// warp takes NSB sub-blocks of the stage, first, first + step, ...; those
// whose first column is at or past `ncols` (the columns of the range from
// the stage's first on) or past the stage's kCols are skipped: at 64
// columns a stage (bf16, 256 lanes) the decode's warps 4-7 take none.  Lane (gid, tig) holds rows gid (h = 0) and
// gid + 8 (h = 1); valid(h, j) says whether stage column j is live for row
// h.
//
// Phase 1: the scores s = (q · k) (· ks), softcapped and masked (kNeg), and
// their row maxima over the warp's sub-blocks (quad-reduced).
template <bool I8, int D, int NSB, typename Valid>
__device__ __forceinline__ void stage_scores(const uint8_t* st, int first, int step, int ncols,
                                             const uint8_t* qs, float softcap, Valid valid,
                                             float (&s)[NSB][2][4], float (&mx)[2]) {
  using T = Tile<I8, D>;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const float* kss = reinterpret_cast<const float*>(st + T::ksOff);
  if (ncols > T::kCols) ncols = T::kCols;  // the stage's columns, not the range's
  // qs: the warp's 16 rows; row gid's and gid + 8's dims of k-step ks
  const uint8_t* q0 = qs + gid * kQRow<D> + 8 * tig;
  const uint8_t* q1 = q0 + 8 * kQRow<D>;
  mx[0] = mx[1] = kNeg;
#pragma unroll
  for (int i = 0; i < NSB; ++i) {
    const int j0 = (first + i * step) * kSub;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][nt][e] = kNeg;
    if (j0 >= ncols) continue;
    float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint2 x0 = *reinterpret_cast<const uint2*>(q0 + 32 * ks);
      const uint2 x1 = *reinterpret_cast<const uint2*>(q1 + 32 * ks);
      const uint32_t a[4] = {x0.x, x1.x, x0.y, x1.y};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const uint8_t* kr = st + T::kOff + (j0 + 8 * nt + gid) * T::kRow;
        uint32_t b0, b1;
        if constexpr (I8) {
          float f[4];
          i8x4_f32(*reinterpret_cast<const uint32_t*>(kr + 16 * ks + 4 * tig), f);
          b0 = int_bf16x2(f[0], f[1]);
          b1 = int_bf16x2(f[2], f[3]);
        } else {
          const uint2 w = *reinterpret_cast<const uint2*>(kr + 2 * (16 * ks + 4 * tig));
          b0 = w.x;
          b1 = w.y;
        }
        i8t::mma_bf16(c[nt], a, b0, b1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + 8 * nt + 2 * tig + (e & 1), h = e >> 1;
        float x = c[nt][e];
        if constexpr (I8) x = __fmul_rn(x, kss[j]);
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        x = valid(h, j) ? x : kNeg;
        s[i][nt][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
}

// Phase 2, given the stage's row maxima mx over every warp that shares the
// rows: m = max(m, mx), l and acc rescaled, p = exp(s - m) (l sums it), the
// PV weights bf16(p) or bf16(p · vs) packed into A fragments, acc += P · V.
template <bool I8, int D, int NSB>
__device__ __forceinline__ void stage_pv(const uint8_t* st, int first, int step, int ncols,
                                         const float (&s)[NSB][2][4], const float (&mx)[2],
                                         float (&acc)[D / 8][4], float (&m)[2], float (&l)[2]) {
  using T = Tile<I8, D>;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const float* vss = reinterpret_cast<const float*>(st + T::vsOff);
  if (ncols > T::kCols) ncols = T::kCols;
  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = fmaxf(m[h], mx[h]);
    alpha[h] = expf(m[h] - m_new);
    m[h] = m_new;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[n][0] *= alpha[0];
    acc[n][1] *= alpha[0];
    acc[n][2] *= alpha[1];
    acc[n][3] *= alpha[1];
  }
#pragma unroll
  for (int i = 0; i < NSB; ++i) {
    const int j0 = (first + i * step) * kSub;
    if (j0 >= ncols) continue;
    float w[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + 8 * nt + 2 * tig + (e & 1), h = e >> 1;
        const float p = s[i][nt][e] > 0.5f * kNeg ? expf(s[i][nt][e] - m[h]) : 0.f;
        l[h] += p;
        w[nt][e] = I8 ? __fmul_rn(p, vss[j]) : p;
      }
    const uint32_t pa[4] = {i8t::pack_bf16x2(w[0][0], w[0][1]), i8t::pack_bf16x2(w[0][2], w[0][3]),
                            i8t::pack_bf16x2(w[1][0], w[1][1]), i8t::pack_bf16x2(w[1][2], w[1][3])};
    // V rows j0 + 2·tig + {0, 1, 8, 9}: the B fragments' column pairs
    const uint8_t* vr = st + T::vOff + (j0 + 2 * tig) * T::vRow;
#pragma unroll
    for (int q = 0; q < D / 32; ++q) {
      if constexpr (I8) {
        float f[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          i8x4_f32(*reinterpret_cast<const uint32_t*>(vr + ((r & 1) + 8 * (r >> 1)) * T::vRow
                                                      + 32 * q + 4 * gid), f[r]);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          i8t::mma_bf16(acc[4 * q + k], pa, int_bf16x2(f[0][k], f[1][k]), int_bf16x2(f[2][k], f[3][k]));
      } else {
        uint2 x[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          x[r] = *reinterpret_cast<const uint2*>(vr + ((r & 1) + 8 * (r >> 1)) * T::vRow
                                                 + 2 * (32 * q + 4 * gid));
        i8t::mma_bf16(acc[4 * q + 0], pa, __byte_perm(x[0].x, x[1].x, 0x5410),
                 __byte_perm(x[2].x, x[3].x, 0x5410));
        i8t::mma_bf16(acc[4 * q + 1], pa, __byte_perm(x[0].x, x[1].x, 0x7632),
                 __byte_perm(x[2].x, x[3].x, 0x7632));
        i8t::mma_bf16(acc[4 * q + 2], pa, __byte_perm(x[0].y, x[1].y, 0x5410),
                 __byte_perm(x[2].y, x[3].y, 0x5410));
        i8t::mma_bf16(acc[4 * q + 3], pa, __byte_perm(x[0].y, x[1].y, 0x7632),
                 __byte_perm(x[2].y, x[3].y, 0x7632));
      }
    }
  }
}

// The stage's row maxima over the CS warps that share rows (tile t: warps
// t·CS .. t·CS + CS - 1), through xm [kWarps][16] in shared memory.  Every
// thread of the block calls it (it holds a barrier); the caller's next
// barrier, before xm is written again, ends the reads.
template <int CS>
__device__ __forceinline__ void stage_max(float* xm, float (&mx)[2]) {
  if constexpr (CS > 1) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gid = lane >> 2;
    if ((lane & 3) == 0) {
      xm[warp * 16 + gid] = mx[0];
      xm[warp * 16 + gid + 8] = mx[1];
    }
    __syncthreads();
    const int w0 = warp / CS * CS;
#pragma unroll
    for (int c = 0; c < CS; ++c) {
      mx[0] = fmaxf(mx[0], xm[(w0 + c) * 16 + gid]);
      mx[1] = fmaxf(mx[1], xm[(w0 + c) * 16 + gid + 8]);
    }
  }
}

// A warp's running state → the merge area (l summed over the quad first),
// its first `rows` rows (the decode's G heads; the rest are zero q rows).
template <int D>
__device__ __forceinline__ void state_out(uint8_t* sm, const float (&acc)[D / 8][4],
                                          const float (&m)[2], float (&l)[2], int rows) {
  using Mg = Merge<D>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gid = lane >> 2, tig = lane & 3;
  float* A = reinterpret_cast<float*>(sm + Mg::acc) + warp * 16 * kAccStride<D>;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (gid + 8 * h >= rows) continue;
    float* row = A + (gid + 8 * h) * kAccStride<D>;
#pragma unroll
    for (int q = 0; q < D / 32; ++q) {
      *reinterpret_cast<float4*>(row + 32 * q + 8 * tig) =
          make_float4(acc[4 * q][2 * h], acc[4 * q + 1][2 * h], acc[4 * q + 2][2 * h],
                      acc[4 * q + 3][2 * h]);
      *reinterpret_cast<float4*>(row + 32 * q + 8 * tig + 4) =
          make_float4(acc[4 * q][2 * h + 1], acc[4 * q + 1][2 * h + 1], acc[4 * q + 2][2 * h + 1],
                      acc[4 * q + 3][2 * h + 1]);
    }
    if (tig == 0) {
      reinterpret_cast<float*>(sm + Mg::m)[warp * 16 + gid + 8 * h] = m[h];
      reinterpret_cast<float*>(sm + Mg::l)[warp * 16 + gid + 8 * h] = l[h];
    }
  }
}

// Merge the states of the warps that share rows: m16 tile t is held by
// warps t·cs .. t·cs + cs - 1, merged in that order into warp t·cs's buffer
// rows; block row r = 16t + i (r < rows) gets its M and L in rowM[r],
// rowL[r].  Call after state_out and a barrier; ends with a barrier.
template <int D>
__device__ __forceinline__ void merge_warps(uint8_t* sm, int rows, int cs) {
  using Mg = Merge<D>;
  constexpr int kAS = kAccStride<D>;
  float* A = reinterpret_cast<float*>(sm + Mg::acc);
  float* mb = reinterpret_cast<float*>(sm + Mg::m);
  float* lb = reinterpret_cast<float*>(sm + Mg::l);
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const int w0 = (r / 16) * cs, i = r % 16;
    float M = kNeg;
    for (int c = 0; c < cs; ++c) M = fmaxf(M, mb[(w0 + c) * 16 + i]);
    float L = 0.f;
    for (int c = 0; c < cs; ++c) {
      const float f = expf(mb[(w0 + c) * 16 + i] - M);
      L += f * lb[(w0 + c) * 16 + i];
      mb[(w0 + c) * 16 + i] = f;  // now the warp's factor
    }
    reinterpret_cast<float*>(sm + Mg::rowM)[r] = M;
    reinterpret_cast<float*>(sm + Mg::rowL)[r] = L;
  }
  __syncthreads();
  if (cs == 1) return;  // one warp a tile: its factor is exp(0) = 1
  for (int e = threadIdx.x; e < rows * (D / 4); e += kThreads) {
    const int r = e / (D / 4), d = (e % (D / 4)) * 4;
    const int w0 = (r / 16) * cs, i = r % 16;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < cs; ++c) {
      const float f = mb[(w0 + c) * 16 + i];
      const float4 x = *reinterpret_cast<const float4*>(A + ((w0 + c) * 16 + i) * kAS + d);
      a.x += f * x.x;
      a.y += f * x.y;
      a.z += f * x.z;
      a.w += f * x.w;
    }
    *reinterpret_cast<float4*>(A + (w0 * 16 + i) * kAS + d) = a;
  }
  __syncthreads();
}

// the merged acc of block row r (tile t = r / 16 held by warp t·cs)
template <int D>
__device__ __forceinline__ float* merged_row(uint8_t* sm, int r, int cs) {
  return reinterpret_cast<float*>(sm + Merge<D>::acc)
         + ((r / 16) * cs * 16 + r % 16) * kAccStride<D>;
}

}  // namespace attn
