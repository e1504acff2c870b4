// The int8 lane-major matmul without a tile table: the Q8_0 and Q5_1 downs
// of llama.cpp's Q6_K and Q5_K_S mixes, whose (ff/32) % 8 != 0 keeps them
// lane-major in both packages (pallas_qmm.py:1320, :1338).
//
// Replaces the Pallas kernel booster_tpu/ops/pallas_qmm.py _qmm_i8_kernel
// (:135, via _qmm_i8 :265; has_mins :153-154) where qmm_lane.cu's
// lane_kernel<false, BM, MINS> ran it before: a matvec for few rows
// (lane_mv_kernel, M <= 32 by construction) and a wgmma tile above
// (lane_mm_kernel); ops/qmm.py lane_i8_plan picks the form by M.  The
// grouped form (a tile table) and the i4p forms stay on qmm_lane.cu.
//
// y[m, n] = sum_k x[m, k] · w[n, k] over an int8 payload q [R, K] whose row
// n holds every k of output column n, scale planes s [R, P, K/G] bf16 (P =
// 1, or 2 with the mins after the scales: Q5_K's dmin·mn, Q5_1's -m):
// w = bf16(f32(bf16 q) · f32(bf16 s)) (one rounding of the exact product),
// with mins w = bf16(w - bf16 m); y = bf16(x) @ w^T in f32.  The reference's
// function up to the order of the f32 sums.
//
// What bounds it on the H100.  At M <= 64 the payload and scale bytes (1.06
// byte a weight, 1.13 with mins) over 3.35 TB/s: 3.6-3.9 µs for the 1.3B
// down (2048 x 5504).  At M = 2048 the bf16 operations: 46.7 µs there.
// The kernel it replaces dequantized each 64-column stage into a bf16 tile
// in shared memory between two barriers, then ran mma.sync over it: the
// tensor cores idled through every dequantization, and at one row 31 of its
// 32 rows a block were zeros, 16 tiles split K 10 ways with f32 partials.
//
// lane_mv_kernel<MT, MINS> (M <= 8·MT, MT 1, 2 or 4): a block of 8 warps
// owns 16 payload rows, read whole; warp w takes the 64-k chunks w, w + 8,
// ... of all of K (no K split, no partials: at N = 2048 the rows alone give
// 128 blocks).  A lane copies, per chunk, 16 bytes of each of its two rows
// (g = lane / 4 and g + 8, k 64c + 16t .. + 15, t = lane % 4) and x at the
// same k for the rows g + 8j < M, with cp.async into a ring of kMvRing
// chunks of its own in shared memory (each lane reads only what it copied:
// no barrier in the stream); the block's 16 rows of scale planes are one
// contiguous run, copied once in 16-byte pieces before the stream (4-byte
// copies of each chunk's scale words cost a sixth of the kernel's time).
// Each chunk is 4 mma.sync steps per m8 tile of x, A the dequantized rows
// in registers (qring::dq_bytes, then sub_min), B x: no zero rows beyond
// the 8 of an m8 tile, no dequantized tile in shared memory.  The k order:
// a lane's 4 bytes 4s .. 4s + 3 feed A slots 2t, 2t + 1 (bytes 0, 1) and
// 2t + 8, 2t + 9 (bytes 2, 3) of step s, so slot 2t + e holds k 64c + 16t +
// 4s + e and slot 2t + 8 + e k 64c + 16t + 4s + 2 + e; x, the B operand,
// comes from the same lane's copy in the same order, so every product is
// bf16(x[k])·w[k] and a 16-k piece lies in one group (G is a multiple of
// 16): only the order of the f32 sums moves.  The block adds its warps'
// sums in order (booster_tpu_torch/testing.py qmm_lane_mv_split mirrors
// it).
//
// lane_mm_kernel<BM, MINS> (any M): computes the product transposed, y^T =
// W x^T, as i8k_tile.cuh does for the K-major weights: a block of two
// warpgroups owns 128 payload rows (64 a warpgroup: wgmma's m64) by BM rows
// of x (wgmma's N) and one split of K, walked in stages of 64 k.  A ring of
// kRing stages is filled with 16-byte cp.async copies, as i8k_tile.cuh's:
// the block's BM rows of x, each 128-byte row in the swizzle of wgmma's B
// descriptor, the stage's 128 x 64 payload bytes (a row's 16-byte chunks
// swizzled so that a warp's reads hit distinct banks) and the words holding
// its scales (and mins).  (A TMA tile copy would take the payload through a
// tensor map per weight; not done.)  A thread's A fragment of a k16 step,
// bytes 2t, 2t + 1 and 2t + 8, 2t + 9 of a row's 16-byte chunk, comes from
// two 32-bit shared loads and a byte permute, then is dequantized in
// registers; wgmma.mma_async m64nBMk16 reads x through the descriptor.  One
// barrier a stage: the next stage is dequantized into a second set of A
// registers while the issued wgmma runs, and waited for before its own
// issue (i8k_tile.cuh's note: ptxas serializes every wgmma, warning C7513,
// if A registers written during an in-flight wgmma feed the next one).  The
// mins stay elementwise in the dequantization, overlapped with the product.
// At KS splits (at most 8, ops/qmm.py lane_i8_plan) a tile's splits form one
// thread-block cluster and add in split order through distributed shared
// memory (i8k::ClusterTiles); testing.py qmm_lane_mm_split mirrors it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "i8k_tile.cuh"  // wgmma_rs, desc, fence_regs, ClusterTiles, launch_split
#include "qmm_ring.cuh"  // dq_bytes, sub_min, allow_smem

namespace {

constexpr int kThreads = 256;  // lane_mm_kernel's two warpgroups
constexpr int kMvRows = 16;    // payload rows of a matvec block
constexpr int kBK = 64;        // k of a matvec chunk and of a tile stage
constexpr int kBN = 128;       // payload rows of a tile

struct Params {
  const uint16_t* x;  // [M, K] bf16
  const uint8_t* q;   // [R, K] int8
  const uint16_t* s;  // [R, P, K/G] bf16: the scales, then (P = 2) the mins
  float* out;         // [M, N] f32
  int M, K, N, G;
  int gshift;         // log2 G where G is a power of 2, else -1
};

__device__ __forceinline__ int gdiv(const Params& p, int k) {
  return p.gshift >= 0 ? k >> p.gshift : k / p.G;
}

// -- the matvec ----------------------------------------------------------------

constexpr int kMvWarps = 8;      // warps of a matvec block
constexpr int kMvMaxK = 16384;   // K up to which the block's scale planes fit beside its ring

// chunks of a warp's ring (96-120 KB of shared memory a block, beside the
// block's scale planes: 11 KB at the 1.3B down with mins, 64 KB at most)
template <int MT>
constexpr int kMvRing = MT == 4 ? 3 : MT == 2 ? 5 : 6;

// A warp's chunk in shared memory: the two payload pieces of each lane
// ([2][32 lanes][16 bytes]) and x of its m8 tiles ([MT][32 lanes][32 bytes]).
template <int MT>
struct MvChunk {
  static constexpr int kQ = 0, kX = 1024;
  static constexpr int kBytes = kX + 1024 * MT;
  static constexpr int kRing = kMvWarps * kMvRing<MT> * kBytes;
};

// The block's 16 rows of scale planes, [16][P][K/G] bf16 contiguous in s
// from element e0 = n0·P·K/G, copied in 16-byte pieces from e0's address
// rounded down to 16 bytes (the last piece ends within the 16 bytes that
// hold the rows' last element): element e of the rows lies at halfword e + d.
struct MvScales {
  const uint8_t* src;  // e0's address rounded down to 16 bytes
  int d;               // halfwords from there to e0
  int bytes;           // the copy, whole 16-byte pieces
  __device__ __forceinline__ MvScales(const Params& p, int n0, int P) {
    const size_t row = static_cast<size_t>(P) * (p.K / p.G);
    const uintptr_t a = reinterpret_cast<uintptr_t>(p.s + n0 * row);
    src = reinterpret_cast<const uint8_t*>(a & ~static_cast<uintptr_t>(15));
    d = static_cast<int>((a & 15) >> 1);
    bytes = (2 * (d + kMvRows * static_cast<int>(row)) + 15) & ~15;
  }
};

template <int MT>
__device__ __forceinline__ void mv_load(const Params& p, uint8_t* st, int n0, int c) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int k0 = c * kBK + 16 * t;
#pragma unroll
  for (int h = 0; h < 2; ++h)
    cpasync::cp_async16(st + MvChunk<MT>::kQ + h * 512 + lane * 16,
                        p.q + static_cast<size_t>(n0 + g + 8 * h) * p.K + k0, true);
#pragma unroll
  for (int j = 0; j < MT; ++j)
    if (g + 8 * j < p.M) {
      const uint16_t* src = p.x + static_cast<size_t>(g + 8 * j) * p.K + k0;
      uint8_t* dst = st + MvChunk<MT>::kX + j * 1024 + lane * 32;
      cpasync::cp_async16(dst, src, true);
      cpasync::cp_async16(dst + 16, src + 8, true);
    }
}

// The chunk's 4 k16 steps into acc (acc[j]: the m16n8 tile of the warp's 16
// rows by x rows 8j .. 8j + 7); sc: the block's scale planes, hs[h] the
// halfword of row g + 8h's first scale there.
template <int MT, bool MINS>
__device__ __forceinline__ void mv_use(const Params& p, const uint8_t* st, int c,
                                       const uint16_t* sc, const int (&hs)[2], int kg,
                                       float (&acc)[MT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int gi = gdiv(p, c * kBK + 16 * t);
  const uint4 qg = *reinterpret_cast<const uint4*>(st + MvChunk<MT>::kQ + lane * 16);
  const uint4 q8 = *reinterpret_cast<const uint4*>(st + MvChunk<MT>::kQ + 512 + lane * 16);
  const uint32_t sg = sc[hs[0] + gi] * 0x10001u, s8 = sc[hs[1] + gi] * 0x10001u;
  uint32_t mg = 0u, m8 = 0u;
  if constexpr (MINS) {  // a row's mins follow its scales
    mg = sc[hs[0] + kg + gi] * 0x10001u;
    m8 = sc[hs[1] + kg + gi] * 0x10001u;
  }
  uint4 xv[MT][2];
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    if (g + 8 * j < p.M) {
      const uint4* xs = reinterpret_cast<const uint4*>(st + MvChunk<MT>::kX + j * 1024 + lane * 32);
      xv[j][0] = xs[0];
      xv[j][1] = xs[1];
    } else {
      xv[j][0] = xv[j][1] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  const uint32_t wg[4] = {qg.x, qg.y, qg.z, qg.w}, w8[4] = {q8.x, q8.y, q8.z, q8.w};
#pragma unroll
  for (int s = 0; s < 4; ++s) {  // step s: bytes 4s .. 4s + 3 of each piece
    uint32_t a[4] = {qring::dq_bytes(wg[s], sg), qring::dq_bytes(w8[s], s8),
                     qring::dq_bytes(wg[s] >> 16, sg), qring::dq_bytes(w8[s] >> 16, s8)};
    if constexpr (MINS) {
      a[0] = qring::sub_min(a[0], mg);
      a[1] = qring::sub_min(a[1], m8);
      a[2] = qring::sub_min(a[2], mg);
      a[3] = qring::sub_min(a[3], m8);
    }
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const uint4 v = xv[j][s >> 1];
      const uint32_t b0 = s & 1 ? v.z : v.x, b1 = s & 1 ? v.w : v.y;  // words 2s, 2s + 1
      i8t::mma_bf16(acc[j], a, b0, b1);
    }
  }
}

template <int MT, bool MINS>
__global__ void __launch_bounds__(32 * kMvWarps, 1) lane_mv_kernel(Params p) {
  constexpr int D = kMvRing<MT>;
  constexpr int P = MINS ? 2 : 1;
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kMvRows;
  const int kg = p.K / p.G;
  const MvScales ms(p, n0, P);
  uint8_t* ring = smem + w * D * MvChunk<MT>::kBytes;
  uint8_t* sbuf = smem + MvChunk<MT>::kRing;
  // the block's scale planes first (group 0), then the ring's first chunks
  for (int o = 16 * threadIdx.x; o < ms.bytes; o += 16 * 32 * kMvWarps)
    cpasync::cp_async16(sbuf + o, ms.src + o, true);
  cpasync::cp_commit();
  const int nc = p.K / kBK;
  const int nw = nc > w ? (nc - w + kMvWarps - 1) / kMvWarps : 0;  // this warp's chunks
  float acc[MT][4];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int i = 0; i < D - 1; ++i) {
    if (i < nw) mv_load<MT>(p, ring + i * MvChunk<MT>::kBytes, n0, w + i * kMvWarps);
    cpasync::cp_commit();
  }
  cpasync::cp_wait<D - 1>();  // this thread's pieces of the scale planes are in
  __syncthreads();            // and every thread's
  const uint16_t* sc = reinterpret_cast<const uint16_t*>(sbuf);
  const int hs[2] = {ms.d + g * P * kg, ms.d + (g + 8) * P * kg};
  for (int i = 0; i < nw; ++i) {
    cpasync::cp_wait<D - 2>();  // this lane's copies of chunk i are in
    mv_use<MT, MINS>(p, ring + (i % D) * MvChunk<MT>::kBytes, w + i * kMvWarps, sc, hs, kg, acc);
    __syncwarp();
    if (i + D - 1 < nw)  // into the slot chunk i - 1 left
      mv_load<MT>(p, ring + ((i + D - 1) % D) * MvChunk<MT>::kBytes, n0,
                  w + (i + D - 1) * kMvWarps);
    cpasync::cp_commit();
  }
  cpasync::cp_wait<0>();
  __syncthreads();  // every warp is done with its ring: the sums go over it
  // red[w][r][m]: warp w's sum of payload row r (of 16) against x row m
  float* red = reinterpret_cast<float*>(smem);
  constexpr int RM = 8 * MT;
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)  // D rows g, g + 8; columns (x rows) 8j + 2t, + 1
      red[(w * kMvRows + g + 8 * (e >> 1)) * RM + 8 * j + 2 * t + (e & 1)] = acc[j][e];
  __syncthreads();
  for (int i = threadIdx.x; i < p.M * kMvRows && i < RM * kMvRows; i += 32 * kMvWarps) {
    const int m = i / kMvRows, r = i % kMvRows;
    float v = 0.f;
#pragma unroll
    for (int ww = 0; ww < kMvWarps; ++ww) v = __fadd_rn(v, red[(ww * kMvRows + r) * RM + m]);
    p.out[static_cast<size_t>(m) * p.N + n0 + r] = v;
  }
}

template <int MT, bool MINS>
cudaError_t launch_mv(const Params& p, cudaStream_t st) {
  // the ring and the block's scale planes at the largest K (K/G at G = 16)
  constexpr int bytes = MvChunk<MT>::kRing + 2 * kMvRows * (MINS ? 2 : 1) * (kMvMaxK / 16) + 16;
  static bool ready = false;
  const cudaError_t e = qring::allow_smem(lane_mv_kernel<MT, MINS>, bytes, ready);
  if (e != cudaSuccess) return e;
  const int used = MvChunk<MT>::kRing + 2 * kMvRows * (MINS ? 2 : 1) * (p.K / p.G) + 16;
  lane_mv_kernel<MT, MINS><<<p.N / kMvRows, 32 * kMvWarps, used, st>>>(p);
  return cudaGetLastError();
}

// -- the tile ------------------------------------------------------------------

constexpr int kSS = 8;  // stages a batch of scale pieces covers (512 k)
constexpr int kSC = 5;  // 16-byte pieces of a row and plane in a batch: 40 halfwords, from
                        // 7 before its first element, hold the 33 elements of 512 k at G >= 16

template <int BM, bool MINS>
struct Tile {
  static_assert(BM == 32 || BM == 64 || BM == 128 || BM == 256,
                "a tile has 32, 64, 128 or 256 rows of x");
  // stages of the ring: two blocks an SM up to 128 rows, one at 256
  static constexpr int kRing = BM == 256 ? 4 : BM == 128 ? 3 : BM == 64 ? 4 : 6;
  static constexpr int kMinBlocks = BM == 256 ? 1 : 2;
  static constexpr int kXB = BM * 128;                    // x: BM rows of 64 k, swizzled
  static constexpr int kQB = kBN * kBK;                   // payload: 128 rows of 64 bytes
  static constexpr int kSlot = kXB + kQB;                 // a multiple of 1024
  static constexpr int kSB = kBN * (MINS ? 2 : 1) * kSC * 16;  // a batch's scale pieces
  static constexpr int kLdt = i8k::Cfg<BM>::kLdt;         // floats a row of the output tile
  static constexpr int kSmem = kRing * kSlot + 2 * kSB + 1024;  // + slack to align on 1 KB
  static_assert(BM * kLdt * 4 <= kRing * kSlot, "the output tile fits over the ring");
};

// Stage k .. k + 63 into a slot, by all threads, in 16-byte copies: x rows
// m0 .. m0 + BM - 1 (zeros past M), chunk c of row r at c ^ (r & 7) (the
// swizzle of wgmma's B descriptor); the payload rows n0 .. n0 + 127, chunk
// c of row r at c ^ ((r / 2) & 3).
template <int BM, bool MINS>
__device__ __forceinline__ void mm_load(const Params& p, int m0, int n0, int k, uint8_t* slot) {
  using C = Tile<BM, MINS>;
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < BM * 8 / kThreads; ++i) {  // BM rows x 8 chunks of 8 bf16
    const int u = t + i * kThreads, r = u >> 3, c = u & 7;
    const bool live = m0 + r < p.M;
    cpasync::cp_async16(slot + r * 128 + ((c ^ (r & 7)) << 4),
                        live ? p.x + static_cast<size_t>(m0 + r) * p.K + k + c * 8 : p.x, live);
  }
#pragma unroll
  for (int i = 0; i < kBN * 4 / kThreads; ++i) {  // 128 rows x 4 chunks of 16 bytes
    const int u = t + i * kThreads, r = u >> 2, c = u & 3;
    cpasync::cp_async16(slot + C::kXB + r * 64 + ((c ^ ((r >> 1) & 3)) << 4),
                        p.q + static_cast<size_t>(n0 + r) * p.K + k + c * 16, true);
  }
}

// The scale (and min) pieces of a batch of kSS stages from k, by all
// threads: row r and plane m of the tile (buf + (r·P + m)·80) from the
// 16-byte boundary at or before its element gdiv(k), kSC pieces, none past
// the planes' end.  (Per-stage 4-byte copies of the words of each row's
// scales cost a fifth of the tile's time.)
template <bool MINS>
__device__ __forceinline__ void mm_scales(const Params& p, int n0, int k, uint8_t* buf) {
  constexpr int P = MINS ? 2 : 1;
  const size_t kg = p.K / p.G;
  const uintptr_t s = reinterpret_cast<uintptr_t>(p.s);
  const uintptr_t end = s + 2 * static_cast<size_t>(p.N) * P * kg;
  const size_t j = gdiv(p, k);
  for (int u = threadIdx.x; u < kBN * P * kSC; u += kThreads) {
    const int rp = u / kSC, c = u % kSC, r = rp / P, m = rp % P;
    const uintptr_t src = ((s + 2 * ((n0 + r) * P * kg + m * kg + j)) & ~uintptr_t{15}) + 16 * c;
    if (src < end)
      cpasync::cp_async16(buf + rp * (kSC * 16) + 16 * c, reinterpret_cast<const void*>(src),
                          true);
  }
}

// Bytes 2t, 2t + 1 (bits 0-15) and 2t + 8, 2t + 9 (bits 16-31) of 16-byte
// chunk c of payload row r of a slot: the A fragment's k of lane t = l % 4
// at k16 step c, from the two words that hold them.
__device__ __forceinline__ uint32_t a_bytes(const uint8_t* q, int r, int c, int t) {
  const uint8_t* b = q + r * 64 + ((c ^ ((r >> 1) & 3)) << 4) + ((t >> 1) << 2);
  const uint32_t lo = *reinterpret_cast<const uint32_t*>(b);
  const uint32_t hi = *reinterpret_cast<const uint32_t*>(b + 8);
  return __byte_perm(lo, hi, t & 1 ? 0x7632 : 0x5410);
}

// bf16 pair (hi, lo) of two f32, each rounded to nearest even.
__device__ __forceinline__ uint32_t bf16x2_rn(float hi, float lo) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// Four int8 payload bytes w → the bf16 pairs bf16(q·s) of bytes 0, 1 (lo)
// and 2, 3 (hi): a byte permute makes each byte of w ^ 0x80808080 the f32
// 2^23 + 128 + q, one subtraction leaves q exactly, the product with the
// f32 of the bf16 scale is exact (8 by 8 significant bits), and the pair
// conversion rounds it once: the reference's bf16 multiply (fewer
// instructions than qring::dq_bytes's nibble split, which the tile's
// dequantization, its critical path, pays for every stage).
__device__ __forceinline__ void dq_word(uint32_t w, float s, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __fmul_rn(__fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u | j)),
                               8388736.f), s);
  lo = bf16x2_rn(f[1], f[0]);
  hi = bf16x2_rn(f[3], f[2]);
}

// acc = the transposed 128 x BM tile (payload rows n0 .., x rows m0 ..) over
// k in [kb, ke), from zero: thread t (warp w, lane l) holds, for i < BM / 2,
// payload row 16·w + l / 4 + 8·((i / 2) % 2) (of the tile's 128) and x row
// 8·(i / 4) + 2·(l % 4) + i % 2 (wgmma's accumulator layout).
template <int BM, bool MINS>
__device__ __forceinline__ void mm_sum(const Params& p, int m0, int n0, int kb, int ke,
                                       uint8_t* sm, float (&acc)[BM / 2]) {
  using C = Tile<BM, MINS>;
  constexpr int S = C::kRing;
  const int n = (ke - kb) / kBK;
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31, g = l >> 2;
  const int r0 = 16 * warp;  // the warp's 16 payload rows of the tile
  constexpr int P = MINS ? 2 : 1;
  const size_t kg = p.K / p.G;
  uint8_t* sbuf = sm + S * C::kSlot;  // two batches of scale pieces
  // the halfword position (mod 8) of the first element of rows r0 + g, r0 + g + 8
  const size_t e0 = (reinterpret_cast<uintptr_t>(p.s) >> 1) + (n0 + r0 + g) * P * kg;
  const size_t e8 = e0 + 8 * P * kg;
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
  if (n > 0) mm_scales<MINS>(p, n0, kb, sbuf);  // the first batch, with stage 0
#pragma unroll
  for (int i = 0; i < S - 2; ++i) {
    if (i < n) mm_load<BM, MINS>(p, m0, n0, kb + i * kBK, sm + i * C::kSlot);
    cpasync::cp_commit();
  }
  // Stage i's A fragments into a (while stage i - 1's wgmma runs), after its
  // data is in and the slot of stage i - 2 is refilled (and, at a batch's
  // first stage, the next batch's scale pieces are on their way).
  auto prepare = [&](int i, uint32_t (&a)[4][4]) {
    cpasync::cp_wait<S - 3>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // x for wgmma
    __syncthreads();  // stage i is in; every wgmma of stage i - 2 is done
    if (i + S - 2 < n)  // into the slot of stage i - 2
      mm_load<BM, MINS>(p, m0, n0, kb + (i + S - 2) * kBK, sm + ((i + S - 2) % S) * C::kSlot);
    if (i % kSS == 0 && i + kSS < n)  // into the buffer the last batch left
      mm_scales<MINS>(p, n0, kb + (i + kSS) * kBK, sbuf + ((i / kSS + 1) & 1) * C::kSB);
    cpasync::cp_commit();
    const uint8_t* slot = sm + (i % S) * C::kSlot;
    const int k = kb + i * kBK;
    const size_t jb = gdiv(p, kb + (i & ~(kSS - 1)) * kBK);  // the batch's first group
    const uint16_t* hb = reinterpret_cast<const uint16_t*>(sbuf + ((i / kSS) & 1) * C::kSB);
    const uint16_t* hg = hb + (r0 + g) * P * kSC * 8 + ((e0 + jb) & 7);
    const uint16_t* h8 = hb + (r0 + g + 8) * P * kSC * 8 + ((e8 + jb) & 7);
    const uint8_t* qs = slot + C::kXB;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {  // rows r0 + g and r0 + g + 8 at k16 step kk
      const uint32_t wg = a_bytes(qs, r0 + g, kk, l & 3), w8 = a_bytes(qs, r0 + g + 8, kk, l & 3);
      const int dj = gdiv(p, k + 16 * kk) - static_cast<int>(jb);
      dq_word(wg, bf16f(hg[dj]), a[kk][0], a[kk][2]);
      dq_word(w8, bf16f(h8[dj]), a[kk][1], a[kk][3]);
      if constexpr (MINS) {  // a row's mins: the next kSC pieces, from their own boundary
        const uint32_t mg = hb[((r0 + g) * P + 1) * kSC * 8 + ((e0 + kg + jb) & 7) + dj] * 0x10001u;
        const uint32_t m8 =
            hb[((r0 + g + 8) * P + 1) * kSC * 8 + ((e8 + kg + jb) & 7) + dj] * 0x10001u;
        a[kk][0] = qring::sub_min(a[kk][0], mg);
        a[kk][1] = qring::sub_min(a[kk][1], m8);
        a[kk][2] = qring::sub_min(a[kk][2], mg);
        a[kk][3] = qring::sub_min(a[kk][3], m8);
      }
    }
  };
  // Stage i's wgmma on a; the next stage is prepared into b while it runs.
  auto step = [&](int i, uint32_t (&a)[4][4], uint32_t (&b)[4][4]) {
    const uint8_t* slot = sm + (i % S) * C::kSlot;
    uint64_t db[kBK / 16];  // x at the 4 k16 steps: +32 bytes each
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      db[kk] = i8k::desc(slot) + 2 * kk;
      asm volatile("" : "+l"(db[kk])::"memory");
    }
    i8k::fence_regs(a);
    i8k::fence_regs(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) i8k::wgmma_rs<BM>(acc, a[kk], db[kk]);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (i + 1 < n) prepare(i + 1, b);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    i8k::fence_regs(acc);
    i8k::fence_regs(a);
  };
  uint32_t a0[4][4], a1[4][4];
  if (n > 0) prepare(0, a0);
  for (int i = 0; i < n; i += 2) {
    step(i, a0, a1);
    if (i + 1 < n) step(i + 1, a1, a0);
  }
  cpasync::cp_wait<0>();
  __syncthreads();  // the ring is free for the output tile
}

template <int BM, bool MINS>
__global__ void __launch_bounds__(kThreads, Tile<BM, MINS>::kMinBlocks)
    lane_mm_kernel(Params p, int KS) {
  using C = Tile<BM, MINS>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* sm = i8k::align_1k(smem_raw);
  const int j = blockIdx.x, s = blockIdx.y, mt = blockIdx.z;
  const int n0 = j * kBN, m0 = mt * BM, rows = min(BM, p.M - m0);
  int kb, ke;
  i8k::split_range(p.K, KS, s, kb, ke);
  float acc[BM / 2];
  mm_sum<BM, MINS>(p, m0, n0, kb, ke, sm, acc);
  // the tile's sums → f32 [BM][kLdt] over the ring, row = x row, column = payload row
  float* tile = reinterpret_cast<float*>(sm);
  const int l = threadIdx.x & 31, c0 = 16 * (threadIdx.x >> 5) + (l >> 2), x0 = 2 * (l & 3);
#pragma unroll
  for (int i = 0; i < BM / 2; ++i)
    tile[(x0 + 8 * (i >> 2) + (i & 1)) * C::kLdt + c0 + 8 * ((i >> 1) & 1)] = acc[i];
  __syncthreads();
  auto put = [&](int r, int c, float4 v) {
    *reinterpret_cast<float4*>(p.out + static_cast<size_t>(m0 + r) * p.N + n0 + c) = v;
  };
  if (KS == 1) {
    for (int e = threadIdx.x; e < rows * (kBN / 4); e += kThreads) {
      const int r = e / (kBN / 4), c = e % (kBN / 4) * 4;
      const float4 v = *reinterpret_cast<const float4*>(&tile[r * C::kLdt + c]);
      put(r, c, make_float4(__fadd_rn(0.f, v.x), __fadd_rn(0.f, v.y), __fadd_rn(0.f, v.z),
                            __fadd_rn(0.f, v.w)));
    }
    return;
  }
  i8k::cluster_sync();  // every split's tile is in its block
  const i8k::ClusterTiles<BM> tiles(tile, KS);
  const int ra = s * rows / KS, nr = ((s + 1) * rows / KS - ra) * (kBN / 4);
  for (int e = threadIdx.x; e < nr; e += kThreads) {
    const int r = ra + e / (kBN / 4), c = e % (kBN / 4) * 4;
    put(r, c, tiles.sum(r, c));
  }
  i8k::cluster_sync();  // the other blocks have read this one's tile
}

template <int BM, bool MINS>
cudaError_t launch_mm(const Params& p, int ks, cudaStream_t st) {
  constexpr int bytes = Tile<BM, MINS>::kSmem;
  static bool ready = false;
  const cudaError_t e = qring::allow_smem(lane_mm_kernel<BM, MINS>, bytes, ready);
  if (e != cudaSuccess) return e;
  if (ks < 1 || ks > i8k::kMaxSplits) return cudaErrorInvalidValue;
  const dim3 grid(p.N / kBN, ks, (p.M + BM - 1) / BM);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = ks;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ks > 1 ? 1 : 0;
  const cudaError_t le = cudaLaunchKernelEx(&cfg, lane_mm_kernel<BM, MINS>, p, ks);
  return le != cudaSuccess ? le : cudaGetLastError();
}

Params params(const void* x, const void* q, const void* s, void* out, int M, int K, int N, int G) {
  return Params{static_cast<const uint16_t*>(x), static_cast<const uint8_t*>(q),
                static_cast<const uint16_t*>(s), static_cast<float*>(out), M, K, N, G,
                (G & (G - 1)) == 0 ? __builtin_ctz(static_cast<unsigned>(G)) : -1};
}

bool shape_ok(int M, int K, int N, int G) {
  return M >= 1 && N % kBN == 0 && N > 0 && K % 128 == 0 && K > 0 && G >= 16 && G % 16 == 0
         && (K / 2) % G == 0;
}

}  // namespace

// y [M, N] f32 = x [M, K] bf16 @ W^T over payload rows [0, N) of an int8
// lane-major weight (q [R, K], R >= N; scale planes [R, 1 + mins, K/G]
// bf16), by the matvec with mt m8 tiles of x (1, 2 or 4: M <= 8·mt); K at
// most 16384.  N a
// multiple of 128, K of 128, G a multiple of 16 dividing K/2; x and q on 16
// bytes.  Returns the CUDA error of the launch (0 on success).
extern "C" int bt_qmm_lane_i8_mv(const void* x, const void* q, const void* s, void* out, int M,
                                 int K, int N, int G, int mins, int mt, void* stream) {
  if (!shape_ok(M, K, N, G) || M > 8 * mt || K > kMvMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p = params(x, q, s, out, M, K, N, G);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (mt == 1) e = mins ? launch_mv<1, true>(p, st) : launch_mv<1, false>(p, st);
  else if (mt == 2) e = mins ? launch_mv<2, true>(p, st) : launch_mv<2, false>(p, st);
  else if (mt == 4) e = mins ? launch_mv<4, true>(p, st) : launch_mv<4, false>(p, st);
  return static_cast<int>(e);
}

// The same by the wgmma tile: bm rows of x a block (32, 64, 128 or 256) and ks
// splits of K on whole 64-k stages (1-8, a tile's splits one cluster;
// ops/qmm.py lane_i8_plan).
extern "C" int bt_qmm_lane_i8_mm(const void* x, const void* q, const void* s, void* out, int M,
                                 int K, int N, int G, int mins, int bm, int ks, void* stream) {
  if (!shape_ok(M, K, N, G)) return static_cast<int>(cudaErrorInvalidValue);
  const Params p = params(x, q, s, out, M, K, N, G);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (bm == 32) e = mins ? launch_mm<32, true>(p, ks, st) : launch_mm<32, false>(p, ks, st);
  else if (bm == 64) e = mins ? launch_mm<64, true>(p, ks, st) : launch_mm<64, false>(p, ks, st);
  else if (bm == 128) e = mins ? launch_mm<128, true>(p, ks, st) : launch_mm<128, false>(p, ks, st);
  else if (bm == 256) e = mins ? launch_mm<256, true>(p, ks, st) : launch_mm<256, false>(p, ks, st);
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
