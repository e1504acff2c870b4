// 4-bit K-major quantized matmul (i4t), with an optional SiLU·mul epilogue.
//
// Replaces the Pallas kernels of booster_tpu/ops/pallas_qmm.py:
//   _tqmm_i4_gd_kernel   (M = 1, group-dot form)           -> i4mv::mv_kernel<G, mins, kF32>
//   _tqmm_i4_kernel      (M > 1, dequantize then dot)      -> mm_kernel<BM, false, G>
//   _gateup_i4_gd_kernel (M = 1, fused gate+up, act·mul)   -> i4mv::mv_kernel<G, mins, kGateUp[Gelu]>
//   _gateup_i4_kernel    (M > 1, fused gate+up, act·mul)   -> mm_kernel<BM, true, G, ACT>
// at G = 32 (Q4_0: zero 8; Q4_K: mins) and G = 16 (Q2_K: mins; Q3_K: zero
// 4 and scales of either sign).  The gate-ups' act is the reference's `act`
// branch: SiLU at both groups, the tanh-GELU of gated-GELU models (Gemma)
// at G = 32; ReLU is not ported yet.
//
// y[m, n] = sum_k x[m, k] * W[n, k],  W = (q - zero) * s - mins, group G along k.
// Payload qw [K/2, N] u8: byte row r holds element r (low nibble) and element
// r + K/2 (high nibble) of every column.  Scale planes s [R, K/(2G), N] bf16:
// rows 0/1 scale the two halves, rows 2/3 (R = 4) hold their affine mins.
//
// Numerics (the plain versions in ops/qmm.py repeat them):
//   M = 1:  per half h and group g, p = sum bf16(x)·q (raw nibble, f32, in
//           row order), xs = sum f32(bf16 x), p -= zero·xs, c = f32(bf16 s)·p
//           - f32(bf16 m)·xs, each group adding c_lo + c_hi; y = sum of the
//           groups' c in i4mv.cuh's fixed order.
//   M > 1:  w = bf16(bf16(q - zero)·bf16(s)); y = sum bf16(x)·w in f32, minus
//           the min term sum_g xs_g·f32(bf16 m_g) with f32 group sums xs
//           (on the tensor cores: below).
//   gate-up: g, u = bf16 of the f32 sums of columns n and ff + n;
//           out = bf16(bf16(g·bf16(sigmoid_f32(g)))·u) (SiLU), or
//           bf16(bf16(g·0.5·(1 + tanh z))·u) with z = c·(g + 0.044715·g³)
//           op by op in f32 (GELU, bf16_ops.cuh gelu_mul) — torch's own op
//           sequences for act(x) then ·u, so the fused kernel equals qmm +
//           act + mul bit for bit.  Both forms run the same per-column
//           code with the same K split and the same reduction order.
//
// M = 1 (i4mv.cuh).  What bounds it: the payload and scale bytes (half a
// byte of payload and 1/16 byte of bf16 scale per weight at G = 32, 1/8 at
// G = 16; twice that with mins) over 3.35 TB/s.  i8mv.cuh's streaming
// block on the nibble layout: a lane streams 4 columns of a warp's groups
// (G payload rows, group g of both halves, with the group's scales)
// through a register ring of two, x in
// registers (a lane a row of both halves, shuffled to the warp), 8 warps a
// 128-column tile over one K split, a tile's KS splits one cluster that
// adds them in split order through distributed shared memory (ops/qmm.py
// i4t_mv_plan gives KS).  The fused gate-up is the same block twice over
// (gate tile j and up tile ff/128 + j, the plan of the fused [K, 2ff]
// weight), its cluster writing silu(g)·u.  No partials, no tickets.
//
// M > 1 (mm_kernel).  What bounds it: at a decode step (M = 64) still the
// bytes (MPT-7B's up, 4096 → 16384: 33.5 MB of payload and 4.2 MB of
// scales, 0.011 ms); at a 1024-row prefill the bf16 operations (0.139 ms).
// Design (qmm_ring.cuh): a block of 8 warps owns a BM x 128 output tile and
// one split of K; ops/qmm.py i4t_plan picks BM (32, 64 or 128) and the
// split from (M, K, N), about two blocks an SM.  A stage is 32 payload rows
// (32 rows of K of each half: one group at G = 32, two at G = 16), their
// R·32/G scale rows (plane-major; payload row r takes row r / G of its
// plane) and the block's 64 columns of x (32 of each half).  A ring
// of S stages (6 at BM <= 64, 3 at 128) keeps S - 2 in flight through
// cp.async while one is used (the copy into the slot the last stage left
// is issued after this stage's work, so its issue does not hold up the
// stage's unpack and products); the stage in use is unpacked from shared
// memory (qring::dq_nibbles) into the bf16 [64 k][128 n] tile, and the
// warps run 4 k16 steps of mma.sync on ldmatrix fragments (.trans for this
// [k][n] tile).  The zero point is in the unpack (qring::nibble_bias: bf16(q -
// zero) exactly for any zero below 16).
//
// Mins (R = 4: Q4_K at G = 32, Q2_K at 16; MINS below).  The min term runs
// on the tensor cores as extra rows of K: A = [hi | mid | lo] of the f32
// group sums xs, B = [-m; -m; -m] (bf16_ops.cuh split3: hi + mid + lo ==
// xs exactly and each part times a bf16 min is exact, so the term is the
// reference's f32 xs against f32(bf16 m), pallas_qmm.py:47-74, with no
// rounding of xs to bf16).  The group sums come off the x fragments the
// stage's mma steps already hold: each k16 step adds one mma of x with a
// 0/1 matrix E (column c all ones: an exact f32 sum on the tensor cores)
// into an accumulator tile of the warp's group sums, one column a group.
// A batch of 16 groups (8 stages at G = 32, 4 at 16) fills two such n8
// tiles, which are already the A fragment of a k16 step (the m16n8 C
// layout is the m16n8k16 A layout's first half); the batch's -m rows
// (negation is exact) go from each stage's scale rows to a 16-row buffer
// while it is unpacked.  At the batch's last stage (or the split's) each
// warp splits its sums into the three parts and runs three k16 steps of
// mma against that buffer into the accumulator it already holds: 3 steps
// for 32 (G = 32) or 16 (G = 16) steps of the main product, and the E
// products a quarter (BM 32, 64) or an eighth (BM 128) of the main ones.
// No CUDA-core pass over x or the accumulators, no extra barrier, no extra
// accumulator registers but the 8·MI of the sums.  (Splitting the sums
// between the two warps of a BM 128 row band, half the E products and
// registers, and swapping them through shared memory measured the same.)
//
// Splits cover whole stages; each writes f32 partials and the last block
// (ticket, reset by it) adds them in split order.  The gate-up tile holds gate columns n0 + [0, 64) and up columns
// ff + n0 + [0, 64), each warp both halves of its 16-column pairs, so g
// and u of a column meet in one thread's registers.  A column's sum is the
// same chain of mma steps as in the matmul on the fused weight (mma.sync
// computes each element from its row, its column and its accumulator), so
// the two agree bit for bit when they take one plan.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "bf16_ops.cuh"
#include "i4mv.cuh"
#include "qmm_ring.cuh"

namespace {

// ------------------------------------------------------------------ M > 1

constexpr int kSR = 32;            // payload rows of a stage (32 k of each half)
constexpr int kBN = qring::kBN;    // 128 columns of a tile
constexpr int kXS = 2 * kSR + 8;   // bf16 per x row of a stage: 32 low-half k, 32 high, pad
constexpr int kWS = kBN + 8;       // bf16 per row of the dequantized [64 k][128 n] tile

template <int BM>
constexpr int kRing = BM == 128 ? 3 : 6;  // stages of the ring

constexpr int kSlots = 16;  // groups of a batch of the min term (MINS): one k16 step a part

// A stage holds 32 rows of k of each half: one group at G = 32, two at G =
// 16, so SPG = 32 / G scale rows of each plane.
template <int BM, int G>
struct alignas(16) MmStage {
  static constexpr int SPG = kSR / G;
  uint8_t q[kSR * kBN];       // the stage's 32 payload rows
  uint16_t s[4 * SPG][kBN];   // its scale rows, plane-major: row plane·SPG + j (R planes of 4)
  uint16_t x[BM * kXS];       // the block's x at the stage's k: 32 of each half
};


template <int BM, int G, bool MINS>
struct MmSmem {
  static constexpr int SPG = kSR / G;
  using Stage = MmStage<BM, G>;
  Stage st[kRing<BM>];
  alignas(16) uint16_t w[2 * kSR * kWS];  // rows 0-31 the low half's k, 32-63 the high half's
  // MINS: -m of the batch's 16 groups as B rows, [16 k][128 n]: row 8h + T·j
  // + b holds group j of half h of the batch's stage b (T = 8 / SPG stages)
  alignas(16) uint16_t mb[MINS ? kSlots * kWS : 8];
};

struct MmParams {
  const uint16_t* x;   // [M, K] bf16
  const uint8_t* qw;   // [K/2, N]
  const uint16_t* s;   // [R, K/(2G), N] bf16
  void* out;           // [M, N] f32, or [M, N/2] bf16 for gate-up
  float* part;         // [KS, M, N] f32 partials (KS > 1), else null
  int* tickets;        // [gridDim.z · gridDim.x] zeros, reset by the last block
  int M, K, N, R, zero, KS;
};

// The payload column of tile column c (a gate-up tile: gate columns n0 +
// [0, 64), then up columns ff + n0 + [0, 64)) and whether it exists (N, or
// ff, is a multiple of 16: whole 16-column chunks).
template <bool GATEUP>
__device__ __forceinline__ int gcol(const MmParams& p, int n0, int c) {
  if constexpr (GATEUP) return c < 64 ? n0 + c : (p.N >> 1) + n0 + c - 64;
  return n0 + c;
}

template <bool GATEUP>
__device__ __forceinline__ bool gcol_live(const MmParams& p, int n0, int c) {
  if constexpr (GATEUP) return n0 + (c & 63) < (p.N >> 1);
  return n0 + c < p.N;
}

// the tile column of the first of a warp's 16-column pair j (n8 tiles 2j,
// 2j + 1); in a gate-up tile the first half of the pairs are gate columns
// and the second half the up columns of the same offsets
template <bool GATEUP, int NI>
__device__ __forceinline__ int pair_col(int wn, int j) {
  if constexpr (GATEUP) {
    constexpr int P = NI / 4;  // pairs per half
    return j < P ? wn * (NI * 4) + j * 16 : 64 + wn * (NI * 4) + (j - P) * 16;
  }
  return wn * (NI * 8) + j * 16;
}

// What a thread copies of each stage, at stage 0 (stage g adds g·32 payload
// rows, g·SPG scale rows of each plane and g·32 columns of x of each half).
template <int BM, bool GATEUP, int G>
struct MmLoad {
  static constexpr int NX = BM * 8 / qring::kThreads;  // 16-byte x chunks a thread
  static constexpr int SPG = kSR / G;
  const uint8_t* q;          // its payload chunk (null: past the last column)
  const uint16_t* s;         // its scale chunk (null: none, or past the last column)
  const uint16_t* x[NX];     // its x chunks (null: rows past M)

  __device__ __forceinline__ MmLoad(const MmParams& p, int m0, int n0) {
    const int t = threadIdx.x, half = p.K >> 1, ngh = half / G;
    {  // payload: 32 rows x 8 chunks of 16 bytes
      const int r = t >> 3, c = (t & 7) * 16;
      q = gcol_live<GATEUP>(p, n0, c)
              ? p.qw + static_cast<size_t>(r) * p.N + gcol<GATEUP>(p, n0, c) : nullptr;
    }
    {  // scale rows: R·SPG x 16 chunks of 8 bf16; stage row h is row j of plane h / SPG
      const int h = t >> 4, c = (t & 15) * 8;
      s = t < p.R * SPG * 16 && gcol_live<GATEUP>(p, n0, c)
              ? p.s + static_cast<size_t>(h / SPG * ngh + h % SPG) * p.N + gcol<GATEUP>(p, n0, c)
              : nullptr;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {  // x: BM rows x 8 chunks of 8 bf16, 4 of each half
      const int idx = t + i * qring::kThreads, row = m0 + (idx >> 3), c = idx & 7;
      x[i] = row < p.M ? p.x + static_cast<size_t>(row) * p.K + (c < 4 ? 0 : half) + (c & 3) * 8
                       : nullptr;
    }
  }
};

template <int BM, bool GATEUP, int G>
__device__ __forceinline__ void mm_load(const MmParams& p, const MmLoad<BM, GATEUP, G>& L,
                                        MmStage<BM, G>& st, int g) {
  constexpr int SPG = kSR / G;
  const int t = threadIdx.x;
  qring::cp_async16(&st.q[t * 16], L.q != nullptr ? L.q + static_cast<size_t>(g) * kSR * p.N
                                                  : p.qw, L.q != nullptr);
  if (t < p.R * SPG * 16)
    qring::cp_async16(&st.s[t >> 4][(t & 15) * 8],
                      L.s != nullptr ? L.s + static_cast<size_t>(g) * SPG * p.N : p.s,
                      L.s != nullptr);
#pragma unroll
  for (int i = 0; i < MmLoad<BM, GATEUP, G>::NX; ++i) {
    const int idx = t + i * qring::kThreads;
    qring::cp_async16(&st.x[(idx >> 3) * kXS + (idx & 7) * 8],
                      L.x[i] != nullptr ? L.x[i] + g * kSR : p.x, L.x[i] != nullptr);
  }
}

// the stage's payload unpacked into the [64 k][128 n] bf16 tile: thread t
// takes 16 bytes of payload row r = t / 8 (16 columns, both nibbles), scaled
// by its group's rows: row r / G of each half's plane
template <int BM, int G, bool MINS>
__device__ __forceinline__ void mm_dequant(const MmStage<BM, G>& st, MmSmem<BM, G, MINS>& sm,
                                           uint32_t bias) {
  constexpr int SPG = kSR / G;
  const int t = threadIdx.x, r = t >> 3, c = (t & 7) * 16, j = r / G;
  const uint4 q = *reinterpret_cast<const uint4*>(&st.q[r * kBN + c]);
  const uint4 la = *reinterpret_cast<const uint4*>(&st.s[j][c]);
  const uint4 lb = *reinterpret_cast<const uint4*>(&st.s[j][c + 8]);
  const uint4 ha = *reinterpret_cast<const uint4*>(&st.s[SPG + j][c]);
  const uint4 hb = *reinterpret_cast<const uint4*>(&st.s[SPG + j][c + 8]);
  const uint32_t qv[4] = {q.x, q.y, q.z, q.w};
  const uint32_t sl[8] = {la.x, la.y, la.z, la.w, lb.x, lb.y, lb.z, lb.w};
  const uint32_t sh[8] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
  uint32_t lo[8], hi[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)  // bytes 2k, 2k + 1: columns c + 2k, c + 2k + 1
    qring::dq_nibbles(qv[k >> 1] >> ((k & 1) * 16), bias, sl[k], sh[k], lo[k], hi[k]);
  uint4* dl = reinterpret_cast<uint4*>(&sm.w[r * kWS + c]);
  uint4* dh = reinterpret_cast<uint4*>(&sm.w[(kSR + r) * kWS + c]);
  dl[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  dl[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
  dh[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  dh[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
}

// MINS: the stage's mins rows (plane 2 + h, row j: group j of half h),
// negated, into the batch's B rows 8h + T·j + b (stage b of the batch)
template <int BM, int G>
__device__ __forceinline__ void mm_mins_rows(const MmStage<BM, G>& st, uint16_t* mb, int b) {
  constexpr int SPG = kSR / G, T = 8 / SPG;
  const int t = threadIdx.x;
  if (t < 2 * SPG * 16) {  // 2·SPG rows x 16 chunks of 8 bf16
    const int hj = t >> 4, c = (t & 15) * 8, h = hj / SPG, j = hj % SPG;
    uint4 v = *reinterpret_cast<const uint4*>(&st.s[2 * SPG + hj][c]);
    v.x ^= 0x80008000u;
    v.y ^= 0x80008000u;
    v.z ^= 0x80008000u;
    v.w ^= 0x80008000u;
    *reinterpret_cast<uint4*>(&mb[(8 * h + T * j + b) * kWS + c]) = v;
  }
}

// MINS: acc += [hi | mid | lo](xs) · (-m) over the batch's 16 groups, three
// k16 steps of mma.  xt[mi][h] is the m16n8 accumulator of the group sums
// (column c: row 8h + c of mb), so tiles 0 and 1 are the A fragment's
// columns 0-7 and 8-15; each f32 sum is split into its three bf16 parts
// (split3).
template <int MI, int NI, bool GATEUP>
__device__ __forceinline__ void mm_mins_flush(float (&acc)[MI][NI][4],
                                              const float (&xt)[MI][2][4], const uint16_t* mb,
                                              int wn) {
  const int lane = threadIdx.x & 31, mat = lane >> 3, lr = lane & 7;
  uint32_t ap[3][MI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // a[r]: tile r / 2, its elements 2·(r % 2), + 1
      const float* c = &xt[mi][r >> 1][(r & 1) * 2];
      uint16_t p0[3], p1[3];
      split3(c[0], p0);
      split3(c[1], p1);
#pragma unroll
      for (int q = 0; q < 3; ++q)
        ap[q][mi][r] = static_cast<uint32_t>(p0[q]) | (static_cast<uint32_t>(p1[q]) << 16);
    }
#pragma unroll
  for (int j = 0; j < NI / 2; ++j) {
    uint32_t b[4];
    i8t::ldmatrix_x4(b, &mb[((mat & 1) * 8 + lr) * kWS + pair_col<GATEUP, NI>(wn, j)
                            + (mat >> 1) * 8], true);
#pragma unroll
    for (int q = 0; q < 3; ++q) qring::mma_pair(acc, ap[q], b, j);
  }
}

template <int BM, bool GATEUP, int G, int ACT, bool MINS>
__global__ void __launch_bounds__(qring::kThreads, 2) mm_kernel(MmParams p) {
  static_assert(G == 16 || G == 32, "a stage holds one group (G = 32) or two (G = 16)");
  using W = qring::Warps<BM>;
  using Smem = MmSmem<BM, G, MINS>;
  constexpr int S = kRing<BM>;
  constexpr int SPG = Smem::SPG;
  constexpr int T = 8 / SPG;  // stages of a batch of the min term (MINS)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wm = warp % W::WM, wn = warp / W::WM;
  const int n0 = blockIdx.x * (GATEUP ? 64 : kBN), split = blockIdx.y, mt = blockIdx.z;
  const int m0 = mt * BM;
  const int nst = (p.K >> 1) / kSR;  // stages of K
  const int g0 = static_cast<int>(static_cast<long long>(split) * nst / p.KS);
  const int n = static_cast<int>(static_cast<long long>(split + 1) * nst / p.KS) - g0;
  const uint32_t bias = qring::nibble_bias(p.zero);
  const int r0 = wm * W::MI * 16;         // the warp's first row in the tile
  const bool warp_live = m0 + r0 < p.M;   // whether the warp has a real row
  const int mat = lane >> 3, lr = lane & 7;
  const int gid = lane >> 2, tig = lane & 3;
  float acc[W::MI][W::NI][4];
  qring::zero_acc(acc);
  float xc[MINS ? W::MI : 1][2][4];  // MINS: the batch's group sums, a column a group
  qring::zero_acc(xc);
  if constexpr (MINS)  // -m rows a short batch leaves unset meet zero sums: no NaN there
    for (int e = t; e < kSlots * kWS / 8; e += qring::kThreads)
      reinterpret_cast<uint4*>(sm.mb)[e] = make_uint4(0u, 0u, 0u, 0u);
  const MmLoad<BM, GATEUP, G> L(p, m0, n0);

#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < n) mm_load<BM, GATEUP, G>(p, L, sm.st[i], g0 + i);
    qring::cp_commit();
  }
  for (int i = 0; i < n; ++i) {
    qring::cp_wait<S - 2>();
    __syncthreads();  // stage i is in; the last stage's tile and slot are free
    const typename Smem::Stage& st = sm.st[i % S];
    const int b = i % T;  // MINS: the stage's place in its batch
    mm_dequant<BM, G, MINS>(st, sm, bias);
    if constexpr (MINS) mm_mins_rows<BM, G>(st, sm.mb, b);
    __syncthreads();  // the tile is dequantized
    if (warp_live) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // k16 steps: rows 0-31 low half, 32-63 high
        uint32_t a[W::MI][4];
        qring::a_frags<W::MI>(a, st.x, kXS, r0, kk * 16);
#pragma unroll
        for (int j = 0; j < W::NI / 2; ++j) {
          uint32_t bw[4];
          i8t::ldmatrix_x4(bw, &sm.w[(kk * 16 + (mat & 1) * 8 + lr) * kWS
                                     + pair_col<GATEUP, W::NI>(wn, j) + (mat >> 1) * 8], true);
          qring::mma_pair(acc, a, bw, j);
        }
        if constexpr (MINS) {  // the group sums: x · E, E's column b + T·j all ones
          const uint32_t e = gid == b + T * (kk & (SPG - 1)) ? 0x3f803f80u : 0u;
#pragma unroll
          for (int mi = 0; mi < W::MI; ++mi) i8t::mma_bf16(xc[mi][kk >> 1], a[mi], e, e);
        }
      }
      if constexpr (MINS)
        if (b == T - 1 || i == n - 1) {  // the batch's min term
          mm_mins_flush<W::MI, W::NI, GATEUP>(acc, xc, sm.mb, wn);
          qring::zero_acc(xc);
        }
    }
    // the copy into the slot stage i - 1 left, after this stage's work
    if (i + S - 1 < n) mm_load<BM, GATEUP, G>(p, L, sm.st[(i + S - 1) % S], g0 + i + S - 1);
    qring::cp_commit();
  }

  const int ncols = GATEUP ? p.N >> 1 : p.N;  // columns of out
  if (p.KS == 1) {
#pragma unroll
    for (int mi = 0; mi < W::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < (GATEUP ? W::NI / 2 : W::NI); ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = m0 + r0 + mi * 16 + gid + (e >> 1) * 8;
          const int c = pair_col<GATEUP, W::NI>(wn, ni >> 1) + (ni & 1) * 8 + tig * 2 + (e & 1);
          if (row >= p.M || n0 + c >= ncols) continue;
          const size_t o = static_cast<size_t>(row) * ncols + n0 + c;
          if constexpr (GATEUP)
            static_cast<uint16_t*>(p.out)[o] =
                act_mul<ACT>(acc[mi][ni][e], acc[mi][ni + W::NI / 2][e]);
          else
            static_cast<float*>(p.out)[o] = acc[mi][ni][e];
        }
    return;
  }
  const size_t plane = static_cast<size_t>(p.M) * p.N;
#pragma unroll
  for (int mi = 0; mi < W::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < W::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + r0 + mi * 16 + gid + (e >> 1) * 8;
        const int c = pair_col<GATEUP, W::NI>(wn, ni >> 1) + (ni & 1) * 8 + tig * 2 + (e & 1);
        if (row < p.M && gcol_live<GATEUP>(p, n0, c))
          p.part[split * plane + static_cast<size_t>(row) * p.N + gcol<GATEUP>(p, n0, c)] =
              acc[mi][ni][e];
      }
  if (!i8t::arrive_last(p.tickets + mt * gridDim.x + blockIdx.x, p.KS)) return;
  const int rows = min(BM, p.M - m0), cols = min(GATEUP ? 64 : kBN, ncols - n0);
  const float* pt = p.part + static_cast<size_t>(m0) * p.N + n0;
  if constexpr (GATEUP) {
    // the gate sums to shared memory (the ring is free), then the up sums
    // meet them there; ff is a multiple of 16: a 4-column group lies in it
    float* gs = reinterpret_cast<float*>(smem_raw);  // [BM][64]
    qring::reduce_splits<BM, 64>(pt, plane, p.KS, p.N, rows, cols, [&](int r, int c, float4 v) {
      *reinterpret_cast<float4*>(&gs[r * 64 + c]) = v;
    });
    __syncthreads();
    qring::reduce_splits<BM, 64>(pt + ncols, plane, p.KS, p.N, rows, cols,
                                 [&](int r, int c, float4 v) {
      const float4 g = *reinterpret_cast<const float4*>(&gs[r * 64 + c]);
      uint16_t* o = static_cast<uint16_t*>(p.out) + static_cast<size_t>(m0 + r) * ncols + n0 + c;
      o[0] = act_mul<ACT>(g.x, v.x);
      o[1] = act_mul<ACT>(g.y, v.y);
      o[2] = act_mul<ACT>(g.z, v.z);
      o[3] = act_mul<ACT>(g.w, v.w);
    });
  } else {
    qring::reduce_splits<BM, kBN>(pt, plane, p.KS, p.N, rows, cols, [&](int r, int c, float4 v) {
      *reinterpret_cast<float4*>(static_cast<float*>(p.out) + static_cast<size_t>(m0 + r) * ncols
                                 + n0 + c) = v;
    });
  }
}

template <int BM, bool GATEUP, int G, int ACT, bool MINS>
cudaError_t launch_mm_form(const MmParams& p, cudaStream_t st) {
  constexpr int bytes = sizeof(MmSmem<BM, G, MINS>);
  static bool ready = false;
  const cudaError_t e = qring::allow_smem(mm_kernel<BM, GATEUP, G, ACT, MINS>, bytes, ready);
  if (e != cudaSuccess) return e;
  const int tn = GATEUP ? 64 : kBN;
  const int ncols = GATEUP ? p.N / 2 : p.N;
  const dim3 grid((ncols + tn - 1) / tn, p.KS, (p.M + BM - 1) / BM);
  mm_kernel<BM, GATEUP, G, ACT, MINS><<<grid, qring::kThreads, bytes, st>>>(p);
  return cudaGetLastError();
}

// R = 4 (mins) or 2
template <int BM, bool GATEUP, int G, int ACT>
cudaError_t launch_mm(const MmParams& p, cudaStream_t st) {
  return p.R == 4 ? launch_mm_form<BM, GATEUP, G, ACT, true>(p, st)
                  : launch_mm_form<BM, GATEUP, G, ACT, false>(p, st);
}

// the GELU gate-up is built at G = 32 only (Q4_0, Q4_K: Gemma's files)
template <int BM, int G>
cudaError_t launch_mm_bm(const MmParams& p, int gateup, int act, cudaStream_t st) {
  if (!gateup) return act == kActSilu ? launch_mm<BM, false, G, kActSilu>(p, st)
                                      : cudaErrorInvalidValue;
  if (act == kActSilu) return launch_mm<BM, true, G, kActSilu>(p, st);
  if constexpr (G == 32) {
    if (act == kActGelu) return launch_mm<BM, true, G, kActGelu>(p, st);
  }
  return cudaErrorInvalidValue;
}

template <int G>
cudaError_t launch_mm_g(const MmParams& p, int gateup, int act, int bm, cudaStream_t st) {
  if (bm == 32) return launch_mm_bm<32, G>(p, gateup, act, st);
  if (bm == 64) return launch_mm_bm<64, G>(p, gateup, act, st);
  if (bm == 128) return launch_mm_bm<128, G>(p, gateup, act, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// y = x @ W^T for an i4t weight at M = 1 (i4mv.cuh's streaming matvec).
// gateup = 0: out f32 [1, N].  gateup = 1: W holds gate columns [0, N/2)
// and up columns [N/2, N); out bf16 [1, N/2] = act(gate) · up, act 0 SiLU
// or 1 GELU (G = 32 only; bf16_ops.cuh kActSilu, kActGelu).  R = 2 or 4
// scale planes (4: with mins); G 32 (Q4_0, Q4_K) or 16 (Q2_K, Q3_K); N a
// multiple of 128 (256 for the gate-up), K of 2G; ks splits of K on whole
// groups (ops/qmm.py i4t_mv_plan of the [K, N] weight, 1-8; one cluster a
// tile); payload on 4 bytes and scales on 8.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int bt_qmm_i4t(const void* x, const void* qw, const void* s, void* out, int K, int N,
                          int R, int zero, int G, int gateup, int act, int ks, void* stream) {
  const i4mv::Op op{static_cast<const uint16_t*>(x), static_cast<const uint8_t*>(qw),
                    static_cast<const uint16_t*>(s), out, K, N, ks, zero};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((G != 16 && G != 32) || (R != 2 && R != 4) || K % (2 * G) != 0
      || (act != kActSilu && (act != kActGelu || !gateup || G != 32)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (act == kActGelu) {
    e = R == 4 ? i4mv::run<32, true, i8mv::kGateUpGelu>(op, st)
               : i4mv::run<32, false, i8mv::kGateUpGelu>(op, st);
  } else if (G == 16) {
    if (R == 4)
      e = gateup ? i4mv::run<16, true, i8mv::kGateUp>(op, st)
                 : i4mv::run<16, true, i8mv::kF32>(op, st);
    else
      e = gateup ? i4mv::run<16, false, i8mv::kGateUp>(op, st)
                 : i4mv::run<16, false, i8mv::kF32>(op, st);
  } else if (R == 4) {
    e = gateup ? i4mv::run<32, true, i8mv::kGateUp>(op, st) : i4mv::run<32, true, i8mv::kF32>(op, st);
  } else {
    e = gateup ? i4mv::run<32, false, i8mv::kGateUp>(op, st)
               : i4mv::run<32, false, i8mv::kF32>(op, st);
  }
  return static_cast<int>(e);
}

// y = x @ W^T for an i4t weight at M > 1 (the tensor-core tile), G 32 or
// 16 (a gate-up's act as bt_qmm_i4t's: GELU at G = 32 only): rows of x per
// block bm (32, 64 or 128) and ks splits of K on whole
// stages of 32 payload rows (ops/qmm.py i4t_plan).  part: [ks, M, N] f32
// when ks > 1; tickets: ceil(M/bm)·ceil(ncols/(gateup ? 64 : 128)) zeros.
// N (gate-up: N/2) a multiple of 16, K of 64; x, qw and s on 16 bytes.
extern "C" int bt_qmm_i4t_mm(const void* x, const void* qw, const void* s, void* out,
                             void* part, void* tickets, int M, int K, int N, int R, int zero,
                             int G, int gateup, int act, int bm, int ks, void* stream) {
  MmParams p{static_cast<const uint16_t*>(x), static_cast<const uint8_t*>(qw),
             static_cast<const uint16_t*>(s), out, static_cast<float*>(part),
             static_cast<int*>(tickets), M, K, N, R, zero, ks};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((R != 2 && R != 4) || K % (2 * kSR) != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (G == 32) e = launch_mm_g<32>(p, gateup, act, bm, st);
  else if (G == 16) e = launch_mm_g<16>(p, gateup, act, bm, st);
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
