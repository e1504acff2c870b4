// Lane-major quantized matmul (i4p, i8): the i4p plain form and the grouped
// forms of the routed experts (MoE).
//
// Replaces the Pallas kernels of booster_tpu/ops/pallas_qmm.py:
//   _qmm_i4_kernel (:96, via _qmm_i4 :225)  -> lane_kernel<true, BM, MN>, no tile table
// and the same bodies as booster_tpu/ops/pallas_moe.py::grouped_qmm (:72)
// calls them (pallas_calls :113, :150; _qmm_i8_kernel :135 in the i8 branch)
// -> lane_kernel<I4, BM, MN> with a tile table.  The i8 form without a
// tile table (_qmm_i8 :265: the Q8_0 and Q5_1 downs) runs qmm_lane_i8.cu;
// this kernel takes it only where a caller names it (ops/qmm.py
// lane_launch; tools/lane_forms.py times the two side by side).
//
// y[m, n] = sum_k x[m, k] · W[n, k] over the payload's rows (lane-major: a
// row of W holds every k of one output column).
//   i4p: qw [R, K/2] u8, byte j of row n holds element j (low nibble) and
//        element j + K/2 (high nibble); scales [R, 2, K/(2G)] bf16, row 0
//        for the low half, row 1 for the high half (prepare_kernel_scales,
//        compact_scales); with affine mins (MN, Q4_K) [R, 4, K/(2G)], rows
//        2 and 3 the two halves' mins.
//   i8:  qw [R, K] int8; scales [R, 1, K/G] bf16; with affine mins (MN,
//        Q5_K and Q5_1) [R, 2, K/G], row 1 the mins (Q5_1's are -m).
// w = bf16(f32(bf16(q - zero)) · f32(bf16 s)) (the product of two bf16 is
// exact in f32, so this is the reference's bf16 multiply), and with mins
// w = bf16(w - bf16 m) (the reference's bf16 subtraction of the expanded
// mins, has_mins :121-123 and :153-154); y = bf16(x) @ w with f32
// accumulation: the reference's function up to the order of the f32 sums.
//
// Grouped form (the routed experts): x is route_pad's group-padded buffer
// [Mp, K], whose 32-row tiles each belong to one expert; tile_expert[t]
// names it, and the tile's rows multiply rows [e·N, e·N + N) of the stacked
// [E·N, K] payload.  rows_used points at the count of the padded groups'
// rows (route_pad's start[E], on the device): tiles at or past it hold only
// zero rows, and their rows are written as zeros without reading a weight
// (the reference reads expert E - 1 for each of them: at decode 7 of 9
// tiles).  The plain form has no tile table and reads rows [0, N).
//
// What bounds it on the H100.  Decode (one row, or 2 and 128 real rows of 8
// experts): the bytes of the payload and scales (0.5625 byte per weight for
// i4p, 1.0625 for i8) over 3.35 TB/s: about 20 µs per expert matrix of
// Mixtral-8x7B.  Prefill (4352 padded rows): the bf16 operations.  Design (qmm_ring.cuh): a block of
// 8 warps owns a BM x 128 output tile and one split of K, and walks it in
// stages of 64 or 128 columns of K (i4p: 32 or 64 payload bytes a row, whose
// low and high nibbles are columns j and K/2 + j).  cp.async keeps the next
// stages of raw payload, scale words and x in flight in a ring of 3 or 4
// (the copy into the slot the last stage left issued after a stage's work);
// the stage in use is dequantized from shared memory into a bf16 [128 n][SK
// k] tile (i4p: qring::dq_nibbles; i8: qring::dq_bytes), which is the .col
// operand of mma.sync as it is.  The scale words of a stage are copied as
// the 4-byte words that hold its groups' scales (any G that is a multiple
// of 16); with mins, the words of the stage's mins beside them, on the same
// ring, and each dequantized pair less its group's min.  ops/qmm.py
// lane_plan picks BM (32, 64 or 128) and the split from
// (M, K, N) (and, grouped, the experts E): where the output tiles cannot
// fill the card, K splits on whole stages, each split writes f32 partials
// and the last block (ticket, reset by it) adds them in split order, all its loads of a split issued at once
// (qring::reduce_splits); at large M a block's 64 or 128 rows reuse each
// dequantized weight.  A grouped block takes BM / 32 consecutive expert
// tiles: it runs its K range once per run of tiles of one expert (table and
// rows_used read on the card).

#include <cuda_runtime.h>
#include <stdint.h>

#include "qmm_ring.cuh"

namespace {

constexpr int kBN = qring::kBN;  // payload rows (output columns) per tile

// Columns of K a stage and stages in the ring, two blocks an SM (shared
// memory: a stage holds its payload, x and scale words; the dequantized
// tile is as wide as a stage).  i4p at 32 rows: 128 columns (64 payload
// bytes of a row, whole cache lines in two stages) and 3 stages; otherwise
// 64 columns and 4 stages, 3 at 128 rows.
template <bool I4, int BM>
constexpr int kSK = BM == 32 && I4 ? 128 : 64;
template <bool I4, int BM>
constexpr int kRing = BM == 32 && I4 ? 3 : BM == 128 ? 3 : 4;
template <bool I4, int BM>
constexpr int kXS = kSK<I4, BM> + 8;  // bf16 per shared row of x and of the tile (pad)
template <bool I4, int BM>
constexpr int kCPR = kSK<I4, BM> / 8;  // 16-byte chunks of x a row in a stage
// payload bytes of a row in a stage (i4p: of each half)
template <bool I4, int BM>
constexpr int kStageBytes = I4 ? kSK<I4, BM> / 2 : kSK<I4, BM>;
// scale words of a payload row and half in a stage: G >= 16, one more for
// a window that starts in the middle of a word
template <bool I4, int BM>
constexpr int kSW = kStageBytes<I4, BM> / 32 + 1;

template <bool I4, int BM, bool MN>
struct Smem {
  struct alignas(16) Stage {
    uint8_t q[kBN * kStageBytes<I4, BM>];      // payload rows' bytes of the stage
    uint16_t x[BM * kXS<I4, BM>];              // the block's x at the stage's k
    uint32_t s[kBN][I4 ? 2 : 1][kSW<I4, BM>];  // the words holding the stage's scales
    uint32_t m[MN ? kBN : 1][I4 ? 2 : 1][kSW<I4, BM>];  // and its mins (MN)
  };
  Stage st[kRing<I4, BM>];
  alignas(16) uint16_t w[kBN * kXS<I4, BM>];  // the dequantized [128 n][SK k] tile
};

struct Params {
  const uint16_t* x;         // [M, K] bf16
  const uint8_t* q;          // payload, rows of K/2 bytes (i4p) or K bytes (i8)
  const uint16_t* s;         // [R, rows, K / (rows·G)] bf16
  float* out;                // [M, N] f32
  float* part;               // [KS, M, N] f32 partials (KS > 1), else null
  int* tickets;              // [gridDim.z · gridDim.x] zeros, reset by the last block
  const int* tile_expert;    // [ceil(M / 32)] or null (the plain form)
  const int* rows_used;      // one int on the device, or null
  int M, K, N, G, zero, KS;  // (with mins: zero 0)
  int gshift;                // log2 G where G is a power of 2, else -1
};

// j / G: a shift where G is a power of 2
__device__ __forceinline__ int gdiv(const Params& p, int j) {
  return p.gshift >= 0 ? j >> p.gshift : j / p.G;
}

// What a thread copies and dequantizes in a pass over payload rows wrow0 ..
// + 127, at stage 0 (stage stg adds stg·QB bytes of payload and columns of
// x, and gdiv(stg·QB) scale elements).  A scale element e lies in the 4-byte
// word (e + eoff) / 2 from sw (s's address rounded down to 4 bytes); the
// bases below count elements from sw, so a word is base / 2.  A payload row
// has K/G scale elements, and with mins K/G more after them (its mins: a
// min's element is its scale's plus K/G, computed where it is read, which
// keeps the mins form within the 128 registers of two blocks an SM).
template <bool I4, int BM, bool MN>
struct Lane {
  static constexpr int QB = kStageBytes<I4, BM>;
  static constexpr int NQ = QB / 16 / 2;              // 16-byte payload chunks a thread
  static constexpr int NX = BM * kCPR<I4, BM> / qring::kThreads;  // 16-byte x chunks a thread
  const uint32_t* sw;
  const uint8_t* q[NQ];
  const uint16_t* x[NX];     // null: a row outside the run (zeros)
  size_t sload;              // the scale element of the (row, half) whose words it copies
  size_t sdq[I4 ? 2 : 1];    // the scale elements of the row it dequantizes, per half

  __device__ __forceinline__ Lane(const Params& p, size_t wrow0, int m0, int ra, int rb) {
    const int t = threadIdx.x;
    const uintptr_t sa = reinterpret_cast<uintptr_t>(p.s);
    sw = reinterpret_cast<const uint32_t*>(sa & ~static_cast<uintptr_t>(3));
    const size_t eoff = (sa >> 1) & 1;
    const size_t ld = I4 ? p.K / 2 : p.K;  // payload bytes of a row
    const size_t per_row = p.K / p.G;      // scale elements of a payload row
    const size_t rs = MN ? 2 * per_row : per_row;  // and its planes' stride
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int idx = t + i * qring::kThreads;
      q[i] = p.q + (wrow0 + idx / (QB / 16)) * ld + idx % (QB / 16) * 16;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const int idx = t + i * qring::kThreads, row = m0 + idx / kCPR<I4, BM>;
      const int c = idx % kCPR<I4, BM> * 8;
      const int k = I4 ? (c < QB ? c : p.K / 2 + c - QB) : c;
      x[i] = row >= ra && row < rb ? p.x + static_cast<size_t>(row) * p.K + k : nullptr;
    }
    const int r = I4 ? t >> 1 : t, h = I4 ? t & 1 : 0;
    sload = (wrow0 + r) * rs + h * (per_row / 2) + eoff;
#pragma unroll
    for (int hh = 0; hh < (I4 ? 2 : 1); ++hh)
      sdq[hh] = (wrow0 + (t >> 1)) * rs + hh * (per_row / 2) + eoff;
  }
};

// Stage stg (payload, scale words, mins words, x of the run's rows, zeros
// for the others) into a ring slot.
template <bool I4, int BM, bool MN>
__device__ __forceinline__ void lane_load(const Params& p, const Lane<I4, BM, MN>& L,
                                          typename Smem<I4, BM, MN>::Stage& st, int stg) {
  constexpr int QB = Lane<I4, BM, MN>::QB;
  const int t = threadIdx.x, qb = stg * QB;
#pragma unroll
  for (int i = 0; i < Lane<I4, BM, MN>::NQ; ++i) {  // 128 rows x QB/16 chunks of 16 bytes
    const int idx = t + i * qring::kThreads;
    qring::cp_async16(&st.q[idx * 16], L.q[i] + qb, true);
  }
  if (t < kBN * (I4 ? 2 : 1)) {  // the scale words of (row, half)
    const size_t w0 = (L.sload + gdiv(p, qb)) >> 1, w1 = (L.sload + gdiv(p, qb + QB - 1)) >> 1;
    uint32_t* d = st.s[I4 ? t >> 1 : t][I4 ? t & 1 : 0];
    for (size_t wi = w0; wi <= w1; ++wi) qring::cp_async4(d + (wi - w0), L.sw + wi, true);
    if constexpr (MN) {
      const size_t mload = L.sload + gdiv(p, p.K);  // K/G: the row's mins follow its scales
      const size_t m0 = (mload + gdiv(p, qb)) >> 1, m1 = (mload + gdiv(p, qb + QB - 1)) >> 1;
      uint32_t* dm = st.m[I4 ? t >> 1 : t][I4 ? t & 1 : 0];
      for (size_t wi = m0; wi <= m1; ++wi) qring::cp_async4(dm + (wi - m0), L.sw + wi, true);
    }
  }
#pragma unroll
  for (int i = 0; i < Lane<I4, BM, MN>::NX; ++i) {  // x: BM rows x 8 chunks of 8 bf16
    const int idx = t + i * qring::kThreads;
    qring::cp_async16(&st.x[idx / kCPR<I4, BM> * kXS<I4, BM> + idx % kCPR<I4, BM> * 8],
                      L.x[i] != nullptr ? L.x[i] + qb : p.x, L.x[i] != nullptr);
  }
}

// the scale (bf16 bits) of byte or column k of stage stg among the words
// `words` of a ring slot's (row, half) (Stage::s, or Stage::m for a min);
// e: the row's element base of those words (Lane::sdq, plus K/G for a min)
template <bool I4, int BM>
__device__ __forceinline__ uint32_t stage_scale(const Params& p, const uint32_t* words,
                                                size_t e, int stg, int k) {
  const int j0 = gdiv(p, stg * kStageBytes<I4, BM>);
  const int idx = gdiv(p, stg * kStageBytes<I4, BM> + k) - j0 + static_cast<int>((e + j0) & 1);
  return reinterpret_cast<const uint16_t*>(words)[idx];
}

// The stage's payload dequantized into the [128 n][SK k] bf16 tile: thread
// t takes half of payload row t / 2 (i4p: both nibbles of its bytes; i8:
// its bytes), 16 columns of K a scale (and a min, MN).
template <bool I4, int BM, bool MN>
__device__ __forceinline__ void lane_dequant(const Params& p, const Lane<I4, BM, MN>& L,
                                             const typename Smem<I4, BM, MN>::Stage& st,
                                             uint16_t* w, int stg, uint32_t bias) {
  constexpr int QB = kStageBytes<I4, BM>;
  constexpr int XS = kXS<I4, BM>;
  const int t = threadIdx.x, r = t >> 1, c = t & 1;
#pragma unroll
  for (int cc = 0; cc < QB / 32; ++cc) {
    const int b = c * (QB / 2) + cc * 16;  // the chunk's first byte (of the stage's half)
    const uint4 q = *reinterpret_cast<const uint4*>(&st.q[r * QB + b]);
    const uint32_t qv[4] = {q.x, q.y, q.z, q.w};
    const uint32_t sl = stage_scale<I4, BM>(p, st.s[r][0], L.sdq[0], stg, b) * 0x10001u;
    uint32_t lo[8], hi[8];
    if constexpr (I4) {
      const uint32_t sh = stage_scale<I4, BM>(p, st.s[r][1], L.sdq[1], stg, b) * 0x10001u;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        qring::dq_nibbles(qv[i >> 1] >> ((i & 1) * 16), bias, sl, sh, lo[i], hi[i]);
      if constexpr (MN) {
        const size_t kg = gdiv(p, p.K);  // K/G: the row's mins follow its scales
        const uint32_t ml = stage_scale<I4, BM>(p, st.m[r][0], L.sdq[0] + kg, stg, b) * 0x10001u;
        const uint32_t mh = stage_scale<I4, BM>(p, st.m[r][1], L.sdq[1] + kg, stg, b) * 0x10001u;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          lo[i] = qring::sub_min(lo[i], ml);
          hi[i] = qring::sub_min(hi[i], mh);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) lo[i] = qring::dq_bytes(qv[i >> 1] >> ((i & 1) * 16), sl);
      if constexpr (MN) {  // Q5_K's mins dmin·mn, or Q5_1's -m (w = q·d + m)
        const uint32_t ml =
            stage_scale<I4, BM>(p, st.m[r][0], L.sdq[0] + gdiv(p, p.K), stg, b) * 0x10001u;
#pragma unroll
        for (int i = 0; i < 8; ++i) lo[i] = qring::sub_min(lo[i], ml);
      }
    }
    uint4* dl = reinterpret_cast<uint4*>(&w[r * XS + b]);
    dl[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    dl[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
    if constexpr (I4) {  // the high nibbles: columns K/2 + j, the tile's second half
      uint4* dh = reinterpret_cast<uint4*>(&w[r * XS + QB + b]);
      dh[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      dh[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    }
  }
}

// acc = x rows [ra, rb) of the block @ payload rows wrow0 .. + 127 over
// stages [s0, s1), from zero, k16 steps in order.
template <bool I4, int BM, bool MN>
__device__ __forceinline__ void lane_pass(
    const Params& p, Smem<I4, BM, MN>& sm, size_t wrow0, int m0, int ra, int rb, int s0, int s1,
    float (&acc)[qring::Warps<BM>::MI][qring::Warps<BM>::NI][4]) {
  using W = qring::Warps<BM>;
  constexpr int S = kRing<I4, BM>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % W::WM, wn = warp / W::WM;
  const int mat = lane >> 3, lr = lane & 7;
  const int r0 = wm * W::MI * 16;
  const bool rows = m0 + r0 < rb && m0 + r0 + W::MI * 16 > ra;  // the warp has a row of the run
  const uint32_t bias = qring::nibble_bias(p.zero);
  const int n = s1 - s0;
  const Lane<I4, BM, MN> L(p, wrow0, m0, ra, rb);
  qring::zero_acc(acc);
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < n) lane_load<I4, BM, MN>(p, L, sm.st[i], s0 + i);
    qring::cp_commit();
  }
  for (int i = 0; i < n; ++i) {
    qring::cp_wait<S - 2>();
    __syncthreads();  // stage i is in; the last stage's tile and slot are free
    const typename Smem<I4, BM, MN>::Stage& st = sm.st[i % S];
    lane_dequant<I4, BM, MN>(p, L, st, sm.w, s0 + i, bias);
    __syncthreads();  // the tile is dequantized
    if (rows) {
#pragma unroll
      for (int kk = 0; kk < kSK<I4, BM> / 16; ++kk) {
        uint32_t a[W::MI][4];
        qring::a_frags<W::MI>(a, st.x, kXS<I4, BM>, r0, kk * 16);
#pragma unroll
        for (int j = 0; j < W::NI / 2; ++j) {
          // matrices: (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
          uint32_t b[4];
          i8t::ldmatrix_x4(b, &sm.w[(wn * W::NI * 8 + j * 16 + (mat >> 1) * 8 + lr) * kXS<I4, BM>
                                    + kk * 16 + (mat & 1) * 8], false);
          qring::mma_pair(acc, a, b, j);
        }
      }
    }
    // the copy into the slot stage i - 1 left, after this stage's work
    if (i + S - 1 < n)
      lane_load<I4, BM, MN>(p, L, sm.st[(i + S - 1) % S], s0 + i + S - 1);
    qring::cp_commit();
  }
  __syncthreads();  // every warp is done with the ring before it is filled again
}

template <bool I4, int BM, bool MN>
__global__ void __launch_bounds__(qring::kThreads, 2) lane_kernel(Params p) {
  using W = qring::Warps<BM>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<I4, BM, MN>& sm = *reinterpret_cast<Smem<I4, BM, MN>*>(smem_raw);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wm = warp % W::WM, wn = warp / W::WM;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * kBN, split = blockIdx.y, mb = blockIdx.z, m0 = mb * BM;
  const int mend = min(m0 + BM, p.M);
  const int used = p.rows_used != nullptr ? min(*p.rows_used, p.M) : p.M;
  const int lend = max(m0, min(mend, used));  // rows [m0, lend) are live, [lend, mend) zero
  const size_t plane = static_cast<size_t>(p.M) * p.N;
  if (lend == m0) {  // only padding rows: zeros, no weight read, no ticket
    if (split == 0)
      for (int e = t; e < BM * kBN / 4; e += qring::kThreads) {
        const int row = m0 + e / (kBN / 4);
        if (row < mend)
          reinterpret_cast<float4*>(p.out + static_cast<size_t>(row) * p.N + n0)[e % (kBN / 4)] =
              make_float4(0.f, 0.f, 0.f, 0.f);
      }
    return;
  }
  const int nst = p.K / kSK<I4, BM>;
  const int s0 = static_cast<int>(static_cast<long long>(split) * nst / p.KS);
  const int s1 = static_cast<int>(static_cast<long long>(split + 1) * nst / p.KS);
  const int r0 = wm * W::MI * 16;
  float acc[W::MI][W::NI][4];
  for (int ra = m0; ra < lend;) {
    // a run of 32-row tiles of one expert (the whole live range without a table)
    int rb = lend, e = 0;
    if (p.tile_expert != nullptr) {
      e = p.tile_expert[ra / 32];
      rb = min(ra + 32, lend);
      while (rb < lend && p.tile_expert[rb / 32] == e) rb = min(rb + 32, lend);
    }
    lane_pass<I4, BM, MN>(p, sm, static_cast<size_t>(e) * p.N + n0, m0, ra, rb, s0, s1, acc);
#pragma unroll
    for (int mi = 0; mi < W::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < W::NI; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows gid and gid + 8 of the fragment
          const int row = m0 + r0 + mi * 16 + gid + h * 8;
          if (row < ra || row >= rb) continue;
          const size_t o = static_cast<size_t>(row) * p.N + n0 + wn * W::NI * 8 + ni * 8 + tig * 2;
          const float2 v = make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
          if (p.KS == 1) *reinterpret_cast<float2*>(p.out + o) = v;
          else *reinterpret_cast<float2*>(p.part + split * plane + o) = v;
        }
    ra = rb;
  }
  if (p.KS == 1) {
    for (int e = t; e < BM * kBN / 4; e += qring::kThreads) {  // rows past rows_used
      const int row = m0 + e / (kBN / 4);
      if (row >= lend && row < mend)
        reinterpret_cast<float4*>(p.out + static_cast<size_t>(row) * p.N + n0)[e % (kBN / 4)] =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  if (!i8t::arrive_last(p.tickets + mb * gridDim.x + blockIdx.x, p.KS)) return;
  const size_t o0 = static_cast<size_t>(m0) * p.N + n0;
  qring::reduce_splits<BM, kBN>(p.part + o0, plane, p.KS, p.N, lend - m0, kBN,
                                [&](int r, int c, float4 v) {
    *reinterpret_cast<float4*>(p.out + o0 + static_cast<size_t>(r) * p.N + c) = v;
  });
  for (int e = t; e < BM * kBN / 4; e += qring::kThreads) {  // rows past rows_used
    const int row = m0 + e / (kBN / 4);
    if (row >= lend && row < mend)
      reinterpret_cast<float4*>(p.out + static_cast<size_t>(row) * p.N + n0)[e % (kBN / 4)] =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <bool I4, int BM, bool MN>
cudaError_t launch(const Params& p, cudaStream_t st) {
  constexpr int bytes = sizeof(Smem<I4, BM, MN>);
  static bool ready = false;
  const cudaError_t e = qring::allow_smem(lane_kernel<I4, BM, MN>, bytes, ready);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.N / kBN, p.KS, (p.M + BM - 1) / BM);
  lane_kernel<I4, BM, MN><<<grid, qring::kThreads, bytes, st>>>(p);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_bm(const Params& p, int i4, int mins, cudaStream_t st) {
  if (mins) return i4 ? launch<true, BM, true>(p, st) : launch<false, BM, true>(p, st);
  return i4 ? launch<true, BM, false>(p, st) : launch<false, BM, false>(p, st);
}

}  // namespace

// y [M, N] f32 = x [M, K] bf16 @ W^T for a lane-major weight: i4 = 1 for i4p
// (zero point `zero`), 0 for i8; mins = 1 when the scale planes hold the
// mins after the scales (i4p: the halves' [R, 4, K/(2G)]; i8: [R, 2,
// K/G]).  tile_expert (int32 [ceil(M/32)]) selects, per 32-row tile, the
// rows [e·N, e·N + N) of the stacked payload; null takes rows [0, N).
// rows_used (one int32 on the device, a multiple of 32, or null): rows at
// or past it are written as zeros.  bm rows of x per block (32, 64 or 128)
// and ks splits of K on whole 64-column stages (ops/qmm.py
// lane_plan); part [ks, M, N] f32 when ks > 1; tickets ceil(M/bm)·N/128
// zeros.  N a multiple of 128; K of 64 (i4p: of 128); G a multiple of 16
// dividing K (K/2 for i4p); x and the payload on 16 bytes.  Returns the
// CUDA error of the launch (0 on success).
extern "C" int bt_qmm_lane(const void* x, const void* q, const void* s, void* out, void* part,
                           void* tickets, const void* tile_expert, const void* rows_used, int M,
                           int K, int N, int G, int zero, int i4, int mins, int bm, int ks,
                           void* stream) {
  Params p{static_cast<const uint16_t*>(x), static_cast<const uint8_t*>(q),
           static_cast<const uint16_t*>(s), static_cast<float*>(out), static_cast<float*>(part),
           static_cast<int*>(tickets), static_cast<const int*>(tile_expert),
           static_cast<const int*>(rows_used), M, K, N, G, zero, ks,
           (G & (G - 1)) == 0 ? __builtin_ctz(static_cast<unsigned>(G)) : -1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (bm == 32) e = launch_bm<32>(p, i4, mins, st);
  else if (bm == 64) e = launch_bm<64>(p, i4, mins, st);
  else if (bm == 128) e = launch_bm<128>(p, i4, mins, st);
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
