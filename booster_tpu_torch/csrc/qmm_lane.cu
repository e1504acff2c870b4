// Lane-major quantized matmul (i4p, i8): the plain form and the grouped
// form of the routed experts (MoE).
//
// Replaces the Pallas kernels of booster_tpu/ops/pallas_qmm.py:
//   _qmm_i4_kernel (:96, via _qmm_i4 :225)  -> qmm_lane_kernel<true>, no tile table
//   _qmm_i8_kernel (:135, via _qmm_i8 :265) -> qmm_lane_kernel<false>, no tile table
// and the same bodies as booster_tpu/ops/pallas_moe.py::grouped_qmm (:72)
// calls them (pallas_calls :113, :150) -> the same kernels with a tile table.
//
// y[m, n] = sum_k x[m, k] · W[n, k] over the payload's rows (lane-major: a
// row of W holds every k of one output column).
//   i4p: qw [R, K/2] u8, byte j of row n holds element j (low nibble) and
//        element j + K/2 (high nibble); scales [R, 2, K/(2G)] bf16, row 0
//        for the low half, row 1 for the high half (prepare_kernel_scales,
//        compact_scales).
//   i8:  qw [R, K] int8; scales [R, 1, K/G] bf16.
// w = bf16(f32(bf16(q - zero)) · f32(bf16 s)) (the product of two bf16 is
// exact in f32, so this is the reference's bf16 multiply); y = bf16(x) @ w
// with f32 accumulation: the reference's function up to the order of the f32
// sums.  Affine mins are not taken (Q4_0 and Q8_0 have none): the wrapper
// raises.
//
// Grouped form (the routed experts): x is route_pad's group-padded buffer
// [Mp, K], whose 32-row tiles each belong to one expert; tile_expert[t]
// names it, and the tile's rows multiply rows [e·N, e·N + N) of the stacked
// [E·N, K] payload.  rows_used points at the count of the padded groups'
// rows (route_pad's start[E], on the device): tiles at or past it hold only
// zero rows, and their blocks write zeros without reading a weight (the
// reference reads expert E - 1 for each of them: at decode 7 of 9 tiles).
// The plain form has no tile table and reads rows [0, N).
//
// What bounds it on the H100.  Decode (2 or 128 real rows of 8 experts): the
// bytes of the routed experts' payload and scales (0.5625 byte per weight
// for i4p) over 3.35 TB/s, about 20 µs per expert matrix of Mixtral-8x7B.
// Prefill (4352 padded rows): the bf16 operations.  Design: a block of 256
// threads owns a 32 x 128 output tile (one expert tile of rows, 128 output
// columns of that expert) and walks K in stages of 128 columns (i4p: 64
// payload bytes, whose low and high nibbles are columns j and K/2 + j).  A
// stage goes global -> registers (16-byte loads, the next stage in flight
// while the tensor cores work on this one) -> shared memory: x as it is, the
// payload dequantized to bf16.  The 8 warps (2 along M x 4 along N) run
// mma.sync m16n8k16 (bf16 in, f32 accumulate) on ldmatrix fragments; the
// weight tile is stored [n][k], which is the .col operand as it is.  Blocks
// run with the column tile fastest: the blocks in flight together are one
// or a few row tiles' column tiles, which share x.  route_pad puts an
// expert's row tiles side by side, so they run one after another, each
// reading the whole expert again: from L2 if it is still there (33 MB of
// Q4_0 gate/up against the H100's 50 MB; the hit rate is not measured).
// Grouping 16 row tiles with the row tile fastest, so that the blocks in
// flight share weight slabs, was measured on the H100 no faster at the
// 4096-row prefill and 47 % slower at the down matmul of one decode token,
// whose real tiles then no longer lead the grid onto idle SMs.
// wgmma, TMA and a ring of stages are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "i8t_tile.cuh"

namespace {

constexpr int kBM = 32;         // rows of x per tile (route_pad's group padding)
constexpr int kBN = 128;        // output columns per tile
constexpr int kSK = 128;        // columns of K per stage
constexpr int kThreads = 256;   // 8 warps: 2 along M x 4 along N
constexpr int kS = kSK + 8;     // bf16 per shared row (pad: no ldmatrix bank conflicts)

struct alignas(16) Smem {
  uint16_t x[kBM * kS];
  uint16_t w[kBN * kS];
};

struct Params {
  const uint16_t* x;         // [M, K] bf16
  const uint8_t* q;          // payload, rows of K/2 bytes (i4p) or K bytes (i8)
  const uint16_t* s;         // [R, rows, K / (rows·G)] bf16
  float* out;                // [M, N] f32
  const int* tile_expert;    // [M / 32] or null (the plain form)
  const int* rows_used;      // one int on the device, or null
  int M, K, N, G, zero;
};

// Stage registers: x (2 chunks of 8 bf16) and the payload (i4p: 2 chunks of
// 16 bytes and their 2 x 2 scales; i8: 4 chunks of 16 bytes and 4 scales).
struct Stage {
  uint4 x[2];
  uint4 q[4];
  uint16_t s[4];
};

// the actual column of logical column lc of stage st (i4p: the low half
// then the high half of 64 payload bytes; i8: 128 consecutive columns)
template <bool I4>
__device__ __forceinline__ int stage_col(const Params& p, int st, int lc) {
  if constexpr (I4) {
    const int b = st * (kSK / 2);  // the stage's first payload byte
    return lc < kSK / 2 ? b + lc : p.K / 2 + b + lc - kSK / 2;
  }
  return st * kSK + lc;
}

template <bool I4>
__device__ __forceinline__ void load_stage(const Params& p, int m0, size_t wrow0, int st,
                                           Stage& r) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // x: 32 rows x 16 chunks of 8 bf16
    const int idx = threadIdx.x + i * kThreads;
    const int row = m0 + (idx >> 4), c = idx & 15;
    r.x[i] = row < p.M ? __ldg(reinterpret_cast<const uint4*>(
                             p.x + static_cast<size_t>(row) * p.K + stage_col<I4>(p, st, c * 8)))
                       : make_uint4(0u, 0u, 0u, 0u);
  }
  if constexpr (I4) {
    const int sgh = p.K / (2 * p.G);  // groups per half
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // 128 rows x 4 chunks of 16 payload bytes
      const int idx = threadIdx.x + i * kThreads;
      const size_t row = wrow0 + (idx >> 2);
      const int b = st * (kSK / 2) + (idx & 3) * 16;  // byte column
      r.q[i] = __ldg(reinterpret_cast<const uint4*>(p.q + row * (p.K / 2) + b));
      const uint16_t* sr = p.s + row * 2 * sgh + b / p.G;
      r.s[2 * i] = __ldg(sr);
      r.s[2 * i + 1] = __ldg(sr + sgh);
    }
  } else {
    const int sg = p.K / p.G;
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // 128 rows x 8 chunks of 16 bytes
      const int idx = threadIdx.x + i * kThreads;
      const size_t row = wrow0 + (idx >> 3);
      const int k = st * kSK + (idx & 7) * 16;
      r.q[i] = __ldg(reinterpret_cast<const uint4*>(p.q + row * p.K + k));
      r.s[i] = __ldg(p.s + row * sg + k / p.G);
    }
  }
}

// 16 values (q_j - zero) · s, rounded to bf16, stored at dst (2 x 16 bytes);
// v(j) gives q_j as an int.
template <typename V>
__device__ __forceinline__ void store16(uint16_t* dst, uint16_t sbits, V v) {
  const float s = bf16f(sbits);
  uint32_t o[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    o[j] = i8t::pack_bf16x2(__fmul_rn(static_cast<float>(v(2 * j)), s),
                            __fmul_rn(static_cast<float>(v(2 * j + 1)), s));
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

template <bool I4>
__device__ __forceinline__ void store_stage(const Params& p, const Stage& r, Smem& sm) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    *reinterpret_cast<uint4*>(&sm.x[(idx >> 4) * kS + (idx & 15) * 8]) = r.x[i];
  }
  if constexpr (I4) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const uint32_t b[4] = {r.q[i].x, r.q[i].y, r.q[i].z, r.q[i].w};
      uint16_t* row = &sm.w[(idx >> 2) * kS];
      const int c = (idx & 3) * 16;
      const int z = p.zero;
      store16(row + c, r.s[2 * i], [&](int j) {
        return static_cast<int>((b[j >> 2] >> (8 * (j & 3))) & 0xfu) - z;
      });
      store16(row + kSK / 2 + c, r.s[2 * i + 1], [&](int j) {
        return static_cast<int>((b[j >> 2] >> (8 * (j & 3) + 4)) & 0xfu) - z;
      });
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const uint32_t b[4] = {r.q[i].x, r.q[i].y, r.q[i].z, r.q[i].w};
      store16(&sm.w[(idx >> 3) * kS + (idx & 7) * 16], r.s[i], [&](int j) {
        return static_cast<int>(static_cast<int8_t>((b[j >> 2] >> (8 * (j & 3))) & 0xffu));
      });
    }
  }
}

// acc += this stage's x tile @ w tile^T, 8 steps of 16 columns of K in order.
// Warp (wm, wn) owns rows wm·16 + [0, 16) and columns wn·32 + [0, 32):
// acc[ni] is the m16n8 fragment of columns wn·32 + ni·8.
__device__ __forceinline__ void mma_stage(const Smem& sm, float (&acc)[4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int mat = lane >> 3, r = lane & 7;  // the 8x8 matrix and row this lane addresses
#pragma unroll
  for (int kk = 0; kk < kSK / 16; ++kk) {
    uint32_t a[4];
    i8t::ldmatrix_x4(a, &sm.x[(wm * 16 + (mat & 1) * 8 + r) * kS + kk * 16 + (mat >> 1) * 8],
                     false);
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      // matrices: (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
      uint32_t b[4];
      i8t::ldmatrix_x4(b, &sm.w[(wn * 32 + nj * 16 + (mat >> 1) * 8 + r) * kS + kk * 16 +
                                (mat & 1) * 8],
                       false);
      i8t::mma_bf16(acc[2 * nj], a, b[0], b[1]);
      i8t::mma_bf16(acc[2 * nj + 1], a, b[2], b[3]);
    }
  }
}

template <bool I4>
__global__ void __launch_bounds__(kThreads) qmm_lane_kernel(Params p) {
  __shared__ Smem sm;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  if (p.rows_used != nullptr && m0 >= *p.rows_used) {  // a tile of padding rows only
    for (int e = threadIdx.x; e < kBM * kBN / 4; e += kThreads) {
      const int row = m0 + e / (kBN / 4);
      if (row < p.M)
        reinterpret_cast<float4*>(p.out + static_cast<size_t>(row) * p.N + n0)[e % (kBN / 4)] =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  const size_t expert = p.tile_expert != nullptr ? p.tile_expert[blockIdx.y] : 0;
  const size_t wrow0 = expert * p.N + n0;
  float acc[4][4];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;

  const int stages = I4 ? (p.K / 2) / (kSK / 2) : p.K / kSK;
  Stage r;
  load_stage<I4>(p, m0, wrow0, 0, r);
  for (int st = 0; st < stages; ++st) {
    __syncthreads();  // the last stage's fragments are read
    store_stage<I4>(p, r, sm);
    __syncthreads();
    if (st + 1 < stages) load_stage<I4>(p, m0, wrow0, st + 1, r);
    mma_stage(sm, acc);
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows gid and gid + 8 of the fragment
      const int row = m0 + wm * 16 + gid + h * 8;
      if (row < p.M)
        *reinterpret_cast<float2*>(p.out + static_cast<size_t>(row) * p.N + n0 + wn * 32 +
                                   ni * 8 + tig * 2) = make_float2(acc[ni][2 * h],
                                                                   acc[ni][2 * h + 1]);
    }
}

}  // namespace

// y [M, N] f32 = x [M, K] bf16 @ W^T for a lane-major weight: i4 = 1 for i4p
// (zero point `zero`), 0 for i8.  tile_expert (int32 [ceil(M/32)]) selects,
// per 32-row tile, the rows [e·N, e·N + N) of the stacked payload; null
// takes rows [0, N).  rows_used (one int32 on the device, or null): tiles at
// or past it are written as zeros.  N a multiple of 128; K a multiple of 256
// (i4p) or 128 (i8); G a multiple of 16 dividing K (K/2 for i4p).  Returns
// the CUDA error of the launch (0 on success).
extern "C" int bt_qmm_lane(const void* x, const void* q, const void* s, void* out,
                           const void* tile_expert, const void* rows_used, int M, int K, int N,
                           int G, int zero, int i4, void* stream) {
  Params p{static_cast<const uint16_t*>(x), static_cast<const uint8_t*>(q),
           static_cast<const uint16_t*>(s), static_cast<float*>(out),
           static_cast<const int*>(tile_expert), static_cast<const int*>(rows_used),
           M, K, N, G, zero};
  const dim3 grid(N / kBN, (M + kBM - 1) / kBM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (i4) qmm_lane_kernel<true><<<grid, kThreads, 0, st>>>(p);
  else qmm_lane_kernel<false><<<grid, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
