// The M = 1 int8 K-major matvec: qmm_i8c.cu's mv_kernel (i8c, a channel
// scale after the sum), qmm_i8t.cu's gd_kernel (i8t, the group-dot form at
// G = 16 or 32, with an optional mins plane) and its fused gate-up
// gateup_gd_kernel.
//
// y[n] = sum_k x[k] · W[k, n] from an int8 payload q [K, N] (K-major: a row
// of K holds every output column).
//   i8c (G = 0): y = (the f32 sum of the exact products bf16(x)·q) · s[n],
//     the scale once at the end.
//   i8t: per group g of G rows, p = the f32 sum of the G exact products
//     bf16(x)·q in row order, c = f32(bf16 s)·p (less f32(bf16 m)·xs with
//     mins, xs the f32 sum of the group's bf16(x)), y = the f32 sum of the
//     c in a fixed order.
//
// What bounds it on the H100: the payload (and scale) bytes over 3.35 TB/s;
// two operations a byte.  A middle-sized row (5-25 MB) sits a few µs above
// that bound; how much of the gap a plain read of the same bytes would show
// is not measured.  What the design does about it:
//   - A lane owns 4 consecutive columns (one 32-bit load a row: a warp
//     reads 128 bytes of a row), a warp a chunk of R rows of K (a group G,
//     or 32 rows for i8c) at a time, a block of 8 warps a 128-column tile
//     over one K split, its chunks dealt to the warps in turn.  Each warp
//     keeps the next chunk's R loads (with its x, 16 bytes a lane per 8
//     rows, and the group's 4 scales) in flight in a register ring of two
//     while it uses the current one: many small warps keep most of a row's
//     bytes requested from the start, and nothing waits on shared memory or
//     a barrier before the stream.
//   - An int8 byte becomes its f32 value by one byte permute into the bit
//     pattern of 2^23 + 128 + q and one exact subtraction (I2F runs at a
//     quarter of the FMA rate, about what the stream needs).
//   - Sum order: i8c, a warp's chunks in turn as one chain of FMAs; i8t, a
//     group's rows in order, then a warp's groups' c in turn; then the
//     block's 8 warps in order; then the K splits in order.  A tile's KS
//     splits (at most 8) run as one thread-block cluster: each block stores
//     its tile sums into the shared memory of the block that writes those
//     columns (block s: columns c with c·KS/128 = s), a cluster barrier,
//     and that block adds them in split order.  A block touches another's
//     shared memory only once every block of the cluster has started: each
//     arrives on a cluster barrier as it starts and waits on it after its
//     stream, just before the stores (by then the wait is met).  No partials
//     in device memory, no ticket, no workspace: every launch repeats the
//     last bit for bit.
//   - The fused gate-up's block is two such halves (gate tile j and up tile
//     ff/128 + j, the same split); its cluster writes silu(g)·u.  Each half
//     runs the code of a gd block, so the gate-up equals gd_kernel on its
//     fused weight + silu·mul bit for bit.
// ops/qmm.py mv_plan gives KS from (K, N, G) alone: the gd matvec and the
// gate-up on one fused weight take one plan.  i4mv.cuh (the 4-bit matvec)
// shares the block's end (Sums, finish) and its cluster launch (launch).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_ops.cuh"

namespace i8mv {

constexpr int kBN = 128;        // columns of a tile: 32 lanes of 4
constexpr int kWarps = 8;       // warps of a block (of each half of the gate-up's)
constexpr int kRing = 2;        // chunks of a warp's register ring
constexpr int kI8cRows = 32;    // rows of K of an i8c chunk
constexpr int kMaxSplits = 8;   // a tile's splits form one cluster (its portable size)

// f32 y; f32 y · s[n] (i8c); bf16 silu(g)·u; bf16 gelu(g)·u (i4mv.cuh only)
enum Out { kF32, kScaled, kGateUp, kGateUpGelu };

__host__ __device__ constexpr bool gate_up(Out o) { return o == kGateUp || o == kGateUpGelu; }

struct Op {
  const uint16_t* x;  // [K] bf16, on 16 bytes
  const int8_t* q;    // [K, N]
  const uint16_t* s;  // i8t: [R, K/G, N] bf16, scales then mins; i8c: unused
  const float* cs;    // i8c: [N] f32 channel scales; else unused
  void* out;          // f32 [N], or bf16 [N/2] for the gate-up
  int K, N, KS;
};

__device__ __forceinline__ uint32_t ld_stream(const void* p) {  // read once: not kept in L1
  uint32_t v;
  asm volatile("ld.global.nc.L1::no_allocate.u32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ uint4 ld128(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ uint2 ld64(const void* p) {
  uint2 v;
  asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Element j of 4 bf16 in v, as f32 (exact).
__device__ __forceinline__ float bf16_of(const uint2& v, int j) {
  const uint32_t w = j < 2 ? v.x : v.y;
  return (j & 1) ? bf16_hi(w) : bf16_lo(w);
}

// Byte j of u = w ^ 0x80808080 (w four int8) as the f32 value of w's byte j:
// 0x4B0000bb is 2^23 + bb, bb = q + 128; less 2^23 + 128, exactly q.
__device__ __forceinline__ float q8(uint32_t u, int j) {
  return __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u | j)), 8388736.f);
}

// One chunk of R rows of a lane's 4 columns: the payload words, x at those
// rows, and (i8t) the group's scales (and mins) of the 4 columns.
template <int R, bool SC, bool MINS>
struct Chunk {
  uint32_t w[R];
  uint4 x[R / 8];
  uint2 s, m;
};

template <int R, bool SC, bool MINS>
__device__ __forceinline__ void load(Chunk<R, SC, MINS>& c, const Op& op, int col, int k) {
  const int8_t* w = op.q + static_cast<size_t>(k) * op.N + col;
#pragma unroll
  for (int r = 0; r < R; ++r) c.w[r] = ld_stream(w + static_cast<size_t>(r) * op.N);
#pragma unroll
  for (int i = 0; i < R / 8; ++i) c.x[i] = ld128(op.x + k + 8 * i);
  if constexpr (SC) {
    const uint16_t* s = op.s + static_cast<size_t>(k / R) * op.N + col;
    c.s = ld64(s);
    if constexpr (MINS) c.m = ld64(s + static_cast<size_t>(op.K / R) * op.N);
  }
}

// Row r of the chunk's x (8 bf16 a uint4) as f32 (exact).
template <int R>
__device__ __forceinline__ float x_row(const uint4 (&x)[R / 8], int r) {
  const uint4 v = x[r >> 3];
  const int e = (r & 7) >> 1;
  const uint32_t w = e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
  return (r & 1) ? bf16_hi(w) : bf16_lo(w);
}

// The chunk into the lane's sums: p[j] += bf16(x)·q in row order; i8t adds
// the group's c = s·p (- m·xs) to acc and restarts p.
template <int R, bool SC, bool MINS>
__device__ __forceinline__ void use(const Chunk<R, SC, MINS>& c, float (&p)[4], float (&acc)[4]) {
  float xs = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float xr = x_row<R>(c.x, r);
    const uint32_t u = c.w[r] ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = __fmaf_rn(xr, q8(u, j), p[j]);
    if constexpr (MINS) xs = __fadd_rn(xs, xr);
  }
  if constexpr (SC) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = __fmul_rn(bf16_of(c.s, j), p[j]);
      if constexpr (MINS) v = __fsub_rn(v, __fmul_rn(bf16_of(c.m, j), xs));
      acc[j] = __fadd_rn(acc[j], v);
      p[j] = 0.f;
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The two halves of a cluster barrier that only says every block has started
// (no memory order): arrive as the block starts, wait before the first access
// to another block's shared memory.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// v into the f32 at this block's shared address a, in cluster block `rank`.
__device__ __forceinline__ void st_rank(uint32_t a, int rank, float v) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" :: "r"(r), "f"(v) : "memory");
}

// K chunks [c0, c1) of split s of KS over nc chunks (spread evenly).
__device__ __forceinline__ void split_chunks(int nc, int KS, int s, int& c0, int& c1) {
  c0 = static_cast<int>(static_cast<long long>(s) * nc / KS);
  c1 = static_cast<int>(static_cast<long long>(s + 1) * nc / KS);
}

// The shared memory of a block's sums: each warp's 4-column sums (per half
// of a gate-up block), the block's tile sums, and the tile sums of every
// split of the cluster (in the block that writes the column).
template <int H>
struct Sums {
  float red[H][kWarps][kBN];
  float tile[H][kBN];
  float slots[H][kMaxSplits][kBN];
};

// The end of a block (j, s) of a launch over (tiles, KS splits): the lane's
// sums v of 4 columns col .. col + 3 of the tile, of warp w of half `half`,
// added over the block's warps in order, then (KS > 1) over the cluster's splits in split order, in the
// block that writes those columns (block s: columns c with c·KS/128 = s),
// which stores out[j·128 + c] (f32 y; y · cs[n]; bf16 silu(g)·u).  A block
// touches another's shared memory only after the wait on the relaxed
// cluster barrier that every block arrived on as it started.
template <int H, Out OUT>
__device__ __forceinline__ void finish(Sums<H>& sm, const float (&v)[4], int col, int half, int w,
                                       int j, int s, int KS, void* out, const float* cs) {
#pragma unroll
  for (int i = 0; i < 4; ++i) sm.red[half][w][col + i] = v[i];
  __syncthreads();
  for (int e = threadIdx.x; e < H * kBN; e += blockDim.x) {  // the block's sum in warp order
    const int h = e / kBN, cc = e % kBN;
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) t = __fadd_rn(t, sm.red[h][i][cc]);
    sm.tile[h][cc] = t;
  }
  __syncthreads();
  if (KS > 1) {  // each split's sums into slot s of the block that writes the column
    cluster_wait();  // every block of the cluster has started
    for (int e = threadIdx.x; e < H * kBN; e += blockDim.x) {
      const int h = e / kBN, cc = e % kBN;
      st_rank(smem_addr(&sm.slots[h][s][cc]), cc * KS / kBN, sm.tile[h][cc]);
    }
    cluster_sync();
  }
  for (int cc = threadIdx.x; cc < kBN; cc += blockDim.x) {
    if (cc * KS / kBN != s) continue;  // another block of the cluster writes it
    float g = sm.tile[0][cc], u = sm.tile[H - 1][cc];
    if (KS > 1) {  // the splits in order, from zero
      g = u = 0.f;
      for (int r = 0; r < KS; ++r) {
        g = __fadd_rn(g, sm.slots[0][r][cc]);
        if constexpr (H == 2) u = __fadd_rn(u, sm.slots[1][r][cc]);
      }
    }
    const int n = j * kBN + cc;
    if constexpr (OUT == kGateUp)
      static_cast<uint16_t*>(out)[n] = silu_mul(g, u);
    else if constexpr (OUT == kGateUpGelu)
      static_cast<uint16_t*>(out)[n] = gelu_mul(g, u);
    else if constexpr (OUT == kScaled)
      static_cast<float*>(out)[n] = __fmul_rn(g, __ldg(cs + n));
    else
      static_cast<float*>(out)[n] = g;
  }
}

// Block (j, s) of a launch over (N / 128 tiles (gate-up: ff / 128 pairs),
// KS splits): H halves of 8 warps, half h on tile j + h·ff/128, warp w on
// chunks c0 + w, c0 + w + 8, ... of split s.
template <int G, bool MINS, Out OUT>
__global__ void __launch_bounds__(32 * kWarps * (gate_up(OUT) ? 2 : 1)) mv_kernel(Op op) {
  constexpr int H = gate_up(OUT) ? 2 : 1;
  constexpr int R = G > 0 ? G : kI8cRows;
  __shared__ Sums<H> sm;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int half = wid / kWarps, w = wid % kWarps;
  const int j = blockIdx.x, s = blockIdx.y, KS = op.KS;
  if (KS > 1) cluster_arrive_relaxed();  // this block has started
  const int col = j * kBN + (gate_up(OUT) ? half * (op.N / 2) : 0) + lane * 4;
  int c0, c1;
  split_chunks(op.K / R, KS, s, c0, c1);
  float p[4] = {0.f, 0.f, 0.f, 0.f}, acc[4] = {0.f, 0.f, 0.f, 0.f};
  Chunk<R, (G > 0), MINS> ring[kRing];
  int c = c0 + w;
#pragma unroll
  for (int i = 0; i < kRing - 1; ++i)
    if (c + i * kWarps < c1) load(ring[i], op, col, (c + i * kWarps) * R);
  for (; c < c1; c += kRing * kWarps) {
#pragma unroll
    for (int i = 0; i < kRing; ++i) {
      const int ci = c + i * kWarps;
      if (ci < c1) {
        const int cn = ci + (kRing - 1) * kWarps;
        if (cn < c1) load(ring[(i + kRing - 1) % kRing], op, col, cn * R);
        use(ring[i], p, acc);
      }
    }
  }
  if constexpr (G > 0) finish<H, OUT>(sm, acc, lane * 4, half, w, j, s, KS, op.out, op.cs);
  else finish<H, OUT>(sm, p, lane * 4, half, w, j, s, KS, op.out, op.cs);
}

// Launches `kern` over (N / H / 128 tiles, KS splits) with H·8 warps a
// block and `smem` bytes of dynamic shared memory, a tile's KS splits (1-8)
// as one cluster.
template <int H, class OpT>
cudaError_t launch(void (*kern)(OpT), const OpT& op, int N, int KS, cudaStream_t st,
                   int smem = 0) {
  if (KS < 1 || KS > kMaxSplits || N % (H * kBN) != 0 || N < H * kBN)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / H / kBN, KS, 1);
  cfg.blockDim = dim3(32 * kWarps * H);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = KS;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = KS > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kern, op);
}

// Launches mv_kernel over (tiles, KS): ops/qmm.py mv_plan's KS (1-8), a
// tile's splits as one cluster.
template <int G, bool MINS, Out OUT>
cudaError_t run(const Op& op, cudaStream_t st) {
  return launch<gate_up(OUT) ? 2 : 1>(mv_kernel<G, MINS, OUT>, op, op.N, op.KS, st);
}

}  // namespace i8mv
