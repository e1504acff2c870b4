// 8-bit K-major quantized matmul (i8t: Q8_0 at group 32, Q6_K at group 16),
// and the fused gate+up.
//
// Replaces the Pallas kernels of booster_tpu/ops/pallas_qmm.py:
//   _tqmm_i8_gd_kernel   (M = 1, group-dot form)       -> gd_kernel
//   _tqmm_i8_kernel      (M > 1, dequantize then dot)  -> dq_kernel<BM, G, false> (i8k_tile.cuh)
//   _gateup_i8_kernel    (M > 1, fused gate+up)        -> dq_kernel<BM, G, true> (i8k_tile.cuh)
//   _gateup_i8_gd_kernel (M = 1, fused gate+up; its 2-D pallas_call :1100
//                         and the stacked one :1143, a layer view here)
//                                                      -> gateup_gd_kernel
// Each is instantiated for the group G of 32 (Q8_0) and 16 (Q6_K).
//
// y[m, n] = sum_k x[m, k] · W[k, n], W[k, n] = q[k, n] · s[k / G, n] (less
// m[k / G, n] with mins).  Payload q [K, N] int8 (K-major: a row of K holds
// every output column); scale planes s [R, K/G, N] bf16 (compact_scales),
// R = 1, or 2 with a mins plane (the M = 1 kernels only; Q8_0 and Q6_K have
// none, no model file of the port has them yet).
//
// Numerics (the plain versions in ops/qmm.py repeat them):
//   M = 1:  per group g of G rows, p = sum bf16(x)·q in f32 (exact
//           products), c = f32(bf16 s)·p (- f32(bf16 m)·xs, xs the f32 sum of
//           the group's bf16(x)), y = sum over groups of c.
//   M > 1:  w = bf16(f32(q)·f32(bf16 s)); y = bf16(x) @ w with f32
//           accumulation (wgmma; see i8k_tile.cuh).
//   gate-up: g, u = bf16 of the sums of columns n and ff + n of the fused
//           [K, 2ff] payload (the gd sums at M = 1, the dq sums above);
//           out = bf16(bf16(g·bf16(sigmoid_f32(g)))·u), so it equals the
//           matmul of its form + silu·mul bit for bit.
//
// What bounds it on the H100.  M = 1: the payload and scale bytes (1 + 2/G
// byte per weight) over 3.35 TB/s; the matvec does two FLOPs per byte.  The
// gd kernel gives each lane 4 consecutive columns (one 32-bit load per
// payload row, so a warp reads 128 consecutive bytes of a row), one warp per
// group of G rows with all G loads issued before the first is used, 8
// warps (8 groups) per block over 128 columns, and K split across blocks
// (gridDim.y): qkv 4096 -> 6144 runs 48 x 16 blocks at G = 32.  The warps
// reduce in warp order through shared memory; the blocks of a column tile
// write f32 partials and the last one (an atomic ticket) adds them in split
// order.  The fused M = 1 gate-up is that kernel over the two halves: a block
// runs the gd block sum of its gate column tile and then of the matching up
// tile (the same function, so each sum is the unfused kernel's bit for bit),
// and the last block of the pair's K splits writes silu(g)·u: the byte bound
// of the [K, 2ff] payload, one launch and no f32 round trip of g and u.
// M = 64 (the batch decode): still the weight bytes (2.25 ms a step at 7B
// against 0.93 TFLOP, 0.94 ms at the bf16 tensor-core rate); M = 2048 (the
// batch prefill): the operations.  Both run the wgmma tile of i8k_tile.cuh
// (dq_kernel: the plan's rows a block, a tile's K splits one cluster that
// adds them in shared memory); PERF.md §6 has its times against its bounds.

#include <cuda_runtime.h>
#include <stdint.h>

#include "i8k_tile.cuh"

namespace {

constexpr int kWarps = 8;     // groups per gd block (one per warp)
constexpr int kGdCols = 128;  // columns per gd block (4 per lane)

struct GdParams {
  const uint16_t* x;  // [1, K] bf16
  const int8_t* q;    // [K, N]
  const uint16_t* s;  // [R, K / G, N] bf16: scales, then mins when R = 2
  void* out;          // [1, N] f32 (gd), or [1, N / 2] bf16 (gate-up)
  float* part;        // [KS, N] f32 partials (KS > 1), else null
  int* tickets;       // [N / 128] (gate-up: [N / 256]) zeros, reset by the last block
  int K, N;
};

// The gd sum of this block's K split (blockIdx.y) over columns n0 + i, i <
// 128, returned in thread i: each warp's group contribution, added in warp
// order.  xs holds the split's bf16 x rows as f32; red is free on entry.
template <int G, bool kMins>
__device__ __forceinline__ float gd_block(const GdParams& p, int n0, const float* xs,
                                          float (*red)[kGdCols]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = blockIdx.y * kWarps + warp;  // this warp's group
  const int col = n0 + lane * 4;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  if (g * G < p.K) {
    uint32_t b[G];
    const int8_t* w = p.q + static_cast<size_t>(g) * G * p.N + col;
#pragma unroll
    for (int r = 0; r < G; ++r) b[r] = __ldg(reinterpret_cast<const uint32_t*>(w + static_cast<size_t>(r) * p.N));
    const uint2 sv = __ldg(reinterpret_cast<const uint2*>(p.s + static_cast<size_t>(g) * p.N + col));
    const float* x = xs + warp * G;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < G; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[j] = __fmaf_rn(x[r], static_cast<float>(static_cast<int8_t>((b[r] >> (8 * j)) & 0xffu)),
                           acc[j]);
    }
    const uint32_t sw[4] = {sv.x & 0xffffu, sv.x >> 16, sv.y & 0xffffu, sv.y >> 16};
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = __fmul_rn(bf16f(sw[j]), acc[j]);
    if constexpr (kMins) {
      const size_t plane = static_cast<size_t>(p.K / G) * p.N;
      const uint2 mv = __ldg(reinterpret_cast<const uint2*>(p.s + plane + static_cast<size_t>(g) * p.N + col));
      const uint32_t mw[4] = {mv.x & 0xffffu, mv.x >> 16, mv.y & 0xffffu, mv.y >> 16};
      float xsum = 0.f;
#pragma unroll
      for (int r = 0; r < G; ++r) xsum = __fadd_rn(xsum, x[r]);
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = __fsub_rn(c[j], __fmul_rn(bf16f(mw[j]), xsum));
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) red[warp][lane * 4 + j] = c[j];
  __syncthreads();

  // block sums in warp order: thread i < 128 takes column n0 + i
  const int i = threadIdx.x;
  float t = 0.f;
  if (i < kGdCols) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t = __fadd_rn(t, red[w][i]);
  }
  __syncthreads();  // red is free again
  return t;
}

// The split's rows of x [1, K] as f32, zero past K.
template <int G>
__device__ __forceinline__ void load_x(const GdParams& p, float* xs) {
  const int k0 = blockIdx.y * kWarps * G;
  for (int i = threadIdx.x; i < kWarps * G; i += blockDim.x)
    xs[i] = k0 + i < p.K ? bf16f(__ldg(p.x + k0 + i)) : 0.f;
  __syncthreads();
}

template <int G, bool kMins>
__global__ void __launch_bounds__(kWarps * 32) gd_kernel(GdParams p) {
  __shared__ float xs[kWarps * G];
  __shared__ float red[kWarps][kGdCols];
  load_x<G>(p, xs);
  const int n0 = blockIdx.x * kGdCols, i = threadIdx.x, KS = gridDim.y;
  float t = gd_block<G, kMins>(p, n0, xs, red);
  float* out = static_cast<float*>(p.out);
  if (KS > 1) {
    if (i < kGdCols) p.part[static_cast<size_t>(blockIdx.y) * p.N + n0 + i] = t;
    if (!i8t::arrive_last(p.tickets + blockIdx.x, KS)) return;
    if (i < kGdCols) t = i8t::sum_splits(p.part + n0 + i, p.N, KS);
  }
  if (i < kGdCols) out[n0 + i] = t;
}

// The fused gate-up at M = 1 over the [K, 2ff] payload: block (j, split)
// takes gate columns j·128 + [0, 128) and up columns ff + j·128 + [0, 128).
template <int G, bool kMins>
__global__ void __launch_bounds__(kWarps * 32) gateup_gd_kernel(GdParams p) {
  __shared__ float xs[kWarps * G];
  __shared__ float red[kWarps][kGdCols];
  load_x<G>(p, xs);
  const int ff = p.N / 2, n0 = blockIdx.x * kGdCols, i = threadIdx.x, KS = gridDim.y;
  float g = gd_block<G, kMins>(p, n0, xs, red);
  float u = gd_block<G, kMins>(p, ff + n0, xs, red);
  if (KS > 1) {
    if (i < kGdCols) {
      float* pr = p.part + static_cast<size_t>(blockIdx.y) * p.N + n0 + i;
      pr[0] = g;
      pr[ff] = u;
    }
    if (!i8t::arrive_last(p.tickets + blockIdx.x, KS)) return;
    if (i < kGdCols) {
      g = i8t::sum_splits(p.part + n0 + i, p.N, KS);
      u = i8t::sum_splits(p.part + ff + n0 + i, p.N, KS);
    }
  }
  if (i < kGdCols) static_cast<uint16_t*>(p.out)[n0 + i] = silu_mul(g, u);
}

struct DqParams {
  i8k::Op op;
  void* out;  // f32 [M, N], or bf16 [M, N/2] for the gate-up
  int K, N, KS;
};

// Block (j, split, mt): column tile j (the gate-up: gate columns j·64 + [0,
// 64) with the matching up columns) over one K split, rows mt·BM.
template <int BM, int G, bool GATEUP>
__global__ void __launch_bounds__(i8k::kThreads, i8k::Cfg<BM>::kMinBlocks)
    dq_kernel(DqParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = i8k::align_1k(smem_raw);
  if constexpr (GATEUP)
    i8k::gateup_item<BM, G, true>(p.op, p.N / 2, p.K, p.KS, blockIdx.x, blockIdx.y, blockIdx.z,
                                  nullptr, static_cast<uint16_t*>(p.out), nullptr, sm);
  else
    i8k::dq_item<BM, G, i8k::kF32, true>(p.op, p.N, p.K, p.KS, blockIdx.x, blockIdx.y,
                                         blockIdx.z, p.out, nullptr, nullptr, nullptr, sm);
}

struct LaunchDq {
  const DqParams& p;
  int G, gateup;
  cudaStream_t st;

  template <int BM, int G_, bool GATEUP>
  cudaError_t go() const {
    constexpr int bytes = i8k::Cfg<BM>::kSmem;
    static bool ready = false;
    const cudaError_t e = qring::allow_smem(dq_kernel<BM, G_, GATEUP>, bytes, ready);
    if (e != cudaSuccess) return e;
    return i8k::launch_split(dq_kernel<BM, G_, GATEUP>,
                             dim3(p.N / i8k::kBN, p.KS, (p.op.M + BM - 1) / BM), bytes, st, p);
  }

  template <int BM>
  cudaError_t run() const {
    if (G == 32) return gateup ? go<BM, 32, true>() : go<BM, 32, false>();
    if (G == 16) return gateup ? go<BM, 16, true>() : go<BM, 16, false>();
    return cudaErrorInvalidValue;
  }
};

template <int G, bool kMins>
void launch_gd(const GdParams& p, bool gateup, int KS, cudaStream_t st) {
  if (gateup)
    gateup_gd_kernel<G, kMins><<<dim3(p.N / 2 / kGdCols, KS), kWarps * 32, 0, st>>>(p);
  else
    gd_kernel<G, kMins><<<dim3(p.N / kGdCols, KS), kWarps * 32, 0, st>>>(p);
}

}  // namespace

// The number of K splits of the M = 1 kernels at group G (their partial
// buffer holds KS·N floats, their tickets one int per 128 columns).
extern "C" int bt_qmm_i8t_gd_splits(int K, int G) {
  return (K / G + kWarps - 1) / kWarps;
}

// M = 1.  gateup = 0: y [1, N] f32 = x [1, K] @ W.  gateup = 1: W holds gate
// columns [0, N/2) and up columns [N/2, N); out bf16 [1, N/2] = silu(gate) ·
// up.  Group G of 16 or 32, mins = 1 with a second (mins) scale plane; N a
// multiple of 128 (256 for the gate-up), K of 2G.  Returns the CUDA error of
// the launch (0 on success).
extern "C" int bt_qmm_i8t_gd(const void* x, const void* q, const void* s, void* out, void* part,
                             void* tickets, int K, int N, int G, int mins, int gateup,
                             void* stream) {
  GdParams p{static_cast<const uint16_t*>(x), static_cast<const int8_t*>(q),
             static_cast<const uint16_t*>(s), out, static_cast<float*>(part),
             static_cast<int*>(tickets), K, N};
  const int KS = bt_qmm_i8t_gd_splits(K, G);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G == 32 && !mins) launch_gd<32, false>(p, gateup, KS, st);
  else if (G == 32) launch_gd<32, true>(p, gateup, KS, st);
  else if (G == 16 && !mins) launch_gd<16, false>(p, gateup, KS, st);
  else if (G == 16) launch_gd<16, true>(p, gateup, KS, st);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// y = x [M, K] @ W [K, N] on the tile of i8k_tile.cuh: bm rows of x a
// block, ks splits of K (ops/qmm.py i8k_plan: a power of two up to 8, one
// cluster a tile).  gateup = 0: out f32 [M, N].  gateup = 1: W holds gate
// columns [0, N/2) and up columns [N/2, N); out bf16 [M, N/2] = silu(gate)
// · up.  K a multiple of 64, N of 128 (256 for the gate-up), G 16 or 32; x,
// payload and scales on 16 bytes.  Returns the CUDA error of the launch.
extern "C" int bt_qmm_i8t_dq(const void* x, const void* q, const void* s, void* out, int M, int K,
                             int N, int KS, int gateup, int G, int bm, void* stream) {
  DqParams p{{static_cast<const uint16_t*>(x), static_cast<const int8_t*>(q),
              static_cast<const uint16_t*>(s), K, N, M},
             out, K, N, KS};
  return static_cast<int>(
      i8k::dispatch(bm, LaunchDq{p, G, gateup, static_cast<cudaStream_t>(stream)}));
}
