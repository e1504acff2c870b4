// 8-bit K-major quantized matmul (i8t, Q8_0), and the fused gate+up.
//
// Replaces the Pallas kernels of booster_tpu/ops/pallas_qmm.py:
//   _tqmm_i8_gd_kernel (M = 1, group-dot form)       -> gd_kernel
//   _tqmm_i8_kernel    (M > 1, dequantize then dot)  -> dq_kernel (i8t_tile.cuh)
//   _gateup_i8_kernel  (M > 1, fused gate+up)        -> gateup_kernel (i8t_tile.cuh)
//
// y[m, n] = sum_k x[m, k] · W[k, n], W[k, n] = q[k, n] · s[k / 32, n].
// Payload q [K, N] int8 (K-major: a row of K holds every output column);
// scale plane s [K/32, N] bf16 (compact_scales; Q8_0 has no zero point and
// no mins).
//
// Numerics (the plain versions in ops/qmm.py repeat them):
//   M = 1:  per group g of 32 rows, p = sum bf16(x)·q in f32 (exact
//           products), y = sum over groups of f32(bf16 s)·p.
//   M > 1:  w = bf16(f32(q)·f32(bf16 s)); y = bf16(x) @ w with f32
//           accumulation (tensor cores; see i8t_tile.cuh).
//   gate-up: g, u = bf16 of the dq sums of columns n and ff + n of the fused
//           [K, 2ff] payload; out = bf16(bf16(g·bf16(sigmoid_f32(g)))·u), so
//           it equals the dq matmul + silu·mul bit for bit.
//
// What bounds it on the H100.  M = 1: the payload and scale bytes (1 + 1/16
// byte per weight) over 3.35 TB/s; the matvec does two FLOPs per byte.  The
// gd kernel gives each lane 4 consecutive columns (one 32-bit load per
// payload row, so a warp reads 128 consecutive bytes of a row), one warp per
// group of 32 rows with all 32 loads issued before the first is used, 8
// warps (8 groups) per block over 128 columns, and K split across blocks
// (gridDim.y): qkv 4096 -> 6144 runs 48 x 16 blocks.  The warps reduce in
// warp order through shared memory; the blocks of a column tile write f32
// partials and the last one (an atomic ticket) adds them in split order.
// M = 64 (the batch decode): still the weight bytes (2.25 ms a step at 7B
// against 0.93 TFLOP, 0.94 ms at the bf16 tensor-core rate); M = 2048 (the
// batch prefill): the operations.  Both take the tensor-core tile of
// i8t_tile.cuh; wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "i8t_tile.cuh"

namespace {

constexpr int kWarps = 8;     // groups per gd block (one per warp)
constexpr int kGdCols = 128;  // columns per gd block (4 per lane)

struct GdParams {
  const uint16_t* x;  // [1, K] bf16
  const int8_t* q;    // [K, N]
  const uint16_t* s;  // [K / 32, N] bf16
  float* out;         // [1, N] f32
  float* part;        // [KS, N] f32 partials (KS > 1), else null
  int* tickets;       // [N / 128] zeros, reset by the last block
  int K, N;
};

__global__ void __launch_bounds__(kWarps * 32) gd_kernel(GdParams p) {
  constexpr int G = i8t::kGroup;
  __shared__ float xs[kWarps * G];
  __shared__ float red[kWarps][kGdCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ks = blockIdx.y, KS = gridDim.y;
  const int n0 = blockIdx.x * kGdCols;
  const int k0 = ks * kWarps * G;
  for (int i = threadIdx.x; i < kWarps * G; i += blockDim.x)
    xs[i] = k0 + i < p.K ? bf16f(__ldg(p.x + k0 + i)) : 0.f;
  __syncthreads();

  const int g = ks * kWarps + warp;  // this warp's group
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
    c[0] = __fmul_rn(bf16f(sv.x & 0xffffu), acc[0]);
    c[1] = __fmul_rn(bf16f(sv.x >> 16), acc[1]);
    c[2] = __fmul_rn(bf16f(sv.y & 0xffffu), acc[2]);
    c[3] = __fmul_rn(bf16f(sv.y >> 16), acc[3]);
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
  if (KS > 1) {
    if (i < kGdCols) p.part[static_cast<size_t>(ks) * p.N + n0 + i] = t;
    if (!i8t::arrive_last(p.tickets + blockIdx.x, KS)) return;
    if (i < kGdCols) t = i8t::sum_splits(p.part + n0 + i, p.N, KS);
  }
  if (i < kGdCols) p.out[n0 + i] = t;
}

struct DqParams {
  i8t::Operand op;
  void* out;     // f32 [M, N], or bf16 [M, N/2] for the gate-up
  float* part;   // [KS, M, N] f32 partials (the gate-up always; the matmul when KS > 1)
  int* tickets;  // zeros, reset by the last blocks
  int K, N, KS;
};

__global__ void __launch_bounds__(i8t::kThreads) dq_kernel(DqParams p) {
  __shared__ i8t::Smem sm;
  i8t::dq_item<false>(p.op, p.N, p.K, p.KS, blockIdx.x, blockIdx.y, blockIdx.z, p.out, p.part,
                      p.tickets, sm);
}

__global__ void __launch_bounds__(i8t::kThreads) gateup_kernel(DqParams p) {
  __shared__ i8t::Smem sm;
  i8t::gateup_item(p.op, p.N / 2, p.K, p.KS, blockIdx.x, blockIdx.y, blockIdx.z, p.part,
                   static_cast<uint16_t*>(p.out), p.tickets, sm);
}

}  // namespace

// The number of K splits of the M = 1 kernel (its partial buffer holds
// KS·N floats, its tickets N/128 ints).
extern "C" int bt_qmm_i8t_gd_splits(int K) {
  return (K / i8t::kGroup + kWarps - 1) / kWarps;
}

// y [1, N] f32 = x [1, K] @ W for an i8t weight with group 32, N a multiple
// of 128, K of 64.  Returns the CUDA error of the launch (0 on success).
extern "C" int bt_qmm_i8t_gd(const void* x, const void* q, const void* s, void* out, void* part,
                             void* tickets, int K, int N, void* stream) {
  GdParams p{static_cast<const uint16_t*>(x), static_cast<const int8_t*>(q),
             static_cast<const uint16_t*>(s), static_cast<float*>(out), static_cast<float*>(part),
             static_cast<int*>(tickets), K, N};
  const dim3 grid(N / kGdCols, bt_qmm_i8t_gd_splits(K));
  gd_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// y = x [M, K] @ W [K, N] split KS ways over K.  gateup = 0: out f32 [M, N].
// gateup = 1: W holds gate columns [0, N/2) and up columns [N/2, N); out
// bf16 [M, N/2] = silu(gate) · up.  part: KS·M·N floats (null when KS = 1
// and gateup = 0); tickets: ceil(M/64)·N/128 zeros.  K a multiple of 64, N
// of 128 (256 for the gate-up).
extern "C" int bt_qmm_i8t_dq(const void* x, const void* q, const void* s, void* out, void* part,
                             void* tickets, int M, int K, int N, int KS, int gateup, void* stream) {
  DqParams p{{static_cast<const uint16_t*>(x), static_cast<const int8_t*>(q),
              static_cast<const uint16_t*>(s), K, N, M},
             out, static_cast<float*>(part), static_cast<int*>(tickets), K, N, KS};
  const dim3 grid(N / i8t::kBN, KS, (M + i8t::kBM - 1) / i8t::kBM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gateup) gateup_kernel<<<grid, i8t::kThreads, 0, st>>>(p);
  else dq_kernel<<<grid, i8t::kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
