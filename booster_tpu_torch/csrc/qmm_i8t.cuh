// 8-bit K-major quantized matmul (i8t: Q8_0 at group 32, Q6_K at group 16,
// Q5_K and Q5_1 at group 32 with a mins plane), and the fused gate+up with
// the SiLU or the tanh-GELU epilogue (the reference's act "silu", "gelu"):
// one library an epilogue, qmm_i8t.cu (the matmuls and the SiLU gate-ups)
// and qmm_i8t_gelu.cu (the GELU gate-ups), as the whole MLP's are.
//
// Replaces the Pallas kernels of booster_tpu/ops/pallas_qmm.py:
//   _tqmm_i8_gd_kernel   (M = 1, group-dot form)       -> gd_kernel (i8mv.cuh)
//   _tqmm_i8_kernel      (M > 1, dequantize then dot)  -> dq_kernel<BM, G, false, MINS>
//   _gateup_i8_kernel    (M > 1, fused gate+up)        -> dq_kernel<BM, G, true, MINS, ACT>
//                        (both on i8k_tile.cuh; has_mins -> MINS, group 32 only)
//   _gateup_i8_gd_kernel (M = 1, fused gate+up; its 2-D pallas_call :1100
//                         and the stacked one :1143, a layer view here)
//                                                      -> i8mv::mv_kernel<G, MINS, kGateUp
//                                                         or kGateUpGelu> (i8mv.cuh)
// Each is instantiated for the group G of 32 (Q8_0) and 16 (Q6_K), each
// gate-up for both epilogues (bf16_ops.cuh kActSilu, kActGelu).
//
// y[m, n] = sum_k x[m, k] · W[k, n], W[k, n] = q[k, n] · s[k / G, n] (less
// m[k / G, n] with mins).  Payload q [K, N] int8 (K-major: a row of K holds
// every output column); scale planes s [R, K/G, N] bf16 (compact_scales),
// R = 1, or 2 with a mins plane (Q5_K, Q5_1: every form at group 32; the
// M = 1 forms at group 16 too, which no format gives).
//
// Numerics (the plain versions in ops/qmm.py repeat them):
//   M = 1:  per group g of G rows, p = sum bf16(x)·q in f32 (exact
//           products), c = f32(bf16 s)·p (- f32(bf16 m)·xs, xs the f32 sum of
//           the group's bf16(x)), y = sum over groups of c.
//   M > 1:  w = bf16(f32(q)·f32(bf16 s)); y = bf16(x) @ w with f32
//           accumulation (wgmma; see i8k_tile.cuh), with mins less
//           sum_g xs_g·f32(bf16 m_g) (f32 group sums of bf16(x), as three
//           exact bf16 parts against -m on wgmma, four stages a batch).
//   gate-up: g, u = bf16 of the sums of columns n and ff + n of the fused
//           [K, 2ff] payload (the gd sums at M = 1, the dq sums above);
//           out = bf16(bf16(g·bf16(sigmoid_f32(g)))·u) (SiLU), or
//           bf16(bf16(g·0.5·(1 + tanh z))·u) with z = c·(g + 0.044715·g³)
//           op by op in f32 (GELU, bf16_ops.cuh gelu_mul), so it equals the
//           matmul of its form + act·mul bit for bit.
//
// What bounds it on the H100.  M = 1: the payload and scale bytes (1 + 2/G
// byte per weight) over 3.35 TB/s; the matvec does two FLOPs per byte.  The
// gd kernel is i8mv.cuh's streaming block: a lane streams 4 columns of a
// warp's groups (the group's 4 scales with its rows) through a register
// ring of two, 8 warps a 128-column tile over one K split, a tile's KS
// splits one cluster that adds them in split order through distributed
// shared memory (ops/qmm.py mv_plan gives KS).  The fused M = 1 gate-up is
// the same block twice over (gate tile j and up tile ff/128 + j, the plan of
// the fused [K, 2ff] weight), its cluster writing act(g)·u: the byte bound
// of the [K, 2ff] payload, one launch and no f32 round trip of g and u, and
// each sum the unfused kernel's bit for bit.
// M = 64 (the batch decode): still the weight bytes (2.25 ms a step at 7B
// against 0.93 TFLOP, 0.94 ms at the bf16 tensor-core rate); M = 2048 (the
// batch prefill): the operations.  Both run the wgmma tile of i8k_tile.cuh
// (dq_kernel: the plan's rows a block, a tile's K splits one cluster that
// adds them in shared memory); PERF.md §6 has its times against its bounds.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "i8k_tile.cuh"
#include "i8mv.cuh"

namespace {

struct DqParams {
  i8k::Op op;
  void* out;  // f32 [M, N], or bf16 [M, N/2] for the gate-up
  int K, N, KS;
};

// Block (j, split, mt): column tile j (the gate-up: gate columns j·64 + [0,
// 64) with the matching up columns, its epilogue ACT) over one K split,
// rows mt·BM.
template <int BM, int G, bool GATEUP, bool MINS, int ACT>
__global__ void __launch_bounds__(i8k::kThreads, i8k::Cfg<BM>::kMinBlocks)
    dq_kernel(DqParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = i8k::align_1k(smem_raw);
  if constexpr (GATEUP)
    i8k::gateup_item<BM, G, true, MINS, ACT>(p.op, p.N / 2, p.K, p.KS, blockIdx.x, blockIdx.y,
                                             blockIdx.z, nullptr, static_cast<uint16_t*>(p.out),
                                             nullptr, sm);
  else
    i8k::dq_item<BM, G, i8k::kF32, true, MINS>(p.op, p.N, p.K, p.KS, blockIdx.x, blockIdx.y,
                                               blockIdx.z, p.out, nullptr, nullptr, nullptr, sm);
}

// The M > 1 launch of the library whose gate-up epilogue is ACT.
template <int ACT>
struct LaunchDq {
  const DqParams& p;
  int G, gateup, mins, act;
  cudaStream_t st;

  template <int BM, int G_, bool GATEUP, bool MINS>
  cudaError_t go() const {
    constexpr int bytes = i8k::Cfg<BM, MINS>::kSmem;
    static bool ready = false;
    const cudaError_t e = qring::allow_smem(dq_kernel<BM, G_, GATEUP, MINS, ACT>, bytes, ready);
    if (e != cudaSuccess) return e;
    return i8k::launch_split(dq_kernel<BM, G_, GATEUP, MINS, ACT>,
                             dim3(p.N / i8k::kBN, p.KS, (p.op.M + BM - 1) / BM), bytes, st, p);
  }

  // the matmul (the SiLU library's; act unused) or the gate-up with ACT
  template <int BM, int G_, bool MINS>
  cudaError_t form() const {
    if (gateup) return act == ACT ? go<BM, G_, true, MINS>() : cudaErrorInvalidValue;
    if constexpr (ACT == kActSilu)
      return act == kActSilu ? go<BM, G_, false, MINS>() : cudaErrorInvalidValue;
    return cudaErrorInvalidValue;
  }

  template <int BM>
  cudaError_t run() const {
    if (G == 32) return mins ? form<BM, 32, true>() : form<BM, 32, false>();
    if (G == 16 && !mins) return form<BM, 16, false>();
    return cudaErrorInvalidValue;
  }
};

// The M = 1 matvec (gateup = 0; the SiLU library's) or fused gate-up of
// i8mv.cuh with the library's epilogue ACT; another act is refused.
template <int G, bool MINS, int ACT>
cudaError_t gd(const i8mv::Op& op, int gateup, int act, cudaStream_t st) {
  if (!gateup) {
    if constexpr (ACT == kActSilu)
      return act == kActSilu ? i8mv::run<G, MINS, i8mv::kF32>(op, st) : cudaErrorInvalidValue;
    return cudaErrorInvalidValue;
  }
  if (act != ACT) return cudaErrorInvalidValue;
  return i8mv::run<G, MINS, ACT == kActGelu ? i8mv::kGateUpGelu : i8mv::kGateUp>(op, st);
}

// M = 1.  gateup = 0: y [1, N] f32 = x [1, K] @ W.  gateup = 1: W holds gate
// columns [0, N/2) and up columns [N/2, N); out bf16 [1, N/2] = act(gate) ·
// up, act 0 SiLU or 1 GELU (bf16_ops.cuh kActSilu, kActGelu; 0 for the
// matmul).  Group G of 16 or 32, mins = 1 with a second (mins) scale
// plane; N a multiple of 128 (256 for the gate-up), K of 2G; ks splits of K
// (ops/qmm.py mv_plan of the [K, N] weight; one cluster a tile); x on 16
// bytes, scales on 8.  The library of epilogue ACT takes gate-ups of act ==
// ACT (and, SiLU's, the matmul).  Returns the CUDA error of the launch (0 on
// success).
template <int ACT>
int i8t_gd(const void* x, const void* q, const void* s, void* out, int K, int N, int G,
           int mins, int gateup, int ks, int act, void* stream) {
  const i8mv::Op op{static_cast<const uint16_t*>(x), static_cast<const int8_t*>(q),
                    static_cast<const uint16_t*>(s), nullptr, out, K, N, ks};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (G == 32)
    e = mins ? gd<32, true, ACT>(op, gateup, act, st) : gd<32, false, ACT>(op, gateup, act, st);
  if (G == 16)
    e = mins ? gd<16, true, ACT>(op, gateup, act, st) : gd<16, false, ACT>(op, gateup, act, st);
  return static_cast<int>(e);
}

// y = x [M, K] @ W [K, N] on the tile of i8k_tile.cuh: bm rows of x a
// block, ks splits of K (ops/qmm.py i8k_plan: a power of two up to 8, one
// cluster a tile).  gateup = 0: out f32 [M, N].  gateup = 1: W holds gate
// columns [0, N/2) and up columns [N/2, N); out bf16 [M, N/2] = act(gate)
// · up, act and the library's ACT as i8t_gd's.  K a multiple of 64, N of
// 128 (256 for the gate-up), G 16 or 32; mins = 1 (G = 32 only) with a
// second (mins) scale plane; x, payload and scales on 16 bytes.  Returns
// the CUDA error of the launch.
template <int ACT>
int i8t_dq(const void* x, const void* q, const void* s, void* out, int M, int K, int N, int KS,
           int gateup, int G, int bm, int mins, int act, void* stream) {
  const uint16_t* s16 = static_cast<const uint16_t*>(s);
  DqParams p{{static_cast<const uint16_t*>(x), static_cast<const int8_t*>(q), s16, K, N, M,
              mins ? s16 + static_cast<size_t>(K / G) * N : nullptr},
             out, K, N, KS};
  return static_cast<int>(i8k::dispatch(
      bm, LaunchDq<ACT>{p, G, gateup, mins, act, static_cast<cudaStream_t>(stream)}));
}

}  // namespace
