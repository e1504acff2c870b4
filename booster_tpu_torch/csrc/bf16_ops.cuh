// bf16 helpers shared by the kernels: exact widening of a bf16 bit pattern,
// round-to-nearest-even, and the gate-up kernels' SiLU·mul and GELU·mul
// epilogues, which must stay one function each so that every fused gate-up
// equals its unfused sequence bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ float bf16f(uint32_t b) { return __uint_as_float(b << 16); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// The three bf16 parts of an f32 value v: hi = bf16(v), mid = bf16(v - hi),
// lo = bf16(v - hi - mid), each difference exact in f32.  hi + mid + lo ==
// v exactly for a normal v (8 + 8 + 8 bits of its 24), and each part times
// a bf16 factor is exact in f32, so the tensor cores take an f32 group sum
// of x against bf16 mins without rounding it to bf16 (ops/qmm.py
// min_split repeats it).
__device__ __forceinline__ void split3(float v, uint16_t (&part)[3]) {
  part[0] = bf16_bits(v);
  const float r = __fsub_rn(v, bf16f(part[0]));
  part[1] = bf16_bits(r);
  part[2] = bf16_bits(__fsub_rn(r, bf16f(part[1])));
}

// out = bf16(bf16(g · bf16(sigmoid_f32(g))) · u) with g, u rounded to bf16
// first: torch's op sequence for x·sigmoid(x) then ·u in bf16 (ops/qmm.py
// silu), so a fused gate-up equals qmm + silu·mul bit for bit.
__device__ __forceinline__ uint16_t silu_mul(float gs, float us) {
  const float g = round_bf16(gs);
  const float u = round_bf16(us);
  const float sg = round_bf16(1.0f / (1.0f + expf(-g)));
  const float r = round_bf16(__fmul_rn(g, sg));
  return bf16_bits(__fmul_rn(r, u));
}

// The tanh-approximate GELU of gated-GELU models (Gemma), as torch computes
// ops/qmm.py gelu then ·u: g and u rounded to bf16 first, then each op in
// f32 rounded where torch rounds it (one elementwise kernel an op):
//   z = c·(g + 0.044715·((g·g)·g)), cdf = 0.5·(1 + tanh z), r = bf16(g·cdf),
//   out = bf16(r·u).
// The _rn intrinsics keep the compiler from contracting a product and a sum
// into one FMA (one rounding where torch has two), and tanhf is the CUDA
// math library's, as torch's own tanh kernel calls it (no fast-math
// anywhere in ops/kernels.py NVCC_FLAGS: tanh.approx.f32 would differ).
__device__ __forceinline__ uint16_t gelu_mul(float gs, float us) {
  const float g = round_bf16(gs);
  const float u = round_bf16(us);
  const float x3 = __fmul_rn(__fmul_rn(g, g), g);
  const float z = __fmul_rn(0.7978845608028654f, __fadd_rn(g, __fmul_rn(0.044715f, x3)));
  const float cdf = __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(z)));
  const float r = round_bf16(__fmul_rn(g, cdf));
  return bf16_bits(__fmul_rn(r, u));
}

// A gate-up's epilogue by its code (ops/qmm.py ACT_IDS): 0 SiLU, 1 GELU.
constexpr int kActSilu = 0;
constexpr int kActGelu = 1;

template <int ACT>
__device__ __forceinline__ uint16_t act_mul(float g, float u) {
  static_assert(ACT == kActSilu || ACT == kActGelu, "SiLU or GELU");
  if constexpr (ACT == kActGelu) return gelu_mul(g, u);
  return silu_mul(g, u);
}
