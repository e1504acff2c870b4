// bf16 helpers shared by the kernels: exact widening of a bf16 bit pattern,
// round-to-nearest-even, and the gate-up kernels' SiLU·mul epilogue, which
// must stay one function so that every fused gate-up equals its unfused
// sequence bit for bit.
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
