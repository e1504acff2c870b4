// The int8 KV cache's row format, shared by the append that writes it
// (kv_append.cu) and the decode attention that mirrors a row before the
// append lands (decode_attn.cu's self term).  The two must agree bit for bit.
//
// A row of f32 values x (bf16 cast exactly, pad lanes zero) is stored as
// scale = amax · f32(1/127) (the reference's amax / 127.0 as XLA compiles it)
// and q = round-half-even(x / max(scale, 1e-12)) as int8.  Explicit rounding
// (__fmul_rn, IEEE __fdiv_rn, rintf) keeps both exact under any nvcc flags; a
// zero row gives scale 0 and payload 0.

#pragma once

namespace int8_row {

constexpr float kRcp127 = 0x1.020408p-7f;  // f32(1/127)

__device__ __forceinline__ float scale(float amax) { return __fmul_rn(amax, kRcp127); }

// the stored int8 value of x, as a float
__device__ __forceinline__ float quantize(float x, float scale) {
  return rintf(__fdiv_rn(x, fmaxf(scale, 1e-12f)));
}

// quantize(x, scale), with the division replaced by a product with rcp =
// __frcp_rn(max(scale, 1e-12)) wherever that gives the same value: y =
// x·rcp is within 2^-23 |y| of x / max(scale, 1e-12), and the correctly
// rounded quotient within 2^-24 |y| of it, so for |y| <= 128 (every x of a
// row, whose scale is its amax / 127) the two lie on one side of each
// half-integer unless y is within 2^-15 of one; there (about one value in
// 8,000) it divides.
__device__ __forceinline__ float quantize_rcp(float x, float scale, float rcp) {
  const float y = __fmul_rn(x, rcp);
  const float q = rintf(y);
  if (0.5f - fabsf(__fsub_rn(y, q)) > 0x1p-14f) return q;
  return quantize(x, scale);
}

// x after the storage round trip: the value a reader of the row dequantizes
__device__ __forceinline__ float round_trip(float x, float scale) {
  return __fmul_rn(quantize(x, scale), scale);
}

}  // namespace int8_row
