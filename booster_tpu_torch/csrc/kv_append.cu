// Deferred decode KV append: every layer's new row for every slot, in one launch.
//
// bt_kv_append replaces _append_all_kernel_plain (booster_tpu/ops/pallas_kv.py),
// the bf16 cache variant of kv_append_all_layers; bt_kv_append_i8 replaces
// _append_all_kernel_quant, its int8 variant (kv_append_i8_kernel below).
// After the layer loop of a T = 1 decode step, the new k/v rows [L, B, H, d] are written at row offsets[b]
// (clamped to S - 1) of every layer of the stacked cache [L, B, H, S, D],
// zero-padded from d to the storage width D.  Unlike the TPU kernel, which
// rewrites an aligned 8-row window (and clobbers the rows after the offset,
// which are never read), this writes that one row only.  The cache is
// updated in place.
//
// bt_kv_append_paged and bt_kv_append_paged_i8 replace
// _append_all_kernel_paged_plain and _append_all_kernel_paged_quant
// (kv_append_all_layers_paged): the same rows go through slot b's page table
// into the stacked pool [L, Np, H, P, D], to page table[b, off / P] at row
// off % P, or to the scratch page 0 at row 0 when off / P is past the table
// (the TPU kernel's rule; its plain version, the JAX scatter, uses row
// off % P of page 0, which no slot reads).
//
// What bounds it on the H100: nothing of the card's rates — it moves
// 2·L·B·H·(d + D)·2 bytes (about 70 KB at TinyLlama's shape), so the launch
// itself is the cost.  Design: one block per (layer, slot, head) row, one
// thread per element; a single launch replaces L per-layer writes.
//
// bt_kv_append_layer and bt_kv_append_layer_i8 replace _append_kernel_plain
// and _append_kernel_quant (kv_append_decode_stacked and its L = 1 view
// kv_append_decode): one layer's T = 1 append, made inside the layer loop
// where decode takes the masked attention (ALiBi models, and a cache whose
// length is no multiple of 128 cannot reach them).  They write layer views
// of the stacked cache, [B, H, S, D], with new rows [B, H, d].  Both launch
// the all-layer kernels at L = 1 (the same function); the int8 kernel takes
// any storage width D that is a multiple of 128 up to 1024, one thread per
// lane.  Bound on the H100: the launch, as above (2·B·H·(2d + D + 4) bytes
// at most: 2.6 MB at B = 64, H = 32).

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_row.cuh"

namespace {

// where the row of (layer l, slot b, head h) lands, in rows of D values of
// the cache [L, B, H, S] (dense) or of the pool [L, Np, H, P] (paged; the
// int8 scale planes share the row index)
struct Dest {
  const int* offsets;  // [B] write positions (the slots' lengths)
  int B, H, S;
  const int* table;    // paged: [B, maxp], else null
  int Np, P, maxp;

  __device__ __forceinline__ size_t row(int blk) const {  // blk = (l * B + b) * H + h
    const int h = blk % H, b = (blk / H) % B, l = blk / (H * B);
    const int off = offsets[b];
    if (table == nullptr)
      return static_cast<size_t>(blk) * S + min(max(off, 0), S - 1);
    const int lp = off / P;
    const bool in_range = lp < maxp;
    const int page = in_range ? table[static_cast<size_t>(b) * maxp + lp] : 0;
    const int o = in_range ? off % P : 0;
    return ((static_cast<size_t>(l) * Np + page) * H + h) * P + o;
  }
};

__global__ void kv_append_kernel(uint16_t* k, uint16_t* v, const uint16_t* nk,
                                 const uint16_t* nv, Dest dest, int D, int d) {
  const int blk = blockIdx.x;
  const size_t dst = dest.row(blk) * D;
  const size_t src = static_cast<size_t>(blk) * d;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    k[dst + i] = i < d ? nk[src + i] : 0;
    v[dst + i] = i < d ? nv[src + i] : 0;
  }
}

// int8 cache: each new row (zero-padded from d to D = blockDim.x lanes, a
// multiple of 128 up to 1024, one thread per lane) is quantized in the
// format of int8_row.cuh, bit-exact with the plain version and with the self
// term that decode attention mirrors before the append lands.  The amax over
// the row is reduced in each warp by shuffles, then across the warps in
// shared memory.  The payload row and its scale go to the destination row.
// Bound on the H100: like the bf16 form, the launch (the rows read and
// written are ~1 MB at L = 22, B = 64).  kD = 128 fixes the width at compile
// time: at the decode caches' width it was 9-14 % faster than the runtime
// width over 5,632-24,576 blocks (chip_smoke.py's kernels phase on an H100
// 80GB HBM3 at 700 W).  kD = 0 takes D = blockDim.x.
template <int kD>
__global__ void __launch_bounds__(kD ? kD : 1024) kv_append_i8_kernel(
    int8_t* k, int8_t* v, float* ks, float* vs, const uint16_t* nk, const uint16_t* nv,
    Dest dest, int d) {
  __shared__ float red[2][32];
  const int D = kD ? kD : blockDim.x;
  const int blk = blockIdx.x;
  const int i = threadIdx.x, lane = i & 31, warp = i >> 5, warps = D >> 5;
  const size_t src = static_cast<size_t>(blk) * d;
  float x[2];
  x[0] = i < d ? __uint_as_float(static_cast<uint32_t>(nk[src + i]) << 16) : 0.f;
  x[1] = i < d ? __uint_as_float(static_cast<uint32_t>(nv[src + i]) << 16) : 0.f;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    float a = fabsf(x[t]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
    if (lane == 0) red[t][warp] = a;
  }
  __syncthreads();
  const size_t dst = dest.row(blk);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    float amax = red[t][0];
    for (int w = 1; w < warps; ++w) amax = fmaxf(amax, red[t][w]);
    const float scale = int8_row::scale(amax);
    (t == 0 ? k : v)[dst * D + i] = static_cast<int8_t>(int8_row::quantize(x[t], scale));
    if (i == 0) (t == 0 ? ks : vs)[dst] = scale;
  }
}

int launch_i8(void* k, void* v, void* ks, void* vs, const void* nk, const void* nv,
              const Dest& dest, int L, int D, int d, void* stream) {
  if (D % 128 != 0 || D > 1024 || d > D || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = D == 128 ? kv_append_i8_kernel<128> : kv_append_i8_kernel<0>;
  kernel<<<L * dest.B * dest.H, D, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(k), static_cast<int8_t*>(v), static_cast<float*>(ks),
      static_cast<float*>(vs), static_cast<const uint16_t*>(nk),
      static_cast<const uint16_t*>(nv), dest, d);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(void* k, void* v, const void* nk, const void* nv, const Dest& dest, int L,
                int D, int d, void* stream) {
  const int threads = D < 128 ? 32 * ((D + 31) / 32) : 128;
  kv_append_kernel<<<L * dest.B * dest.H, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint16_t*>(k), static_cast<uint16_t*>(v), static_cast<const uint16_t*>(nk),
      static_cast<const uint16_t*>(nv), dest, D, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// k, v: [L, B, H, S, D] int8 and ks, vs: [L, B, H, S] f32 (updated in
// place), D a multiple of 128 up to 1024; nk, nv: [L, B, H, d] bf16, d <= D;
// offsets: [B] int32.
extern "C" int bt_kv_append_i8(void* k, void* v, void* ks, void* vs, const void* nk,
                               const void* nv, const void* offsets, int L, int B, int H, int S,
                               int D, int d, void* stream) {
  const Dest dest{static_cast<const int*>(offsets), B, H, S, nullptr, 0, 0, 0};
  return launch_i8(k, v, ks, vs, nk, nv, dest, L, D, d, stream);
}

// k, v: [L, B, H, S, D] bf16 (updated in place); nk, nv: [L, B, H, d] bf16;
// offsets: [B] int32.  Returns the CUDA error of the launch (0 on success).
extern "C" int bt_kv_append(void* k, void* v, const void* nk, const void* nv,
                            const void* offsets, int L, int B, int H, int S, int D, int d,
                            void* stream) {
  const Dest dest{static_cast<const int*>(offsets), B, H, S, nullptr, 0, 0, 0};
  return launch_bf16(k, v, nk, nv, dest, L, D, d, stream);
}

// The paged forms: k, v the pool [L, Np, H, P, D] (int8 with ks, vs
// [L, Np, H, P] f32, D as above; or bf16), table [B, maxp] int32; the rest as above.
extern "C" int bt_kv_append_paged_i8(void* k, void* v, void* ks, void* vs, const void* nk,
                                     const void* nv, const void* offsets, const void* table,
                                     int L, int B, int H, int Np, int P, int maxp, int D, int d,
                                     void* stream) {
  if (table == nullptr || P < 1 || maxp < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Dest dest{static_cast<const int*>(offsets), B, H, 0, static_cast<const int*>(table),
                  Np, P, maxp};
  return launch_i8(k, v, ks, vs, nk, nv, dest, L, D, d, stream);
}

extern "C" int bt_kv_append_paged(void* k, void* v, const void* nk, const void* nv,
                                  const void* offsets, const void* table, int L, int B, int H,
                                  int Np, int P, int maxp, int D, int d, void* stream) {
  if (table == nullptr || P < 1 || maxp < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Dest dest{static_cast<const int*>(offsets), B, H, 0, static_cast<const int*>(table),
                  Np, P, maxp};
  return launch_bf16(k, v, nk, nv, dest, L, D, d, stream);
}

// One layer's T = 1 append: k, v the layer view [B, H, S, D] (bf16; or int8
// with ks, vs [B, H, S] f32 and D a multiple of 128 up to 1024), nk, nv
// [B, H, d] bf16, d <= D; offsets [B] int32 (clamped to S - 1).
extern "C" int bt_kv_append_layer(void* k, void* v, const void* nk, const void* nv,
                                  const void* offsets, int B, int H, int S, int D, int d,
                                  void* stream) {
  const Dest dest{static_cast<const int*>(offsets), B, H, S, nullptr, 0, 0, 0};
  return launch_bf16(k, v, nk, nv, dest, 1, D, d, stream);
}

extern "C" int bt_kv_append_layer_i8(void* k, void* v, void* ks, void* vs, const void* nk,
                                     const void* nv, const void* offsets, int B, int H, int S,
                                     int D, int d, void* stream) {
  const Dest dest{static_cast<const int*>(offsets), B, H, S, nullptr, 0, 0, 0};
  return launch_i8(k, v, ks, vs, nk, nv, dest, 1, D, d, stream);
}
