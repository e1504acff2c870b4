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
// bt_kv_append_layer and bt_kv_append_layer_i8 replace _append_kernel_plain
// and _append_kernel_quant (kv_append_decode_stacked and its L = 1 view
// kv_append_decode): one layer's T = 1 append, made inside the layer loop
// where decode takes the masked attention (ALiBi models, and a cache whose
// length is no multiple of 128 cannot reach them).  They write layer views
// of the stacked cache, [B, H, S, D], with new rows [B, H, d], and launch
// the all-layer kernels at L = 1 (the same function).
//
// What bounds it on the H100: the bytes, 4·L·B·H·(d + D) (bf16) or
// L·B·H·(4d + 2D + 8) (int8 with its scales), over 3.35 TB/s: 12.7 MB at
// the 7B's int8 batch shape (3.8 µs), 68 KB at TinyLlama's bf16 one, where
// the launch itself is the cost.  Design:
//   - One warp a row, kRows (8) rows a block, the grid (row blocks, L): no
//     division per element, one per row for its slot and head.
//   - bf16: a row is D/8 16-byte chunks of k, then of v; lane i copies
//     chunks i, i + 32, ... (at D = 128 one chunk a lane, lanes 0-15 k and
//     16-31 v), zeros past d, with 16-byte loads and stores where D and d
//     are multiples of 8 and the four pointers lie on 16 bytes, one element
//     at a time otherwise.
//   - int8: a warp takes a row of D = 128·P lanes (P = 1-8, a template
//     parameter: the per-layer form's wider storage) in P passes of 4
//     consecutive lanes a lane, k's and v's loaded together as 8 bytes of
//     bf16 where d is a multiple of 4 and the new rows lie on 8 bytes.  The
//     row's amax comes from shuffles alone (no shared memory, no block
//     barrier); the division by the scale is a product with its reciprocal
//     wherever that gives the same integer (int8_row::quantize_rcp); each
//     lane stores its 4 payload bytes as one 32-bit word, and lane 0 the
//     scale.  The values are int8_row.cuh's: bit-exact with the plain
//     version and with the self term that decode attention mirrors.  (Two
//     rows a warp, their loads issued together, was slower on every int8
//     row of the paths; chip_smoke.py's kernels phase has the rows' times.)

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_ops.cuh"
#include "i8mv.cuh"  // ld64, ld128
#include "int8_row.cuh"

namespace {

constexpr int kRows = 8;  // rows (warps) a block

// where the row of (layer l, slot b, head h) lands, in rows of D values of
// the cache [L, B, H, S] (dense) or of the pool [L, Np, H, P] (paged; the
// int8 scale planes share the row index)
struct Dest {
  const int* offsets;  // [B] write positions (the slots' lengths)
  int B, H, S;
  const int* table;    // paged: [B, maxp], else null
  int Np, P, maxp;

  __device__ __forceinline__ size_t row(int l, int b, int h) const {
    const int off = offsets[b];
    if (table == nullptr)
      return (static_cast<size_t>(l) * B * H + static_cast<size_t>(b) * H + h) * S
             + min(max(off, 0), S - 1);
    const int lp = off / P;
    const bool in_range = lp < maxp;
    const int page = in_range ? table[static_cast<size_t>(b) * maxp + lp] : 0;
    const int o = in_range ? off % P : 0;
    return ((static_cast<size_t>(l) * Np + page) * H + h) * P + o;
  }
};

// The warp's row: (layer blockIdx.y, slot b, head h); false past the last.
__device__ __forceinline__ bool warp_row(const Dest& dest, int& b, int& h) {
  const int r = blockIdx.x * kRows + (threadIdx.x >> 5);
  if (r >= dest.B * dest.H) return false;
  b = r / dest.H;
  h = r - b * dest.H;
  return true;
}

// bf16 cache: the new row zero-padded from d to D, copied into k and v.
__global__ void __launch_bounds__(32 * kRows)
    kv_append_kernel(uint16_t* k, uint16_t* v, const uint16_t* nk, const uint16_t* nv, Dest dest,
                     int D, int d, int vec) {
  int b, h;
  if (!warp_row(dest, b, h)) return;
  const int lane = threadIdx.x & 31, l = blockIdx.y;
  const size_t src = ((static_cast<size_t>(l) * dest.B + b) * dest.H + h) * d;
  const size_t dst = dest.row(l, b, h) * D;
  if (vec) {  // 16-byte chunks of 8 bf16: k's, then v's
    const int n = D >> 3;
    for (int i = lane; i < 2 * n; i += 32) {
      const int t = i >= n, c = (i - t * n) << 3;
      const uint4 val = c < d ? i8mv::ld128((t ? nv : nk) + src + c) : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>((t ? v : k) + dst + c) = val;
    }
    return;
  }
  for (int i = lane; i < D; i += 32) {
    k[dst + i] = i < d ? nk[src + i] : 0;
    v[dst + i] = i < d ? nv[src + i] : 0;
  }
}

// int8 cache: the new row (zero-padded from d to D = 128·P) quantized in the
// format of int8_row.cuh; lane i takes lanes 128p + 4i .. + 3 of pass p.  The
// warp loads k's and v's row first, then quantizes and stores each.
template <int P>
__global__ void __launch_bounds__(32 * kRows)
    kv_append_i8_kernel(int8_t* k, int8_t* v, float* ks, float* vs, const uint16_t* nk,
                        const uint16_t* nv, Dest dest, int d, int vec) {
  constexpr int D = 128 * P;
  int b, h;
  if (!warp_row(dest, b, h)) return;
  const int lane = threadIdx.x & 31, l = blockIdx.y;
  const size_t src = ((static_cast<size_t>(l) * dest.B + b) * dest.H + h) * d;
  float x[2][P][4];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const uint16_t* in = (t ? nv : nk) + src;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int e = p * 128 + lane * 4;
      if (vec) {  // d a multiple of 4: the 4 lanes lie all in the row or all past it
        const uint2 u = e < d ? i8mv::ld64(in + e) : make_uint2(0u, 0u);
        x[t][p][0] = bf16f(u.x & 0xffffu);
        x[t][p][1] = bf16f(u.x >> 16);
        x[t][p][2] = bf16f(u.y & 0xffffu);
        x[t][p][3] = bf16f(u.y >> 16);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) x[t][p][j] = e + j < d ? bf16f(in[e + j]) : 0.f;
      }
    }
  }
  const size_t dst = dest.row(l, b, h);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    float a = 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int j = 0; j < 4; ++j) a = fmaxf(a, fabsf(x[t][p][j]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
    const float scale = int8_row::scale(a);
    const float rcp = __frcp_rn(fmaxf(scale, 1e-12f));
    int8_t* out = (t ? v : k) + dst * D;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        word |= (static_cast<uint32_t>(static_cast<int>(
                     int8_row::quantize_rcp(x[t][p][j], scale, rcp))) & 0xffu) << (8 * j);
      *reinterpret_cast<uint32_t*>(out + p * 128 + lane * 4) = word;
    }
    if (lane == 0) (t ? vs : ks)[dst] = scale;
  }
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

dim3 row_grid(const Dest& dest, int L) { return dim3((dest.B * dest.H + kRows - 1) / kRows, L); }

int launch_i8(void* k, void* v, void* ks, void* vs, const void* nk, const void* nv,
              const Dest& dest, int L, int D, int d, void* stream) {
  if (D % 128 != 0 || D > 1024 || d > D || d < 1 || L < 1 || dest.B * dest.H < 1
      || !aligned(k, 4) || !aligned(v, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  void (*const kernels[8])(int8_t*, int8_t*, float*, float*, const uint16_t*, const uint16_t*,
                           Dest, int, int) = {
      kv_append_i8_kernel<1>, kv_append_i8_kernel<2>, kv_append_i8_kernel<3>,
      kv_append_i8_kernel<4>, kv_append_i8_kernel<5>, kv_append_i8_kernel<6>,
      kv_append_i8_kernel<7>, kv_append_i8_kernel<8>};
  const int vec = d % 4 == 0 && aligned(nk, 8) && aligned(nv, 8);
  kernels[D / 128 - 1]<<<row_grid(dest, L), 32 * kRows, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(k), static_cast<int8_t*>(v), static_cast<float*>(ks),
      static_cast<float*>(vs), static_cast<const uint16_t*>(nk),
      static_cast<const uint16_t*>(nv), dest, d, vec);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(void* k, void* v, const void* nk, const void* nv, const Dest& dest, int L,
                int D, int d, void* stream) {
  if (d > D || d < 1 || L < 1 || dest.B * dest.H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = D % 8 == 0 && d % 8 == 0 && aligned(k, 16) && aligned(v, 16)
                  && aligned(nk, 16) && aligned(nv, 16);
  kv_append_kernel<<<row_grid(dest, L), 32 * kRows, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint16_t*>(k), static_cast<uint16_t*>(v), static_cast<const uint16_t*>(nk),
      static_cast<const uint16_t*>(nv), dest, D, d, vec);
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
