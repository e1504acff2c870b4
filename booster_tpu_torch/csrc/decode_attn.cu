// T = 1 GQA decode attention over one layer of the stacked KV cache, dense
// or paged.
//
// Replaces _decode_attn_kernel_merged (booster_tpu/ops/pallas_attention.py),
// bf16 cache (Q = false) and int8 cache (Q = true, `quantized=True`); it also
// covers the per-b twin _decode_attn_kernel, which computes the same function.
// The paged form (Paged = true, bt_paged_decode_attn) replaces
// _paged_attn_kernel_merged (booster_tpu/ops/pallas_paged_attention.py), and
// covers its per-(row, head) twin _paged_attn_kernel_stacked and the one-layer
// _paged_attn_kernel (no self term): the same function, with column j of slot
// b read from page table[b, j / P] at row j % P of the layer's pool
// [Np, Hkv, P, D] (scales [Np, Hkv, P]).  Each 64-column chunk looks up the
// row of each of its columns first (a chunk may cross a page when a window
// starts it mid-page); the rest of the kernel is the dense one.  Pages that
// several slots share (a common prompt prefix) are read by each of their
// blocks, so part of that traffic hits L2.
//
// For each (b, kv head h) and each of the G query heads of that kv head:
//   s_j = q · k_j (f32) over the valid columns j in [lens - win + selfok, lens),
//   optional softcap s = c·tanh(s/c), online softmax over column chunks
//   (m, l, acc carried in f32; l sums the unrounded p, PV uses bf16(p)),
//   then the deferred-append self term: the new token's k/v (not yet in the
//   cache) folded in as one more column in f32, and out = acc / max(l, 1e-30).
// q arrives pre-scaled and rounded to bf16 [B, Hkv, G, D]; the cache is
// [L, B, Hkv, S, D] with D the lane-padded storage width (zero pad lanes),
// and the wrapper passes the base of layer l.  Out is f32 [B, Hkv, G, D].
//
// int8 cache (with f32 scales ks, vs [B, Hkv, S] of the layer): k_j and v_j
// are cast to f32 exactly and the scales stay out of the [S, D] tiles, as in
// the TPU kernel: s_j = (q · k_j) · ks_j (the scale after the dot), l sums
// the unrounded p_j, and PV takes bf16(p_j · vs_j) against v_j.  The self
// term's k/v (bf16 rows not yet in the cache) go through the storage round
// trip first, in f32 through the append's own helpers (int8_row.cuh), so it
// is the row the append will write; a zero row stays zero.  The int8 form
// moves half the cache bytes.
//
// What bounds it on the H100: the K and V bytes of the valid columns,
// 2·2·D bytes per column per kv head, over 3.35 TB/s; the FLOPs (4·G·D per
// column) are far below the card's rate.  Design: one block per (b, kv
// head), so the G query heads of a kv head share every K/V chunk.  A chunk
// of 64 columns is loaded with 16-byte loads, all issued before any is used,
// into shared memory as f32: K with row stride D + 1 (a thread per column
// walks its row, lanes on distinct banks), V with stride D (a warp per head
// reads consecutive dims).  Scores: a thread per (column, G/4 heads); the
// running max and sum, then PV: a warp per head, lane l owning dims
// l, l + 32, ...; q is read from shared memory as broadcasts.  Only the
// valid column range is read.  At B = 1 this runs Hkv blocks, a few SMs of 132:
// splitting S across blocks (with a second merge pass) is later work, as is
// using the tensor cores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "bf16_ops.cuh"

#include "int8_row.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;
constexpr int kHeadGroups = kThreads / kChunk;  // scores: heads g ≡ t / kChunk (mod 4)
constexpr int kMaxG = 16;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct AttnParams {
  const uint16_t* q;    // [B, Hkv, G, D] bf16, pre-scaled
  const void* k;        // [B, Hkv, S, D] bf16 or int8: layer l of the stacked cache
  const void* v;
  const float* ks;      // [B, Hkv, S] f32 scales of an int8 layer, else null
  const float* vs;
  const uint16_t* sk;   // [B, Hkv, D] bf16 self-term k, or null
  const uint16_t* sv;
  const int* lens;      // [B] valid cache columns
  const int* self_ok;   // [B] the new token is live, or null
  float* out;           // [B, Hkv, G, D]
  int Hkv, G, S, win;   // paged: S = maxp · P
  float softcap;
  const int* table;     // paged: [B, maxp] physical page of each logical page
  int P, maxp;          // paged: rows per page, pages per slot
};

// row of cache column c of slot b, kv head h, in the layer's K/V rows of D
// values (and its scale planes): dense [B, Hkv, S], paged [Np, Hkv, P]
template <bool Paged>
__device__ __forceinline__ size_t kv_row(const AttnParams& p, int b, int h, int c) {
  if constexpr (Paged) {
    const int page = __ldg(p.table + static_cast<size_t>(b) * p.maxp + c / p.P);
    return (static_cast<size_t>(page) * p.Hkv + h) * p.P + c % p.P;
  } else {
    return (static_cast<size_t>(b) * p.Hkv + h) * p.S + c;
  }
}

template <int D>
size_t smem_bytes(int G) {
  return sizeof(float) * (static_cast<size_t>(G) * D + static_cast<size_t>(kChunk) * (D + 1)
                          + static_cast<size_t>(kChunk) * D + static_cast<size_t>(G) * kChunk
                          + 2 * static_cast<size_t>(G) + 2 * kChunk);
}

// one chunk of n rows of K or V (bf16 rows rows[0..n) of D values from
// src) → f32 shared memory with row stride `stride`; 16-byte loads, all
// issued first
template <int D>
__device__ __forceinline__ void load_chunk(const uint16_t* src, const size_t* rows, int n,
                                           float* dst, int stride) {
  constexpr int kVec = D / 8;                                    // 16-byte vectors per row
  constexpr int kIters = (kChunk * kVec + kThreads - 1) / kThreads;
  uint4 r[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int j = i / kVec;
    if (j < n) r[it] = __ldg(reinterpret_cast<const uint4*>(src + rows[j] * D) + (i % kVec));
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int j = i / kVec, d = (i % kVec) * 8;
    if (j < n) {
      const uint32_t w[4] = {r[it].x, r[it].y, r[it].z, r[it].w};
      float* o = dst + j * stride + d;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[2 * e] = __uint_as_float(w[e] << 16);
        o[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
      }
    }
  }
}

// the same for int8 rows: 16 values per 16-byte load
template <int D>
__device__ __forceinline__ void load_chunk_i8(const int8_t* src, const size_t* rows, int n,
                                              float* dst, int stride) {
  constexpr int kVec = D / 16;
  constexpr int kIters = (kChunk * kVec + kThreads - 1) / kThreads;
  uint4 r[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int j = i / kVec;
    if (j < n) r[it] = __ldg(reinterpret_cast<const uint4*>(src + rows[j] * D) + (i % kVec));
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int j = i / kVec, d = (i % kVec) * 16;
    if (j < n) {
      const uint32_t w[4] = {r[it].x, r[it].y, r[it].z, r[it].w};
      float* o = dst + j * stride + d;
#pragma unroll
      for (int e = 0; e < 16; ++e)
        o[e] = static_cast<float>(static_cast<int8_t>((w[e / 4] >> (8 * (e % 4))) & 0xffu));
    }
  }
}

template <int D, bool Q, bool Paged>
__global__ void __launch_bounds__(kThreads) decode_attn_kernel(AttnParams p) {
  constexpr int KP = D + 1;     // K row stride in shared memory
  constexpr int DL = D / 32;    // dims per lane in PV: lane + 32·e
  __shared__ size_t rows[kChunk];  // the chunk's columns' rows in the layer
  extern __shared__ float sm[];
  const int G = p.G;
  float* qs = sm;                 // [G][D]
  float* ks = qs + G * D;         // [kChunk][D + 1]
  float* vs = ks + kChunk * KP;   // [kChunk][D]
  float* ps = vs + kChunk * D;    // [G][kChunk]: scores, then bf16(p)
  float* mrow = ps + G * kChunk;  // [G] running max
  float* lrow = mrow + G;         // [G] running sum of p
  float* kss = lrow + G;          // [kChunk] k scales of the chunk (int8)
  float* vss = kss + kChunk;      // [kChunk] v scales of the chunk (int8)

  const int bh = blockIdx.x;  // b * Hkv + h
  const int b = bh / p.Hkv, h = bh % p.Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lens = p.lens[b];
  const int ok = p.self_ok != nullptr && p.self_ok[b] > 0;
  const int lo = max(lens - p.win + ok, 0);
  const int hi = min(lens, p.S);

  for (int i = tid; i < G * D; i += kThreads) qs[i] = bf16f(p.q[static_cast<size_t>(bh) * G * D + i]);
  for (int g = tid; g < G; g += kThreads) {
    mrow[g] = kNeg;
    lrow[g] = 0.f;
  }
  // PV accumulators: warp w owns heads w, w + 8, ...; lane owns dims lane + 32·e
  float acc[kMaxG / kWarps][DL];
#pragma unroll
  for (int a = 0; a < kMaxG / kWarps; ++a)
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[a][e] = 0.f;
  __syncthreads();

  const int j_s = tid % kChunk;       // the scores' column
  const int hg = tid / kChunk;        // the scores' head group
  for (int c0 = lo; c0 < hi; c0 += kChunk) {
    const int n = min(kChunk, hi - c0);
    if (tid < n) rows[tid] = kv_row<Paged>(p, b, h, c0 + tid);
    __syncthreads();
    if constexpr (Q) {
      load_chunk_i8<D>(static_cast<const int8_t*>(p.k), rows, n, ks, KP);
      load_chunk_i8<D>(static_cast<const int8_t*>(p.v), rows, n, vs, D);
      if (tid < n) kss[tid] = p.ks[rows[tid]];
      else if (tid >= kChunk && tid - kChunk < n) vss[tid - kChunk] = p.vs[rows[tid - kChunk]];
    } else {
      load_chunk<D>(static_cast<const uint16_t*>(p.k), rows, n, ks, KP);
      load_chunk<D>(static_cast<const uint16_t*>(p.v), rows, n, vs, D);
    }
    __syncthreads();
    // scores of column j_s for heads hg, hg + 4, ...
    {
      float s[kMaxG / kHeadGroups];
#pragma unroll
      for (int a = 0; a < kMaxG / kHeadGroups; ++a) s[a] = 0.f;
      if (j_s < n) {
        const float* kj = ks + j_s * KP;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          const float kv = kj[d];
#pragma unroll
          for (int a = 0; a < kMaxG / kHeadGroups; ++a) {
            const int g = hg + a * kHeadGroups;
            if (g < G) s[a] = __fmaf_rn(qs[g * D + d], kv, s[a]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < kMaxG / kHeadGroups; ++a) {
        const int g = hg + a * kHeadGroups;
        if (g < G) {
          float v = kNeg;
          if (j_s < n) {
            v = s[a];
            if constexpr (Q) v = __fmul_rn(v, kss[j_s]);
            if (p.softcap > 0.f) v = p.softcap * tanhf(v / p.softcap);
          }
          ps[g * kChunk + j_s] = v;
        }
      }
    }
    __syncthreads();
    // running max and sum, then PV, a warp per head (a compile-time slot a
    // per head keeps the accumulators in registers)
#pragma unroll
    for (int a = 0; a < kMaxG / kWarps; ++a) {
      const int g = warp + a * kWarps;
      if (g >= G) break;
      float mx = kNeg;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, ps[g * kChunk + j]);
      const float m_prev = mrow[g];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int j = lane; j < kChunk; j += 32) {
        float e = 0.f, w = 0.f;
        if (j < n) {
          e = expf(ps[g * kChunk + j] - m_new);
          sum += e;
          w = Q ? __fmul_rn(e, vss[j]) : e;
        }
        ps[g * kChunk + j] = round_bf16(w);
      }
      sum = warp_sum(sum);
      const float alpha = expf(m_prev - m_new);  // m_prev, m_new are warp-uniform
      __syncwarp();
      if (lane == 0) {
        lrow[g] = lrow[g] * alpha + sum;
        mrow[g] = m_new;
      }
      // acc = acc·alpha + sum_j bf16(p_j)·v_j
#pragma unroll
      for (int e = 0; e < DL; ++e) acc[a][e] *= alpha;
      const float* pg = ps + g * kChunk;
      for (int j = 0; j < n; ++j) {
        const float pj = pg[j];
        const float* vj = vs + j * D + lane;
#pragma unroll
        for (int e = 0; e < DL; ++e) acc[a][e] = __fmaf_rn(pj, vj[32 * e], acc[a][e]);
      }
    }
    __syncthreads();
  }

  const bool self_term = ok && p.sk != nullptr;
  // the self term's k and v rows, lane owns dims lane + 32·e (every warp
  // holds both rows; for int8 their storage round trip)
  float skr[DL], svr[DL];
  if (self_term) {
#pragma unroll
    for (int e = 0; e < DL; ++e) {
      skr[e] = bf16f(p.sk[static_cast<size_t>(bh) * D + lane + 32 * e]);
      svr[e] = bf16f(p.sv[static_cast<size_t>(bh) * D + lane + 32 * e]);
    }
    if constexpr (Q) {
      float ak = 0.f, av = 0.f;
#pragma unroll
      for (int e = 0; e < DL; ++e) {
        ak = fmaxf(ak, fabsf(skr[e]));
        av = fmaxf(av, fabsf(svr[e]));
      }
      const float sck = int8_row::scale(warp_max(ak));
      const float scv = int8_row::scale(warp_max(av));
#pragma unroll
      for (int e = 0; e < DL; ++e) {
        skr[e] = int8_row::round_trip(skr[e], sck);
        svr[e] = int8_row::round_trip(svr[e], scv);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < kMaxG / kWarps; ++a) {
    const int g = warp + a * kWarps;
    if (g >= G) break;
    float l = lrow[g];
    if (self_term) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < DL; ++e) s = __fmaf_rn(qs[g * D + lane + 32 * e], skr[e], s);
      s = warp_sum(s);
      if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
      const float m_prev = mrow[g];
      const float m2 = fmaxf(m_prev, s);
      const float alpha = expf(m_prev - m2);
      const float ps_self = expf(s - m2);
#pragma unroll
      for (int e = 0; e < DL; ++e) acc[a][e] = acc[a][e] * alpha + ps_self * svr[e];
      l = l * alpha + ps_self;
    }
    l = fmaxf(l, 1e-30f);
#pragma unroll
    for (int e = 0; e < DL; ++e)
      p.out[(static_cast<size_t>(bh) * G + g) * D + lane + 32 * e] = acc[a][e] / l;
  }
}

template <int D, bool Q, bool Paged>
cudaError_t launch(const AttnParams& p, int B, cudaStream_t st) {
  // raise the dynamic shared memory limit once, for the largest G taken
  // (before any stream capture: the first launch of each form does it)
  static const cudaError_t configured = cudaFuncSetAttribute(
      decode_attn_kernel<D, Q, Paged>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<D>(kMaxG)));
  if (configured != cudaSuccess) return configured;
  const size_t smem = smem_bytes<D>(p.G);
  decode_attn_kernel<D, Q, Paged><<<B * p.Hkv, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// D (the cache's storage head dim) must be 128, the only width ported yet
// (head dims up to 128 are stored lane-padded to it), and G <= 16.  ks and
// vs non-null select the int8 form (k, v int8), null the bf16 form.
// Returns the CUDA error of the launch (0 on success).
extern "C" int bt_decode_attn(const void* q, const void* k, const void* v, const void* ks,
                              const void* vs, const void* sk, const void* sv, const void* lens,
                              const void* self_ok, void* out, int B, int Hkv, int G, int S,
                              int D, int win, float softcap, void* stream) {
  AttnParams p{static_cast<const uint16_t*>(q), k, v, static_cast<const float*>(ks),
               static_cast<const float*>(vs), static_cast<const uint16_t*>(sk),
               static_cast<const uint16_t*>(sv), static_cast<const int*>(lens),
               static_cast<const int*>(self_ok), static_cast<float*>(out),
               Hkv, G, S, win, softcap, nullptr, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G > kMaxG || G < 1 || D != 128 || (ks == nullptr) != (vs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = ks != nullptr ? launch<128, true, false>(p, B, st)
                                      : launch<128, false, false>(p, B, st);
  return static_cast<int>(e);
}

// The paged form: k, v are layer l's pool [Np, Hkv, P, D] (bf16, or int8 with
// scales ks, vs [Np, Hkv, P] f32), table [B, maxp] int32; the rest as
// bt_decode_attn, with S = maxp · P.
extern "C" int bt_paged_decode_attn(const void* q, const void* k, const void* v, const void* ks,
                                    const void* vs, const void* sk, const void* sv,
                                    const void* table, const void* lens, const void* self_ok,
                                    void* out, int B, int Hkv, int G, int P, int maxp, int D,
                                    int win, float softcap, void* stream) {
  AttnParams p{static_cast<const uint16_t*>(q), k, v, static_cast<const float*>(ks),
               static_cast<const float*>(vs), static_cast<const uint16_t*>(sk),
               static_cast<const uint16_t*>(sv), static_cast<const int*>(lens),
               static_cast<const int*>(self_ok), static_cast<float*>(out),
               Hkv, G, P * maxp, win, softcap, static_cast<const int*>(table), P, maxp};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G > kMaxG || G < 1 || D != 128 || P < 1 || maxp < 1 || table == nullptr
      || (ks == nullptr) != (vs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = ks != nullptr ? launch<128, true, true>(p, B, st)
                                      : launch<128, false, true>(p, B, st);
  return static_cast<int>(e);
}
