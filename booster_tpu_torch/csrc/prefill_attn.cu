// Chunked-prefill flash attention over one layer of the int8 KV cache.
//
// Replaces _prefill_attn_kernel (booster_tpu/ops/pallas_attention.py, via
// prefill_attention), which the reference runs over an int8 cache.
//
// For each (b, kv head) row bh, each of its G query heads and each query
// position t of the chunk (at position pos0 + t):
//   s_j = (q · k_j) · ks_j (f32; k_j int8 cast exactly, the scale after the
//   dot), optional softcap c·tanh(s/c), over the valid columns
//   col <= pos0 + t, col < lens, col >= pos0 + t - win + 1;
//   online softmax over column chunks (m, l, acc in f32; l sums the
//   unrounded p, PV takes bf16(p_j · vs_j) against v_j), out = acc / max(l, 1e-30).
// q arrives pre-scaled and rounded to bf16, [BH, G, T, D]; k/v are the
// layer's [BH, S, D] int8 payload with scales [BH, S] f32 (the chunk itself
// is already in the cache, quantized).  Out is f32 [BH, G, T, D].
//
// What bounds it on the H100: the K and V bytes of the live columns (D + 4
// bytes per column per kv head, each) and the G·T·(live columns)·D·4
// operations of QK^T and PV; at the prefill path's shapes (T = 16-32 new
// tokens over a short cache) both are tiny, so the launch and the block's
// serial chunk loop set the time.  Design: one block per (bh, tile of
// G·TQ query rows), TQ = min(kRows / G, T), so the G heads and TQ positions
// of a tile share every K/V chunk and a block reads only the columns its
// rows can see.  Where G·T < kRows (MHA, G = 1, at the prompt buckets T = 16
// and 32) the tile is the whole chunk and the rows past G·T idle.  Two
// threads per query row, each scoring 32 of a chunk's 64 columns (columns
// 2i + h, so the pair reads neighbouring K rows on distinct banks) with q
// from shared memory (row stride D + 1); the pair merges its max and sum by
// one shuffle and writes the row's PV weights to shared memory, and in PV
// each thread owns every other dim of the row's accumulator.  CUDA cores
// only: tensor cores (wgmma) and split-S are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "bf16_ops.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = kThreads / 2;  // query rows per block
constexpr int kChunk = 64;           // columns per chunk
constexpr int kHalf = kChunk / 2;    // columns per thread
constexpr float kNeg = -1e30f;

struct PrefillParams {
  const uint16_t* q;  // [BH, G, T, D] bf16, pre-scaled
  const int8_t* k;    // [BH, S, D]
  const int8_t* v;
  const float* ks;    // [BH, S]
  const float* vs;
  const int* pos0;    // [BH] position of query row 0
  const int* lens;    // [BH] valid columns (cache rows incl. this chunk)
  float* out;         // [BH, G, T, D]
  int G, T, TQ, S, win;  // TQ: query positions per block
  float softcap;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kRows) * (D + 1) + kChunk * (D + 1)
                          + kChunk * D + kRows * (kChunk + 1) + 2 * kChunk);
}

// rows [c0, c0 + n) of an int8 [S, D] source → f32 shared memory with row
// stride `stride`; rows n..kChunk-1 are zero (PV reads them with weight 0)
template <int D>
__device__ __forceinline__ void load_chunk_i8(const int8_t* src, int c0, int n, float* dst,
                                              int stride) {
  constexpr int kVec = D / 16;
  for (int i = threadIdx.x; i < kChunk * kVec; i += kThreads) {
    const int j = i / kVec, d = (i % kVec) * 16;
    float* o = dst + j * stride + d;
    if (j < n) {
      const uint4 r = __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(c0 + j) * D) + (i % kVec));
      const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int e = 0; e < 16; ++e)
        o[e] = static_cast<float>(static_cast<int8_t>((w[e / 4] >> (8 * (e % 4))) & 0xffu));
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) o[e] = 0.f;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) prefill_attn_kernel(PrefillParams p) {
  constexpr int QP = D + 1;  // q and K row stride in shared memory
  constexpr int DH = D / 2;  // dims per thread in PV: 2e + h
  constexpr int PS = kChunk + 1;  // weight row stride: a warp's 16 rows on distinct banks
  extern __shared__ float sm[];
  float* qs = sm;                   // [kRows][D + 1]
  float* kc = qs + kRows * QP;      // [kChunk][D + 1]
  float* vc = kc + kChunk * QP;     // [kChunk][D]
  float* ps = vc + kChunk * D;      // [kRows][kChunk + 1]: PV weights bf16(p·vs)
  float* kss = ps + kRows * PS;     // [kChunk]
  float* vss = kss + kChunk;        // [kChunk]

  const int bh = blockIdx.y;
  const int G = p.G, TQ = p.TQ;
  const int t0 = blockIdx.x * TQ;
  const int tid = threadIdx.x, r = tid >> 1, h = tid & 1;
  const bool live = r < G * TQ;  // rows past G·TQ compute on zeros and write nothing
  const int g = live ? r / TQ : 0, t = t0 + r % TQ;
  const int pos0 = p.pos0[bh], lens = p.lens[bh];
  const int qpos = pos0 + t;
  const int lo = max(pos0 + t0 - p.win + 1, 0);
  const int hi = min(pos0 + t0 + TQ, lens);

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    const size_t src = ((static_cast<size_t>(bh) * G + rr / TQ) * p.T + t0 + rr % TQ) * D + d;
    qs[rr * QP + d] = rr < G * TQ ? bf16f(p.q[src]) : 0.f;
  }
  float m = kNeg, l = 0.f;
  float acc[DH];
#pragma unroll
  for (int e = 0; e < DH; ++e) acc[e] = 0.f;
  const size_t kv_base = static_cast<size_t>(bh) * p.S;

  for (int c0 = lo; c0 < hi; c0 += kChunk) {
    const int n = min(kChunk, hi - c0);
    __syncthreads();  // the previous chunk's reads are done (and q is stored)
    load_chunk_i8<D>(p.k + kv_base * D, c0, n, kc, QP);
    load_chunk_i8<D>(p.v + kv_base * D, c0, n, vc, D);
    if (tid < n) kss[tid] = p.ks[kv_base + c0 + tid];
    else if (tid >= kChunk && tid - kChunk < n) vss[tid - kChunk] = p.vs[kv_base + c0 + tid - kChunk];
    __syncthreads();

    float s[kHalf];
#pragma unroll
    for (int i = 0; i < kHalf; ++i) s[i] = 0.f;
    const float* qr = qs + r * QP;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qv = qr[d];
#pragma unroll
      for (int i = 0; i < kHalf; ++i) s[i] = __fmaf_rn(qv, kc[(2 * i + h) * QP + d], s[i]);
    }
    float mx = kNeg;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const int j = 2 * i + h, col = c0 + j;
      const bool valid = j < n && col <= qpos && col < lens && col >= qpos - p.win + 1;
      float v = __fmul_rn(s[i], valid ? kss[j] : 0.f);
      if (p.softcap > 0.f) v = p.softcap * tanhf(v / p.softcap);
      s[i] = valid ? v : kNeg;
      mx = fmaxf(mx, s[i]);
    }
    const float m_new = fmaxf(m, fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1)));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const int j = 2 * i + h;
      const float e = s[i] > 0.5f * kNeg ? expf(s[i] - m_new) : 0.f;
      sum += e;
      s[i] = round_bf16(__fmul_rn(e, vss[j < n ? j : 0]));  // now the PV weight
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float alpha = expf(m - m_new);
    l = l * alpha + sum;
    m = m_new;
    float* pr = ps + r * PS;  // the row's weights, both threads' halves
#pragma unroll
    for (int i = 0; i < kHalf; ++i) pr[2 * i + h] = s[i];
    __syncwarp();
#pragma unroll
    for (int e = 0; e < DH; ++e) acc[e] *= alpha;
    for (int j = 0; j < n; ++j) {
      const float w = pr[j];
      const float* vj = vc + j * D + h;
#pragma unroll
      for (int e = 0; e < DH; ++e) acc[e] = __fmaf_rn(w, vj[2 * e], acc[e]);
    }
  }

  if (!live) return;
  l = fmaxf(l, 1e-30f);
  float* o = p.out + ((static_cast<size_t>(bh) * G + g) * p.T + t) * D + h;
#pragma unroll
  for (int e = 0; e < DH; ++e) o[2 * e] = acc[e] / l;
}

}  // namespace

// D (the cache's storage head dim) must be 128 and G must divide kRows =
// 128 with T a multiple of TQ = min(128 / G, T).  Returns the CUDA error of
// the launch (0 on success).
extern "C" int bt_prefill_attn_i8(const void* q, const void* k, const void* v, const void* ks,
                                  const void* vs, const void* pos0, const void* lens, void* out,
                                  int BH, int G, int T, int S, int D, int win, float softcap,
                                  void* stream) {
  constexpr int kD = 128;
  const int TQ = G >= 1 && kRows % G == 0 ? (kRows / G < T ? kRows / G : T) : 0;
  if (D != kD || TQ < 1 || T % TQ != 0) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t configured = cudaFuncSetAttribute(
      prefill_attn_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<kD>()));
  if (configured != cudaSuccess) return static_cast<int>(configured);
  PrefillParams p{static_cast<const uint16_t*>(q), static_cast<const int8_t*>(k),
                  static_cast<const int8_t*>(v), static_cast<const float*>(ks),
                  static_cast<const float*>(vs), static_cast<const int*>(pos0),
                  static_cast<const int*>(lens), static_cast<float*>(out), G, T, TQ, S, win,
                  softcap};
  const dim3 grid(T / TQ, BH);
  prefill_attn_kernel<kD><<<grid, kThreads, smem_bytes<kD>(), static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
