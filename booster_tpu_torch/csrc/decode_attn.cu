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
// [Np, Hkv, P, D] (scales [Np, Hkv, P]).  Each column's row is looked up as
// its copy is issued (a stage may cross a page when a window starts it
// mid-page); the rest of the kernel is the dense one.  Pages that several
// slots share (a common prompt prefix) are read by each of their blocks, so
// part of that traffic hits L2.
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
// are cast exactly and the scales stay out of the [S, D] tiles, as in the TPU
// kernel: s_j = (q · k_j) · ks_j (the scale after the dot), l sums the
// unrounded p_j, and PV takes bf16(p_j · vs_j) against v_j.  The self term's
// k/v (bf16 rows not yet in the cache) go through the storage round trip
// first, in f32 through the append's own helpers (int8_row.cuh), so it is
// the row the append will write; a zero row stays zero.  The int8 form
// moves half the cache bytes.
//
// The storage width D (head dims up to 128 at 128 lanes, Gemma's 256 at
// 256) is a template parameter of the dense and the paged forms.  At D = 256
// the bf16 stages hold 64 columns (attn_mma.cuh), so slices round to 64
// columns there and warps 4-7 take no column of a stage (stage_scores and
// stage_pv cap a stage's columns at its kCols, whatever is left of the
// slice, on every stage of a page as of a dense range), and both forms run
// one block an SM (their shared memory, 150 KB).  A 256-row page is then 4
// bf16 stages or 2 int8 ones; each column's row still comes through the
// table as its copy is issued.
//
// What bounds it on the H100: the K and V bytes of the valid columns,
// 2·2·D bytes per column per kv head (int8: 2·(D + 4)), over 3.35 TB/s; the
// FLOPs (4·G·D per column) are far below the tensor cores' rate.  At B = 1
// the bytes are a few MB, so the time is latency: how many SMs read at once
// and how many round trips each makes.  Design:
// - Split over the cache (flash-decoding): the grid is (B·Hkv, nsplit), and
//   block s takes slice s of the slot's live range [lo, hi), which it works
//   out from lens on the card (the host never reads lens).  Slices are
//   ceil((hi - lo) / nsplit) columns rounded up to a 128-column stage, so a
//   short range takes fewer slices; blocks past the last live slice exit.
//   The wrapper picks nsplit from (B, Hkv, S) and the cache type alone: the
//   blocks the card holds at once (two an SM over an int8 cache, one over
//   bf16, whose ring takes 143 KB of shared memory; 1 at B = 64, where the
//   batch and paged forms keep one block per (slot, kv head)).
// - Each live slice's block writes its (m, l, acc) to f32 scratch; the block
//   that arrives last (an atomic ticket per (slot, kv head), reset by that
//   block) merges them in slice order in f32, adds the self term once and
//   writes out.  A range of one slice is finished by its block directly.
//   One launch per call: no second merge kernel.
// - In a block, attn_mma.cuh's stage: 128-column stages through a 2-stage
//   cp.async ring, the tiles kept bf16 or int8 in shared memory; the G query
//   heads are the rows of one m16 tile (rows past G are zero) and the 8
//   warps split each stage's columns, 16 each, whatever G, each with its own
//   (l, acc) against the stage's shared running max, added across warps at
//   the end (the G live rows only).  q and the self term's k and v rows are
//   copied in with the first stage, before lens is read.  Each slice's
//   bf16(p) is rounded against its own running max, as decode_attn_limit
//   allows (a weight moves by at most 2^-8 of itself).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "attn_mma.cuh"
#include "bf16_ops.cuh"
#include "int8_row.cuh"

namespace {

using attn::kNeg;
using attn::kThreads;
using attn::kWarps;
constexpr int kMaxG = 16;
// shared memory: the ring, then (reusing it) the merge area; past both the
// q rows and the self term's k and v rows
template <bool Q, int D>
constexpr int kQOff = 2 * attn::Tile<Q, D>::bytes > attn::Merge<D>::bytes
                          ? 2 * attn::Tile<Q, D>::bytes : attn::Merge<D>::bytes;
template <bool Q, int D>
constexpr int kSmem = kQOff<Q, D> + 16 * attn::kQRow<D> + 2 * D * 2;

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
  int nsplit;           // slices of the live range
  float* part;          // nsplit > 1: [B·Hkv, nsplit, G, D + 2] f32 scratch
  int* tickets;         // nsplit > 1: [B·Hkv] zeros, reset by the last blocks
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

// true in every thread of the block that arrives last of `expect`, whose
// earlier blocks' writes it then sees; that block resets the ticket
__device__ __forceinline__ bool arrive_last(int* ticket, int expect) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool l = atomicAdd(ticket, 1) == expect - 1;
    if (l) *ticket = 0;
    last = l;
  }
  __syncthreads();
  const bool l = last;
  if (l) __threadfence();
  return l;
}

// The self term and the output, from the merged (M, L, acc) of the G heads
// in the merge area's rows 0 .. G - 1: a warp per head, lane owning dims
// lane + 32·e (every warp holds the self k and v rows; for int8 their
// storage round trip).
template <bool Q, int D>
__device__ void finish(const AttnParams& p, uint8_t* sm, int bh, bool self_term) {
  constexpr int DL = D / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* rowM = reinterpret_cast<const float*>(sm + attn::Merge<D>::rowM);
  const float* rowL = reinterpret_cast<const float*>(sm + attn::Merge<D>::rowL);
  const uint8_t* qs = sm + kQOff<Q, D>;
  const uint16_t* self_kv = reinterpret_cast<const uint16_t*>(qs + 16 * attn::kQRow<D>);
  float skr[DL], svr[DL];
  if (self_term) {
#pragma unroll
    for (int e = 0; e < DL; ++e) {
      skr[e] = bf16f(self_kv[lane + 32 * e]);
      svr[e] = bf16f(self_kv[D + lane + 32 * e]);
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
  for (int g = warp; g < p.G; g += kWarps) {
    const float* a = attn::merged_row<D>(sm, g, kWarps);
    float acc[DL];
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[e] = a[lane + 32 * e];
    float l = rowL[g];
    if (self_term) {
      const uint16_t* qg = reinterpret_cast<const uint16_t*>(qs + g * attn::kQRow<D>);
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < DL; ++e) s = __fmaf_rn(bf16f(qg[lane + 32 * e]), skr[e], s);
      s = warp_sum(s);
      if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
      const float m_prev = rowM[g];
      const float m2 = fmaxf(m_prev, s);
      const float alpha = expf(m_prev - m2);
      const float ps_self = expf(s - m2);
#pragma unroll
      for (int e = 0; e < DL; ++e) acc[e] = acc[e] * alpha + ps_self * svr[e];
      l = l * alpha + ps_self;
    }
    l = fmaxf(l, 1e-30f);
#pragma unroll
    for (int e = 0; e < DL; ++e)
      p.out[(static_cast<size_t>(bh) * p.G + g) * D + lane + 32 * e] = acc[e] / l;
  }
}

template <bool Q, bool Paged, int D>
__global__ void __launch_bounds__(kThreads, Q && D == 128 ? 2 : 1)
    decode_attn_kernel(AttnParams p) {
  using T = attn::Tile<Q, D>;
  using Mg = attn::Merge<D>;
  constexpr int kCols = T::kCols;
  extern __shared__ __align__(16) uint8_t sm[];
  const int bh = blockIdx.x, split = blockIdx.y;  // bh = b * Hkv + h
  const int b = bh / p.Hkv, h = bh % p.Hkv, G = p.G;
  const int tid = threadIdx.x, warp = tid >> 5;
  // q (rows past G zero) and the self term's k and v rows come in with the
  // first stage, into shared memory past the ring and the merge area; issued
  // first, as they do not wait for lens
  uint8_t* qs = sm + kQOff<Q, D>;
  uint16_t* self_kv = reinterpret_cast<uint16_t*>(qs + 16 * attn::kQRow<D>);  // [2][D]
  const uint16_t* qb = p.q + static_cast<size_t>(bh) * G * D;
  attn::load_q<D>(qs, 16, p.q, [&](int r) { return r < G ? qb + r * D : nullptr; });
  if (p.sk != nullptr && tid < 2 * (D / 8)) {
    const int e = tid % (D / 8);
    const uint16_t* src = (tid < D / 8 ? p.sk : p.sv) + static_cast<size_t>(bh) * D + e * 8;
    attn::cp_async16(self_kv + (tid / (D / 8)) * D + e * 8, src, true);
  }
  const int lens = p.lens[b];
  const int ok = p.self_ok != nullptr && p.self_ok[b] > 0;
  const bool self_term = ok && p.sk != nullptr;
  const int lo = max(lens - p.win + ok, 0);
  const int hi = min(lens, p.S);
  // this block's slice: whole stages; a slot whose range fits one slice is
  // served by block 0 alone
  const int n = max(hi - lo, 0);
  const int per = (n + p.nsplit - 1) / p.nsplit;
  const int span = (per + kCols - 1) / kCols * kCols;
  const int live = span > 0 ? (n + span - 1) / span : 0;
  if (split > 0 && split >= live) {  // no slice: let the q copies land first
    attn::cp_commit();
    attn::cp_wait<0>();
    return;
  }
  const int s_lo = lo + split * span, s_hi = min(s_lo + span, hi);

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  auto rowof = [&](int c) { return kv_row<Paged>(p, b, h, c); };
  const int chunks = (s_hi - s_lo + kCols - 1) / kCols;  // 0 for an empty range
  // copy group c holds stage c; groups 0 and 1 are issued up front
  for (int c = 0; c < 2; ++c) {
    if (c < chunks)
      attn::load_stage<Q, D>(sm + c * T::bytes, p.k, p.v, p.ks, p.vs, s_lo + c * kCols, s_hi,
                             rowof);
    attn::cp_commit();
  }
  __shared__ float xm[kWarps * 16];  // the warps' row maxima of a stage
  for (int c = 0; c < chunks; ++c) {
    attn::cp_wait<1>();  // groups 0 .. c have landed (c + 1 may still fly)
    __syncthreads();
    uint8_t* st = sm + (c & 1) * T::bytes;
    const int c0 = s_lo + c * kCols, ncols = s_hi - c0;
    float s[1][2][4], mx[2];
    attn::stage_scores<Q, D, 1>(st, warp, 1, ncols, qs, p.softcap,
                                [&](int, int j) { return j < ncols; }, s, mx);
    attn::stage_max<kWarps>(xm, mx);
    attn::stage_pv<Q, D, 1>(st, warp, 1, ncols, s, mx, acc, m, l);
    __syncthreads();  // every warp is done with this stage (and with xm)
    if (c + 2 < chunks)
      attn::load_stage<Q, D>(st, p.k, p.v, p.ks, p.vs, c0 + 2 * kCols, s_hi, rowof);
    attn::cp_commit();
  }
  attn::cp_wait<0>();
  __syncthreads();  // the ring becomes the merge area
  attn::state_out<D>(sm, acc, m, l, G);
  __syncthreads();
  attn::merge_warps<D>(sm, G, kWarps);
  float* rowM = reinterpret_cast<float*>(sm + Mg::rowM);
  float* rowL = reinterpret_cast<float*>(sm + Mg::rowL);
  if (live <= 1) {
    finish<Q, D>(p, sm, bh, self_term);
    return;
  }
  // a slice of several: the partial to scratch, the last block merges
  const size_t stride = static_cast<size_t>(G) * (D + 2);
  float* mine = p.part + (static_cast<size_t>(bh) * p.nsplit + split) * stride;
  for (int e = tid; e < G * D; e += kThreads)
    mine[e] = attn::merged_row<D>(sm, e / D, kWarps)[e % D];
  if (tid < G) {
    mine[G * D + 2 * tid] = rowM[tid];
    mine[G * D + 2 * tid + 1] = rowL[tid];
  }
  if (!arrive_last(p.tickets + bh, live)) return;
  const float* base = p.part + static_cast<size_t>(bh) * p.nsplit * stride;
  float* fac = reinterpret_cast<float*>(sm + Mg::fac);  // [live][16]
  if (tid < G) {
    float M = kNeg;
    for (int s = 0; s < live; ++s) M = fmaxf(M, __ldcg(base + s * stride + G * D + 2 * tid));
    float L = 0.f;
    for (int s = 0; s < live; ++s) {
      const float f = expf(__ldcg(base + s * stride + G * D + 2 * tid) - M);
      L += f * __ldcg(base + s * stride + G * D + 2 * tid + 1);
      fac[s * 16 + tid] = f;
    }
    rowM[tid] = M;
    rowL[tid] = L;
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D;
    float a = 0.f;
    for (int s = 0; s < live; ++s) a += fac[s * 16 + g] * __ldcg(base + s * stride + e);
    attn::merged_row<D>(sm, g, kWarps)[e % D] = a;
  }
  __syncthreads();
  finish<Q, D>(p, sm, bh, self_term);
}

template <bool Q, bool Paged, int D>
cudaError_t launch(const AttnParams& p, int B, cudaStream_t st) {
  // raise the dynamic shared memory limit once (before any stream capture:
  // the first launch of each form does it)
  constexpr int smem = kSmem<Q, D>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      decode_attn_kernel<Q, Paged, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (configured != cudaSuccess) return configured;
  decode_attn_kernel<Q, Paged, D><<<dim3(B * p.Hkv, p.nsplit), kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

bool bad_split(int nsplit, const void* part, const void* tickets) {
  return nsplit < 1 || nsplit > attn::kMaxSplits
      || (nsplit > 1 && (part == nullptr || tickets == nullptr));
}

}  // namespace

// D (the cache's storage head dim) must be 128 (head dims up to 128 are
// stored lane-padded to it) or 256 (head dims 129-256), and G <= 16.  ks and
// vs non-null select the int8 form (k, v int8), null the bf16 form.  nsplit
// slices of the live range (1 .. 128); above 1, part is f32 scratch of
// B·Hkv·nsplit·G·(D + 2) and tickets B·Hkv int32 zeros (left zero).
// Returns the CUDA error of the launch (0 on success).
extern "C" int bt_decode_attn(const void* q, const void* k, const void* v, const void* ks,
                              const void* vs, const void* sk, const void* sv, const void* lens,
                              const void* self_ok, void* out, void* part, void* tickets, int B,
                              int Hkv, int G, int S, int D, int win, float softcap, int nsplit,
                              void* stream) {
  AttnParams p{static_cast<const uint16_t*>(q), k, v, static_cast<const float*>(ks),
               static_cast<const float*>(vs), static_cast<const uint16_t*>(sk),
               static_cast<const uint16_t*>(sv), static_cast<const int*>(lens),
               static_cast<const int*>(self_ok), static_cast<float*>(out),
               Hkv, G, S, win, softcap, nullptr, 0, 0, nsplit, static_cast<float*>(part),
               static_cast<int*>(tickets)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G > kMaxG || G < 1 || (D != 128 && D != 256) || (ks == nullptr) != (vs == nullptr)
      || bad_split(nsplit, part, tickets))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (D == 256)
    e = ks != nullptr ? launch<true, false, 256>(p, B, st) : launch<false, false, 256>(p, B, st);
  else
    e = ks != nullptr ? launch<true, false, 128>(p, B, st) : launch<false, false, 128>(p, B, st);
  return static_cast<int>(e);
}

// The paged form: k, v are layer l's pool [Np, Hkv, P, D] (bf16, or int8 with
// scales ks, vs [Np, Hkv, P] f32), table [B, maxp] int32; the rest as
// bt_decode_attn, with S = maxp · P and D 128 or 256.
extern "C" int bt_paged_decode_attn(const void* q, const void* k, const void* v, const void* ks,
                                    const void* vs, const void* sk, const void* sv,
                                    const void* table, const void* lens, const void* self_ok,
                                    void* out, void* part, void* tickets, int B, int Hkv, int G,
                                    int P, int maxp, int D, int win, float softcap, int nsplit,
                                    void* stream) {
  AttnParams p{static_cast<const uint16_t*>(q), k, v, static_cast<const float*>(ks),
               static_cast<const float*>(vs), static_cast<const uint16_t*>(sk),
               static_cast<const uint16_t*>(sv), static_cast<const int*>(lens),
               static_cast<const int*>(self_ok), static_cast<float*>(out),
               Hkv, G, P * maxp, win, softcap, static_cast<const int*>(table), P, maxp,
               nsplit, static_cast<float*>(part), static_cast<int*>(tickets)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G > kMaxG || G < 1 || (D != 128 && D != 256) || P < 1 || maxp < 1 || table == nullptr
      || (ks == nullptr) != (vs == nullptr) || bad_split(nsplit, part, tickets))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (D == 256)
    e = ks != nullptr ? launch<true, true, 256>(p, B, st) : launch<false, true, 256>(p, B, st);
  else
    e = ks != nullptr ? launch<true, true, 128>(p, B, st) : launch<false, true, 128>(p, B, st);
  return static_cast<int>(e);
}
