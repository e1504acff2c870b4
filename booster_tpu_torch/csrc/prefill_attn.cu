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
// bytes per column per kv head, each) over 3.35 TB/s; the G·T·(live
// columns)·D·4 operations of QK^T and PV are small beside the tensor cores'
// rate (at G = 1, T = 32, 64 slots of 16 kv heads, pos0 200: 84 MB against
// 2 GFLOP).  Design: one block per (bh, tile of G·TQ query rows),
// TQ = min(128 / G, T), so the G heads and TQ positions of a tile share every
// K/V stage and a block reads only the columns its rows can see; the last
// tile of a chunk may be partial (T need not be a multiple of TQ).  The
// products run on the tensor cores (attn_mma.cuh): mma.sync m16n8k16, bf16
// in, f32 accumulate, each warp owning 16 query rows, the (g, t) pairs
// flattened.  wgmma would need 64-row tiles, and at G = 1 a (slot, head) has
// only 16 or 32 query rows, so mma.sync is the tile here.  K and V stay int8
// in device memory and come in 128-column stages through a 2-stage cp.async
// ring with their scales; the fragments are cast to bf16 as they are built.
// No idle rows at G = 1: the tile's m16 tiles (1 at T 16, 2 at T 32, 8 at
// G·T >= 128) take the 8 warps between them, and the warps that share a
// tile split each stage's 16-column sub-blocks (8 warps on 8 sub-blocks at
// T 16, 4 on 2 each at T 32), each with its own (l, acc) against the
// stage's shared running max; at the end they add them in shared memory
// (f32, in warp order), or, where a warp holds a tile alone (G·T >= 128),
// it writes its rows from registers.  A stage's bf16(p · vs) are rounded
// against the max of the columns up to that stage, as the chunked kernel
// before this one did (prefill_attn_limit).  The block's q rows (36 KB at
// 128 rows) come in with the first stage, before pos0 and lens are read;
// with the ring (74 KB) two blocks fit an SM.  At the storage width D =
// 256 (Gemma's head dim, a template parameter) a block holds 64 query rows
// (TQ = min(64 / G, T)): the accumulator of a warp's rows doubles (128 f32
// a thread) and a stage's rows are 272 bytes, so the ring (141 KB) and 64
// q rows take 176 KB, one block an SM.  Measured limits (PERF.md
// §6, PR 11): at G·T >= 128 each warp casts the whole stage's K and V to
// bf16 for its own rows, eight times over a block.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "attn_mma.cuh"
#include "bf16_ops.cuh"

namespace {

using attn::kNeg;
using attn::kThreads;

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
  int tiles;          // m16 tiles of a block's rows
};

// shared memory: the ring, then (reusing it) the merge area; past both the
// block's q rows
template <int D>
constexpr int kQOff = 2 * attn::Tile<true, D>::bytes > attn::Merge<D>::fac
                          ? 2 * attn::Tile<true, D>::bytes : attn::Merge<D>::fac;
template <int D>
constexpr int kSmem = kQOff<D> + attn::kRowsOf<D> * attn::kQRow<D>;

// CS: the warps that share an m16 tile's rows (8 / the tiles rounded up to a
// power of 2); each takes kSubs / CS sub-blocks of a stage
template <int CS, int D>
__global__ void __launch_bounds__(kThreads, D == 128 ? 2 : 1) prefill_attn_kernel(PrefillParams p) {
  using T = attn::Tile<true, D>;
  constexpr int kCols = T::kCols;
  constexpr int NSB = T::kSubs / CS;
  extern __shared__ __align__(16) uint8_t sm[];
  const int bh = blockIdx.y;
  const int G = p.G, TQ = p.TQ;
  const int t0 = blockIdx.x * TQ;
  const int tn = min(TQ, p.T - t0);  // positions of this tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gid = lane >> 2;
  const int tile = warp / CS, part = warp % CS;
  const bool busy = tile < p.tiles;
  // the block's q rows (rows past the tile zero) come in with the first
  // stage, into shared memory past the ring; issued first, as they do not
  // wait for pos0 and lens
  uint8_t* qs = sm + kQOff<D>;
  attn::load_q<D>(qs, p.tiles * 16, p.q, [&](int r) {
    return r < G * TQ && r % TQ < tn
        ? p.q + ((static_cast<size_t>(bh) * G + r / TQ) * p.T + t0 + r % TQ) * D : nullptr;
  });
  const int pos0 = p.pos0[bh], lens = p.lens[bh];
  const int lo = max(pos0 + t0 - p.win + 1, 0);
  const int hi = min(pos0 + t0 + tn, lens);

  // this warp's rows 16·tile + gid (h = 0) and + 8 (h = 1): head r / TQ,
  // position t0 + r % TQ
  int qpos[2];
  bool row_ok[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * tile + gid + 8 * hh;
    row_ok[hh] = busy && r < G * TQ && r % TQ < tn;
    qpos[hh] = pos0 + t0 + r % TQ;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  const size_t base = static_cast<size_t>(bh) * p.S;
  auto rowof = [&](int c) { return base + c; };
  const int chunks = max(hi - lo, 0) > 0 ? (hi - lo + kCols - 1) / kCols : 0;
  for (int c = 0; c < 2; ++c) {  // copy group c holds stage c
    if (c < chunks)
      attn::load_stage<true, D>(sm + c * T::bytes, p.k, p.v, p.ks, p.vs, lo + c * kCols, hi,
                                rowof);
    attn::cp_commit();
  }
  __shared__ float xm[attn::kWarps * 16];  // the warps' row maxima of a stage
  for (int c = 0; c < chunks; ++c) {
    attn::cp_wait<1>();  // groups 0 .. c have landed
    __syncthreads();
    uint8_t* st = sm + (c & 1) * T::bytes;
    const int c0 = lo + c * kCols, ncols = hi - c0;
    float s[NSB][2][4], mx[2] = {kNeg, kNeg};
    if (busy)
      attn::stage_scores<true, D, NSB>(st, part, CS, ncols, qs + 16 * tile * attn::kQRow<D>,
                                       p.softcap,
                                    [&](int hh, int j) {
        const int col = c0 + j;
        return row_ok[hh] && col < hi && col <= qpos[hh] && col >= qpos[hh] - p.win + 1;
      }, s, mx);
    attn::stage_max<CS>(xm, mx);
    if (busy) attn::stage_pv<true, D, NSB>(st, part, CS, ncols, s, mx, acc, m, l);
    __syncthreads();  // every warp is done with this stage (and with xm)
    if (c + 2 < chunks)
      attn::load_stage<true, D>(st, p.k, p.v, p.ks, p.vs, c0 + 2 * kCols, hi, rowof);
    attn::cp_commit();
  }
  attn::cp_wait<0>();
  if constexpr (CS == 1) {  // one warp a tile: its rows are done, out from registers
    const int tig = lane & 3;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      if (!row_ok[hh]) continue;
      const int r = 16 * tile + gid + 8 * hh;
      const float l_r = fmaxf(l[hh], 1e-30f);
      float* o = p.out + ((static_cast<size_t>(bh) * G + r / TQ) * p.T + t0 + r % TQ) * D;
#pragma unroll
      for (int q = 0; q < D / 32; ++q) {
        *reinterpret_cast<float4*>(o + 32 * q + 8 * tig) =
            make_float4(acc[4 * q][2 * hh] / l_r, acc[4 * q + 1][2 * hh] / l_r,
                        acc[4 * q + 2][2 * hh] / l_r, acc[4 * q + 3][2 * hh] / l_r);
        *reinterpret_cast<float4*>(o + 32 * q + 8 * tig + 4) =
            make_float4(acc[4 * q][2 * hh + 1] / l_r, acc[4 * q + 1][2 * hh + 1] / l_r,
                        acc[4 * q + 2][2 * hh + 1] / l_r, acc[4 * q + 3][2 * hh + 1] / l_r);
      }
    }
    return;
  }
  __syncthreads();  // the ring becomes the merge area
  attn::state_out<D>(sm, acc, m, l, 16);
  __syncthreads();
  attn::merge_warps<D>(sm, p.tiles * 16, CS);
  const float* rowL = reinterpret_cast<const float*>(sm + attn::Merge<D>::rowL);
  for (int e = tid; e < p.tiles * 16 * (D / 4); e += kThreads) {
    const int r = e / (D / 4), d = (e % (D / 4)) * 4;
    if (r >= G * TQ || r % TQ >= tn) continue;
    const float l_r = fmaxf(rowL[r], 1e-30f);
    const float4 a = *reinterpret_cast<const float4*>(attn::merged_row<D>(sm, r, CS) + d);
    float* o = p.out + ((static_cast<size_t>(bh) * G + r / TQ) * p.T + t0 + r % TQ) * D + d;
    *reinterpret_cast<float4*>(o) = make_float4(a.x / l_r, a.y / l_r, a.z / l_r, a.w / l_r);
  }
}

template <int CS, int D>
cudaError_t launch(const PrefillParams& p, dim3 grid, cudaStream_t st) {
  constexpr int smem = kSmem<D>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      prefill_attn_kernel<CS, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (configured != cudaSuccess) return configured;
  prefill_attn_kernel<CS, D><<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const PrefillParams& p, dim3 grid, cudaStream_t st) {
  return p.tiles == 1 ? launch<8, D>(p, grid, st)
         : p.tiles == 2 ? launch<4, D>(p, grid, st)
         : p.tiles <= 4 ? launch<2, D>(p, grid, st) : launch<1, D>(p, grid, st);
}

}  // namespace

// D (the cache's storage head dim) must be 128 or 256 and G must divide the
// block's rows R (128 at D = 128, 64 at D = 256); the tiles hold TQ =
// min(R / G, T) positions (the last one fewer when TQ does not divide T).
// Returns the CUDA error of the launch (0 on success).
extern "C" int bt_prefill_attn_i8(const void* q, const void* k, const void* v, const void* ks,
                                  const void* vs, const void* pos0, const void* lens, void* out,
                                  int BH, int G, int T, int S, int D, int win, float softcap,
                                  void* stream) {
  const int rows = D == 256 ? attn::kRowsOf<256> : attn::kRowsOf<128>;
  if ((D != 128 && D != 256) || G < 1 || rows % G != 0 || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int TQ = rows / G < T ? rows / G : T;
  const int tiles = (G * TQ + 15) / 16;
  PrefillParams p{static_cast<const uint16_t*>(q), static_cast<const int8_t*>(k),
                  static_cast<const int8_t*>(v), static_cast<const float*>(ks),
                  static_cast<const float*>(vs), static_cast<const int*>(pos0),
                  static_cast<const int*>(lens), static_cast<float*>(out), G, T, TQ, S, win,
                  softcap, tiles};
  const dim3 grid((T + TQ - 1) / TQ, BH);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = D == 256 ? launch_d<256>(p, grid, st) : launch_d<128>(p, grid, st);
  return static_cast<int>(e);
}
