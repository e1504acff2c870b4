// The whole gated MLP over K-major int8 weights (i8t: Q8_0 at group 32, or
// Q5_K with mins planes on both weights; Q6_K at group 16) in one launch, a
// library for each epilogue (mlp_i8t.cu SiLU, mlp_i8t_gelu.cu GELU: 15
// kernels each, which ops/kernels.py builds at once, in about half the
// time one source of all 30 takes):
//   out [M, C] bf16 = (act(x @ Wg) · (x @ Wu)) @ Wd
// with act SiLU or the tanh-GELU of gated-GELU models (Gemma).
//
// Replaces _mlp_i8_kernel of booster_tpu/ops/pallas_qmm.py (qmm_mlp; its
// act branch as ACT, bf16_ops.cuh act_mul; its group as G, 32 or 16; its
// has_mins and d_has_mins forms as MINS, both together and at group 32
// only, the formats' forms: each product less its min term on the f32
// group sums of its bf16 input, x or mid, as i8k_tile.cuh computes it).
// At group 16 a 64-row stage of either product holds four groups' scale
// rows in place of two (the slot's 1 KB of scale rows, full); the items,
// ready counts and splits are the same.
//
// The TPU kernel walked the ff tiles in order on one core and carried the
// down product's sum in VMEM scratch.  Here the work is a queue of items
// that the blocks take in turn: an atomic counter hands out the ids of a
// range [first, first + n) in order (ops/mlp.py mlp_schedule is that order,
// the one the tests hold):
//   1. ids [0, nA), the fused gate-up's items (i8k::gateup_item of
//      i8k_tile.cuh: gate columns j·64 + [0, 64) with the matching up
//      columns, BM rows, one K split); the item that finishes a pair (at one
//      split the item itself, else the last of its splits, which adds them
//      in order) applies act·mul, writes that BM x 64 tile of mid [M, ff]
//      (bf16, global memory: 1.8 MB at M = 64, so it stays in the 50 MB L2)
//      and adds one to the ready count of the down split that reads it (64
//      mid columns are one stage of the down's K, so a pair lies in one
//      split);
//   2. ids [nA, nA + nD), the down product's items (i8k::dq_item: a BM x
//      128 tile of [M, C] over one split of ff), each of which first waits
//      until its split's ready count holds every pair (one thread polls
//      with backoff); its x rows (mid) come in through cp.async.cg, from
//      L2.  The last split of an output tile adds the splits in order and
//      writes bf16.
// Every down item comes after the gate-up items it reads, and blocks take
// ids in order, so a block waits only on items that running blocks already
// hold, and those never wait: the queue needs no co-residency guarantee
// and the launch is an ordinary one.  A range that starts at nA or later
// (the down items alone, on a mid computed before) does not wait.  The last
// block to leave zeroes the ready counts and the counters (its threads
// together).
//
// Bit-exactness: the items are the gate-up's and the matmul's own code
// (i8k_tile.cuh) with the rows a block and split counts those kernels take
// at this M (ops/qmm.py i8k_plan), so out equals qmm_i8t (dq form) on the
// fused gate-up weight, act·mul in bf16 (ops/qmm.py act_mul; with SiLU at
// M > 1 that is qmm_i8t_gateup), then qmm_i8t (dq form) on mid and a cast
// to bf16, bit for bit, at every M and on any number of blocks.
//
// What bounds it on the H100: at decode (M <= 64) the 176 MB of payload and
// scales of a 7B layer over 3.35 TB/s (53 µs); mid and the f32 partials
// stay in L2.  What bounds it in fact (tools/mlp_sched.py): a block streams
// an item at a rate set by the tile, whatever the queue; the gate-up's
// items all run at once and end together, so the down items wait for
// them, and the kernel takes about its gate-up items alone plus its down
// items alone.  The launch holds two blocks an SM (one at BM 256, where
// one fits) and is built for that residency: at BM 16 and 32 a third block
// an SM, which the tile's shared memory allows, put up to three gate-up
// items on one SM and none on another (the SM, not the queue, sets the
// pace).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "i8k_tile.cuh"

namespace {

// blocks an SM the kernel is built and launched for: two, or one where
// only one fits
template <int BM>
constexpr int kMlpBlocks = i8k::Cfg<BM>::kMinBlocks < 2 ? i8k::Cfg<BM>::kMinBlocks : 2;

struct MlpParams {
  i8k::Op gu;         // x [M, K] with the fused [K, 2ff] gate-up payload
  i8k::Op down;       // mid [M, ff] with the [ff, C] down payload
  float* part1;       // [KS1, M, 2ff] (KS1 > 1)
  uint16_t* mid;      // [M, ff] bf16
  float* part2;       // [KS2, M, C] (KS2 > 1)
  uint16_t* out;      // [M, C] bf16
  int* ws;            // zeros: counter, exits, ready [mtiles, 8], pair and down tickets
  int K, ff, C, KS1, KS2;
  int first, n_items;  // the item ids [first, first + n_items), taken in order
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

template <int BM, int G, bool MINS, int ACT>
__global__ void __launch_bounds__(i8k::kThreads, kMlpBlocks<BM>)
    mlp_kernel(MlpParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = i8k::align_1k(smem_raw);
  __shared__ int item;
  const int mtiles = (p.gu.M + BM - 1) / BM;
  const int nF = p.ff / 64, nC = p.C / i8k::kBN;  // gate/up column pairs of 64; down tiles
  const int nA = mtiles * nF * p.KS1;
  const bool wait = p.first < nA;  // the launch holds the gate-up items
  int* counter = p.ws;
  int* exits = p.ws + 1;
  int* ready = p.ws + 2;                            // [mtiles, kMaxSplits]: pairs written
  int* pair_tickets = ready + mtiles * i8k::kMaxSplits;  // [mtiles, nF]
  int* down_tickets = pair_tickets + mtiles * nF;   // [mtiles, nC]
  for (;;) {
    __syncthreads();  // every thread has read the last item
    if (threadIdx.x == 0) {
      const int q = atomicAdd(counter, 1);
      item = q < p.n_items ? p.first + q : -1;
    }
    __syncthreads();
    int it = item;
    if (it < 0) break;
    if (it < nA) {
      // id: (pair fj, split s, M tile mt), mt fastest
      const int mt = it % mtiles;
      it /= mtiles;
      const int s = it % p.KS1;
      const int fj = it / p.KS1;
      if (i8k::gateup_item<BM, G, false, MINS, ACT>(p.gu, p.ff, p.K, p.KS1, fj, s, mt,
                                                    p.part1, p.mid, pair_tickets, sm)) {
        __threadfence();
        __syncthreads();
        // the down split whose stages [s·nF/KS2, (s+1)·nF/KS2) hold stage fj
        if (threadIdx.x == 0)
          atomicAdd(ready + mt * i8k::kMaxSplits + ((fj + 1) * p.KS2 - 1) / nF, 1);
      }
    } else {
      // id - nA: (split s of ff, output column tile j, M tile mt), mt fastest
      it -= nA;
      const int mt = it % mtiles;
      it /= mtiles;
      const int j = it % nC;
      const int s = it / nC;
      int kb, ke;
      i8k::split_range(p.ff, p.KS2, s, kb, ke);
      if (wait && threadIdx.x == 0) {
        const int* r = ready + mt * i8k::kMaxSplits + s;
        const int need = (ke - kb) / 64;
        int ns = 32;
        for (long long spins = 0; ld_acquire(r) < need; ++spins) {
          if (spins == (1ll << 23)) __trap();  // over a second: a broken queue fails loudly
          __nanosleep(ns);
          ns = ns < 256 ? 2 * ns : ns;
        }
        __threadfence();
      }
      __syncthreads();
      i8k::dq_item<BM, G, i8k::kBf16, false, MINS>(p.down, p.C, p.ff, p.KS2, j, s, mt, p.out,
                                                   p.part2, down_tickets, nullptr, sm);
    }
  }
  // the queue is empty: the last block to leave zeroes the counts for the
  // next launch (every block has taken its last item)
  __shared__ int last;
  if (threadIdx.x == 0) last = atomicAdd(exits, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  for (int i = threadIdx.x; i < mtiles * i8k::kMaxSplits; i += i8k::kThreads) ready[i] = 0;
  if (threadIdx.x == 0) {
    *counter = 0;
    *exits = 0;
  }
  __threadfence();
}

// The launch of the forms the formats give with epilogue ACT: group 32 with
// or without mins (Q8_0, Q5_K), group 16 without (Q6_K).
template <int ACT>
struct LaunchMlp {
  const MlpParams& p;
  int grid;  // blocks; 0: kMlpBlocks an SM
  int G, mins;
  cudaStream_t st;

  template <int BM>
  cudaError_t run() const {
    if (G == 32) return mins ? go<BM, 32, true>() : go<BM, 32, false>();
    if (G == 16 && !mins) return go<BM, 16, false>();
    return cudaErrorInvalidValue;
  }

  template <int BM, int G_, bool MINS>
  cudaError_t go() const {
    constexpr int bytes = i8k::Cfg<BM, MINS>::kSmem;
    static bool ready = false;
    static int sms = 0;  // the device's SMs (asked once)
    cudaError_t e = qring::allow_smem(mlp_kernel<BM, G_, MINS, ACT>, bytes, ready);
    if (e != cudaSuccess) return e;
    if (sms == 0) {
      int dev = 0;
      e = cudaGetDevice(&dev);
      if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return e;
    }
    int blocks = grid > 0 ? grid : kMlpBlocks<BM> * sms;
    if (blocks > p.n_items) blocks = p.n_items;
    mlp_kernel<BM, G_, MINS, ACT><<<blocks, i8k::kThreads, bytes, st>>>(p);
    return cudaGetLastError();
  }
};

// Ints of zeroed workspace a launch with tiles of bm rows needs (it leaves
// them zero again): counter, exits, 8 ready counts an M tile, a ticket per
// gate/up pair and per down tile of each M tile.
inline int mlp_ws_ints(int M, int ff, int C, int bm) {
  const int mtiles = (M + bm - 1) / bm;
  return 2 + mtiles * (i8k::kMaxSplits + ff / 64 + C / i8k::kBN);
}

// out [M, C] bf16 = (act(x @ Wg) · (x @ Wu)) @ Wd with the fused [K, 2ff]
// gate-up payload qgu / scales sgu and the [ff, C] down payload qd / scales
// sd, group G (32, or 16 without mins), act by its code (bf16_ops.cuh: 0
// SiLU, 1 GELU); tiles of bm rows, the gate-up split KS1 ways over K, the
// down product KS2 ways over ff (ops/qmm.py i8k_plan of each).  part1:
// KS1·M·2ff floats (null when KS1 = 1), mid: M·ff bf16, part2: KS2·M·C
// floats (null when KS2 = 1), ws: bt_mlp_i8t_ws_ints zeros.  The launch
// runs the item ids [first, first + n_items) (ops/mlp.py mlp_plan: first 0
// and n_items nA + nD for the whole MLP; a part of it for the schedule's
// ablations, the down items alone on a mid computed before) on `grid`
// blocks, or two an SM when grid is 0.  mins = 1 (G 32): both weights hold
// a second (mins) plane after their scales.  Returns the CUDA error (0 on
// success; cudaErrorInvalidValue for a form not instantiated, an act other
// than the library's ACT among them).
template <int ACT>
int mlp_launch(const void* x, const void* qgu, const void* sgu, const void* qd, const void* sd,
               void* part1, void* mid, void* part2, void* out, void* ws, int M, int K, int ff,
               int C, int KS1, int KS2, int bm, int first, int n_items, int grid, int mins, int G,
               int act, void* stream) {
  if (act != ACT || (G != 16 && G != 32) || K % G || ff % G)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint16_t* sg = static_cast<const uint16_t*>(sgu);
  const uint16_t* sdn = static_cast<const uint16_t*>(sd);
  MlpParams p{{static_cast<const uint16_t*>(x), static_cast<const int8_t*>(qgu), sg, K, 2 * ff, M,
               mins ? sg + static_cast<size_t>(K / G) * 2 * ff : nullptr},
              {static_cast<const uint16_t*>(mid), static_cast<const int8_t*>(qd), sdn, ff, C, M,
               mins ? sdn + static_cast<size_t>(ff / G) * C : nullptr},
              static_cast<float*>(part1), static_cast<uint16_t*>(mid),
              static_cast<float*>(part2), static_cast<uint16_t*>(out), static_cast<int*>(ws),
              K, ff, C, KS1, KS2, first, n_items};
  return static_cast<int>(
      i8k::dispatch(bm, LaunchMlp<ACT>{p, grid, G, mins, static_cast<cudaStream_t>(stream)}));
}

}  // namespace
