// The whole gated MLP over K-major int8 weights (i8t, Q8_0) in one launch:
//   out [M, C] bf16 = (silu(x @ Wg) · (x @ Wu)) @ Wd
//
// Replaces _mlp_i8_kernel of booster_tpu/ops/pallas_qmm.py (qmm_mlp).
//
// The TPU kernel walked the ff tiles in order on one core and carried the
// down product's sum in VMEM scratch.  Here the work is a queue of items
// that resident blocks take in order (an atomic counter):
//   1. the fused gate-up's items (i8k::gateup_item of i8k_tile.cuh: gate
//      columns j·64 + [0, 64) with the matching up columns, BM rows, one K
//      split); the item that finishes a pair (at one split the item itself,
//      else the last of its splits, which adds them in order) applies
//      silu·mul, writes that BM x 64 tile of mid [M, ff] (bf16, global
//      memory: 1.8 MB at M = 64, so it stays in the 50 MB L2) and raises the
//      tile's flag;
//   2. the down product's items (i8k::dq_item: a BM x 128 tile of [M, C]
//      over one split of ff), each of which first waits for the flags of
//      the mid tiles its split reads (their x rows then come in through
//      cp.async.cg, from L2); the last split of an output tile adds the
//      splits in order and writes bf16.
// A block waits only on items that running blocks already hold, and those
// never wait, so the queue needs no co-residency guarantee and the launch is
// an ordinary one (as many blocks as fit the card, asked of the occupancy
// query once).  The last block to leave resets the counters and flags.
//
// Bit-exactness: the items are the gate-up's and the matmul's own code
// (i8k_tile.cuh) with the rows a block and split counts those kernels take
// at this M (ops/qmm.py i8k_plan), so out equals qmm_i8t_gateup followed by
// qmm_i8t (dq form) and a cast to bf16, bit for bit, at every M.
//
// What bounds it on the H100: at decode (M <= 64) the 176 MB of payload and
// scales of a 7B layer over 3.35 TB/s (53 µs); mid and the f32 partials
// stay in L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "i8k_tile.cuh"

namespace {

struct MlpParams {
  i8k::Op gu;         // x [M, K] with the fused [K, 2ff] gate-up payload
  i8k::Op down;       // mid [M, ff] with the [ff, C] down payload
  float* part1;       // [KS1, M, 2ff] (KS1 > 1)
  uint16_t* mid;      // [M, ff] bf16
  float* part2;       // [KS2, M, C] (KS2 > 1)
  uint16_t* out;      // [M, C] bf16
  int* ws;            // zeros: counter, exits, flags, pair tickets, down tickets
  int K, ff, C, KS1, KS2;
};

template <int BM>
__global__ void __launch_bounds__(i8k::kThreads, i8k::Cfg<BM>::kMinBlocks)
    mlp_kernel(MlpParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = i8k::align_1k(smem_raw);
  __shared__ int item;
  const int mtiles = (p.gu.M + BM - 1) / BM;
  const int nF = p.ff / 64, nC = p.C / i8k::kBN;  // gate/up column pairs of 64; down tiles
  const int nA = mtiles * nF * p.KS1;
  const int nD = mtiles * nC * p.KS2;
  int* counter = p.ws;
  int* exits = p.ws + 1;
  int* flags = p.ws + 2;                           // [mtiles, nF]: mid tile written
  int* pair_tickets = flags + mtiles * nF;         // [mtiles, nF]
  int* down_tickets = pair_tickets + mtiles * nF;  // [mtiles, nC]
  for (;;) {
    __syncthreads();  // every thread has read the last item
    if (threadIdx.x == 0) item = atomicAdd(counter, 1);
    __syncthreads();
    int it = item;
    if (it < nA) {
      // gate/up column pairs in ff order, splits, then M tiles
      const int mt = it % mtiles;
      it /= mtiles;
      const int s = it % p.KS1;
      const int fj = it / p.KS1;
      if (i8k::gateup_item<BM, 32, false>(p.gu, p.ff, p.K, p.KS1, fj, s, mt, p.part1, p.mid,
                                          pair_tickets, sm)) {
        __threadfence();
        __syncthreads();
        if (threadIdx.x == 0) atomicExch(flags + mt * nF + fj, 1);
      }
    } else if (it < nA + nD) {
      // splits of ff in order (the first need the first mid tiles), then
      // output column tiles, then M tiles
      it -= nA;
      const int mt = it % mtiles;
      it /= mtiles;
      const int j = it % nC;
      const int s = it / nC;
      int kb, ke;
      i8k::split_range(p.ff, p.KS2, s, kb, ke);
      if (threadIdx.x == 0) {
        for (int f = kb / 64; f <= (ke - 1) / 64; ++f)
          while (atomicAdd(flags + mt * nF + f, 0) == 0) __nanosleep(64);
        __threadfence();
      }
      __syncthreads();
      i8k::dq_item<BM, 32, i8k::kBf16, false>(p.down, p.C, p.ff, p.KS2, j, s, mt, p.out,
                                              p.part2, down_tickets, nullptr, sm);
    } else {
      if (threadIdx.x == 0 && atomicAdd(exits, 1) == static_cast<int>(gridDim.x) - 1) {
        // every block has left its last item: zeros for the next launch
        for (int i = 0; i < mtiles * nF; ++i) flags[i] = 0;
        *counter = 0;
        *exits = 0;
        __threadfence();
      }
      return;
    }
  }
}

struct LaunchMlp {
  const MlpParams& p;
  cudaStream_t st;

  template <int BM>
  cudaError_t run() const {
    constexpr int bytes = i8k::Cfg<BM>::kSmem;
    static bool ready = false;
    static int blocks = 0;  // resident blocks of this kernel on the device (queried once)
    cudaError_t e = qring::allow_smem(mlp_kernel<BM>, bytes, ready);
    if (e != cudaSuccess) return e;
    if (blocks == 0) {
      int dev = 0, sms = 0, per_sm = 0;
      e = cudaGetDevice(&dev);
      if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mlp_kernel<BM>, i8k::kThreads,
                                                          bytes);
      if (e != cudaSuccess) return e;
      blocks = sms * (per_sm > 0 ? per_sm : 1);
    }
    const int mtiles = (p.gu.M + BM - 1) / BM;
    const int items = mtiles * (p.ff / 64 * p.KS1 + p.C / i8k::kBN * p.KS2);
    mlp_kernel<BM><<<items < blocks ? items : blocks, i8k::kThreads, bytes, st>>>(p);
    return cudaGetLastError();
  }
};

}  // namespace

// Ints of zeroed workspace a launch with tiles of bm rows needs (it leaves
// them zero again).
extern "C" int bt_mlp_i8t_ws_ints(int M, int ff, int C, int bm) {
  const int mtiles = (M + bm - 1) / bm;
  return 2 + 2 * mtiles * (ff / 64) + mtiles * (C / i8k::kBN);
}

// out [M, C] bf16 = (silu(x @ Wg) · (x @ Wu)) @ Wd with the fused [K, 2ff]
// gate-up payload qgu / scales sgu and the [ff, C] down payload qd / scales
// sd, group 32; tiles of bm rows, the gate-up split KS1 ways over K, the
// down product KS2 ways over ff (ops/qmm.py i8k_plan of each).  part1:
// KS1·M·2ff floats (null when KS1 = 1), mid: M·ff bf16, part2: KS2·M·C
// floats (null when KS2 = 1), ws: bt_mlp_i8t_ws_ints zeros.  Returns the
// CUDA error (0 on success).
extern "C" int bt_mlp_i8t(const void* x, const void* qgu, const void* sgu, const void* qd,
                          const void* sd, void* part1, void* mid, void* part2, void* out, void* ws,
                          int M, int K, int ff, int C, int KS1, int KS2, int bm, void* stream) {
  MlpParams p{{static_cast<const uint16_t*>(x), static_cast<const int8_t*>(qgu),
               static_cast<const uint16_t*>(sgu), K, 2 * ff, M},
              {static_cast<const uint16_t*>(mid), static_cast<const int8_t*>(qd),
               static_cast<const uint16_t*>(sd), ff, C, M},
              static_cast<float*>(part1), static_cast<uint16_t*>(mid),
              static_cast<float*>(part2), static_cast<uint16_t*>(out), static_cast<int*>(ws),
              K, ff, C, KS1, KS2};
  return static_cast<int>(i8k::dispatch(bm, LaunchMlp{p, static_cast<cudaStream_t>(stream)}));
}
