// Per-channel int8 matmul (i8c, weights="i8c").
//
// Replaces _i8c_kernel of booster_tpu/ops/pallas_qmm.py (via _tqmm_i8c; its
// 2-D pallas_call and its stacked one, whose layer index the wrapper turns
// into a pointer offset into [L, K, N]):
//   M = 1  -> mv_kernel (the streaming matvec of i8mv.cuh)
//   M > 1  -> mm_kernel (the wgmma tile of i8k_tile.cuh, no group scales)
//
// y[m, n] = (sum_k bf16(x[m, k]) · q[k, n]) · s[n]
// Payload q [K, N] int8 (K-major: consecutive output columns are
// consecutive bytes); s [1, N] f32, one symmetric scale per output channel
// (quant/qtensor.py channel_quantize).  The sum is f32 over exact products
// (a bf16 times an int8 fits f32's mantissa), and the scale multiplies the
// finished sum once, as the reference's rank-1 rescale after its dot does.
// The H100 has no bf16 x int8 MMA: the M > 1 form converts each int8 to
// bf16 in registers (exact for |q| <= 128) and runs wgmma on bf16.
//
// What bounds it on the H100.  M = 1: the payload, 1 byte a weight, over
// 3.35 TB/s (qkv 4096 -> 6144: 25 MB, 7.5 us; the 7B decode token: 7.11 GB).
// mv_kernel is i8mv.cuh's block with no group scales: a lane streams 4
// columns of 32-row chunks of K through a register ring of two, 8 warps a
// 128-column tile over one K split, a tile's KS splits one cluster that adds
// them in split order through distributed shared memory and scales each
// column once (ops/qmm.py mv_plan gives KS).
// M = 64: still the payload bytes; M = 2048: the operations (2·M·N·K at the
// bf16 tensor-core rate).  Both run the tile of i8k_tile.cuh (the dq tile
// of qmm_i8t.cu with no group scales; the column scale multiplies each
// finished sum in the epilogue).

#include <cuda_runtime.h>
#include <stdint.h>

#include "i8k_tile.cuh"
#include "i8mv.cuh"

namespace {

struct MmParams {
  i8k::Op op;       // x [M, K] bf16 with q [K, N]; op.s unused
  const float* s;   // [1, N] f32
  float* out;       // [M, N] f32
  int K, N, KS;
};

// Block (j, split, mt): the BM x 128 tile of rows mt·BM, columns j·128 over
// one K split, the tile's splits one cluster; y = sum · s[n].
template <int BM>
__global__ void __launch_bounds__(i8k::kThreads, i8k::Cfg<BM>::kMinBlocks)
    mm_kernel(MmParams p) {
  extern __shared__ uint8_t smem_raw[];
  i8k::dq_item<BM, 0, i8k::kScaled, true>(p.op, p.N, p.K, p.KS, blockIdx.x, blockIdx.y,
                                          blockIdx.z, p.out, nullptr, nullptr, p.s,
                                          i8k::align_1k(smem_raw));
}

struct LaunchMm {
  const MmParams& p;
  cudaStream_t st;

  template <int BM>
  cudaError_t run() const {
    constexpr int bytes = i8k::Cfg<BM>::kSmem;
    static bool ready = false;
    const cudaError_t e = qring::allow_smem(mm_kernel<BM>, bytes, ready);
    if (e != cudaSuccess) return e;
    return i8k::launch_split(mm_kernel<BM>, dim3(p.N / i8k::kBN, p.KS, (p.op.M + BM - 1) / BM),
                             bytes, st, p);
  }
};

}  // namespace

// y [1, N] f32 = x [1, K] @ q · s for K a multiple of 32 and N of 128 on
// i8mv.cuh: ks splits of K (ops/qmm.py mv_plan; one cluster a tile); x on
// 16 bytes.  Returns the CUDA error of the launch (0 on success).
extern "C" int bt_qmm_i8c_mv(const void* x, const void* q, const void* s, void* out, int K, int N,
                             int ks, void* stream) {
  const i8mv::Op op{static_cast<const uint16_t*>(x), static_cast<const int8_t*>(q), nullptr,
                    static_cast<const float*>(s), out, K, N, ks};
  return static_cast<int>(i8mv::run<0, false, i8mv::kScaled>(op, static_cast<cudaStream_t>(stream)));
}

// y [M, N] f32 = x [M, K] @ q · s on the tile of i8k_tile.cuh: bm rows of x
// a block, KS splits of K (ops/qmm.py i8k_plan: a power of two up to 8, one
// cluster a tile); K a multiple of 64, N of 128.  Returns the CUDA error of
// the launch.
extern "C" int bt_qmm_i8c_mm(const void* x, const void* q, const void* s, void* out, int M, int K,
                             int N, int KS, int bm, void* stream) {
  MmParams p{{static_cast<const uint16_t*>(x), static_cast<const int8_t*>(q), nullptr, K, N, M},
             static_cast<const float*>(s), static_cast<float*>(out), K, N, KS};
  return static_cast<int>(i8k::dispatch(bm, LaunchMm{p, static_cast<cudaStream_t>(stream)}));
}
