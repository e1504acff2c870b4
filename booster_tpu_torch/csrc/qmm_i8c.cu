// Per-channel int8 matmul (i8c, weights="i8c").
//
// Replaces _i8c_kernel of booster_tpu/ops/pallas_qmm.py (via _tqmm_i8c; its
// 2-D pallas_call and its stacked one, whose layer index the wrapper turns
// into a pointer offset into [L, K, N]):
//   M = 1  -> mv_kernel (split-K matvec)
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
// mv_kernel gives each lane 4 consecutive columns (one 32-bit load per
// payload row: a warp reads 128 consecutive bytes of a row), one warp per
// 32 rows of K with all 32 loads in flight before the first is used, 8 warps
// per block over 128 columns, and K split across blocks (gridDim.y = K/256):
// qkv runs 48 x 16 blocks, the lm head 4096 -> 32000 250 x 16.  The warps
// add in warp order through shared memory; the blocks of a column tile
// write f32 partials and the last to arrive (an atomic ticket) adds them
// in split order and applies the scale, so a result repeats bit for bit.
// M = 64: still the payload bytes; M = 2048: the operations (2·M·N·K at the
// bf16 tensor-core rate).  Both run the tile of i8k_tile.cuh (the dq tile
// of qmm_i8t.cu with no group scales; the column scale multiplies each
// finished sum in the epilogue).

#include <cuda_runtime.h>
#include <stdint.h>

#include "i8k_tile.cuh"

namespace {

constexpr int kWarps = 8;                 // 32-row slices of K per mv block (one per warp)
constexpr int kRows = 32;                 // rows of K per warp
constexpr int kMvRows = kWarps * kRows;   // rows of K per mv block: 256
constexpr int kMvCols = 128;              // columns per mv block (4 per lane)

struct MvParams {
  const uint16_t* x;  // [1, K] bf16
  const int8_t* q;    // [K, N]
  const float* s;     // [1, N] f32
  float* out;         // [1, N] f32
  float* part;        // [K/256, N] f32 partials (K > 256), else null
  int* tickets;       // [N / 128] zeros, reset by the last block
  int K, N;
};

__global__ void __launch_bounds__(kWarps * 32) mv_kernel(MvParams p) {
  __shared__ float xs[kMvRows];
  __shared__ float red[kWarps][kMvCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ks = blockIdx.y, KS = gridDim.y;
  const int n0 = blockIdx.x * kMvCols;
  const int k0 = ks * kMvRows;
  for (int i = threadIdx.x; i < kMvRows; i += blockDim.x) xs[i] = bf16f(__ldg(p.x + k0 + i));
  __syncthreads();

  const int col = n0 + lane * 4;
  uint32_t b[kRows];
  const int8_t* w = p.q + static_cast<size_t>(k0 + warp * kRows) * p.N + col;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    b[r] = __ldg(reinterpret_cast<const uint32_t*>(w + static_cast<size_t>(r) * p.N));
  const float* x = xs + warp * kRows;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[j] = __fmaf_rn(x[r], static_cast<float>(static_cast<int8_t>((b[r] >> (8 * j)) & 0xffu)),
                         acc[j]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) red[warp][lane * 4 + j] = acc[j];
  __syncthreads();

  // block sums in warp order: thread i < 128 takes column n0 + i
  const int i = threadIdx.x;
  float t = 0.f;
  if (i < kMvCols) {
#pragma unroll
    for (int v = 0; v < kWarps; ++v) t = __fadd_rn(t, red[v][i]);
  }
  if (KS > 1) {
    if (i < kMvCols) p.part[static_cast<size_t>(ks) * p.N + n0 + i] = t;
    if (!i8t::arrive_last(p.tickets + blockIdx.x, KS)) return;
    if (i < kMvCols) t = i8t::sum_splits(p.part + n0 + i, p.N, KS);
  }
  if (i < kMvCols) p.out[n0 + i] = __fmul_rn(t, __ldg(p.s + n0 + i));
}

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

// y [1, N] f32 = x [1, K] @ q · s for K a multiple of 256 and N of 128.
// part: (K/256)·N floats (null when K = 256); tickets: N/128 zeros.
// Returns the CUDA error of the launch (0 on success).
extern "C" int bt_qmm_i8c_mv(const void* x, const void* q, const void* s, void* out, void* part,
                             void* tickets, int K, int N, void* stream) {
  MvParams p{static_cast<const uint16_t*>(x), static_cast<const int8_t*>(q),
             static_cast<const float*>(s), static_cast<float*>(out), static_cast<float*>(part),
             static_cast<int*>(tickets), K, N};
  const dim3 grid(N / kMvCols, K / kMvRows);
  mv_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
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
