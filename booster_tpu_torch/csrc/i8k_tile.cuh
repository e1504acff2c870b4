// The int8 K-major dequantize-then-multiply tile of qmm_i8t.cu (the M > 1
// matmul and the fused gate-up; the dq form at M = 1), qmm_i8c.cu (M > 1)
// and mlp_i8t.cu (both products of the whole MLP).
//
// y[M, N] = x[M, K] @ W[K, N] from an int8 payload q [K, ldq] (K-major: a
// row of K holds every output column).  i8t: W = bf16(f32(q) · f32(bf16 s))
// with the bf16 scale plane s [K/G, ldq], G = 32 (Q8_0, Q5_K, Q5_1) or 16
// (Q6_K); i8c (G = 0 here): W = bf16(q), exact, and the caller scales the
// finished f32 sum per column.  With mins (MINS: Q5_K and Q5_1, G = 32, a
// bf16 plane m [K/G, ldq]) y less the min term sum_g xs[m, g] · f32(bf16
// m[g, n]), xs the f32 sums of each group's bf16 x (the reference's
// _MIN_DOT form, pallas_qmm.py:47-74, :451-453: the sums never rounded to
// bf16).
//
// A block of two warpgroups owns a BM x 128 output tile (BM 16-256: wgmma's
// N; ops/qmm.py i8k_plan) and one split of K, walked in stages of 64 rows
// of K.  A ring of kRing raw stages in shared memory is filled with
// cp.async (cp_async.cuh): the stage's 64 x 128 payload bytes, its 64/G
// scale rows (once per group, not once per row) and the block's BM rows of
// x, each 128-byte row in the swizzle that wgmma and ldmatrix read without
// bank conflicts (16-byte chunk c of row r at chunk c ^ (r & 7)).
//
// The product is computed transposed, y^T = W^T x^T, so that the
// dequantized weight never goes back to shared memory: it is wgmma's A
// operand, in registers.  Warp w owns tile columns 16w + [0, 16): row j of
// its m16 slice is column 16w + 2j, row j + 8 column 16w + 2j + 1, the
// order in which ldmatrix.trans hands them out.  Per 8 rows of K it gives a
// thread the bytes of those two columns at two rows of K, already the
// byte-spread form that qring::dq_spread turns into a bf16 pair of the A
// fragment (bf16x2 instructions, one rounding of the exact product) with
// each column's group scale.  x is wgmma's B operand, read from the stage
// through a shared-memory descriptor; wgmma.mma_async m64nBMk16 (bf16 in,
// f32 accumulate) runs the stage's 4 k16 steps.  While they run, the
// warpgroup dequantizes the next stage into a second set of A registers; it
// waits for them (wgmma.wait_group 0) before it issues the next stage's:
// ptxas serializes every wgmma (warning C7513) if a stage's is issued while
// the last stage's, during which its A registers were written, is still in
// flight.  One barrier a stage; the slot
// of the stage before the last is refilled after it, so kRing - 2 stages
// are in flight ahead of the one being dequantized.  cp.async writes reach
// wgmma's async proxy through fence.proxy.async before the barrier.
//
// Mins (MINS, G = 32).  The min term runs on the tensor cores, as extra
// rows of K of the same transposed product: A = -m^T (registers, as the
// dequantized weight is) and B = [hi | mid | lo] of the f32 group sums xs
// (shared memory, as x is), bf16_ops.cuh split3: hi + mid + lo == xs
// exactly and each part times a bf16 min is exact in f32, so the term is
// the reference's f32 xs against f32(bf16 m) with no rounding of xs to
// bf16.  The stage's two mins rows ride the ring after its two scale rows
// (the slot's 1 KB of scale rows holds all four).  The group sums run on
// the tensor cores too from 128 rows a block: before a stage's wgmma is
// issued, each warp multiplies an m16 tile of the stage's x rows by a 0/1
// matrix E with mma.sync (4 k16 steps; exact products, f32 sums) — on the
// CUDA cores the sums of 128-256 rows cost more than the stage's
// dequantization and kept the tensor cores waiting, and an mma.sync issued
// while a wgmma is in flight waits for it; once the wgmma is issued, the
// sums' three parts go to the min term's B tile past the ring.  Below 128
// rows a thread sums one or two 16-byte chunks of x on the CUDA cores in
// the wgmma's shadow (group_sums_cc).  The stage's mins rows go to a small
// buffer beside the B tile in the next stage's preparation.  A batch is 4
// stages, 8 groups: one k16 step of [hi | mid] and one of [lo | 0] against
// A = [-m | -m] and [-m | 0] (a thread's two k slots of -m are its
// columns' mins of one stage's two groups).  The B tile holds two batches
// (k 0-31 and 32-63 of one 128-byte swizzled row a row of x) and the mins
// buffer two, so a batch's wgmma, issued with the next batch's first stage
// (its parts are fenced and behind that stage's barrier), has completed
// before its half is written again; the split's last batch runs after the
// loop, behind a barrier of its own.  2 k16 steps for the 16 of the main
// product and no CUDA-core pass over the accumulators.  (An accumulator of
// their own for the min term's steps at 16 and 32 rows a block measured
// slower.)  At BM 128 the ring holds 3 stages with mins (4 without), so that two blocks
// still fit an SM.  The gate-up's and the whole MLP's products run the
// same code per column (the down items on mid's group sums), so the
// bit-for-bit invariants below hold with mins too.
//
// The tile's sums go to shared memory (f32, over the ring).  At one split
// the block writes its output (f32, bf16, or the gate-up's act(g)·u)
// straight from there.  At KS splits (KS <= 8, a power of two: the plan's)
// the standalone kernels launch a tile's splits as one thread-block
// cluster, and block s adds rows [s·BM/KS, (s+1)·BM/KS) of the KS tiles
// through distributed shared memory, in split order: no f32 partials in
// device memory, no ticket.  The whole MLP's queue cannot form clusters: its
// items write f32 partials [KS, M, N], and the block that arrives last at
// the tile's ticket adds them in split order (qring::reduce_splits) and
// resets it.  Both add ((0 + p0) + p1) + ... and round alike.
//
// A gate-up tile holds gate columns col0 + [0, 64) (warpgroup 0) and up
// columns col1 + [0, 64) (warpgroup 1), col1 = ff + col0; a matmul tile 128
// consecutive columns (col1 = col0 + 64).  Every column goes through the
// same wgmma m64nBM instruction, the same k16 steps from zero over the same
// split's stages and the same split order in either, so the gate-up equals
// the matmul on its fused weight + act·mul, and the whole MLP its unfused
// kernels, bit for bit, as long as all of them take (BM, KS) from one plan
// (ops/qmm.py i8k_plan).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_ops.cuh"
#include "cp_async.cuh"
#include "i8t_tile.cuh"  // arrive_last, ldmatrix_x4
#include "qmm_ring.cuh"  // dq_spread, reduce_splits, allow_smem

namespace i8k {

constexpr int kBN = 128;       // output columns of a tile: one warpgroup each 64
constexpr int kBK = 64;        // rows of K a stage: 128 bytes of bf16 x a row, one swizzle row
constexpr int kThreads = 256;  // two warpgroups
constexpr int kMaxSplits = 8;  // a tile's splits form one cluster (its portable size)

template <int BM, bool MINS = false>
struct Cfg {
  static_assert(BM == 16 || BM == 32 || BM == 64 || BM == 128 || BM == 256,
                "a tile has 16, 32, 64, 128 or 256 rows");
  static constexpr int kRing = BM >= 128 ? (MINS && BM == 128 ? 3 : 4) : 5;  // stages of the ring
  static constexpr int kMinBlocks = BM == 256 ? 1 : BM >= 64 ? 2 : 3;  // blocks an SM
  static constexpr int kXB = BM * 128;            // x bytes of a stage
  static constexpr int kQB = kBK * kBN;           // payload bytes of a stage
  static constexpr int kSB = 1024;                // scale rows of a stage (64/G x 256 bytes)
  static constexpr int kSlot = kXB + kQB + kSB;   // a multiple of 1024
  static constexpr int kLdt = kBN + 4;            // floats a row of the output tile
  // MINS: the min term's B tile (BM rows of 128 bytes: two batches' parts)
  // and the -m rows of two batches ([2][8][128] bf16), past the ring
  static constexpr int kMinsB = MINS ? BM * 128 : 0;
  static constexpr int kMinsM = MINS ? 2 * 8 * kBN * 2 : 0;
  static constexpr int kSmem = kRing * kSlot + kMinsB + kMinsM + 1024;  // + slack to align on 1 KB
  static_assert(BM * kLdt * 4 <= kRing * kSlot, "the output tile fits over the ring");
};

// One product's operands.  x rows may be written by an earlier phase of the
// same launch (the MLP's mid): cp.async.cg reads them through L2.
struct Op {
  const uint16_t* x;  // bf16 [M, ldx]
  const int8_t* q;    // [K, ldq]
  const uint16_t* s;  // [K / G, ldq] bf16 (i8t), unused for i8c
  int ldx, ldq, M;
  const uint16_t* m = nullptr;  // [K / G, ldq] bf16 mins (MINS), else unused
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory from its first 1 KB boundary (the swizzle's
// period, which wgmma's descriptors assume).
__device__ __forceinline__ uint8_t* align_1k(uint8_t* raw) {
  return raw + ((1024u - (smem_addr(raw) & 1023u)) & 1023u);
}

// K rows [kb, ke) of split s of KS over K, on whole stages.
__device__ __forceinline__ void split_range(int K, int KS, int s, int& kb, int& ke) {
  const int nk = K / kBK;
  kb = static_cast<int>(static_cast<long long>(s) * nk / KS) * kBK;
  ke = static_cast<int>(static_cast<long long>(s + 1) * nk / KS) * kBK;
}

// -- the ring ----------------------------------------------------------------

// Stage k .. k + 63 into a slot, by all threads: the payload rows (16-byte
// chunk c: tile columns 16c .. 16c + 15, from col0 for c < 4, else col1;
// swizzled), for i8t the 64/G scale rows (then, with MINS, the 64/G mins
// rows), and x rows m0 .. m0 + BM - 1 (zeros past M; swizzled).
template <int BM, int G, bool MINS = false>
__device__ __forceinline__ void load_stage(const Op& op, int m0, int col0, int col1, int k,
                                           uint8_t* slot) {
  using C = Cfg<BM>;
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kBK * 8 / kThreads; ++i) {  // 64 rows x 8 chunks
    const int u = t + i * kThreads, r = u >> 3, c = u & 7;
    const int col = (c < 4 ? col0 : col1 - 64) + c * 16;
    cpasync::cp_async16(slot + C::kXB + r * 128 + ((c ^ (r & 7)) << 4),
                        op.q + static_cast<size_t>(k + r) * op.ldq + col, true);
  }
  if constexpr (G > 0) {
    constexpr int NG = kBK / G;
    if (t < (MINS ? 2 : 1) * NG * 16) {  // 64/G rows (and 64/G mins rows) x 16 chunks of 8 bf16
      const int rr = t >> 4, cs = t & 15;
      const int col = (cs < 8 ? col0 : col1 - 64) + cs * 8;
      const uint16_t* src = !MINS || rr < NG ? op.s + static_cast<size_t>(k / G + rr) * op.ldq
                                             : op.m + static_cast<size_t>(k / G + rr - NG) * op.ldq;
      cpasync::cp_async16(slot + C::kXB + C::kQB + rr * 256 + cs * 16, src + col, true);
    }
  }
#pragma unroll
  for (int i = 0; i < (BM * 8 + kThreads - 1) / kThreads; ++i) {  // BM rows x 8 chunks
    const int u = t + i * kThreads, r = u >> 3, c = u & 7;
    if (BM * 8 % kThreads == 0 || u < BM * 8) {
      const int row = m0 + r;
      const bool live = row < op.M;
      cpasync::cp_async16(slot + r * 128 + ((c ^ (r & 7)) << 4),
                          live ? op.x + static_cast<size_t>(row) * op.ldx + k + c * 8 : op.x,
                          live);
    }
  }
}

// -- wgmma ---------------------------------------------------------------------

// A shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (SBO), the leading offset unused by this layout.
__device__ __forceinline__ uint64_t desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3ffffu) >> 4) | (1ull << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// Registers that an issued wgmma reads or writes: the compiler may not move
// their definitions into the wgmma's pipeline stage (ptxas would serialize
// it) nor their uses before its wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i / 4][i % 4])::"memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d (64 x N) += A (64 x 16, bf16 in registers: the m16n8k16 A fragment of
// each warp's 16 rows) · B (16 x N, K-major at descriptor b)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// -- the tile ------------------------------------------------------------------

template <bool EVEN>
struct Parity {  // a stage's parity as a type (tile_sum's lambdas)
  static constexpr bool value = EVEN;
};

// The group sums of a stage on the tensor cores: its x rows (in the slot,
// swizzled) times E, E's column n all ones on the 32 rows of k of group n
// % 2 (mma.sync m16n8k16: exact products, f32 sums; k16 steps 0 and 2 in
// one accumulator, 1 and 3 in another, then their f32 sum), an m16 tile
// of rows a warp, the tiles dealt to both warpgroups in turn (tile w % 4 ·
// 2 + w / 4, + 8, ...: kSumTiles a warp).  xs[t]: tile t's sums, rows gid
// and gid + 8 of it, groups 0 and 1 (columns 2·tig and 2·tig + 1).
template <int BM>
constexpr int kSumTiles = BM >= 256 ? 2 : 1;

// Below 128 rows a block the sums stay on the CUDA cores (a thread's one or
// two 16-byte chunks of x, in the wgmma's shadow): one warp's mma.sync
// chain before each issue costs a small tile more than that
template <int BM>
constexpr bool kSumsOnTensorCores = BM >= 128;

__device__ __forceinline__ int sum_tile(int t) {  // this warp's m16 tile t of the stage
  const int w = threadIdx.x >> 5;
  return (w & 3) * 2 + (w >> 2) + 8 * t;
}

template <int BM>
__device__ __forceinline__ void group_sums(const uint8_t* slot, float (&xs)[kSumTiles<BM>][4]) {
  const int lane = threadIdx.x & 31, mat = lane >> 3, gid = lane >> 2;
#pragma unroll
  for (int t = 0; t < kSumTiles<BM>; ++t) {
    float odd[4] = {0.f, 0.f, 0.f, 0.f};  // k16 steps 1 and 3: two chains of two, not one of four
#pragma unroll
    for (int e = 0; e < 4; ++e) xs[t][e] = 0.f;
    if (sum_tile(t) < BM / 16) {  // warp-uniform
      const int r = sum_tile(t) * 16 + (mat & 1) * 8 + (lane & 7);  // this lane's ldmatrix row
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        i8t::ldmatrix_x4(a[kk], slot + r * 128 + (((2 * kk + (mat >> 1)) ^ (r & 7)) << 4), false);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // k16 steps 0, 1: group 0; 2, 3: group 1
        const uint32_t e = (gid & 1) == (kk >> 1) ? 0x3f803f80u : 0u;
        i8t::mma_bf16(kk & 1 ? odd : xs[t], a[kk], e, e);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[t][e] = __fadd_rn(xs[t][e], odd[e]);
    }
  }
}

// The same on the CUDA cores (BM < 128), in prepare: four threads a (row,
// group), each the sum of one 16-byte chunk's 8 values as a tree, ((v0 +
// v1) + (v2 + v3)) + ((v4 + v5) + (v6 + v7)), then (p0 + p1) + (p2 + p3)
// across the four lanes by shuffles (each lane then holds the sum); lane
// `part` of the four writes that part of it to pb as store_sum_parts does.
template <int BM>
__device__ __forceinline__ void group_sums_cc(const uint8_t* slot, uint8_t* pb, int q, int b) {
  constexpr int IT = (8 * BM + kThreads - 1) / kThreads;  // chunks a thread: 1 or 2
  uint4 v[IT];
#pragma unroll
  for (int j = 0; j < IT; ++j) {
    const int u = threadIdx.x + j * kThreads, r = u >> 3, c = u & 7;
    if (8 * BM % kThreads == 0 || u < 8 * BM)
      v[j] = *reinterpret_cast<const uint4*>(slot + r * 128 + ((c ^ (r & 7)) << 4));
  }
#pragma unroll
  for (int j = 0; j < IT; ++j) {
    const int u = threadIdx.x + j * kThreads, r = u >> 3, c = u & 7;
    if (8 * BM % kThreads == 0 || u < 8 * BM) {  // warp-uniform: 8·BM is 128 or k·256
      const uint32_t w[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
      float e[8];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        e[2 * h] = bf16f(w[h] & 0xffffu);
        e[2 * h + 1] = bf16f(w[h] >> 16);
      }
      float p = __fadd_rn(__fadd_rn(__fadd_rn(e[0], e[1]), __fadd_rn(e[2], e[3])),
                          __fadd_rn(__fadd_rn(e[4], e[5]), __fadd_rn(e[6], e[7])));
      p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, 1));
      p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, 2));
      const int k = c & 3;  // this lane's part
      if (k < 3) {
        uint16_t part[3];
        split3(p, part);
        *reinterpret_cast<uint16_t*>(pb + r * 128 + (((4 * q + k) ^ (r & 7)) << 4)
                                     + (2 * b + (c >> 2)) * 2) =
            k == 0 ? part[0] : k == 1 ? part[1] : part[2];
      }
    }
  }
}

// The stage's group sums xs (group_sums) → the min term's B tile pb (BM rows
// of 128 bytes, swizzled as x) as their three bf16 parts at k = 32q +
// 8·part + 2b + g (group g of stage b of a batch of parity q): lane tig < 3
// of each quad writes part tig of its rows' sums.
template <int BM>
__device__ __forceinline__ void store_sum_parts(const float (&xs)[kSumTiles<BM>][4], uint8_t* pb,
                                                int q, int b) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, k = lane & 3;
  if (k == 3) return;
#pragma unroll
  for (int t = 0; t < kSumTiles<BM>; ++t)
    if (sum_tile(t) < BM / 16) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // rows gid, gid + 8; groups 0, 1
        const int r = sum_tile(t) * 16 + gid + (e >> 1) * 8;
        uint16_t part[3];
        split3(xs[t][e], part);
        *reinterpret_cast<uint16_t*>(pb + r * 128 + (((4 * q + k) ^ (r & 7)) << 4)
                                     + (2 * b + (e & 1)) * 2) =
            k == 0 ? part[0] : k == 1 ? part[1] : part[2];
      }
    }
}

// A thread's A fragment of the min term of a batch of nb stages: rows (tile
// columns) 16w + 2·(l / 4) and + 1, k slots 2·(l % 4), + 1 (stage l % 4's
// two groups) of -m from the batch's mins rows mr [8][128] bf16, zero for a
// stage past nb; hm = [-m | -m] (the [hi | mid] step), lo = [-m | 0].
__device__ __forceinline__ void mins_frag(const uint16_t* mr, int nb, uint32_t (&hm)[4],
                                          uint32_t (&lo)[4]) {
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31, t = l & 3;
  const int col = 16 * warp + 2 * (l >> 2);
  const uint32_t e = *reinterpret_cast<const uint32_t*>(mr + (2 * t) * kBN + col);
  const uint32_t o = *reinterpret_cast<const uint32_t*>(mr + (2 * t + 1) * kBN + col);
  const uint32_t a0 = t < nb ? __byte_perm(e, o, 0x5410) ^ 0x80008000u : 0u;  // column col
  const uint32_t a1 = t < nb ? __byte_perm(e, o, 0x7632) ^ 0x80008000u : 0u;  // column col + 1
  hm[0] = a0;
  hm[1] = a1;
  hm[2] = a0;
  hm[3] = a1;
  lo[0] = a0;
  lo[1] = a1;
  lo[2] = 0u;
  lo[3] = 0u;
}

// acc = the transposed BM x 128 tile at rows m0 of x @ W over K rows [kb,
// ke), from zero: thread t (warp w = t / 32, lane l) holds, for i < BM / 2,
// tile column 16·w + 2·(l / 4) + (i / 2) % 2 and row 8·(i / 4) + 2·(l % 4) +
// i % 2 (wgmma's accumulator layout, its rows being tile columns).  sm: the
// ring (and, with MINS, the min term's B tile and mins rows past it).  With
// MINS (G = 32) each batch of 4 stages adds its min term in two k16 steps
// of wgmma, issued with the next batch's first stage (the last batch's
// after the loop).
template <int BM, int G, bool MINS = false>
__device__ __forceinline__ void tile_sum(const Op& op, int m0, int col0, int col1, int kb, int ke,
                                         uint8_t* sm, float (&acc)[BM / 2]) {
  using C = Cfg<BM, MINS>;
  constexpr int S = C::kRing;
  constexpr int NG = G > 0 ? kBK / G : 1;  // groups of a stage
  static_assert(!MINS || G == 32, "mins at group 32 (Q5_K, Q5_1)");
  uint8_t* pb = sm + S * C::kSlot;  // MINS: the min term's B tile, [BM][64] bf16 swizzled
  uint16_t* mrows = reinterpret_cast<uint16_t*>(pb + C::kMinsB);  // MINS: [2][8][128] mins
  const int n = (ke - kb) / kBK;
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;  // warp: 16 tile columns
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
  if constexpr (MINS)  // slots a short batch leaves unset meet zero -m: no NaN there
    for (int u = threadIdx.x; u < BM * 8; u += kThreads)
      reinterpret_cast<uint4*>(pb)[u] = make_uint4(0u, 0u, 0u, 0u);
  uint32_t mhm[4] = {0u, 0u, 0u, 0u}, mlo[4] = {0u, 0u, 0u, 0u};  // MINS: the last batch's -m
#pragma unroll
  for (int i = 0; i < S - 2; ++i) {
    if (i < n) load_stage<BM, G, MINS>(op, m0, col0, col1, kb + i * kBK, sm + i * C::kSlot);
    cpasync::cp_commit();
  }
  // Stage i's A fragments into a (while stage i - 1's wgmma runs), after its
  // data is in and the slot of stage i - 2 is refilled.  even: i is even
  // (a compile-time tag, so that the min term's registers are written only
  // where no wgmma that reads them is in flight: mhm and mlo feed the even
  // stages' wgmma and are written while the odd ones' run).
  auto prepare = [&](int i, uint32_t (&a)[4][4], auto even) {
    cpasync::cp_wait<S - 3>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // x for wgmma
    __syncthreads();  // stage i is in; every wgmma of stage i - 2 is done
    if (i + S - 2 < n)  // into the slot of stage i - 2
      load_stage<BM, G, MINS>(op, m0, col0, col1, kb + (i + S - 2) * kBK,
                              sm + ((i + S - 2) % S) * C::kSlot);
    cpasync::cp_commit();
    const uint8_t* slot = sm + (i % S) * C::kSlot;
    if constexpr (MINS) {
      const int q = (i >> 2) & 1, b = i & 3;  // the batch's parity, the stage's place in it
      if constexpr (decltype(even)::value)
        if (b == 0 && i > 0)  // the last batch's -m (its rows are behind this barrier)
          mins_frag(mrows + (q ^ 1) * 8 * kBN, 4, mhm, mlo);
      if (threadIdx.x < 32) {  // the stage's two mins rows → rows 2b, 2b + 1 of the batch's
        const int g = threadIdx.x >> 4, cs = threadIdx.x & 15;
        *reinterpret_cast<uint4*>(mrows + (q * 8 + 2 * b + g) * kBN + cs * 8) =
            *reinterpret_cast<const uint4*>(slot + C::kXB + C::kQB + (2 + g) * 256 + cs * 16);
      }
    }
    // the scales of this thread's columns 2·(l / 4), + 1 of its 16, per group
    uint32_t sl[NG], sh[NG];
#pragma unroll
    for (int gi = 0; gi < NG; ++gi) {
      uint32_t v = 0u;
      if constexpr (G > 0)
        v = *reinterpret_cast<const uint32_t*>(slot + C::kXB + C::kQB + gi * 256 + 32 * warp
                                               + 4 * (l >> 2));
      sl[gi] = __byte_perm(v, 0u, 0x1010);
      sh[gi] = __byte_perm(v, 0u, 0x3232);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // k16 steps 2h, 2h + 1: 4 matrices of 8 rows of K
      const int k = 32 * h + l;    // this lane's row: 32h + 8·(l / 8) + l % 8
      uint32_t r[4];
      i8t::ldmatrix_x4(r, slot + C::kXB + k * 128 + ((warp ^ (k & 7)) << 4), true);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int kk = 2 * h + q, gi = G > 0 ? kk * 16 / (G > 0 ? G : 1) : 0;
        // bytes 0, 2: column 2j at rows 2t, 2t + 1 (j = l / 4, t = l % 4); 1, 3: column 2j + 1
        a[kk][0] = qring::dq_spread<(G > 0)>(r[2 * q], sl[gi]);
        a[kk][1] = qring::dq_spread<(G > 0)>(r[2 * q] >> 8, sh[gi]);
        a[kk][2] = qring::dq_spread<(G > 0)>(r[2 * q + 1], sl[gi]);
        a[kk][3] = qring::dq_spread<(G > 0)>(r[2 * q + 1] >> 8, sh[gi]);
      }
    }
    if constexpr (MINS && !kSumsOnTensorCores<BM>)  // read a batch later
      group_sums_cc<BM>(slot, pb, (i >> 2) & 1, i & 3);
  };
  // Stage i's wgmma on a; the next stage is prepared into b while it runs
  // (b's definitions lie in this wgmma's pipeline stage but feed only the
  // next one, issued after the wait: ptxas keeps both asynchronous).
  auto step = [&](int i, uint32_t (&a)[4][4], uint32_t (&b)[4][4], auto even) {
    constexpr bool kMinStep = MINS && decltype(even)::value;  // a batch's first stage is even
    const uint8_t* slot = sm + (i % S) * C::kSlot;
    uint64_t db[kBK / 16];  // x at the 4 k16 steps: +32 bytes each
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      db[kk] = desc(slot) + 2 * kk;
      asm volatile("" : "+l"(db[kk])::"memory");
    }
    // MINS: the stage's group sums on mma.sync, before the issue: the
    // tensor cores run an mma.sync only after an in-flight wgmma (in its
    // shadow the sums cost more than here)
    [[maybe_unused]] float xs[kSumTiles<BM>][4];
    if constexpr (MINS && kSumsOnTensorCores<BM>) group_sums<BM>(slot, xs);
    fence_regs(a);
    fence_regs(acc);
    if constexpr (kMinStep) {
      fence_regs(mhm);
      fence_regs(mlo);
    }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    if constexpr (kMinStep)
      if ((i & 3) == 0 && i > 0) {  // the last batch's min term: parts at k 32q' + [0, 32)
        const uint64_t dp = desc(pb) + 4 * (((i >> 2) - 1) & 1);
        wgmma_rs<BM>(acc, mhm, dp);
        wgmma_rs<BM>(acc, mlo, dp + 2);
      }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) wgmma_rs<BM>(acc, a[kk], db[kk]);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if constexpr (MINS && kSumsOnTensorCores<BM>)  // read a batch later
      store_sum_parts<BM>(xs, pb, (i >> 2) & 1, i & 3);
    if (i + 1 < n) prepare(i + 1, b, Parity<!decltype(even)::value>{});
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(acc);
    fence_regs(a);
    if constexpr (kMinStep) {
      fence_regs(mhm);
      fence_regs(mlo);
    }
  };
  uint32_t a0[4][4], a1[4][4];
  if (n > 0) prepare(0, a0, Parity<true>{});
  for (int i = 0; i < n; i += 2) {
    step(i, a0, a1, Parity<true>{});
    if (i + 1 < n) step(i + 1, a1, a0, Parity<false>{});
  }
  if constexpr (MINS)
    if (n > 0) {  // the split's last batch: its parts and rows behind a barrier of their own
      const int last = (n - 1) >> 2;
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      mins_frag(mrows + (last & 1) * 8 * kBN, n - 4 * last, mhm, mlo);
      const uint64_t dp = desc(pb) + 4 * (last & 1);
      fence_regs(mhm);
      fence_regs(mlo);
      fence_regs(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      wgmma_rs<BM>(acc, mhm, dp);
      wgmma_rs<BM>(acc, mlo, dp + 2);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(acc);
    }
  cpasync::cp_wait<0>();
  __syncthreads();  // the ring is free for the output tile
}

// The tile's sums → the f32 tile [BM][kLdt] at t (over the ring).
template <int BM>
__device__ __forceinline__ void store_tile(const float (&acc)[BM / 2], float* t) {
  const int l = threadIdx.x & 31;
  const int c0 = 16 * (threadIdx.x >> 5) + 2 * (l >> 2), r0 = 2 * (l & 3);
#pragma unroll
  for (int i = 0; i < BM / 2; ++i)
    t[(r0 + 8 * (i >> 2) + (i & 1)) * Cfg<BM>::kLdt + c0 + ((i >> 1) & 1)] = acc[i];
  __syncthreads();
}

// -- the cluster of a tile's splits --------------------------------------------

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld_cluster4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a) : "memory");
  return v;
}

// The f32 tiles t [BM][kLdt] of the KS blocks of a cluster (rank = split):
// sum(r, c) is ((0 + t_0) + t_1) + ... at row r, columns c .. c + 3, the KS
// loads issued together.
template <int BM>
struct ClusterTiles {
  uint32_t base[kMaxSplits];
  int KS;

  __device__ __forceinline__ ClusterTiles(const float* t, int ks) : KS(ks) {
#pragma unroll
    for (int k = 0; k < kMaxSplits; ++k) {
      base[k] = 0u;
      if (k < KS)
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                     : "=r"(base[k]) : "r"(smem_addr(t)), "r"(k));
    }
  }

  __device__ __forceinline__ float4 sum(int r, int c) const {
    const uint32_t off = (r * Cfg<BM>::kLdt + c) * 4;
    float4 v[kMaxSplits];
#pragma unroll
    for (int k = 0; k < kMaxSplits; ++k)
      if (k < KS) v[k] = ld_cluster4(base[k] + off);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kMaxSplits; ++k)
      if (k < KS)
        a = make_float4(__fadd_rn(a.x, v[k].x), __fadd_rn(a.y, v[k].y), __fadd_rn(a.z, v[k].z),
                        __fadd_rn(a.w, v[k].w));
    return a;
  }
};

// -- the items -----------------------------------------------------------------

enum Out { kF32, kBf16, kScaled };  // f32 y; bf16 y (the MLP's down); f32 y · s[n] (i8c)

// Four outputs of a matmul at out[o .. o + 3].
template <Out OUT>
__device__ __forceinline__ void put4(void* out, size_t o, float4 v, const float* cs, int col) {
  if constexpr (OUT == kBf16) {
    uint2 b;
    b.x = static_cast<uint32_t>(bf16_bits(v.x)) | (static_cast<uint32_t>(bf16_bits(v.y)) << 16);
    b.y = static_cast<uint32_t>(bf16_bits(v.z)) | (static_cast<uint32_t>(bf16_bits(v.w)) << 16);
    *reinterpret_cast<uint2*>(static_cast<uint16_t*>(out) + o) = b;
  } else {
    if constexpr (OUT == kScaled)
      v = make_float4(__fmul_rn(v.x, __ldg(cs + col)), __fmul_rn(v.y, __ldg(cs + col + 1)),
                      __fmul_rn(v.z, __ldg(cs + col + 2)), __fmul_rn(v.w, __ldg(cs + col + 3)));
    *reinterpret_cast<float4*>(static_cast<float*>(out) + o) = v;
  }
}

// One item of y [M, N] = x @ W split KS ways over K: column tile j, split
// s, M tile mt.  At one split the block writes y.  Else, with CLUSTER (the
// tile's splits are one cluster) block s writes its rows' split sums; else
// its partial goes into part [KS, M, N], and the last block of the tile's
// splits (ticket mt·N/128 + j) adds them in split order and writes y.  cs:
// i8c's column scales.
template <int BM, int G, Out OUT, bool CLUSTER, bool MINS = false>
__device__ void dq_item(const Op& op, int N, int K, int KS, int j, int s, int mt, void* out,
                        float* part, int* tickets, const float* cs, uint8_t* sm) {
  using C = Cfg<BM>;
  const int m0 = mt * BM, n0 = j * kBN, rows = min(BM, op.M - m0);
  int kb, ke;
  split_range(K, KS, s, kb, ke);
  float acc[BM / 2];
  tile_sum<BM, G, MINS>(op, m0, n0, n0 + 64, kb, ke, sm, acc);
  float* t = reinterpret_cast<float*>(sm);
  store_tile<BM>(acc, t);
  auto put = [&](int r, int c, float4 v) {
    put4<OUT>(out, static_cast<size_t>(m0 + r) * N + n0 + c, v, cs, n0 + c);
  };
  if (KS == 1) {
    for (int e = threadIdx.x; e < rows * (kBN / 4); e += kThreads) {
      const int r = e / (kBN / 4), c = e % (kBN / 4) * 4;
      const float4 v = *reinterpret_cast<const float4*>(&t[r * C::kLdt + c]);
      put(r, c, make_float4(__fadd_rn(0.f, v.x), __fadd_rn(0.f, v.y), __fadd_rn(0.f, v.z),
                            __fadd_rn(0.f, v.w)));
    }
    return;
  }
  if constexpr (CLUSTER) {
    cluster_sync();  // every split's tile is in its block
    const ClusterTiles<BM> tiles(t, KS);
    const int r0 = s * rows / KS, n = ((s + 1) * rows / KS - r0) * (kBN / 4);
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int r = r0 + e / (kBN / 4), c = e % (kBN / 4) * 4;
      put(r, c, tiles.sum(r, c));
    }
    cluster_sync();  // the other blocks have read this one's tile
    return;
  }
  const size_t plane = static_cast<size_t>(op.M) * N;
  for (int e = threadIdx.x; e < rows * (kBN / 4); e += kThreads) {
    const int r = e / (kBN / 4), c = e % (kBN / 4) * 4;
    *reinterpret_cast<float4*>(part + s * plane + static_cast<size_t>(m0 + r) * N + n0 + c) =
        *reinterpret_cast<const float4*>(&t[r * C::kLdt + c]);
  }
  if (!i8t::arrive_last(tickets + mt * (N / kBN) + j, KS)) return;
  qring::reduce_splits<BM, kBN, kThreads, 16>(part + static_cast<size_t>(m0) * N + n0, plane,
                                              KS, N, rows, kBN, put);
}

// One item of the fused gate-up over the [K, 2ff] payload: column pair j
// (gate columns j·64 + [0, 64), up columns ff + j·64 + [0, 64)), split s, M
// tile mt.  Writes mid [M, ff] = act(g)·u (bf16; ACT: bf16_ops.cuh act_mul,
// SiLU or the tanh-GELU of gated-GELU models): at once when KS is 1;
// with CLUSTER block s its rows; else the pair's partials go into part [KS,
// M, 2ff], and the last block of the pair's splits (ticket mt·ff/64 + j)
// adds them in split order.  Returns true in a block that wrote the tile of
// mid (the last one without CLUSTER).
template <int BM, int G, bool CLUSTER, bool MINS = false, int ACT = kActSilu>
__device__ bool gateup_item(const Op& op, int ff, int K, int KS, int j, int s, int mt,
                            float* part, uint16_t* mid, int* tickets, uint8_t* sm) {
  using C = Cfg<BM>;
  const int N = 2 * ff, m0 = mt * BM, c0 = j * 64, rows = min(BM, op.M - m0);
  int kb, ke;
  split_range(K, KS, s, kb, ke);
  float acc[BM / 2];
  tile_sum<BM, G, MINS>(op, m0, c0, ff + c0, kb, ke, sm, acc);
  float* t = reinterpret_cast<float*>(sm);
  store_tile<BM>(acc, t);
  auto put = [&](int r, int c, float4 g, float4 u) {  // mid columns c0 + c .. c0 + c + 3
    uint2 b;
    b.x = static_cast<uint32_t>(act_mul<ACT>(g.x, u.x))
          | (static_cast<uint32_t>(act_mul<ACT>(g.y, u.y)) << 16);
    b.y = static_cast<uint32_t>(act_mul<ACT>(g.z, u.z))
          | (static_cast<uint32_t>(act_mul<ACT>(g.w, u.w)) << 16);
    *reinterpret_cast<uint2*>(mid + static_cast<size_t>(m0 + r) * ff + c0 + c) = b;
  };
  if (KS == 1) {
    for (int e = threadIdx.x; e < rows * 16; e += kThreads) {
      const int r = e >> 4, c = (e & 15) * 4;
      put(r, c, *reinterpret_cast<const float4*>(&t[r * C::kLdt + c]),
          *reinterpret_cast<const float4*>(&t[r * C::kLdt + 64 + c]));
    }
    return true;
  }
  if constexpr (CLUSTER) {
    cluster_sync();  // every split's tile is in its block
    const ClusterTiles<BM> tiles(t, KS);
    const int r0 = s * rows / KS, n = ((s + 1) * rows / KS - r0) * 16;
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int r = r0 + (e >> 4), c = (e & 15) * 4;
      put(r, c, tiles.sum(r, c), tiles.sum(r, 64 + c));
    }
    cluster_sync();  // the other blocks have read this one's tile
    return true;
  }
  const size_t plane = static_cast<size_t>(op.M) * N;
  for (int e = threadIdx.x; e < rows * (kBN / 4); e += kThreads) {
    const int r = e / (kBN / 4), c = e % (kBN / 4) * 4;
    const int col = c < 64 ? c0 + c : ff + c0 + c - 64;
    *reinterpret_cast<float4*>(part + s * plane + static_cast<size_t>(m0 + r) * N + col) =
        *reinterpret_cast<const float4*>(&t[r * C::kLdt + c]);
  }
  if (!i8t::arrive_last(tickets + mt * (ff / 64) + j, KS)) return false;
  // the gate sums into the tile's first 64 columns, then the up sums meet them
  const float* pt = part + static_cast<size_t>(m0) * N + c0;
  qring::reduce_splits<BM, 64, kThreads, 16>(pt, plane, KS, N, rows, 64,
                                             [&](int r, int c, float4 v) {
    *reinterpret_cast<float4*>(&t[r * C::kLdt + c]) = v;
  });
  __syncthreads();
  qring::reduce_splits<BM, 64, kThreads, 16>(pt + ff, plane, KS, N, rows, 64,
                                             [&](int r, int c, float4 v) {
    put(r, c, *reinterpret_cast<const float4*>(&t[r * C::kLdt + c]), v);
  });
  return true;
}

// Launches a kernel of the tile over grid (column tiles, KS splits, M
// tiles), a tile's KS splits as one cluster.
template <typename P>
cudaError_t launch_split(void (*kernel)(P), dim3 grid, int smem, cudaStream_t st, const P& p) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = grid.y;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

// Calls f.template run<BM>() for a tile of bm rows (the plan's).
template <typename F>
cudaError_t dispatch(int bm, const F& f) {
  switch (bm) {
    case 16: return f.template run<16>();
    case 32: return f.template run<32>();
    case 64: return f.template run<64>();
    case 128: return f.template run<128>();
    case 256: return f.template run<256>();
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace i8k
