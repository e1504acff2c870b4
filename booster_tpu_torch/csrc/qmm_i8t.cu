// The 8-bit K-major matmul and the fused gate-up with the SiLU epilogue: the
// kernels, their forms and their numerics are qmm_i8t.cuh's (qmm_i8t_gelu.cu
// is the same library for the GELU gate-ups).  Replaces _tqmm_i8_gd_kernel,
// _tqmm_i8_kernel, and _gateup_i8_kernel and _gateup_i8_gd_kernel with act
// "silu", of booster_tpu/ops/pallas_qmm.py.

#include "qmm_i8t.cuh"

// M = 1: the matvec (gateup = 0) or the gate-up, act 0 (kActSilu) only;
// i8t_gd's arguments.
extern "C" int bt_qmm_i8t_gd(const void* x, const void* q, const void* s, void* out, int K, int N,
                             int G, int mins, int gateup, int ks, int act, void* stream) {
  return i8t_gd<kActSilu>(x, q, s, out, K, N, G, mins, gateup, ks, act, stream);
}

// M > 1: the matmul or the gate-up, act 0 only; i8t_dq's arguments.
extern "C" int bt_qmm_i8t_dq(const void* x, const void* q, const void* s, void* out, int M, int K,
                             int N, int KS, int gateup, int G, int bm, int mins, int act,
                             void* stream) {
  return i8t_dq<kActSilu>(x, q, s, out, M, K, N, KS, gateup, G, bm, mins, act, stream);
}
