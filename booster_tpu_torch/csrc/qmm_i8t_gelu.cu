// The 8-bit K-major fused gate-up with the tanh-GELU epilogue of gated-GELU
// models (Gemma): the kernels, their forms and their numerics are
// qmm_i8t.cuh's (qmm_i8t.cu is the same library with the SiLU epilogue and
// the matmuls).  Replaces _gateup_i8_kernel (M > 1) and _gateup_i8_gd_kernel
// (M = 1) of booster_tpu/ops/pallas_qmm.py with act "gelu".

#include "qmm_i8t.cuh"

// M = 1: the gate-up (gateup = 1), act 1 (kActGelu) only; i8t_gd's arguments.
extern "C" int bt_qmm_i8t_gd(const void* x, const void* q, const void* s, void* out, int K, int N,
                             int G, int mins, int gateup, int ks, int act, void* stream) {
  return i8t_gd<kActGelu>(x, q, s, out, K, N, G, mins, gateup, ks, act, stream);
}

// M > 1: the gate-up, act 1 only; i8t_dq's arguments.
extern "C" int bt_qmm_i8t_dq(const void* x, const void* q, const void* s, void* out, int M, int K,
                             int N, int KS, int gateup, int G, int bm, int mins, int act,
                             void* stream) {
  return i8t_dq<kActGelu>(x, q, s, out, M, K, N, KS, gateup, G, bm, mins, act, stream);
}
