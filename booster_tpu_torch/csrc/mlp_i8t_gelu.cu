// The whole gated MLP over K-major int8 weights with the tanh-GELU epilogue
// of gated-GELU models (Gemma): the kernel, its queue and its forms are
// mlp_i8t.cuh's (mlp_i8t.cu is the same library with the SiLU epilogue).
// Replaces _mlp_i8_kernel of booster_tpu/ops/pallas_qmm.py with act "gelu".

#include "mlp_i8t.cuh"

// Ints of zeroed workspace a launch with tiles of bm rows needs.
extern "C" int bt_mlp_i8t_ws_ints(int M, int ff, int C, int bm) {
  return mlp_ws_ints(M, ff, C, bm);
}

// out [M, C] bf16 = (gelu(x @ Wg) · (x @ Wu)) @ Wd: mlp_launch's arguments,
// act 1 (kActGelu) only.
extern "C" int bt_mlp_i8t(const void* x, const void* qgu, const void* sgu, const void* qd,
                          const void* sd, void* part1, void* mid, void* part2, void* out, void* ws,
                          int M, int K, int ff, int C, int KS1, int KS2, int bm, int first,
                          int n_items, int grid, int mins, int G, int act, void* stream) {
  return mlp_launch<kActGelu>(x, qgu, sgu, qd, sd, part1, mid, part2, out, ws, M, K, ff, C,
                              KS1, KS2, bm, first, n_items, grid, mins, G, act, stream);
}
