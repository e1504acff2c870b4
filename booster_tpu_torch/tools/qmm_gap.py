"""Where does a K-major q8_0 matmul's stream rate go?  (mmq gap analysis)

Counterpart of ``tools/qmm_gap.py`` on the H100: each stage of a fused
dequantize-matmul at the SAME tiling (one grid, one staging; only the stage
under test differs), y [M, N] = x [M, K] @ W with W int8 K-major [K, N]:

  v0  bf16 x @ int8 w (a mixed dot on the TPU)        (the i8c ceiling)
  v1  + the explicit i8 -> bf16 cast                  (the same on Hopper)
  v2  + times a bf16 [K, N] scale plane, rounded      (the multiply, no expansion)
  v3  + group scales [K/32, N] expanded over rows     (the q8_0 kernel's function)
  v4  int8 x: per-group (32) i32 dots, each x s_g in f32, summed (the CUDA mmq shape)
  v5  v3 over the K-reordered layout: row r of K block b takes scale row
      b*bk/32 + r % (bk/32)
  v6  bf16 x: per-group (32) f32 dots x s_g, summed in f32
  v7  v6 over groups of 128, scale row 4g

v0-v3 and v5 are ``ops.probes.i8mm``, v4, v6 and v7 ``ops.probes.i8mm_group``
(csrc/probe_i8.cu).  Inputs from ``np.random.default_rng(0)``.  ``--bk``
stays because v5's function depends on it; ``--bn`` and ``--sub`` are the
TPU's tile knobs and are accepted and ignored.

    python -m booster_tpu_torch.tools.qmm_gap [--device cuda|cpu] [--m 64] [--n 4096] [--k 4096]
        [--bk 2048] [--variants v0,v1,v3,v6,v7]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from booster_tpu_torch.device import resolve_device
from booster_tpu_torch.ops import probes
from booster_tpu_torch.tools.timing import BF16_OPS_PER_S, INT8_OPS_PER_S, Ladder, emit

G = 32  # q8_0 group size
NAMES = {"v0": "v0 mixed i8 dot", "v1": "v1 cast only", "v2": "v2 + preexp scale",
         "v3": "v3 + expansion", "v4": "v4 group int dots", "v5": "v5 lead-dim bcast",
         "v6": "v6 group mix dots", "v7": "v7 g128 mix dots"}


def variants(x, xq, qw, s_small, s_big, bk: int) -> dict:
    """variant → (kernel call, plain call, int8 x?, scale bytes, kernel name)."""
    mm, mmp = probes.i8mm, probes.i8mm_plain
    gm, gmp = probes.i8mm_group, probes.i8mm_group_plain
    small = s_small.numel() * 2
    return {
        "v0": (lambda: mm(x, qw), lambda: mmp(x, qw), False, 0, "probe_i8mm"),
        "v1": (lambda: mm(x, qw), lambda: mmp(x, qw), False, 0, "probe_i8mm"),
        "v2": (lambda: mm(x, qw, s=s_big, scale="plane"),
               lambda: mmp(x, qw, s=s_big, scale="plane"), False, s_big.numel() * 2,
               "probe_i8mm"),
        "v3": (lambda: mm(x, qw, s=s_small, scale="group"),
               lambda: mmp(x, qw, s=s_small, scale="group"), False, small, "probe_i8mm"),
        "v4": (lambda: gm(xq, qw, s_small), lambda: gmp(xq, qw, s_small), True, small,
               "probe_i8mm_group"),
        "v5": (lambda: mm(x, qw, s=s_small, scale="reorder", bk=bk),
               lambda: mmp(x, qw, s=s_small, scale="reorder", bk=bk), False, small,
               "probe_i8mm"),
        "v6": (lambda: gm(x, qw, s_small), lambda: gmp(x, qw, s_small), False, small,
               "probe_i8mm_group"),
        "v7": (lambda: gm(x, qw, s_small, group=128), lambda: gmp(x, qw, s_small, group=128),
               False, small, "probe_i8mm_group"),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--m", type=int, default=64)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--k", type=int, default=4096)
    ap.add_argument("--bn", type=int, default=1024, help="the TPU's tile width: ignored")
    ap.add_argument("--bk", type=int, default=2048,
                    help="rows of K per block: v5's scale rows depend on it")
    ap.add_argument("--sub", type=int, default=256, help="the TPU's sub-tile: ignored")
    ap.add_argument("--variants", default="v0,v1,v3,v6,v7",
                    help="comma list (v0,v1,v2,v3,v4,v5,v6,v7)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    M, N, K, BK = args.m, args.n, args.k, args.bk
    wanted = args.variants.split(",")
    if set(wanted) - set(NAMES):
        ap.error(f"variants are {sorted(NAMES)}")
    rng = np.random.default_rng(0)
    qw = torch.from_numpy(rng.integers(-127, 127, (K, N), dtype=np.int8)).to(dev)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(dev, torch.bfloat16)
    s_small = torch.from_numpy((rng.random((K // G, N)) + 0.5).astype(np.float32)).to(
        dev, torch.bfloat16)
    s_big = torch.from_numpy((rng.random((K, N)) + 0.5).astype(np.float32)).to(
        dev, torch.bfloat16)
    xq = torch.from_numpy(rng.integers(-127, 127, (M, K), dtype=np.int8)).to(dev)
    lad = Ladder("qmm_gap", dev)
    runs = variants(x, xq, qw, s_small, s_big, BK)
    for v in wanted:
        fn, plain, x_i8, sbytes, kernel = runs[v]
        lad.rung(NAMES[v], fn, plain, K * N, K * N + M * K * (1 if x_i8 else 2) + sbytes
                 + 4 * M * N, 2 * M * N * K, INT8_OPS_PER_S if x_i8 else BF16_OPS_PER_S,
                 kernel=kernel)
    return lad.result()


if __name__ == "__main__":
    emit(main())
