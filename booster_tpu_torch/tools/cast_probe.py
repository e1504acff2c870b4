"""Bisect the i8 stream: where between the raw read of an int8 weight and
a dot against it does the bandwidth go?

Counterpart of ``tools/cast_probe.py`` on the H100.  Every rung reads the
same [N, K] int8 array (46.1 MB at the default 11264 x 4096; drawn from
``np.random.default_rng(0)``):

  sum_i32       column sums, each 1024-row block in i32     (the read probe)
  sum_f32       column sums in f32
  sum_bf16      each 1024-row block summed in bf16, the block sums in f32
  dot_bf16      x bf16 [64, K] @ bf16(q)^T, f32 out         (no-scale qmm)
  dot_sub       the same, K in 512-wide pieces on the TPU
  dot_i8        x int8 @ q^T in i32, then f32
  dot_mixed     x bf16 @ int8 q^T (a mixed dot on the TPU)

The sums are ``ops.probes.colsum`` (csrc/probe_i8.cu colsum_kernel), the
dots ``ops.probes.i8mm`` over the N-major weight.  Hopper has no mixed
bf16 x int8 MMA and no notion of a sub-tile width, so dot_bf16, dot_sub and
dot_mixed are one function and one kernel here (timed as three rungs).

    python -m booster_tpu_torch.tools.cast_probe [--device cuda|cpu] [--n N --k K --bm M]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from booster_tpu_torch.device import resolve_device
from booster_tpu_torch.ops import probes
from booster_tpu_torch.tools.timing import F32_OPS_PER_S, INT8_OPS_PER_S, Ladder, emit

N, K, BM = 11264, 4096, 64
BN = probes.BLOCK_ROWS  # rows per block of the sums (the JAX tool's BN)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--n", type=int, default=N, help="weight rows (a multiple of 1024)")
    ap.add_argument("--k", type=int, default=K, help="weight columns, the dots' K")
    ap.add_argument("--bm", type=int, default=BM, help="rows of x")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n, k, bm = args.n, args.k, args.bm
    rng = np.random.default_rng(0)
    qw = torch.from_numpy(rng.integers(-127, 127, (n, k), dtype=np.int8)).to(dev)
    x = torch.from_numpy(rng.normal(size=(bm, k)).astype(np.float32)).to(dev, torch.bfloat16)
    xi = torch.from_numpy(rng.integers(-127, 127, (bm, k), dtype=np.int8)).to(dev)
    lad = Ladder("cast_probe", dev)
    qbytes = n * k
    for mode in probes.SUM_MODES:
        lad.rung(f"sum_{mode}", lambda mode=mode: probes.colsum(qw, mode, BN),
                 lambda mode=mode: probes.colsum_plain(qw, mode, BN), qbytes, qbytes + 4 * k,
                 n * k, F32_OPS_PER_S, exact=True, kernel="probe_colsum")
    dot_bytes = qbytes + 2 * bm * k + 4 * bm * n
    for name in ("dot_bf16", "dot_sub", "dot_mixed"):
        lad.rung(name, lambda: probes.i8mm(x, qw, n_major=True),
                 lambda: probes.i8mm_plain(x, qw, n_major=True), qbytes, dot_bytes,
                 2 * bm * k * n, kernel="probe_i8mm")
    lad.rung("dot_i8", lambda: probes.i8mm(xi, qw, n_major=True),
             lambda: probes.i8mm_plain(xi, qw, n_major=True), qbytes,
             qbytes + bm * k + 4 * bm * n, 2 * bm * k * n, INT8_OPS_PER_S, exact=True,
             kernel="probe_s8mm")
    return lad.result()


if __name__ == "__main__":
    emit(main())
