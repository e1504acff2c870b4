"""Probe the K-major (transposed) quantized-weight layout on the H100.

Counterpart of ``tools/tqmm_probe.py``: the weight stored [K, N] with f32
group scales [K/32, N] (scales vary along K, the rows), at [K 4096 -> N
4096], G 32, BM 8 and 64:

  tqmm_i8[sub_reshape], [sub_repeat]  x @ (bf16(q) * bf16(s[k // G, n]))
                                      (i8mm, K-major f32 group scales)
  tqmm_i8[sub_ptile]                  the same with s[k % SG, n] (i8mm, periodic scales)
  tqmm_i8[noscale]                    x @ bf16(q) (i8mm)
  tqmm_i4[sub_reshape]                the split-half i4: x3 [BM, 2, K/2], payload u8
                                      [K/2, N] (byte row r: k = r low, r + K/2 high),
                                      y = sum_h x3[:, h] @ bf16(bf16(nib_h - 8) * bf16(s_h))
                                      (ops.probes_i4.i4mm on the tensor cores)
  qmm_i4t.cu (tensor-core tile)       the same function through the serving path's own
                                      M > 1 kernel, the scales rounded to bf16 planes
                                      (not a rung of the JAX tool: the comparison the
                                      i4t M > 1 redesign needs)

The two expansions of the JAX tool are one function and one kernel here.
Each rung times its kernel call (the JAX tool's scan adds y[:, :128] to a
carry).  Inputs from ``np.random.default_rng(0)``, as the JAX tool draws
them.

    python -m booster_tpu_torch.tools.tqmm_probe [--device cuda|cpu]
        [--n 4096 --k 4096]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from booster_tpu_torch.device import resolve_device
from booster_tpu_torch.ops import probes, probes_i4
from booster_tpu_torch.tools.timing import BF16_OPS_PER_S, Ladder, emit

G = 32


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--k", type=int, default=4096, help="a multiple of 512")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    N, K = args.n, args.k
    SG, half = K // G, K // 2
    rng = np.random.default_rng(0)
    lad = Ladder("tqmm_probe", dev)
    for BM in (8, 64):
        qw = torch.from_numpy(rng.integers(-127, 127, (K, N)).astype(np.int8)).to(dev)
        s = torch.from_numpy((rng.random((SG, N)) * 0.02).astype(np.float32)).to(dev)
        x_np = rng.normal(size=(BM, K)).astype(np.float32)
        x = torch.from_numpy(x_np).to(dev, torch.bfloat16)
        base = N * K + 2 * BM * K + 4 * BM * N
        ops = 2 * BM * N * K
        for variant, scale in (("sub_reshape", "group"), ("sub_repeat", "group"),
                               ("sub_ptile", "tile"), ("noscale", "none")):
            sc = None if scale == "none" else s
            lad.rung(f"tqmm_i8[{variant}] BM={BM}",
                     lambda sc=sc, scale=scale: probes.i8mm(x, qw, s=sc, scale=scale),
                     lambda sc=sc, scale=scale: probes.i8mm_plain(x, qw, s=sc, scale=scale),
                     N * K, base + (0 if sc is None else s.numel() * 4), ops, BF16_OPS_PER_S,
                     kernel="probe_i8mm")
        lo = rng.integers(0, 15, (half, N)).astype(np.uint8)
        hi = rng.integers(0, 15, (half, N)).astype(np.uint8)
        packed = torch.from_numpy(lo | (hi << 4)).to(dev)
        s4 = torch.from_numpy((rng.random((2, half // G, N)) * 0.02).astype(np.float32)).to(dev)
        x3 = torch.from_numpy(x_np.reshape(BM, 2, half)).to(dev, torch.bfloat16)
        nbytes = N * half + 2 * BM * K + 4 * BM * N
        lad.rung(f"tqmm_i4[sub_reshape] BM={BM}", lambda: probes_i4.i4mm(x3, packed, s4),
                 lambda: probes_i4.i4mm_plain(x3, packed, s4), N * half,
                 nbytes + s4.numel() * 4, ops, BF16_OPS_PER_S, kernel="probe_i4mm")
        w = probes_i4.i4t_weight(packed, s4)  # bf16 planes, outside the timed rung
        lad.rung(f"qmm_i4t.cu (tensor-core tile, bf16 planes) BM={BM}",
                 lambda: probes_i4.qmm_i4t(x3, w), lambda: probes_i4.qmm_i4t_plain(x3, w),
                 N * half,
                 nbytes + s4.numel() * 2, ops, BF16_OPS_PER_S, kernel="probe_qmm_i4t_dq")
    return lad.result()


if __name__ == "__main__":
    emit(main())
