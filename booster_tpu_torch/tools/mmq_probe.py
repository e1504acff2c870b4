"""mmq design probe: per-channel int8 weights at M = 64, which dot reaches
the raw read rate?

Counterpart of ``tools/mmq_probe.py`` on the H100, at the 7B shapes
(qkv 4096 -> 6144, gate-up 4096 -> 28672, down 14336 -> 4096) with the
weight K-major [K, N] int8:

  a) int8 x @ int8 w -> i32 (activations quantized per row beforehand)
  b) bf16 x @ int8 w -> f32 (exact activations, no dequantize pass)

``int_mm`` is ``ops.probes.i8mm`` (csrc/probe_i8.cu i8mm_kernel): (a) on
m16n8k32 s8 mma.sync, the K-major weight byte-transposed as it is staged;
(b) on bf16 m16n8k16 with the weight converted to bf16 (exact) on its way
to shared memory.  Inputs from ``np.random.default_rng(0)``.

    python -m booster_tpu_torch.tools.mmq_probe [--device cuda|cpu] [--m M] [--shapes ...]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from booster_tpu_torch.device import resolve_device
from booster_tpu_torch.ops import probes
from booster_tpu_torch.tools.timing import BF16_OPS_PER_S, INT8_OPS_PER_S, Ladder, emit

SHAPES = ((6144, 4096, "qkv"), (28672, 4096, "gateup"), (4096, 14336, "down"))


def int_mm(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """x [M, K] @ w [K, N] int8: (a) int8 x → i32, (b) bf16 x → f32 (the JAX
    tool's int_mm; its bn / bk tiles are the TPU's)."""
    if out_dtype != (torch.int32 if x.dtype == torch.int8 else torch.float32):
        raise NotImplementedError("int_mm: int8 x gives i32 and bf16 x f32, nothing else")
    return probes.i8mm(x, w, out_i32=out_dtype == torch.int32)


def int_mm_plain(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    return probes.i8mm_plain(x, w, out_i32=out_dtype == torch.int32)


def _shape(s: str) -> tuple:
    n, k, label = s.split(":")
    return int(n), int(k), label


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--m", type=int, default=64, help="rows of x (the JAX tool's MM)")
    ap.add_argument("--shapes", type=lambda v: [_shape(s) for s in v.split(",")],
                    default=list(SHAPES), help="N:K:label,... (default: the 7B's three)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    M = args.m
    rng = np.random.default_rng(0)
    lad = Ladder("mmq_probe", dev)
    for N, K, label in args.shapes:
        wq = torch.from_numpy(rng.integers(-127, 127, (K, N), dtype=np.int8)).to(dev)
        xb = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(dev, torch.bfloat16)
        xq = torch.from_numpy(rng.integers(-127, 127, (M, K), dtype=np.int8)).to(dev)
        for name, x, dt, xbytes, rate in (("i8xi8->i32", xq, torch.int32, M * K, INT8_OPS_PER_S),
                                          ("bf16xi8->f32", xb, torch.float32, 2 * M * K,
                                           BF16_OPS_PER_S)):
            lad.rung(f"{name} {label}", lambda x=x, dt=dt, wq=wq: int_mm(x, wq, dt),
                     lambda x=x, dt=dt, wq=wq: int_mm_plain(x, wq, dt), N * K,
                     N * K + xbytes + 4 * M * N, 2 * M * N * K, rate, exact=x.dtype == torch.int8,
                     kernel="probe_i8mm")
        del wq
    return lad.result()


if __name__ == "__main__":
    emit(main())
