"""Probe variants of the fused quantized-matmul inner loop on the H100.

Counterpart of ``tools/qmm_probe.py``: the gate-up shape of the 1.1B model
(M 64, N 11264, K 2048, groups of 32), the int8 weight N-major [N, K] with
f32 group scales [N, K/32]:

  current sub=256/512/2048  x @ (bf16(q) * bf16(s expanded over 32 columns))^T
  cast-only                 x @ bf16(q)^T (no scales)
  int8 dot                  int8 x @ q^T -> i32 (no dequantize)
  int8 group dots           per-group (32) i32 dots x s, summed in f32

The first two are ``ops.probes.i8mm`` over the N-major weight, the int8 dot
its s8 form with an i32 output, the group dots ``ops.probes.i8mm_group``
(csrc/probe_i8.cu).  The sub-tile width is the TPU's: the three "current"
rungs are one kernel here.  Each step feeds its output back as the next x
(y[:, :K] in bf16, or clipped to int8 for the integer rungs), as the JAX
tool's scan carry does, and that step is what is timed.  Inputs from
``np.random.default_rng(0)``.

    python -m booster_tpu_torch.tools.qmm_probe [--device cuda|cpu] [--m M --n N --k K]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from booster_tpu_torch.device import resolve_device
from booster_tpu_torch.ops import probes
from booster_tpu_torch.tools.timing import BF16_OPS_PER_S, INT8_OPS_PER_S, Ladder, emit

M, N, K, G = 64, 11264, 2048, 32  # gate-up shape, Q8_0-like grouping


def feed(x: torch.Tensor, y: torch.Tensor) -> None:
    """The next step's x from this step's y: y[:, :K] in x's dtype, clipped
    to [-127, 127] for int8 (the JAX tool's carry), written into x."""
    y = y[:, :x.shape[1]]
    x.copy_(y.clamp(-127, 127).to(torch.int8) if x.dtype == torch.int8 else y.to(x.dtype))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--m", type=int, default=M)
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--k", type=int, default=K, help="at most N (the output feeds x)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    m, n, k = args.m, args.n, args.k
    rng = np.random.default_rng(0)
    qw = torch.from_numpy(rng.integers(-127, 127, (n, k), dtype=np.int8)).to(dev)
    s = torch.from_numpy((rng.random((n, k // G)) * 0.01).astype(np.float32)).to(dev)
    xb = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev, torch.bfloat16)
    xq = torch.from_numpy(rng.integers(-127, 127, (m, k), dtype=np.int8)).to(dev)
    lad = Ladder("qmm_probe", dev)
    sbytes = s.numel() * 4
    rungs = [(f"current bf16-dequant sub={sub}", xb,
              lambda x: probes.i8mm(x, qw, n_major=True, s=s, scale="group"),
              lambda x: probes.i8mm_plain(x, qw, n_major=True, s=s, scale="group"), sbytes,
              "probe_i8mm") for sub in (256, 512, 2048)]
    rungs += [
        ("cast-only (no scales)", xb, lambda x: probes.i8mm(x, qw, n_major=True),
         lambda x: probes.i8mm_plain(x, qw, n_major=True), 0, "probe_i8mm"),
        ("int8 MXU dot (no dequant)", xq, lambda x: probes.i8mm(x, qw, n_major=True, out_i32=True),
         lambda x: probes.i8mm_plain(x, qw, n_major=True, out_i32=True), 0, "probe_s8mm"),
        ("int8 group dots + acc scales", xq, lambda x: probes.i8mm_group(x, qw, s, n_major=True),
         lambda x: probes.i8mm_group_plain(x, qw, s, n_major=True), sbytes, "probe_i8mm_group"),
    ]
    for name, x0, fn, plain, sb, kernel in rungs:
        x = x0.clone()  # each rung's chain starts from the same x
        x_i8 = x.dtype == torch.int8
        lad.rung(name, lambda: fn(x), lambda: plain(x), n * k,
                 n * k + m * k * (1 if x_i8 else 2) + sb + 4 * m * n, 2 * m * n * k,
                 INT8_OPS_PER_S if x_i8 else BF16_OPS_PER_S, exact="dot (" in name,
                 step=lambda: feed(x, fn(x)), kernel=kernel)
    return lad.result()


if __name__ == "__main__":
    emit(main())
