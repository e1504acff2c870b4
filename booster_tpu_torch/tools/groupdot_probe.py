"""M = 1 group-dot matvec with f32 scales on the H100: raw-payload dots, each
group rescaled.

Counterpart of ``tools/groupdot_probe.py``: out_n = sum_g s_gn *
((x_g . q_gn) - zero * xs_g) over groups of 32 rows, with unrounded f32
scales (``ops.probes_i4.groupdot``, csrc/probe_i4.cu):

  gd_i4     split-half nibbles (zero 8), x [1, 2, K/2], scales [2, K/64, N]
  gd_i4m    the affine form (Q4_K's): s[h] * p - s[2 + h] * xs, scales [4, K/64, N]
  gd_i8     int8 [K, N], scales [1, K/32, N]
  gd_i8raw  the TPU's mixed bf16 x int8 dot: the same function as gd_i8 here
  qmm_i4t.cu gd (bf16 planes)
            the serving path's own M = 1 kernel on the i4 rungs' payload, its
            scales (and mins) rounded to bf16: another function, timed beside
            its f32-scale counterpart

Shapes (``--shapes``): 1b, the 1.1B model's gate-up [11264 <- 2048] and
down [2048 <- 5632] (the default); 8b, [28672 <- 4096] and [4096 <- 14336];
or a list N:K:label.  The JAX tool's ``--iters`` (its timer) and
``--check`` (against float64) are not ported: the timer is
``tools/timing.py``'s and every rung is held to its plain version.  Inputs
from ``np.random.default_rng(0)`` per rung, as the JAX tool draws them.

    python -m booster_tpu_torch.tools.groupdot_probe [--device cuda|cpu] [--shapes 1b|8b]
        [--fmts i4,i4m,i8,i8raw]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from booster_tpu_torch.device import resolve_device
from booster_tpu_torch.ops import probes_i4
from booster_tpu_torch.tools.timing import F32_OPS_PER_S, Ladder, emit

G = 32
SHAPES = {"1b": ((11264, 2048, "gateup"), (2048, 5632, "down")),
          "8b": ((28672, 4096, "gateup"), (4096, 14336, "down"))}
FMTS = ("i4", "i4m", "i8", "i8raw")


def _shapes(spec: str) -> tuple:
    if spec in SHAPES:
        return SHAPES[spec]
    return tuple((int(n), int(k), label) for n, k, label in (s.split(":") for s in spec.split(",")))


def run_i4(lad: Ladder, dev, N: int, K: int, label: str, affine: bool) -> None:
    rng = np.random.default_rng(0)
    half = K // 2
    lo = rng.integers(0, 16, size=(half, N), dtype=np.uint8).astype(np.int32)
    hi = rng.integers(0, 16, size=(half, N), dtype=np.uint8).astype(np.int32)
    payload = torch.from_numpy((lo | (hi << 4)).astype(np.uint8)).to(dev)
    rows = 4 if affine else 2
    s = torch.from_numpy(rng.random((rows, half // G, N), dtype=np.float32) * 0.02 + 0.01).to(dev)
    x = torch.from_numpy(rng.standard_normal((1, 2, half)).astype(np.float32)).to(
        dev, torch.bfloat16)
    fmt = "i4m" if affine else "i4"
    qbytes = payload.numel() + s.numel() * 4
    lad.rung(f"gd_{fmt} {label} [{N}x{K}]", lambda: probes_i4.groupdot(x, payload, s, fmt),
             lambda: probes_i4.groupdot_plain(x, payload, s, fmt), qbytes,
             qbytes + 2 * K + 4 * N, 2 * N * K, F32_OPS_PER_S, kernel="probe_gd")
    w = probes_i4.i4t_weight(payload, s, 0 if affine else 8)
    lad.rung(f"qmm_i4t.cu gd {label} [{N}x{K}] ({fmt}, bf16 planes)",
             lambda: probes_i4.qmm_i4t(x, w), lambda: probes_i4.qmm_i4t_plain(x, w),
             payload.numel() + s.numel() * 2, payload.numel() + s.numel() * 2 + 2 * K + 4 * N,
             2 * N * K, F32_OPS_PER_S, kernel="probe_qmm_i4t_gd")


def run_i8(lad: Ladder, dev, N: int, K: int, label: str, name: str) -> None:
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.integers(-127, 128, size=(K, N)).astype(np.int8)).to(dev)
    s = torch.from_numpy(rng.random((1, K // G, N), dtype=np.float32) * 0.02 + 0.01).to(dev)
    x = torch.from_numpy(rng.standard_normal((1, K)).astype(np.float32)).to(dev, torch.bfloat16)
    qbytes = q.numel() + s.numel() * 4
    lad.rung(f"{name} {label} [{N}x{K}]", lambda: probes_i4.groupdot(x, q, s, "i8"),
             lambda: probes_i4.groupdot_plain(x, q, s, "i8"), qbytes, qbytes + 2 * K + 4 * N,
             2 * N * K, F32_OPS_PER_S, kernel="probe_gd")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--shapes", default="1b", help="1b, 8b, or N:K:label[,...]")
    ap.add_argument("--fmts", default=",".join(FMTS), help=f"a comma list of {FMTS}")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    want = args.fmts.split(",")
    if set(want) - set(FMTS):
        ap.error(f"fmts are {FMTS}")
    lad = Ladder("groupdot_probe", dev)
    for N, K, label in _shapes(args.shapes):
        if "i4" in want:
            run_i4(lad, dev, N, K, label, False)
        if "i4m" in want:
            run_i4(lad, dev, N, K, label, True)
        for fmt in ("i8", "i8raw"):
            if fmt in want:
                run_i8(lad, dev, N, K, label, f"gd_{fmt}")
    return lad.result()


if __name__ == "__main__":
    emit(main())
