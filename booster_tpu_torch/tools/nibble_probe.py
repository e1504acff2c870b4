"""Probe i4 nibble-unpack strategies inside a K-major dequant matmul on the H100.

Counterpart of ``tools/nibble_probe.py``, at the 1.1B model's gate+up
shape: W [11264, 2048] as a split-half payload u8 [1024, 11264] (11.5 MB;
byte row r holds k = r in its low nibble and r + 1024 in its high one),
f32 scale rows [R, 32, 11264], M 8 and 64 (``ops.probes_i4``,
csrc/probe_i4.cu):

  correct[...]              the dequantized tiles alone, u8 [256, 128]    (nibble_tiles, exact)
  u8->i32 (current)         w_h = bf16(bf16(nib_h - 8) * bf16(s_h)), rows [s0, s1]
  i8 mask+sub               the byte ^ 0x80: lo - 8 and 16(hi - 8), rows [s0, s1/16]
                            (the same numbers as current)
  i8 mask affine            lo unsigned, w_lo = bf16(bf16(lo * s0) - 8 s0), rows
                            [s0, s1/16, 8 s0] (other roundings)
  unpack xor88 / magic_f32 / magic_bf16
                            current's function with other unpack instructions: the
                            word ^ 0x88888888 sign-extended by shifts (the JAX tool's
                            unpack_i8_shift, which its main never runs), the
                            0x4B000000 float trick of qmm_i4t.cu, and 0x4300 bf16
                            pairs scaled by a bf16x2 fused multiply
  qmm_i4t.cu (tensor cores) current's function through the serving path's own M > 1
                            kernel, the scales rounded to bf16 planes

The matmul rungs are ``i4mm`` on the tensor cores, one tiling; only the
unpack differs.  Each rung times its kernel call (the JAX tool's scan adds
out[:, :128] to a carry).  Inputs from ``np.random.default_rng(0)``, as the
JAX tool draws them; the JAX tool's BN 1408 is its tile knob (the kernels
compute whole N).

    python -m booster_tpu_torch.tools.nibble_probe [--device cuda|cpu]
        [--n 11264 --k 2048]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from booster_tpu_torch.device import resolve_device
from booster_tpu_torch.ops import probes_i4
from booster_tpu_torch.tools.timing import BF16_OPS_PER_S, F32_OPS_PER_S, Ladder, emit

N, K, G = 11264, 2048, 32
CHECK = (256, 128)  # the check's tile: payload rows, columns


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--n", type=int, default=N, help="a multiple of 128")
    ap.add_argument("--k", type=int, default=K, help="at least 512, a multiple of 64")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n, half = args.n, args.k // 2
    rng = np.random.default_rng(0)
    qw = torch.from_numpy(rng.integers(0, 256, (half, n)).astype(np.uint8)).to(dev)
    s0 = rng.normal(size=(half // G, n)).astype(np.float32)
    s1 = rng.normal(size=(half // G, n)).astype(np.float32)
    rows = {"current": np.stack([s0, s1]), "i8mask": np.stack([s0, s1 / 16]),
            "affine": np.stack([s0, s1 / 16, 8 * s0])}
    rows = {m: torch.from_numpy(r).to(dev) for m, r in rows.items()}
    lad = Ladder("nibble_probe", dev)
    cr, cc = CHECK
    qs = qw[:cr, :cc].contiguous()
    for name, mode in (("i8mask_sub", "i8mask"), ("i8mask_affine", "affine"),
                       ("current", "current")):
        sc = rows[mode][:, :cr // G, :cc].contiguous()
        lad.rung(f"correct[{name}]",
                 lambda sc=sc, mode=mode: torch.stack(probes_i4.nibble_tiles(qs, sc, mode)),
                 lambda sc=sc, mode=mode: torch.stack(probes_i4.nibble_tiles_plain(qs, sc, mode)),
                 cr * cc, cr * cc + sc.numel() * 4 + 2 * cr * cc * 4, 2 * cr * cc,
                 F32_OPS_PER_S, exact=True, kernel="probe_nibble")
    payload = n * half
    w = probes_i4.i4t_weight(qw, rows["current"])  # bf16 planes, outside the timed rungs
    for bm in (8, 64):
        x3 = torch.from_numpy(rng.normal(size=(bm, 2, half)).astype(np.float32)).to(
            dev, torch.bfloat16)
        base = payload + x3.numel() * 2 + 4 * bm * n
        ops = 2 * bm * n * 2 * half
        for name, mode, unpack in (("u8->i32 (current)", "current", "i32"),
                                   ("i8 mask+sub", "i8mask", "i32"),
                                   ("i8 mask affine", "affine", "i32"),
                                   ("unpack xor88 (i8 shift)", "current", "xor88"),
                                   ("unpack magic_f32 (0x4B000000)", "current", "magic_f32"),
                                   ("unpack magic_bf16 (0x4300 pairs)", "current", "magic_bf16")):
            s = rows[mode]
            lad.rung(f"M={bm:3d} {name}",
                     lambda s=s, mode=mode, unpack=unpack: probes_i4.i4mm(x3, qw, s, mode, unpack),
                     lambda s=s, mode=mode: probes_i4.i4mm_plain(x3, qw, s, mode), payload,
                     base + s.numel() * 4, ops, BF16_OPS_PER_S, kernel="probe_i4mm")
        lad.rung(f"M={bm:3d} qmm_i4t.cu (tensor-core tile, bf16 planes)",
                 lambda: probes_i4.qmm_i4t(x3, w), lambda: probes_i4.qmm_i4t_plain(x3, w),
                 payload, base + w.scales.numel() * 2, ops, BF16_OPS_PER_S,
                 kernel="probe_qmm_i4t_dq")
    return lad.result()


if __name__ == "__main__":
    emit(main())
