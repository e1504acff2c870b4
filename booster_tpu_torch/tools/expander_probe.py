"""Probe the dequant matmul's scale expansion on the H100.

Counterpart of ``tools/expander_probe.py``.  The fused dequant matmul
expands per-group scales s [BN, SG] to per-column scales [BN, SUB], each
scale repeated g times along a row.  The JAX tool compares the TPU's
lowerings of that step; on Hopper each of its variants is one of a few
functions of the data:

part 1, the expansion alone (s [8, 128] f32 -> [8, 256], g 32;
``ops.probes_i4.expand``, csrc/probe_i4.cu):
  reshape, jnp.repeat, jnp.take   column c takes s[:, c // g]  (one function)
  pltpu.repeat                    tile semantics: s[:, c % SG]
  one-hot dot bf16                the repeat of bf16(s)

part 2, the N-major i8 matvec [N 4096, K 4096], G 32, at BM 8 (x bf16
[BM, K], q int8 [N, K], f32 scales [N, K/32]; ``ops.probes``,
csrc/probe_i8.cu):
  dot_f32, dot_bf16    x @ (bf16(q) * bf16(s[n, k // G]))^T  (i8mm, N-major f32 group scales)
  ptile SUB BN         the same with s[n, k % SG]            (i8mm, periodic scales)
  noscale SUB BN       x @ bf16(q)^T                          (i8mm)
  castonly 1024 1024   every output of a BN tile: sum over SUB pieces of
                       1e-9 * the tile's piece sum            (blocksum)
  gloop                per-group (32) f32 dots * s, scales [SG, N] (i8mm_group)

SUB and BN are the TPU's tile knobs: they change the function only for
castonly.  Each rung times its kernel call (the JAX tool's scan step also
casts y back into x).  Inputs from ``np.random.default_rng(0)``, as the JAX
tool draws them.  With ``--bm`` only part 2 runs, as in the JAX tool.

    python -m booster_tpu_torch.tools.expander_probe [--device cuda|cpu] [--bm 8]
        [--n 4096 --k 4096]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from booster_tpu_torch.device import resolve_device
from booster_tpu_torch.ops import probes, probes_i4
from booster_tpu_torch.tools.timing import BF16_OPS_PER_S, F32_OPS_PER_S, Ladder, emit

G = 32
PART1 = (8, 128, 32, 256)  # BN, SG, g, SUB
# part 2's (variant, SUB, BN), in the JAX tool's order (part2_timing)
PART2 = (("dot_f32", 512, 512), ("dot_bf16", 512, 512), ("ptile", 512, 512),
         ("ptile", 1024, 512), ("ptile", 512, 1024), ("ptile", 1024, 1024),
         ("noscale", 512, 512), ("noscale", 1024, 1024), ("castonly", 1024, 1024),
         ("gloop", 512, 512))


def part1(lad: Ladder, dev: torch.device) -> None:
    BN, SG, g, SUB = PART1
    rng = np.random.default_rng(0)
    s = torch.from_numpy(rng.normal(size=(BN, SG)).astype(np.float32)).to(dev)
    for name, tile, bf16 in (("reshape (bcast+merge, sublane g)", False, False),
                             ("jnp.repeat", False, False), ("jnp.take const idx", False, False),
                             ("pltpu.repeat (tile semantics)", True, False),
                             ("one-hot dot bf16", False, True)):
        lad.rung(name, lambda tile=tile, bf16=bf16: probes_i4.expand(s, g, SUB, tile, bf16),
                 lambda tile=tile, bf16=bf16: probes_i4.expand_plain(s, g, SUB, tile, bf16),
                 BN * SUB * 4, probes_i4.expand_bytes(BN, SG, g, SUB, tile), 0, exact=True,
                 kernel="probe_expand")


def part2(lad: Ladder, dev: torch.device, BM: int, N: int, K: int) -> None:
    SG = K // G
    rng = np.random.default_rng(0)
    qw = torch.from_numpy(rng.integers(-127, 127, (N, K)).astype(np.int8)).to(dev)
    x = torch.from_numpy(rng.normal(size=(BM, K)).astype(np.float32)).to(dev, torch.bfloat16)
    s = torch.from_numpy((rng.random((N, SG)) * 0.02).astype(np.float32)).to(dev)
    s_t = s.t().contiguous()  # gloop's pre-transposed [SG, N]
    base = N * K + 2 * BM * K + 4 * BM * N
    ops = 2 * BM * N * K
    calls = {
        "dot_f32": (lambda: probes.i8mm(x, qw, n_major=True, s=s, scale="group"),
                    lambda: probes.i8mm_plain(x, qw, n_major=True, s=s, scale="group"),
                    s.numel() * 4, "probe_i8mm"),
        "ptile": (lambda: probes.i8mm(x, qw, n_major=True, s=s, scale="tile"),
                  lambda: probes.i8mm_plain(x, qw, n_major=True, s=s, scale="tile"),
                  s.numel() * 4, "probe_i8mm"),
        "noscale": (lambda: probes.i8mm(x, qw, n_major=True),
                    lambda: probes.i8mm_plain(x, qw, n_major=True), 0, "probe_i8mm"),
        "gloop": (lambda: probes.i8mm_group(x, qw, s_t.t(), n_major=True),
                  lambda: probes.i8mm_group_plain(x, qw, s_t.t(), n_major=True),
                  s.numel() * 4, "probe_i8mm_group"),
    }
    calls["dot_bf16"] = calls["dot_f32"]  # the one-hot expander's dtype: one function here
    for variant, sub, bn in PART2:
        name = f"qmm[{variant} SUB={sub} BN={bn}]"
        if variant == "castonly":
            lad.rung(name, lambda sub=sub, bn=bn: probes.blocksum(qw, BM, bn, sub),
                     lambda sub=sub, bn=bn: probes.blocksum_plain(qw, BM, bn, sub), N * K,
                     N * K + 4 * BM * N, N * K, F32_OPS_PER_S, exact=True,
                     kernel="probe_blocksum")
            continue
        fn, plain, sbytes, kernel = calls[variant]
        lad.rung(name, fn, plain, N * K, base + sbytes, ops, BF16_OPS_PER_S, kernel=kernel)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--bm", type=int, default=None, help="rows of x; given, only part 2 runs")
    ap.add_argument("--n", type=int, default=4096, help="part 2's weight rows")
    ap.add_argument("--k", type=int, default=4096, help="part 2's K (a multiple of 1024)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    lad = Ladder("expander_probe", dev)
    if args.bm is None:
        part1(lad, dev)
    part2(lad, dev, args.bm or 8, args.n, args.k)
    return lad.result()


if __name__ == "__main__":
    emit(main())
