"""The M > 1 tiles' mins forms on the card at every tile height they take:
each redesigned form (csrc/qmm_i4t.cu's tile with four planes at group 32,
Q4_K, and 16, Q2_K; csrc/i8k_tile.cuh's with a mins plane, Q5_K) beside the
same kernel on the weight without its mins plane (its twin), at the rows a
block that ``ops.qmm.i4t_plan`` / ``i8k_plan`` picks and at the others,
their K splits by the same rule.  Where the twin ratio differs between tile
heights at one M, the cost lies in the tile height's own resources (rows a
warp, registers, shared memory), not in the min term's share of the work.

Rows (real planes, testing.q4k_weight, q2k_weight, q5k_weight, seeded; x
seeded normal): config 2's Q4_K qkv 4096 → 6144 at M = 128 and 8192; the
Llama-3-8B Q2_K q 4096 → 4096 at M = 16, 64 and 2048 and its fused gate-up
4096 → 2·14336 at 64 and 2048; the DeepSeek-Coder-1.3B Q5_K qkv 2048 →
6144 and fused gate-up 2048 → 2·5504 at M = 16, 64 and 2048, its wo 2048 →
2048 at 16.  At each height the matmul is held within
2e-4 of the largest output of its plain version and the gate-up equal to
the matmul + silu·mul bit for bit, then both forms are timed by
``timing.timed`` (CUDA graphs of 20 calls, each after an L2 scrub, the
median of 5).

    python -m booster_tpu_torch.tools.mins_tiles [--device cuda|cpu] [--small]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from booster_tpu_torch.device import resolve_device
from booster_tpu_torch.ops import qmm as tq
from booster_tpu_torch.testing import q2k_weight, q4k_weight, q5k_weight, without_mins
from booster_tpu_torch.tools.timing import NOT_MEASURED, card, emit, timed

# (label, format, K, N, gate-up, rows M)
ROWS = [("Llama-3-8B Q4_K qkv", "q4k", 4096, 6144, False, (128, 8192)),
        ("Llama-3-8B Q2_K q", "q2k", 4096, 4096, False, (16, 64, 2048)),
        ("Llama-3-8B Q2_K gateup", "q2k", 4096, 28672, True, (64, 2048)),
        ("1.3B Q5_K qkv", "q5k", 2048, 6144, False, (16, 64, 2048)),
        ("1.3B Q5_K wo", "q5k", 2048, 2048, False, (16,)),
        ("1.3B Q5_K gateup", "q5k", 2048, 11008, True, (16, 64, 2048))]
SMALL = [("Q4_K", "q4k", 512, 256, False, (5, 40)), ("Q2_K gateup", "q2k", 512, 512, True, (33,)),
         ("Q5_K", "q5k", 256, 256, False, (17,)), ("Q5_K gateup", "q5k", 256, 512, True, (70,))]
HEIGHTS = {"i4t": (32, 64, 128), "i8t": (16, 32, 64, 128, 256)}


def _weight(fmt: str, N: int, K: int, seed: int, dev):
    return {"q4k": q4k_weight, "q2k": q2k_weight, "q5k": q5k_weight}[fmt](N, K, seed, dev)


def heights(kind: str, M: int) -> list:
    """The tile heights worth a look at M rows: those of at most 32 tiles
    of rows, and at least the two largest."""
    hs = HEIGHTS[kind]
    return [b for b in hs if b >= min(M / 32, hs[-2])]


def at_height(x, w, gateup: bool, bm: int, timing: bool) -> dict:
    """The form (matmul or gate-up) and its twin at `bm` rows a block:
    checked, then timed where `timing`."""
    i4 = w.kind == "i4t"
    mm = tq.qmm_i4t if i4 else tq.qmm_i8t
    fused = tq.qmm_i4t_gateup if i4 else tq.qmm_i8t_gateup
    name = "i4t_plan" if i4 else "i8k_plan"
    plan = getattr(tq, name)
    wn = without_mins(w)
    try:
        setattr(tq, name, lambda M_, K_, N_, bm_=None: plan(M_, K_, N_, bm))
        y = mm(x, w)
        if gateup:
            ff = w.shape[0] // 2
            g = y.to(torch.bfloat16)
            ok = torch.equal(fused(x, w), tq.silu(g[:, :ff]) * g[:, ff:])
        else:
            want = tq.qmm_plain(x, w)
            ok = float((y - want).abs().max()) <= 2e-4 * float(want.abs().max())
        if not ok:
            raise AssertionError(f"mins_tiles {w.kind} M={x.shape[0]} at {bm} rows a block: "
                                 "outside the limit of its plain version or not the matmul")
        if not timing:
            return {"ms": NOT_MEASURED, "no_mins_ms": NOT_MEASURED}
        fn = (lambda w_: fused(x, w_)) if gateup else (lambda w_: mm(x, w_))
        ms, twin = timed(lambda: fn(w)), timed(lambda: fn(wn))
        return {"ms": ms, "no_mins_ms": twin, "ratio": ms / twin}
    finally:
        setattr(tq, name, plan)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--small", action="store_true", help="narrow shapes (a rehearsal)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = card(dev)
    res = {"tool": "mins_tiles", "device": str(dev), "card": name, "rows": []}
    print(f"mins_tiles: device {dev} [{name}]", flush=True)
    for seed, (label, fmt, K, N, gateup, ms) in enumerate(SMALL if args.small else ROWS, 1):
        w = _weight(fmt, N, K, 400 + seed, dev)
        kind = w.resolved().kind
        for M in ms:
            x = torch.from_numpy(np.random.default_rng(seed + M).normal(size=(M, K))
                                 .astype(np.float32)).to(dev, torch.bfloat16)
            plan_bm = (tq.i4t_plan if kind == "i4t" else tq.i8k_plan)(M, K, N)[0]
            for bm in heights(kind, M):
                row = {"shape": f"{label} M={M} K={K} N={N}", "bm": bm, "plan_bm": plan_bm,
                       **at_height(x, w, gateup, bm, dev.type == "cuda")}
                if dev.type == "cuda":
                    print(f"mins_tiles {row['shape']} BM {bm}{' (plan)' if bm == plan_bm else ''}:"
                          f" {row['ms']:.5f} ms, twin {row['no_mins_ms']:.5f}, "
                          f"{row['ratio']:.3f}x [{name}]", flush=True)
                res["rows"].append(row)
            del x
        del w
    return res


if __name__ == "__main__":
    emit(main())
