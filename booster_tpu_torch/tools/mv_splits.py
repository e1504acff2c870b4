"""The K splits of the M = 1 matvecs (csrc/i8mv.cuh, and csrc/i4mv.cuh on
its block) on the card: each path row's kernel at every split count 1-8,
beside the count that ``ops.qmm.mv_plan`` (``i4t_mv_plan``) gives it.

Rows (K, N, group; i8c has none): the 7B i8c weights (qkv, wo, gate-up,
down, lm head: generate_i8c), the 7B Q8_0 matvecs (qkv, wo, lm head:
generate_q8), the 1.3B Q6_K ones (qkv, wo, the lm heads of 32256 and 32000
rows: generate_q6k), TinyLlama's widened to Q8_0 (qkv, wo, lm head:
generate_i8) and the fused gate-ups (the 1.3B at group 16, also with a
mins plane; the 7B at group 32); the 4-bit rows (Q4_0, i4t): TinyLlama's
qkv, wo, down, lm head and fused gate-up (generate), MPT-7B's qkv, wo, up
and down (generate_mpt), Mixtral's qkv and wo (generate_moe).  Inputs are
seeded.  At each split count the wrapper (``qmm_i8c``, ``qmm_i8t``,
``qmm_i8t_gateup``, ``qmm_i4t``, ``qmm_i4t_gateup``) is held within
2e-4 of the largest output of its plain version (the gate-ups: equal to the
matvec at the same splits + silu·mul) and timed by ``timing.timed`` (CUDA
graphs of 20 calls, each after an L2 scrub, the median of 7).  A row's time
at the plan's count is the kernel's as the serving path launches it; per-row
times beside the bound and the library call are chip_smoke.py's.

    python -m booster_tpu_torch.tools.mv_splits [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from booster_tpu_torch.device import resolve_device
from booster_tpu_torch.gguf import GGMLType
from booster_tpu_torch.ops import qmm as tq
from booster_tpu_torch.quant.qtensor import QTensor
from booster_tpu_torch.tools.timing import NOT_MEASURED, card, emit, timed

# (path, label, K, N, group (0: i8c), mins); paths i4t and "i4t gateup" take a
# 4-bit payload (zero 8; with mins, four planes and zero 0)
ROWS = [("i8c", "7B qkv", 4096, 6144, 0, False), ("i8c", "7B wo", 4096, 4096, 0, False),
        ("i8c", "7B gateup", 4096, 28672, 0, False), ("i8c", "7B down", 14336, 4096, 0, False),
        ("i8c", "7B lm_head", 4096, 32000, 0, False),
        ("q8", "7B qkv", 4096, 6144, 32, False), ("q8", "7B wo", 4096, 4096, 32, False),
        ("q8", "7B lm_head", 4096, 32000, 32, False),
        ("q6k", "1.3B qkv", 2048, 6144, 16, False), ("q6k", "1.3B wo", 2048, 2048, 16, False),
        ("q6k", "1.3B lm_head", 2048, 32256, 16, False),
        ("q6k", "lm_head 32000", 2048, 32000, 16, False),
        ("i8", "TinyLlama qkv", 2048, 2560, 32, False), ("i8", "TinyLlama wo", 2048, 2048, 32, False),
        ("i8", "TinyLlama lm_head", 2048, 32000, 32, False),
        ("gateup", "1.3B gateup", 2048, 11008, 16, False),
        ("gateup", "1.3B gateup, mins", 2048, 11008, 16, True),
        ("gateup", "7B gateup", 4096, 28672, 32, False),
        ("i4t", "TinyLlama qkv", 2048, 2560, 32, False), ("i4t", "TinyLlama wo", 2048, 2048, 32, False),
        ("i4t", "TinyLlama down", 5632, 2048, 32, False),
        ("i4t", "TinyLlama lm_head", 2048, 32000, 32, False),
        ("i4t gateup", "TinyLlama gateup", 2048, 11264, 32, False),
        ("i4t", "MPT-7B qkv", 4096, 12288, 32, False), ("i4t", "MPT-7B wo", 4096, 4096, 32, False),
        ("i4t", "MPT-7B up", 4096, 16384, 32, False), ("i4t", "MPT-7B down", 16384, 4096, 32, False),
        ("i4t", "Mixtral qkv", 4096, 6144, 32, False)]
SPLITS = range(1, 9)


def weight(K: int, N: int, G: int, mins: bool, seed: int, dev, i4: bool = False) -> QTensor:
    rng = np.random.default_rng(seed)
    if i4:
        qw = torch.from_numpy(rng.integers(0, 256, (K // 2, N), dtype=np.uint8)).to(dev)
        s = (rng.random((4 if mins else 2, K // (2 * G), N)) * 2e-2 + 1e-3).astype(np.float32)
        return QTensor("i4t", qw, torch.from_numpy(s).to(dev, torch.bfloat16), None, G, (N, K),
                       GGMLType.Q4_0, zero=0 if mins else 8)
    qw = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int8)).to(dev)
    if not G:
        s = torch.from_numpy((rng.random((1, N)) * 2e-3 + 1e-4).astype(np.float32)).to(dev)
        return QTensor("i8c", qw, s, None, K, (N, K), GGMLType.Q8_0)
    s = (rng.random((2 if mins else 1, K // G, N)) * 2e-3 + 1e-4).astype(np.float32)
    return QTensor("i8t", qw, torch.from_numpy(s).to(dev, torch.bfloat16), None, G, (N, K),
                   GGMLType.Q8_0 if G == 32 else GGMLType.Q6_K)


def sweep(x: torch.Tensor, w: QTensor, gateup: bool, timing: bool) -> dict:
    """The wrapper at each split count: checked, and timed where `timing`."""
    K, N = x.shape[1], w.shape[0]
    i4 = w.kind == "i4t"
    mv = tq.qmm_i4t if i4 else tq.qmm_i8t
    if gateup:
        fn, want = (lambda: (tq.qmm_i4t_gateup if i4 else tq.qmm_i8t_gateup)(x, w)), None
    elif w.kind == "i8c":
        fn, want = (lambda: tq.qmm_i8c(x, w)), tq.qmm_i8c_plain(x, w)
    else:
        fn, want = (lambda: mv(x, w)), tq.qmm_plain(x, w)
    plan_name = "i4t_mv_plan" if i4 else "mv_plan"
    plan, ms = getattr(tq, plan_name), {}
    try:
        for ks in SPLITS:
            setattr(tq, plan_name, lambda K_, N_, G_, ks=ks: ks)
            got = fn()
            if gateup:
                g = mv(x, w).to(torch.bfloat16)
                ok = torch.equal(got, tq.silu(g[:, :N // 2]) * g[:, N // 2:])
            else:
                ok = float((got - want).abs().max()) <= 2e-4 * float(want.abs().max())
            if not ok:
                raise AssertionError(f"mv_splits K={K} N={N}: {ks} splits: outside the limit "
                                     "of its plain version or not the matvec")
            ms[ks] = timed(fn, trials=7) if timing else NOT_MEASURED
    finally:
        setattr(tq, plan_name, plan)
    return ms


def main(argv=None, rows=ROWS) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = card(dev)
    res = {"tool": "mv_splits", "device": str(dev), "card": name, "rows": []}
    print(f"mv_splits: device {dev} [{name}]", flush=True)
    for seed, (path, label, K, N, G, mins) in enumerate(rows, 1):
        i4 = path.startswith("i4t")
        w = weight(K, N, G, mins, seed, dev, i4)
        x = torch.from_numpy(np.random.default_rng(seed).normal(size=(1, K))
                             .astype(np.float32)).to(dev, torch.bfloat16)
        ms = sweep(x, w, path.endswith("gateup"), dev.type == "cuda")
        ks = (tq.i4t_mv_plan if i4 else tq.mv_plan)(K, N, G)
        row = {"path": path, "shape": f"{label} K={K} N={N}" + (f" G={G}" if G else ""),
               "plan_splits": ks, "ms": ms[ks], "split_ms": ms}
        if dev.type == "cuda":
            best = min(ms, key=ms.get)
            row.update(best_splits=best, plan_over_best=ms[ks] / ms[best])
            print(f"mv_splits {path} {row['shape']}: plan {ks} {ms[ks]:.5f} ms, best {best} "
                  f"{ms[best]:.5f} ms [{name}]", flush=True)
        res["rows"].append(row)
        del w, x
    return res


if __name__ == "__main__":
    emit(main())
