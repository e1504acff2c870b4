"""The K splits of the M = 1 int8 matvec (csrc/i8mv.cuh) on the card: each
path row's kernel at every split count 1-8, beside the count that
``ops.qmm.mv_plan`` gives it.

Rows (K, N, group; i8c has none): the 7B i8c weights (qkv, wo, gate-up,
down, lm head: generate_i8c), the 7B Q8_0 matvecs (qkv, wo, lm head:
generate_q8), the 1.3B Q6_K ones (qkv, wo, the lm heads of 32256 and 32000
rows: generate_q6k), TinyLlama's widened to Q8_0 (qkv, wo, lm head:
generate_i8) and the fused gate-ups (the 1.3B at group 16, also with a
mins plane; the 7B at group 32).  Inputs are seeded.  At each split count
the wrapper (``qmm_i8c``, ``qmm_i8t``, ``qmm_i8t_gateup``) is held within
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

# (path, label, K, N, group (0: i8c), mins)
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
        ("gateup", "7B gateup", 4096, 28672, 32, False)]
SPLITS = range(1, 9)


def weight(K: int, N: int, G: int, mins: bool, seed: int, dev) -> QTensor:
    rng = np.random.default_rng(seed)
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
    if gateup:
        fn, want = (lambda: tq.qmm_i8t_gateup(x, w)), None
    elif w.kind == "i8c":
        fn, want = (lambda: tq.qmm_i8c(x, w)), tq.qmm_i8c_plain(x, w)
    else:
        fn, want = (lambda: tq.qmm_i8t(x, w)), tq.qmm_plain(x, w)
    plan, ms = tq.mv_plan, {}
    try:
        for ks in SPLITS:
            tq.mv_plan = lambda K_, N_, G_, ks=ks: ks
            got = fn()
            if gateup:
                g = tq.qmm_i8t(x, w).to(torch.bfloat16)
                ok = torch.equal(got, tq.silu(g[:, :N // 2]) * g[:, N // 2:])
            else:
                ok = float((got - want).abs().max()) <= 2e-4 * float(want.abs().max())
            if not ok:
                raise AssertionError(f"mv_splits K={K} N={N}: {ks} splits: outside the limit "
                                     "of its plain version or not the matvec")
            ms[ks] = timed(fn, trials=7) if timing else NOT_MEASURED
    finally:
        tq.mv_plan = plan
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
        w = weight(K, N, G, mins, seed, dev)
        x = torch.from_numpy(np.random.default_rng(seed).normal(size=(1, K))
                             .astype(np.float32)).to(dev, torch.bfloat16)
        ms = sweep(x, w, path == "gateup", dev.type == "cuda")
        ks = tq.mv_plan(K, N, G)
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
