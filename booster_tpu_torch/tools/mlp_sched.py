"""The whole MLP's schedule on the card: the kernel beside the unfused
kernels it equals and beside parts of itself.

At config 3's 7B widths (hidden 4096, ff 14336, Q8_0) and M = 1, 16, 64
rows, times in one process (``timing.timed``: CUDA graphs of 20 calls, each
after an L2 scrub):

- ``mlp``: ``ops.mlp.qmm_mlp_i8t``, the kernel of csrc/mlp_i8t.cu as the
  serving path launches it (every item id in order, two blocks an SM, the
  down items waiting for their pairs);
- ``unfused``: the sequence it equals bit for bit (the gate-up, silu·mul,
  the down matmul in the dequantize form, a cast to bf16);
- ``gateup_items``: the kernel on the gate-up items alone (ids [0, nA));
- ``down_items``: the kernel on the down items alone (ids [nA, nA + nD)),
  on a mid computed before, with no waits;
- ``workers=<n>``: the whole MLP on n blocks (the kernel is built for two
  an SM: blocks past that wait for a free slot, and take the ids left).

Each row's bound is that of the bytes its items stream (x and mid from L2
aside) and of its operations: the whole MLP's for the whole, each part's
own for a part.  Every run of the whole MLP must equal the unfused sequence
bit for bit.

    python -m booster_tpu_torch.tools.mlp_sched [--device cuda|cpu] [--m 1,16,64]
        [--k 4096 --ff 14336 --c 4096] [--workers 132,396]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from booster_tpu_torch.device import resolve_device
from booster_tpu_torch.gguf import GGMLType
from booster_tpu_torch.ops import mlp as tm
from booster_tpu_torch.ops import qmm as tq
from booster_tpu_torch.quant.qtensor import QTensor
from booster_tpu_torch.tools.timing import NOT_MEASURED, bound, card, emit, timed


def _i8t(K: int, N: int, rng, dev) -> QTensor:
    qw = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int8)).to(dev)
    s = torch.from_numpy((rng.random((1, K // 32, N)) * 2e-3 + 1e-4).astype(np.float32))
    return QTensor("i8t", qw, s.to(dev, torch.bfloat16), None, 32, (N, K), GGMLType.Q8_0)


def unfused(x: torch.Tensor, wg: QTensor, wd: QTensor) -> torch.Tensor:
    """The kernels that the whole MLP equals: the gate-up (at one row the
    dequantize-form matmul on the fused weight, then silu·mul), the down
    matmul in the dequantize form, a cast to bf16."""
    ff = wg.shape[0] // 2
    if x.shape[0] == 1:
        g = tq.qmm_i8t(x, wg, dq=True).to(torch.bfloat16)
        mid = tq.silu(g[:, :ff]) * g[:, ff:]
    else:
        mid = tq.qmm_i8t_gateup(x, wg)
    return tq.qmm_i8t(mid, wd, dq=True).to(torch.bfloat16)


def _part_bound(plan: dict, items: range, ops: int) -> tuple:
    """The bound of a part of the MLP: the payload and scale bytes its items
    stream (``ops.mlp.item_bytes``) and its operations."""
    return bound(sum(tm.item_bytes(plan, i) for i in items), ops)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--m", default="1,16,64", help="rows of x, comma-separated")
    ap.add_argument("--k", type=int, default=4096, help="hidden width")
    ap.add_argument("--ff", type=int, default=14336, help="the MLP's inner width")
    ap.add_argument("--c", type=int, default=4096, help="output width")
    ap.add_argument("--workers", default="132,396",
                    help="block counts to run the whole MLP on, besides two an SM")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    K, ff, C = args.k, args.ff, args.c
    rng = np.random.default_rng(0)
    wg, wd = _i8t(K, 2 * ff, rng, dev), _i8t(ff, C, rng, dev)
    name = card(dev)
    res = {"tool": "mlp_sched", "device": str(dev), "card": name, "rows": []}
    print(f"mlp_sched: device {dev} [{name}]", flush=True)
    for M in (int(m) for m in args.m.split(",")):
        x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(dev, torch.bfloat16)
        want = unfused(x, wg, wd) if dev.type == "cuda" else tm.qmm_mlp_plain(x, wg, wd)
        nbytes = K * 2 * ff + K // 32 * 2 * ff * 2 + ff * C + ff // 32 * C * 2 + 4 * M * K
        b_ms, b_by = bound(nbytes, 2 * M * K * 2 * ff + 2 * M * ff * C)
        if dev.type != "cuda":
            got = tm.qmm_mlp_i8t(x, wg, wd)
            res["rows"].append({"M": M, "name": "mlp", "ms": NOT_MEASURED, "bound_ms": b_ms,
                                "equal": bool(torch.equal(got, want))})
            continue
        plan = tm.mlp_plan(M, K, ff, C, wg.group)
        nA, nD = plan["nA"], plan["nD"]
        _, mid = tm._run(x, wg, wd)
        cases = {"mlp": (lambda: tm.qmm_mlp_i8t(x, wg, wd), True, (b_ms, b_by)),
                 "unfused": (lambda: unfused(x, wg, wd), False, (b_ms, b_by)),
                 "gateup_items": (lambda: tm._run(x, wg, wd, 0, nA), False,
                                  _part_bound(plan, range(nA), 2 * M * K * 2 * ff)),
                 "down_items": (lambda: tm._run(x, wg, wd, nA, nD, mid=mid), False,
                                _part_bound(plan, range(nA, nA + nD), 2 * M * ff * C))}
        for w in (int(v) for v in args.workers.split(",")):
            cases[f"workers={w}"] = (lambda w=w: tm._run(x, wg, wd, workers=w)[0], True,
                                     (b_ms, b_by))
        for label, (fn, whole, (p_ms, p_by)) in cases.items():
            row = {"M": M, "name": label, "bm": plan["bm"], "ks1": plan["ks1"],
                   "ks2": plan["ks2"]}
            if whole:
                row["equal"] = bool(torch.equal(fn(), want))
            row["ms"] = timed(fn)
            row["warm_ms"] = timed(fn, cold=False)
            row["bound_ms"], row["bound_by"] = p_ms, p_by
            row["share_of_bound"] = p_ms / row["ms"]
            print(f"mlp_sched M={M} {label}: {row['ms']:.5f} ms cold, {row['warm_ms']:.5f} warm"
                  f" ({100 * row['share_of_bound']:.1f} % of its {p_by} bound {p_ms:.5f} ms)"
                  f"{'' if 'equal' not in row else ', equal' if row['equal'] else ', DIFFERS'}"
                  f" [{name}]", flush=True)
            res["rows"].append(row)
        del x, mid
    bad = [f"M={r['M']} {r['name']}" for r in res["rows"] if r.get("equal") is False]
    if bad:
        raise AssertionError(f"mlp_sched: the whole MLP differs from the unfused kernels: {bad}")
    return res


if __name__ == "__main__":
    emit(main())
