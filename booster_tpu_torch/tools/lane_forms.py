"""The int8 lane-major matmul's forms on the card, side by side at each M:
csrc/qmm_lane_i8.cu's matvec (up to 32 rows) and wgmma tile (every M; the
heights that fit M, ``ops.qmm.lane_i8_plan``'s splits),
and csrc/qmm_lane.cu's kernel that ran the form before (``("lane",)``), on
the DeepSeek-Coder-1.3B down (5504 → 2048; or the 7B's, 14336 → 4096) with
real Q5_1 planes (``testing.q5_1_weight``) and on the same weight without its mins plane (the
Q8_0 down's form).  Each form is held within 2e-4 of the largest output of
``qmm_lane_plain``, then timed by ``timing.timed`` (CUDA graphs of 20 calls,
each after an L2 scrub, the median of 5), the forms of one M in turn; the
plan's threshold between the matvec and the tile, and any M where the old
kernel stays, are read from these rows (PERF.md §6).

    python -m booster_tpu_torch.tools.lane_forms [--device cuda|cpu] [--shape 1.3b|7b|small]
        [--rows 1,2,4,8,16,32,64,2048]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from booster_tpu_torch.device import resolve_device
from booster_tpu_torch.ops import qmm as tq
from booster_tpu_torch.testing import (q5_1_weight, qmm_lane_mm_split, qmm_lane_mv_split,
                                       without_mins)
from booster_tpu_torch.tools.timing import NOT_MEASURED, bound, card, emit, timed

ROWS = (1, 2, 4, 8, 16, 32, 64, 2048)
SHAPES = {"1.3b": (5504, 2048), "7b": (14336, 4096), "small": (512, 256)}  # the downs' K, N


def forms(M: int, K_: int, N_: int) -> list:
    """The forms worth timing at M rows: the matvec with the fewest m8 tiles
    that hold M (up to 32 rows), the tile at each
    height (32, 64, 128, 256) that holds M in at most 64 tiles of rows and
    is at most twice M, its splits by the plan's rule, and the old
    kernel."""
    out = []
    if M <= 32:
        out.append(("mv", 1 if M <= 8 else 2 if M <= 16 else 4))
    out += [tq.lane_i8_plan(M, K_, N_, bm) for bm in (32, 64, 128, 256)
            if bm >= M / 64 and (bm == 32 or M > bm // 2)]
    if M > 256:  # the largest tile at one split too
        out.append(("mm", 256, 1))
    return list(dict.fromkeys(out)) + [("lane",)]


def run(x: torch.Tensor, w, form: tuple, timing: bool) -> dict:
    """One form on (x, w): checked against the plain version (on the CPU the
    form's mirror stands in for the kernel), then timed where `timing`."""
    want = tq.qmm_lane_plain(x, w)
    if x.device.type == "cuda":
        got = tq.lane_i8_launch(x, w, form)
    elif form[0] == "mv":
        got = qmm_lane_mv_split(x, w)
    elif form[0] == "mm":
        got = qmm_lane_mm_split(x, w, form[2])
    else:
        got = want
    err = float((got - want).abs().max())
    limit = 2e-4 * float(want.abs().max())
    if not err <= limit:
        raise AssertionError(f"lane_forms {form} M={x.shape[0]}: max err {err} over {limit}")
    if not timing:
        return {"ms": NOT_MEASURED, "max_abs_err": err}
    return {"ms": timed(lambda: tq.lane_i8_launch(x, w, form)), "max_abs_err": err}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--shape", default="1.3b", choices=sorted(SHAPES),
                    help="the down: 1.3b (5504 → 2048), 7b (14336 → 4096) or small (a rehearsal)")
    ap.add_argument("--rows", default=",".join(map(str, ROWS)), help="the M to run")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = card(dev)
    K_, N_ = SHAPES[args.shape]
    res = {"tool": "lane_forms", "device": str(dev), "card": name, "rows": []}
    print(f"lane_forms: device {dev} [{name}]", flush=True)
    w = q5_1_weight(N_, K_, seed=24, device=dev)
    for mins, wt in (("Q5_1", w), ("no mins", without_mins(w))):
        sbytes = wt.scales.numel() * 2
        for M in (int(m) for m in args.rows.split(",")):
            x = torch.from_numpy(np.random.default_rng(M).normal(size=(M, K_))
                                 .astype(np.float32)).to(dev, torch.bfloat16)
            b_ms, b_by = bound(N_ * K_ + sbytes + M * K_ * 2 + M * N_ * 4, 2 * M * N_ * K_)
            for form in forms(M, K_, N_):
                row = {"shape": f"{args.shape} down {mins} M={M} K={K_} N={N_}", "form": list(form),
                       "plan": list(tq.lane_i8_plan(M, K_, N_)), "bound_ms": b_ms,
                       "bound_by": b_by, **run(x, wt, form, dev.type == "cuda")}
                if dev.type == "cuda":
                    print(f"lane_forms {row['shape']} {form}: {row['ms']:.5f} ms "
                          f"(bound {b_ms:.5f}, {b_by}) [{name}]", flush=True)
                res["rows"].append(row)
            del x
    return res


if __name__ == "__main__":
    emit(main())
