"""Device time per call on the card, the card's bounds, and the probe tools'
report lines.

Counterpart of ``tools/qmm_clean.py``'s ``timeit`` (a scan of N steps on the
TPU, the slope between two trip counts): on the H100 a call is timed from a
CUDA graph of `reps` calls replayed between CUDA events, the median of
`trials` replays, so host dispatch stays out of the measurement.  Cold (the
default): each call follows a read of four times the 50 MB L2 cache, and a
graph of those reads alone, replayed in turn, is subtracted; the decode
path finds its weights cold, and the probes' operands (11.5-46 MB) would
otherwise stay in L2.  On the CPU nothing is timed: ``measure`` reports
"not measured".
"""

from __future__ import annotations

import json
import statistics
import subprocess
from typing import Callable, Optional

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core rate, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core rate, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores, NVIDIA data sheet
SCRUB_BYTES = 200 << 20  # 4x the H100's 50 MB L2: read between timed calls
NOT_MEASURED = "not measured"

_scrub_buf: dict = {}


def scrub():
    """Reads a buffer of four times the H100's 50 MB L2 cache, so that the
    next call finds none of its operands there, as on the decode path, where
    about 25 MB of weights stream between two calls of one shape."""
    buf = _scrub_buf.get("buf")
    if buf is None:
        buf = _scrub_buf["buf"] = torch.ones(SCRUB_BYTES // 4, device="cuda")
    return buf.sum()


def release() -> None:
    """Frees the scrub buffer (200 MB on the card)."""
    _scrub_buf.clear()


def graph(body: Callable, reps: int):
    """`reps` calls of `body` captured in one CUDA graph (called once first,
    so libraries load and workspaces exist before the capture)."""
    body()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            body()
    g.replay()
    torch.cuda.synchronize()
    return g


def replay_ms(g) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def timed(fn: Callable, reps: int = 20, trials: int = 5, cold: bool = True) -> float:
    """Device ms per call, from CUDA graphs of `reps` calls replayed `trials`
    times between CUDA events, the median taken.  The graph keeps host
    dispatch out of the measurement (a wrapper's Python costs more than some
    of its kernels).  Cold (the default): each call follows an L2 scrub, and
    a graph of the scrubs alone, replayed in turn, is subtracted.  `fn` is
    called reps + 1 times."""
    body = (lambda: (scrub(), fn())) if cold else fn
    g = graph(body, reps)
    base = graph(scrub, reps) if cold else None
    times = []
    for _ in range(trials):
        t = replay_ms(g)
        if base is not None:
            t -= replay_ms(base)
        times.append(t / reps)
    del g, base
    return statistics.median(times)


def bound(nbytes: float, ops: float, ops_per_s: float = BF16_OPS_PER_S) -> tuple[float, str]:
    """The least ms the card could take: the bytes over 3.35 TB/s or the
    operations over `ops_per_s`, the larger, and which of the two it is."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations")


def card(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def measure(fn: Callable, device: torch.device, reps: int = 20, trials: int = 5) -> dict:
    """Cold and warm ms per call of `fn` on the card, and the calls of `fn`
    that took (each a launch of its kernels: a wrapper counts a launch when
    it is called, also while a graph is captured); on the CPU nothing."""
    if device.type != "cuda":
        return {"ms": NOT_MEASURED, "warm_ms": NOT_MEASURED, "calls": 0}
    return {"ms": timed(fn, reps, trials), "warm_ms": timed(fn, reps, trials, cold=False),
            "calls": 2 * (reps + 1)}


class Ladder:
    """The rungs of one probe tool: each rung's check against its plain
    version, its cold and warm times, GB/s of the quantized stream and share
    of the bound, printed as a line and kept for ``result``."""

    def __init__(self, tool: str, device: torch.device):
        self.tool, self.device, self.card = tool, device, card(device)
        self.rungs: list = []
        print(f"{tool}: device {device} [{self.card}]", flush=True)

    def rung(self, name: str, fn: Callable, plain: Optional[Callable], stream_bytes: int,
             nbytes: int, ops: float, ops_per_s: float = BF16_OPS_PER_S, exact: bool = False,
             step: Optional[Callable] = None, kernel: Optional[str] = None) -> dict:
        """`fn` computes the rung's function (a kernel wrapper), `plain` the
        same from its plain version (None: no check, as for a library call);
        the error is max|fn - plain| on the card, held to 0 (`exact`) or to
        2e-4 of the largest |plain| (on the CPU `fn` is the plain version).
        `step` (default `fn`) is what is timed: the JAX tool's step, which
        may feed the output back as the next input.  `kernel`: the launch
        counter (ops.kernels) that each call of `fn` and of `step` adds one
        to; the rung's "launches" are the calls it made."""
        got = fn()
        err, limit = 0.0, 0.0
        if plain is not None and self.device.type == "cuda":
            want = plain()
            err = float((got.double() - want.double()).abs().max())
            limit = 0.0 if exact else 2e-4 * float(want.double().abs().max())
        t = measure(step or fn, self.device)
        b_ms, b_by = bound(nbytes, ops, ops_per_s)
        launches = 1 + t["calls"] if kernel is not None and self.device.type == "cuda" else 0
        r = {"name": name, **t, "kernel": kernel, "launches": launches, "bytes": stream_bytes,
             "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err, "limit": limit,
             "ok": err <= limit, "card": self.card}
        if isinstance(t["ms"], float):
            r["gb_s"] = stream_bytes / (t["ms"] * 1e-3) / 1e9
            r["share_of_bound"] = b_ms / t["ms"]
            times = (f"{t['ms']:.5f} ms cold, {t['warm_ms']:.5f} warm, {r['gb_s']:.1f} GB/s, "
                     f"{100 * r['share_of_bound']:.1f} % of its {b_by} bound {b_ms:.5f} ms")
        else:
            r["gb_s"] = r["share_of_bound"] = NOT_MEASURED
            times = f"{NOT_MEASURED} (bound {b_ms:.5f} ms, {b_by})"
        print(f"{self.tool} {name}: {times}; err {err:.3g} (limit {limit:.3g}) "
              f"[{self.card}]", flush=True)
        self.rungs.append(r)
        return r

    def result(self) -> dict:
        bad = [r["name"] for r in self.rungs if not r["ok"]]
        if bad:
            raise AssertionError(f"{self.tool}: kernel and plain version disagree: {bad}")
        return {"tool": self.tool, "device": str(self.device), "card": self.card,
                "rungs": self.rungs}


def emit(result: dict) -> None:
    print(json.dumps(result), flush=True)
