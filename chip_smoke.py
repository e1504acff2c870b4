#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (booster_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases build,kernels,parity,generate,batch]

Phases, each printing one JSON line with its seconds:

1. build — compile every CUDA kernel of the paths from csrc/ (one nvcc per
   source, all at once); print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them.
2. kernels — at the paths' shapes (TinyLlama-1.1B: batch 1 for the Q4_0
   kernels, batch 64 over a 512-row int8 cache for int8 decode attention,
   the quantizing append, and chunked-prefill attention at both prompt
   buckets, T = 16 and the batch phase's T = 32), each kernel against
   its plain torch version on the same inputs, with the tolerance stated at
   CHECKS; the fused gate-up against qmm + silu·mul (equal); each attention
   check must see the wrong kernels of booster_tpu_torch.testing (a dropped
   self term, a missed last column, a column read past the end, ignored v
   scales) at 8x its limit; median times of kernel, plain version and one
   library call (the yardstick), each call after an L2 scrub (cold, as on
   the decode path), and the kernel's time warm as well.
3. parity — 2-layer models at TinyLlama's full width on the CPU (plain
   versions) and on the card (kernels), both fed the CPU's greedy tokens:
   (a) batch 1, Q4_0, bf16 cache: prefill, then 16 decode steps; (b) the
   batched path: bf16 weights, int8 cache, 4 slots of which 2 are live,
   prefill, then 16 decode steps.  The live slots' logits agree within the
   stated tolerance at every step, and the greedy tokens wherever the
   CPU's top-2 margin exceeds it.
4. generate — the full 22-layer TinyLlama-shaped Q4_0 GGUF (random weights
   from a seed, built by booster_tpu_torch.testing.make_model and cached
   under build/), ``load_model(device="cuda")`` and
   ``Engine(max_batch=1, max_seq=1024, decode_chunk=128).generate`` of 128
   greedy tokens, with the kernels' launch counts reset just before and read
   just after; every kernel of the path must have launched, at the expected
   counts, and no other.  One more generate runs under torch.profiler:
   kernel time and launches per token, and the device busy share.
5. batch — the same GGUF through ``load_model(weights="auto",
   batch_hint=64)``, which must resolve to bf16 weights, and
   ``Engine(max_batch=64, max_seq=512, kv_quantized=True, decode_chunk=32)``
   driven as bench.py's bench_batch drives the reference: 64 slots with
   ``SamplingParams(temp=0.8, top_k=40, seed=s)`` and prompts
   ``f"stream {s} benchmark prompt"``, ``prefill_slots``, one warm chunk,
   then pipelined chunks to 128 tokens.  One warm-up run first; the counts
   are reset just before the measured run and read just after, and must be
   exact: 22 int8 decode attentions per step, one quantizing append per
   step, 22 prefill attentions per prefill chunk, no 4-bit matmul.  It
   prints aggregate and per-stream tok/s, prefill ms, and (one more run
   under torch.profiler) the device busy share and the top kernels.

Then one ``{"kernels": [...]}`` line (each kernel's launches are those of
the path that runs it: generate for the Q4_0 kernels, batch for the int8
ones) and, last, ``{"ok": true, "device": {...}}``.  Without CUDA, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core rate, NVIDIA data sheet
SCRUB_BYTES = 200 << 20  # 4x the H100's 50 MB L2: read between timed calls
PHASES = ("build", "kernels", "parity", "generate", "batch")

# TinyLlama-1.1B (config 1 of bench.py)
TINYLLAMA = dict(vocab_size=32000, hidden=2048, heads=32, kv_heads=4, ff=5632,
                 seed=0, weight_scale=0.05)
PROMPT = "hello world and the end"  # 15 tokens: the 16-row prefill bucket

# tolerances of kernel vs plain version on the card, and why
CHECKS = {
    # f32 sums of the same exact products in another order
    "qmm": "max|kernel - plain| <= 2e-4 * max|plain|",
    # bf16 outputs: g or u may round the other way where their f32 sums differ
    "gateup": "|kernel - plain| <= 2^-7 |plain| + 1e-5 max|plain| per element",
    # online softmax over chunks vs one pass: bf16(p) is rounded against
    # another running max, so a weight may move by 2^-8 of itself
    # (booster_tpu_torch.testing.decode_attn_limit); the check must see a
    # dropped self term, a missed last column and one read past the end
    "attention": "|kernel - plain| <= 2^-8 * 1.01 * (sum_j p_j |v_j|) / l + 1e-5 max|plain| "
                 "per element; each of three wrong kernels exceeds it 8x",
    "append": "exact",
    # the int8 forms: the same bound with the v scale in the weight,
    # 2^-8 * 1.01 * (sum_j p_j |vs_j v_j|) / l; must see the same wrong
    # kernels and one that ignores the v scales, each 8x
    "attention_i8": "|kernel - plain| <= 2^-8 * 1.01 * (sum_j p_j |vs_j v_j|) / l "
                    "+ 1e-5 max|plain| per element; each of four wrong kernels exceeds it 8x",
    "prefill": "|kernel - plain| <= 2^-8 * 1.01 * (sum_j p_j |vs_j v_j|) / l "
               "+ 1e-5 max|plain| per element; each of four wrong kernels exceeds it 8x",
    "append_i8": "exact (payload and scales)",
    # two bf16 roundings of any intermediate may differ and propagate
    "logits": "max|cuda - cpu| <= 2^-5 * max|cpu logit|",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _scrub():
    """Reads a buffer of four times the H100's 50 MB L2 cache, so that the
    next call finds none of its operands there, as on the decode path, where
    about 25 MB of weights stream between two calls of one shape."""
    import torch

    buf = _scrub_buf.get("buf")
    if buf is None:
        buf = _scrub_buf["buf"] = torch.ones(SCRUB_BYTES // 4, device="cuda")
    return buf.sum()


_scrub_buf: dict = {}


def _graph(body, reps: int):
    """`reps` calls of `body` captured in one CUDA graph (called once first,
    so libraries load and workspaces exist before the capture)."""
    import torch

    body()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            body()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def _replay_ms(graph) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def timed(fn, reps: int = 20, trials: int = 5, cold: bool = True) -> float:
    """Device ms per call, from CUDA graphs of `reps` calls replayed `trials`
    times between CUDA events, the median taken.  The graph keeps host
    dispatch out of the measurement (a wrapper's Python costs more than some
    of its kernels).  Cold (the default): each call follows an L2 scrub, and
    a graph of the scrubs alone, replayed in turn, is subtracted."""
    body = (lambda: (_scrub(), fn())) if cold else fn
    graph = _graph(body, reps)
    base = _graph(_scrub, reps) if cold else None
    times = []
    for _ in range(trials):
        t = _replay_ms(graph)
        if base is not None:
            t -= _replay_ms(base)
        times.append(t / reps)
    del graph, base
    return statistics.median(times)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations")


# -- phase 1 -----------------------------------------------------------------


def phase_build() -> dict:
    from booster_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    report = kernels.build()
    libs = {}
    for name, r in report.items():
        lines = [ln.strip() for ln in r["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        libs[name] = {"seconds": round(r["seconds"], 2), "ptxas": lines[:8]}
    return {"phase": "build", "seconds": time.perf_counter() - t0, "libraries": libs}


# -- phase 2 -----------------------------------------------------------------


def _stacked_i4t(L, K, N, gen):
    import torch

    from booster_tpu_torch.gguf import GGMLType
    from booster_tpu_torch.quant.qtensor import QTensor

    qw = torch.randint(0, 256, (L, K // 2, N), dtype=torch.uint8, device="cuda", generator=gen)
    s = (torch.rand((L, 2, K // 64, N), device="cuda", generator=gen) * 0.02 + 1e-3)
    return QTensor("i4t", qw, s.to(torch.bfloat16), None, 32, (N, K), GGMLType.Q4_0, zero=8)


def phase_kernels(entries: list) -> dict:
    import torch
    import torch.nn.functional as F

    from booster_tpu_torch.ops import decode_attention as da
    from booster_tpu_torch.ops import kv_append as ka
    from booster_tpu_torch.ops import qmm as tq
    from booster_tpu_torch.quant.qtensor import dequantize
    from booster_tpu_torch.testing import (decode_attn_case, decode_attn_limit,
                                           decode_attn_mutants)

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    L, C, ff, V = 22, 2048, 5632, 32000
    Hkv, G, D, Dc, S = 4, 8, 64, 128, 1024
    # two layers of each stacked weight (the calls take layer 1's view, as
    # the path takes layer i's); the lm head is one 2-D matrix
    weights = {
        "qkv": _stacked_i4t(2, C, C + 2 * Hkv * D, gen),
        "wo": _stacked_i4t(2, C, C, gen),
        "down": _stacked_i4t(2, ff, C, gen),
        "gateup": _stacked_i4t(2, C, 2 * ff, gen),
        "lm_head": _stacked_i4t(1, C, V, gen),
    }
    failures = []

    for form, M in (("gd", 1), ("dq", 16)):
        for label in ("qkv", "wo", "down", "lm_head", "gateup"):
            if form == "dq" and label == "lm_head":
                continue  # the lm head sees one gathered row at prefill too
            w = weights[label]
            w1 = w.at(w.qw.shape[0] - 1)
            N, K = w.shape
            x = torch.randn(M, K, device="cuda", generator=gen).to(torch.bfloat16)
            gateup = label == "gateup"
            if gateup:
                got = tq.qmm_i4t_gateup(x, w1)
                want = tq.qmm_gateup_plain(x, w1)
                d = (got.float() - want.float()).abs()
                ok = bool((d <= 2 ** -7 * want.float().abs()
                           + 1e-5 * want.float().abs().max()).all())
                gu = tq.qmm_i4t(x, w1).to(torch.bfloat16)
                if not torch.equal(got, tq.silu(gu[:, :ff]) * gu[:, ff:]):
                    failures.append(f"gateup {form}: fused != qmm + silu·mul")
                name = f"qmm_i4t_gateup_{form}"
                kern, plain = tq.qmm_i4t_gateup, tq.qmm_gateup_plain
                out_bytes = M * ff * 2
            else:
                got = tq.qmm_i4t(x, w1)
                want = tq.qmm_plain(x, w1)
                d = (got - want).abs()
                ok = bool(d.max() <= 2e-4 * want.abs().max())
                name = f"qmm_i4t_{form}"
                kern, plain = tq.qmm_i4t, tq.qmm_plain
                out_bytes = M * N * 4
            if not (ok and torch.isfinite(got.float()).all()):
                failures.append(f"{name} {label}: max err {float(d.max())}")
            ms = timed(lambda: kern(x, w1))
            warm_ms = timed(lambda: kern(x, w1), cold=False)
            plain_ms = timed(lambda: plain(x, w1), reps=3, trials=3)
            lib_ms = None
            if not gateup:
                deq = dequantize(w1, torch.bfloat16)
                lib_ms = timed(lambda: torch.matmul(x, deq.t()))
                del deq
            nbytes = K // 2 * N + 2 * (K // 64) * N * 2 + M * K * 2 + out_bytes
            b_ms, b_by = bound(nbytes, 2 * M * K * N)
            entries.append({
                "name": name, "shape": f"{label} M={M} K={K} N={N}",
                "key": (name, (K, N)), "route": "cuda",
                "source": "booster_tpu_torch/csrc/qmm_i4t.cu",
                "replaces": {"qmm_i4t_gd": "booster_tpu/ops/pallas_qmm.py:393",
                             "qmm_i4t_dq": "booster_tpu/ops/pallas_qmm.py:469",
                             "qmm_i4t_gateup_gd": "booster_tpu/ops/pallas_qmm.py:932",
                             "qmm_i4t_gateup_dq": "booster_tpu/ops/pallas_qmm.py:798"}[name],
                "max_abs_err": float(d.max()), "ms": ms, "warm_ms": warm_ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib_ms, "check": CHECKS["gateup" if gateup else "qmm"]})
    del weights

    # decode attention over layer L - 1 of a [22, 1, 4, 1024, 128] cache with
    # the deferred-append self term, at the generate phase's mean cache
    # length (15-token prompt + 0..127 tokens: 79) and late in a 1024-token
    # context; inputs on which a dropped self term or a column missed or
    # read past the end shows (booster_tpu_torch.testing)
    for lens_v in (79, 1000):
        args = decode_attn_case(L, 1, Hkv, G, S, D, Dc, [lens_v], "cuda", seed=lens_v)
        err, share, seen = _attn_check(f"decode_attn lens={lens_v}", da.decode_attn,
                                       da.decode_attn_plain, args, decode_attn_limit,
                                       decode_attn_mutants, failures)
        ms = timed(lambda: da.decode_attn(*args))
        warm_ms = timed(lambda: da.decode_attn(*args), cold=False)
        plain_ms = timed(lambda: da.decode_attn_plain(*args), reps=5, trials=3)
        q, kc, vc, layer, _, _, _, sk, sv, _ = args
        qs = q[..., :D].reshape(1, Hkv * G, 1, D).contiguous()
        kcat = torch.cat([kc[layer, :, :, :lens_v, :D], sk[:, :, None, :D]], dim=2)
        vcat = torch.cat([vc[layer, :, :, :lens_v, :D], sv[:, :, None, :D]], dim=2)
        try:
            lib_ms = timed(lambda: F.scaled_dot_product_attention(
                qs, kcat, vcat, scale=1.0, enable_gqa=True))
        except TypeError:  # older torch: no enable_gqa — expand the kv heads first
            kx, vx = kcat.repeat_interleave(G, 1), vcat.repeat_interleave(G, 1)
            lib_ms = timed(lambda: F.scaled_dot_product_attention(qs, kx, vx, scale=1.0))

        def attn_bytes(width):  # q, the valid K/V rows, self k/v, out
            return (Hkv * G * width * 2 + 2 * Hkv * lens_v * width * 2
                    + 2 * Hkv * width * 2 + Hkv * G * width * 4)
        # the function needs the head dim D: q's pad lanes are zero and the
        # output's are sliced off; the Dc figure is what the padded layout moves
        b_ms, b_by = bound(attn_bytes(D), 4 * Hkv * G * (lens_v + 1) * D)
        entries.append({
            "name": "decode_attn", "shape": f"B=1 Hkv={Hkv} G={G} S={S} Dc={Dc} lens={lens_v}",
            "key": ("decode_attn", None), "route": "cuda",
            "source": "booster_tpu_torch/csrc/decode_attn.cu",
            "replaces": "booster_tpu/ops/pallas_attention.py:177",
            "max_abs_err": err, "max_err_of_limit": share, "min_wrong_kernel_of_limit": seen,
            "ms": ms, "warm_ms": warm_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "bound_ms_at_Dc": bound(attn_bytes(Dc), 0)[0],
            "library_ms": lib_ms, "check": CHECKS["attention"]})

    # all-layer append of one token into the same cache
    nk = torch.randn(L, 1, Hkv, D, device="cuda", generator=gen).to(torch.bfloat16)
    nv = torch.randn(L, 1, Hkv, D, device="cuda", generator=gen).to(torch.bfloat16)
    off = torch.tensor([79], dtype=torch.int32, device="cuda")
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    ka.kv_append(k1, v1, nk, nv, off)
    ka.kv_append_plain(k2, v2, nk, nv, off)
    err = max(float((k1.float() - k2.float()).abs().max()),
              float((v1.float() - v2.float()).abs().max()))
    if err != 0.0:
        failures.append(f"kv_append: max err {err}")
    ms = timed(lambda: ka.kv_append(k1, v1, nk, nv, off))
    warm_ms = timed(lambda: ka.kv_append(k1, v1, nk, nv, off), cold=False)
    plain_ms = timed(lambda: ka.kv_append_plain(k2, v2, nk, nv, off))
    # the new rows read and written at the head dim D (the pad lanes of the
    # cache are zero already); the Dc figure writes the padded rows
    b_ms, b_by = bound(2 * L * Hkv * 2 * D * 2, 0)
    entries.append({
        "name": "kv_append", "shape": f"L={L} B=1 H={Hkv} S={S} Dc={Dc} d={D}",
        "key": ("kv_append", None), "route": "cuda",
        "source": "booster_tpu_torch/csrc/kv_append.cu",
        "replaces": "booster_tpu/ops/pallas_kv.py:246",
        "max_abs_err": err, "ms": ms, "warm_ms": warm_ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by,
        "bound_ms_at_Dc": bound(2 * L * Hkv * (D + Dc) * 2, 0)[0],
        "library_ms": None, "check": CHECKS["append"]})
    del args, kc, vc, k1, v1, k2, v2, kcat, vcat
    torch.cuda.empty_cache()
    _int8_kernels(entries, failures)
    _scrub_buf.clear()
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("kernel checks failed: " + "; ".join(failures))
    return {"phase": "kernels", "seconds": time.perf_counter() - t0,
            "checks": {e["name"] + " " + e["shape"]: e["max_abs_err"] for e in entries}}


def _attn_check(name, kern, plain, args, limit_fn, mutants_fn, failures) -> tuple:
    """Kernel against plain version within the per-element limit, and every
    wrong kernel of `mutants_fn` at 8x it or more: (max error, its share of
    the limit, the smallest mutant share)."""
    import torch

    got, want = kern(*args), plain(*args)
    limit = limit_fn(args)
    d = (got - want).abs()
    if not (bool((d <= limit).all()) and torch.isfinite(got).all()):
        failures.append(f"{name}: max err {float(d.max())}, {float((d / limit).max())} of its limit")
    seen_min = None
    for what, margs in mutants_fn(args).items():
        seen = float(((plain(*margs) - want).abs() / limit).max())
        seen_min = seen if seen_min is None else min(seen_min, seen)
        if seen < 8:
            failures.append(f"{name}: the check cannot see {what} ({seen} of the limit)")
    return float(d.max()), float((d / limit).max()), seen_min


def _int8_kernels(entries: list, failures: list) -> None:
    """The batched path's kernels at its shapes: B = 64 slots, 4 kv heads of
    8 query heads, a 512-row int8 cache of 22 layers (head dim 64 stored at
    128 lanes)."""
    import torch
    import torch.nn.functional as F

    from booster_tpu_torch.ops import decode_attention as da
    from booster_tpu_torch.ops import kv_append as ka
    from booster_tpu_torch.ops import prefill_attention as pa
    from booster_tpu_torch.ops.decode_attention import self_row
    from booster_tpu_torch.testing import (decode_attn_case, decode_attn_limit,
                                           decode_attn_mutants, prefill_attn_case,
                                           prefill_attn_limit, prefill_attn_mutants)

    L, B, Hkv, G, D, Dc, S = 22, 64, 4, 8, 64, 128, 512
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

    def sdpa(q, k, v, mask=None):  # the kv heads expanded to the query heads ahead
        kx, vx = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
        return timed(lambda: F.scaled_dot_product_attention(q, kx, vx, attn_mask=mask,
                                                            scale=1.0))

    # K4: int8 decode attention over layer L - 1, every slot at one length
    # (a short and a long context), the self term live
    for lens_v in (30, 500):
        args = decode_attn_case(L, B, Hkv, G, S, D, Dc, [lens_v] * B, "cuda", seed=lens_v,
                                quantized=True)
        err, share, seen = _attn_check(f"decode_attn_i8 lens={lens_v}", da.decode_attn,
                                       da.decode_attn_plain, args, decode_attn_limit,
                                       decode_attn_mutants, failures)
        ms = timed(lambda: da.decode_attn(*args))
        warm_ms = timed(lambda: da.decode_attn(*args), cold=False)
        plain_ms = timed(lambda: da.decode_attn_plain(*args), reps=3, trials=3)
        q, kc, vc, layer, _, _, _, sk, sv, _, ks, vs = args
        # yardstick: SDPA over a bf16 copy dequantized ahead (the valid rows
        # plus the self row as the cache will hold it)
        kd = torch.cat([(kc[layer, :, :, :lens_v].float() * ks[layer, :, :, :lens_v]),
                        self_row(sk, True)[:, :, None]], 2)[..., :D].to(torch.bfloat16)
        vd = torch.cat([(vc[layer, :, :, :lens_v].float() * vs[layer, :, :, :lens_v]),
                        self_row(sv, True)[:, :, None]], 2)[..., :D].to(torch.bfloat16)
        lib_ms = sdpa(q[..., :D].reshape(B, Hkv * G, 1, D).contiguous(), kd, vd)
        nbytes = (B * Hkv * G * D * 2 + 2 * B * Hkv * lens_v * (D + 4)
                  + 2 * B * Hkv * D * 2 + B * Hkv * G * D * 4)
        b_ms, b_by = bound(nbytes, 4 * B * Hkv * G * (lens_v + 1) * D)
        entries.append({
            "name": "decode_attn_i8", "shape": f"B={B} Hkv={Hkv} G={G} S={S} Dc={Dc} lens={lens_v}",
            "key": ("decode_attn_i8", None), "path": "batch", "route": "cuda",
            "source": "booster_tpu_torch/csrc/decode_attn.cu",
            "replaces": "booster_tpu/ops/pallas_attention.py:177",
            "max_abs_err": err, "max_err_of_limit": share, "min_wrong_kernel_of_limit": seen,
            "ms": ms, "warm_ms": warm_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms,
            "library": "scaled_dot_product_attention over a pre-dequantized bf16 copy",
            "check": CHECKS["attention_i8"]})
        del args, q, kc, vc, sk, sv, ks, vs, kd, vd
        torch.cuda.empty_cache()

    # K5: the quantizing all-layer append of one step, into the same cache
    kc = torch.zeros(L, B, Hkv, S, Dc, dtype=torch.int8, device="cuda")
    ksc = torch.zeros(L, B, Hkv, S, 1, device="cuda")
    nk = (torch.randn(L, B, Hkv, D, device="cuda", generator=gen) * 2).to(torch.bfloat16)
    nv = (torch.randn(L, B, Hkv, D, device="cuda", generator=gen) * 2).to(torch.bfloat16)
    nk[0, 0, 0] = 0  # a zero row
    off = torch.randint(0, S, (B,), dtype=torch.int32, device="cuda", generator=gen)
    out = [(kc.clone(), kc.clone(), ksc.clone(), ksc.clone()) for _ in range(2)]
    ka.kv_append(out[0][0], out[0][1], nk, nv, off, out[0][2], out[0][3])
    ka.kv_append_plain(out[1][0], out[1][1], nk, nv, off, out[1][2], out[1][3])
    exact = all(torch.equal(a, b) for a, b in zip(*out))
    if not exact:
        failures.append("kv_append_i8: payload or scales differ from the plain version")
    k1, v1, ks1, vs1 = out[0]
    ms = timed(lambda: ka.kv_append(k1, v1, nk, nv, off, ks1, vs1))
    warm_ms = timed(lambda: ka.kv_append(k1, v1, nk, nv, off, ks1, vs1), cold=False)
    plain_ms = timed(lambda: ka.kv_append_plain(k1, v1, nk, nv, off, ks1, vs1))
    # the new rows read, the int8 rows (at the head dim D) and scales written
    b_ms, b_by = bound(2 * L * B * Hkv * D * 2 + 2 * L * B * Hkv * (D + 4), 0)
    entries.append({
        "name": "kv_append_i8", "shape": f"L={L} B={B} H={Hkv} S={S} Dc={Dc} d={D}",
        "key": ("kv_append_i8", None), "path": "batch", "route": "cuda",
        "source": "booster_tpu_torch/csrc/kv_append.cu",
        "replaces": "booster_tpu/ops/pallas_kv.py:218",
        "max_abs_err": 0.0 if exact else None, "ms": ms, "warm_ms": warm_ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "bound_ms_at_Dc": bound(2 * L * B * Hkv * D * 2 + 2 * L * B * Hkv * (Dc + 4), 0)[0],
        "library_ms": None, "check": CHECKS["append_i8"]})
    del out, k1, v1, ks1, vs1, kc, ksc

    # K6: chunked-prefill attention of a T-row chunk per slot over one layer,
    # at both prompt buckets (the batch phase's prompts take T = 32: two
    # query tiles per (slot, kv head)), each as the first chunk (pos0 = 0)
    # and as a chunk late in the cache; n_valid of 1 to T rows per slot
    rng = torch.Generator().manual_seed(2)
    for T, pos in ((16, 0), (16, 200), (32, 0), (32, 200)):
        n_valid = [int(x) for x in torch.randint(1, T + 1, (B,), generator=rng)]
        args = prefill_attn_case(B, Hkv, G, T, S, D, Dc, [pos] * B, n_valid, "cuda", seed=pos)
        err, share, seen = _attn_check(f"prefill_attn_i8 T={T} pos0={pos}", pa.prefill_attn,
                                       pa.prefill_attn_plain, args, prefill_attn_limit,
                                       prefill_attn_mutants, failures)
        ms = timed(lambda: pa.prefill_attn(*args))
        warm_ms = timed(lambda: pa.prefill_attn(*args), cold=False)
        plain_ms = timed(lambda: pa.prefill_attn_plain(*args), reps=3, trials=3)
        q, k, v, ks, vs, p0, lens, win, _ = args
        hi = int(lens.max())
        kd = (k[:, :hi].float() * ks[:, :hi, None])[..., :D].to(torch.bfloat16)
        vd = (v[:, :hi].float() * vs[:, :hi, None])[..., :D].to(torch.bfloat16)
        col = torch.arange(hi, device="cuda")
        qpos = p0[:, None] + torch.arange(T, device="cuda")[None, :]  # [BH, T]
        valid = (col[None, None] <= qpos[..., None]) & (col[None, None] < lens[:, None, None])
        mask = valid.reshape(B, Hkv, 1, T, hi)[:, 0]  # the kv heads of a slot agree
        lib_ms = sdpa(q.reshape(B, Hkv * G, T, Dc)[..., :D].contiguous(),
                      kd.reshape(B, Hkv, hi, D), vd.reshape(B, Hkv, hi, D), mask)
        live_cols = int(torch.minimum(p0 + T, lens).sum())  # columns a block reads
        n_pairs = int(valid.sum()) * G  # (query row, valid column) pairs
        nbytes = B * Hkv * G * T * D * 2 + 2 * live_cols * (D + 4) + B * Hkv * G * T * D * 4
        b_ms, b_by = bound(nbytes, 4 * n_pairs * D)
        entries.append({
            "name": "prefill_attn_i8",
            "shape": f"B={B} Hkv={Hkv} G={G} T={T} S={S} Dc={Dc} pos0={pos}",
            "key": ("prefill_attn_i8", None), "path": "batch", "route": "cuda",
            "source": "booster_tpu_torch/csrc/prefill_attn.cu",
            "replaces": "booster_tpu/ops/pallas_attention.py:552",
            "max_abs_err": err, "max_err_of_limit": share, "min_wrong_kernel_of_limit": seen,
            "ms": ms, "warm_ms": warm_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms,
            "library": "scaled_dot_product_attention with a boolean mask over a "
                       "pre-dequantized bf16 copy",
            "check": CHECKS["prefill"]})
        del args, q, k, v, ks, vs, kd, vd, mask
        torch.cuda.empty_cache()


# -- phase 3 -----------------------------------------------------------------


def _gguf(layers: int) -> str:
    from booster_tpu_torch.testing import make_model

    d = ROOT / "build" / "smoke"
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"tinyllama-shape-q4_0-L{layers}-seed0.gguf"
    if not path.exists():
        tmp = path.with_suffix(".tmp")
        make_model(str(tmp), layers=layers, **TINYLLAMA)  # Q4_0 weights
        tmp.replace(path)
    return str(path)


def _teacher_forced(models, caches, prompts, T, live, steps=16) -> list:
    """Prefill `prompts` (one per slot, [] for an idle slot) in one T-row
    batch, then `steps` decode steps with the live slots fed the CPU's
    greedy token, on every device of `models`; returns per device the live
    slots' logits [steps + 1, n_live, V] on the CPU."""
    import torch

    from booster_tpu_torch.models.llama import forward

    B = len(prompts)
    arr = torch.zeros(B, T, dtype=torch.int32)
    nv = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    for b, ids in enumerate(prompts):
        arr[b, :len(ids)] = torch.tensor(ids, dtype=torch.int32)
    rows = torch.tensor(live).nonzero()[:, 0]
    logits = {}
    for dev, m in models.items():
        lg, caches[dev] = forward(m.params, m.cfg, arr.to(dev), caches[dev],
                                  gather_idx=torch.clamp_min(nv - 1, 0).to(dev),
                                  n_valid=nv.to(dev))
        logits[dev] = [lg[rows, -1].float().cpu()]
    step_nv = torch.tensor(live, dtype=torch.int32)
    for _ in range(steps):
        tok = torch.zeros(B, 1, dtype=torch.int32)
        tok[rows, 0] = torch.argmax(logits["cpu"][-1], -1).to(torch.int32)
        for dev, m in models.items():
            lg, caches[dev] = forward(m.params, m.cfg, tok.to(dev), caches[dev],
                                      last_only=True, n_valid=step_nv.to(dev))
            logits[dev].append(lg[rows, -1].float().cpu())
    return [torch.stack(logits[dev]) for dev in ("cuda", "cpu")]


def _compare_logits(name, got, want, tol) -> dict:
    """Card logits against CPU logits, [steps, rows, V]: within `tol` of the
    largest CPU logit at every step, the greedy tokens equal wherever the
    CPU's top-2 margin exceeds it."""
    import torch

    if not torch.isfinite(got).all():
        raise AssertionError(f"parity {name}: non-finite logits on the card")
    scale = want.abs().amax(-1)  # [steps, rows]
    errs = (got - want).abs().amax(-1) / scale
    top2 = torch.topk(want, 2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]) / scale
    same = torch.argmax(got, -1) == torch.argmax(want, -1)
    if bool((~same & (margin > tol)).any()):
        raise AssertionError(f"parity {name}: a greedy token differs at a margin over {tol}")
    if float(errs.max()) > tol:
        raise AssertionError(f"parity {name}: logits differ by {float(errs.max())} > {tol}")
    return {"prefill_rel_err": float(errs[0].max()), "first_decode_rel_err": float(errs[1].max()),
            "max_rel_err": float(errs.max()),
            "greedy_tokens_equal": f"{int(same.sum())}/{same.numel()}"}


def phase_parity() -> dict:
    from booster_tpu_torch.models import load_model
    from booster_tpu_torch.ops.kv_cache import KVCache

    t0 = time.perf_counter()
    path = _gguf(2)
    tol = 2 ** -5
    out = {"phase": "parity", "layers": 2, "tolerance": CHECKS["logits"]}
    # (a) batch 1, Q4_0 weights, bf16 cache (the generate path)
    models = {dev: load_model(path, device=dev) for dev in ("cpu", "cuda")}
    cfg = models["cpu"].cfg
    ids = models["cpu"].tokenizer.encode(PROMPT)
    T = max(16, 1 << (len(ids) - 1).bit_length())  # the engine's prompt bucket
    caches = {dev: KVCache.create(cfg.n_layers, 1, 256, cfg.n_kv_heads, cfg.head_dim, dev)
              for dev in models}
    got, want = _teacher_forced(models, caches, [ids], T, [True])
    out["q4_0_bf16_cache_1_slot"] = _compare_logits("q4_0", got, want, tol)
    # (b) the batched path: bf16 weights, int8 cache, 4 slots, 2 of them live
    models = {dev: load_model(path, device=dev, weights="bf16") for dev in ("cpu", "cuda")}
    tok = models["cpu"].tokenizer
    prompts = [tok.encode("stream 0 benchmark prompt"), [],
               tok.encode("stream 2 benchmark prompt"), []]
    T = max(16, 1 << (max(len(p) for p in prompts) - 1).bit_length())
    caches = {dev: KVCache.create(cfg.n_layers, 4, 512, cfg.n_kv_heads, cfg.head_dim, dev,
                                  quantized=True) for dev in models}
    got, want = _teacher_forced(models, caches, prompts, T, [True, False, True, False])
    out["bf16_int8_cache_4_slots_2_live"] = _compare_logits("batched", got, want, tol)
    lengths = [caches[dev].lengths.tolist() for dev in ("cpu", "cuda")]
    expect = [len(prompts[0]) + 16, 0, len(prompts[2]) + 16, 0]
    if lengths != [expect, expect]:
        raise AssertionError(f"parity batched: cache lengths {lengths} != {expect}")
    out["seconds"] = time.perf_counter() - t0
    return out


# -- phase 4 -----------------------------------------------------------------


def _profile(run, steps: int) -> dict:
    """One more run of a path under torch.profiler: the kernels' device time (the
    sum over CUDA kernel events; one stream, so they do not overlap), their
    count per decoded token, and the kernels that take the most time.  The
    profiler stretches the host side, so shares are taken against the wall
    time of the unprofiled run by the caller."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        rows.append((e.key[:70], us / 1e3, e.count))
    if not rows:
        return {"kernel_ms": None, "note": "the trace held no device events"}
    rows.sort(key=lambda r: -r[1])
    return {"kernel_ms": sum(r[1] for r in rows),
            "kernel_launches_per_decoded_token": sum(r[2] for r in rows) / steps,
            "top_kernels_ms": [[k, round(ms, 3), n] for k, ms, n in rows[:12]]}


def phase_generate(layers: int) -> dict:
    import torch

    from booster_tpu_torch.models import load_model
    from booster_tpu_torch.ops import kernels
    from booster_tpu_torch.sampling import SamplingParams
    from booster_tpu_torch.serving import Engine

    t0 = time.perf_counter()
    path = _gguf(layers)
    t_build = time.perf_counter() - t0
    model = load_model(path, device="cuda")
    t_load = time.perf_counter() - t0 - t_build
    eng = Engine(model, max_batch=1, max_seq=1024, decode_chunk=128)
    ids = model.tokenizer.encode(PROMPT)
    sp = SamplingParams(temp=0.0)
    eng.generate(ids, sp, max_new_tokens=128)  # warm-up: first calls of every op
    torch.cuda.synchronize()
    kernels.reset_counts()
    t_run = time.perf_counter()
    res = eng.generate(ids, sp, max_new_tokens=128)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t_run)
    counts = dict(kernels.launch_counts)
    shape_counts = dict(kernels.shape_counts)
    shapes = {f"{k[0]}:{k[1][0]}x{k[1][1]}": v for k, v in shape_counts.items()}
    steps = 128  # one chunk of decode_chunk steps runs whatever the host keeps
    L = layers
    expected = dict.fromkeys(counts, 0) | {
        "qmm_i4t_gd": (3 * L + 1) * steps + 1, "qmm_i4t_dq": 3 * L,
        "qmm_i4t_gateup_gd": L * steps, "qmm_i4t_gateup_dq": L,
        "decode_attn": L * steps, "kv_append": steps}
    if counts != expected:
        raise AssertionError(f"launch counts {counts} != expected {expected}")
    prof = _profile(lambda: eng.generate(ids, sp, max_new_tokens=128), steps=128)
    if prof["kernel_ms"] is not None:
        prof["device_busy_share"] = prof["kernel_ms"] / wall_ms
    V = model.cfg.n_vocab
    if not (len(res.token_ids) >= 1 and all(0 <= t < V for t in res.token_ids)):
        raise AssertionError("generate: bad token ids")
    if res.n_generated != 128 and res.finish_reason != "stop":
        raise AssertionError(f"generate: {res.n_generated} tokens, {res.finish_reason}")
    return {"phase": "generate", "seconds": time.perf_counter() - t0, "layers": layers,
            "gguf_build_s": t_build, "load_s": t_load,
            "n_prompt": res.n_prompt, "n_generated": res.n_generated,
            "finish_reason": res.finish_reason,
            "decode_tok_per_s": 1000.0 / res.gen_ms_per_token,
            "decode_ms_per_token": res.gen_ms_per_token,
            "prompt_ms_per_token": res.prompt_ms_per_token, "ttft_ms": res.ttft_ms,
            "launches": counts, "launches_per_decoded_token": {
                k: v / steps for k, v in counts.items() if k.endswith("_gd") or k in (
                    "decode_attn", "kv_append")},
            "launches_by_shape": shapes, "tokens_head": res.token_ids[:16],
            "wall_ms": wall_ms, "profile": prof,
            "_shape_counts": shape_counts}


# -- phase 5 -----------------------------------------------------------------


def _bench_batch(eng, tokenizer, n_streams: int, n_tokens: int) -> dict:
    """bench.py's bench_batch on the port: claim every slot, prefill the
    prompts in one batch, one warm chunk, then pipelined chunks of 32 to
    n_tokens (each chunk enqueued before the previous one is read)."""
    import torch

    from booster_tpu_torch.sampling import SamplingParams

    t_start = time.perf_counter()
    eng.init_batch_state()
    prompts = {}
    for s in range(n_streams):
        eng.reset_slot(s, SamplingParams(temp=0.8, top_k=40, seed=s), seed=s)
        prompts[s] = tokenizer.encode(f"stream {s} benchmark prompt")
    t0 = time.perf_counter()
    first = eng.prefill_slots(prompts)  # ends in the first tokens' readback
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    last = dict(first)
    toks, _ = eng.decode_slots(last, n_steps=32)  # the warm chunk
    rows = {s: [first[s]] + toks[s] for s in prompts}
    slots = list(prompts)
    t0 = time.perf_counter()
    done_tokens = 0
    steps = 32
    handle = eng.decode_slots_start(slots, n_steps=32)
    while steps < n_tokens:
        nxt = eng.decode_slots_start(slots, n_steps=32)  # pipelined
        toks, _ = eng.decode_slots_finish(handle)
        done_tokens += sum(len(r) for r in toks.values())
        for s, r in toks.items():
            rows[s] += r
        handle = nxt
        steps += 32
    toks, _ = eng.decode_slots_finish(handle)
    done_tokens += sum(len(r) for r in toks.values())
    for s, r in toks.items():
        rows[s] += r
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return {"agg_tok_per_s": done_tokens / dt, "per_stream_tok_per_s": done_tokens / dt / n_streams,
            "prefill_ms": prefill_ms, "decode_s": dt, "decoded_tokens": done_tokens,
            "wall_ms": 1e3 * (time.perf_counter() - t_start), "decode_steps": steps + 32,
            "prompt_tokens": {s: len(p) for s, p in prompts.items()}, "rows": rows}


def phase_batch(layers: int) -> dict:
    import torch

    from booster_tpu_torch.models import load_model
    from booster_tpu_torch.ops import kernels
    from booster_tpu_torch.serving import Engine

    t0 = time.perf_counter()
    path = _gguf(layers)
    t_load = time.perf_counter()
    model = load_model(path, device="cuda", weights="auto", batch_hint=64)
    t_load = time.perf_counter() - t_load
    kinds = {k: v.kind for k, v in model.params["layers"].items() if hasattr(v, "kind")}
    kinds["output"] = model.params["output"].kind
    if set(kinds.values()) != {"dense"}:
        raise AssertionError(f"batch: weights=auto at batch_hint=64 gave {kinds}, not bf16")
    B, n_tokens = 64, 128
    eng = Engine(model, max_batch=B, max_seq=512, kv_quantized=True, decode_chunk=32)
    _bench_batch(eng, model.tokenizer, B, n_tokens)  # warm-up: first calls of every op
    kernels.reset_counts()
    res = _bench_batch(eng, model.tokenizer, B, n_tokens)
    counts = dict(kernels.launch_counts)
    steps = res["decode_steps"]
    T = max(16, 1 << (max(res["prompt_tokens"].values()) - 1).bit_length())
    prefill_chunks = 1  # every prompt fits one chunk of the engine's 512
    expected = dict.fromkeys(counts, 0) | {"decode_attn_i8": layers * steps,
                                           "kv_append_i8": steps,
                                           "prefill_attn_i8": layers * prefill_chunks}
    if counts != expected or kernels.shape_counts:
        raise AssertionError(f"batch: launch counts {counts} != expected {expected}")
    V = model.cfg.n_vocab
    lengths = eng.cache.lengths.tolist()
    for s, row in res["rows"].items():
        if not all(0 <= t < V for t in row):
            raise AssertionError(f"batch: slot {s} sampled a token id out of range")
        # a slot emits every step of a chunk until an end-of-generation
        # token (the next chunk resumes it, as in the reference); its cache
        # advances once per emitted step
        emitted = len(row) - 1  # the first token is sampled at prefill
        stopped = any(t in model.tokenizer.vocab.eog_ids for t in row)
        if lengths[s] != res["prompt_tokens"][s] + emitted or not (emitted == steps or stopped):
            raise AssertionError(f"batch: slot {s} length {lengths[s]} after {emitted} steps")
    prof = _profile(lambda: _bench_batch(eng, model.tokenizer, B, n_tokens), steps=steps)
    if prof["kernel_ms"] is not None:
        prof["device_busy_share"] = prof["kernel_ms"] / res["wall_ms"]
    return {"phase": "batch", "seconds": time.perf_counter() - t0, "layers": layers,
            "weights": "bf16", "load_s": t_load, "streams": B, "prefill_T": T,
            "agg_tok_per_s": res["agg_tok_per_s"],
            "per_stream_tok_per_s": res["per_stream_tok_per_s"],
            "prefill_ms": res["prefill_ms"], "decode_s": res["decode_s"],
            "decoded_tokens": res["decoded_tokens"], "decode_steps": steps,
            "wall_ms": res["wall_ms"], "launches": counts, "expected_launches": expected,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
            "tokens_head_slot0": res["rows"][0][:16], "profile": prof}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    if set(phases) - set(PHASES):
        ap.error(f"phases are {PHASES}")
    if not (ROOT / "booster_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py: booster_tpu_torch/ not found beside this script "
              "(run it from a checkout of the repository)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available; this smoke run needs a GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' f32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    entries: list = []
    path_counts: dict = {}
    shape_counts: dict = {}
    t_all = time.perf_counter()
    if "build" in phases:
        emit(phase_build())
    print(smi_line(), flush=True)
    if "kernels" in phases:
        emit(phase_kernels(entries))
    if "parity" in phases:
        emit(phase_parity())
    if "generate" in phases:
        gen = phase_generate(22)
        shape_counts = gen.pop("_shape_counts")
        path_counts["generate"] = gen["launches"]
        emit(gen)
        torch.cuda.empty_cache()
    if "batch" in phases:
        bat = phase_batch(22)
        path_counts["batch"] = bat["launches"]
        emit(bat)
    if entries:
        from booster_tpu_torch.ops import kernels

        for e in entries:
            name, shape = e.pop("key")
            counts = path_counts.get(e.pop("path", "generate"))
            if counts is None:
                e["launches"] = None
            elif shape is None:
                e["launches"] = counts[name]
            else:
                e["launches"] = shape_counts.get((name, shape), 0)
        emit({"kernels": entries, "seconds_total": time.perf_counter() - t_all,
              "counted_kernels": sorted(kernels.launch_counts)})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
