"""The M = 1 int8 matvec's plan and arithmetic, on the CPU.

csrc/i8mv.cuh runs qmm_i8t.cu's group-dot matvec and fused gate-up (i8t at
group 16 or 32, with an optional mins plane) and qmm_i8c.cu's matvec at one
row of x.  A lane streams 4 columns of a warp's chunks of K (a group, or 32
rows for i8c), the chunks of a K split dealt to a block's 8 warps in turn; a
block adds its warps in order, and a 128-column tile's KS splits, one
cluster, add in split order.  Every wrapper takes KS from ``ops.qmm.mv_plan``,
a function of (K, N, G) alone, which keeps the fused gate-up equal to the
matvec on its fused weight.  These tests hold the plan to what the kernel
needs, hold the wrappers to the plan (through a stand-in for the compiled
library, so no card is needed), and hold the sum order, mirrored in plain
torch (``testing.qmm_mv_split``), to the matmuls' limit (2e-4 of the largest
output) against the plain versions; each wrong kernel of
``testing.qmm_mv_mutants`` must land 8x past it."""

import types

import numpy as np
import pytest
import torch

from booster_tpu_torch.gguf import GGMLType
from booster_tpu_torch.ops import kernels
from booster_tpu_torch.ops import qmm as tq
from booster_tpu_torch.quant.qtensor import QTensor
from booster_tpu_torch.testing import mv_chunks, qmm_mv_mutants, qmm_mv_split
from booster_tpu_torch.testing import torch_threads

SMS = 132

# (K, N, G) of the M = 1 matvecs of the paths: the 7B i8c (qkv, wo, gate-up,
# down, lm head), the 7B Q8_0 (qkv, wo, lm head, the fused gate-up), the 1.3B
# Q6_K (qkv, wo, lm heads of 32256 and 32000, the fused gate-up) and
# TinyLlama with weights="i8" (qkv, wo, lm head)
PATHS = [(4096, 6144, 0), (4096, 4096, 0), (4096, 28672, 0), (14336, 4096, 0), (4096, 32000, 0),
         (4096, 6144, 32), (4096, 4096, 32), (4096, 32000, 32), (4096, 28672, 32),
         (2048, 6144, 16), (2048, 2048, 16), (2048, 32256, 16), (2048, 32000, 16),
         (2048, 11008, 16), (2048, 2560, 32), (2048, 2048, 32), (2048, 32000, 32)]
# ragged: K not a power of two (i8t: a multiple of 64; i8c: of 256), N a
# multiple of 128 only, a single tile, splits with a chunk a warp or fewer
RAGGED = [(1088, 384, 32), (1088, 384, 16), (64, 128, 32), (64, 128, 16), (5632, 2048, 32),
          (768, 640, 0), (256, 128, 0), (1280, 384, 0), (14336, 128, 16), (4096, 1152, 32)]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


@pytest.mark.parametrize("K,N,G", PATHS + RAGGED)
def test_plan_chunks_cover_k_once(K, N, G):
    """Every row of K in exactly one chunk of one warp of one split; the
    splits contiguous and in order; the warps of a split within one chunk
    of each other, each with one at least; at most 8 splits (one
    cluster)."""
    ks = tq.mv_plan(K, N, G)
    assert 1 <= ks <= 8
    r = tq.mv_chunk_rows(G)
    splits = mv_chunks(K, N, G)
    assert len(splits) == ks and all(len(warps) == 8 for warps in splits)
    rows = [k for warps in splits for starts in warps for c in starts for k in range(c, c + r)]
    assert sorted(rows) == list(range(K))
    spans = [(min(c for st in warps for c in st), max(c for st in warps for c in st) + r)
             for warps in splits]
    assert spans[0][0] == 0 and spans[-1][1] == K
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    for warps in splits:
        n = [len(st) for st in warps]
        assert max(n) - min(n) <= 1 and (min(n) >= 1 or ks == 1)
        assert all(st == sorted(st) for st in warps)


@pytest.mark.parametrize("K,N,G", PATHS + RAGGED)
def test_plan_tiles_and_grid(K, N, G):
    """Every column in one 128-column tile, of the matvec and, where N is a
    multiple of 256, of the fused gate-up (a tile pair a block, the same
    splits); no more blocks than two an SM once there is more than one
    split.  (The block's shared memory is static, so nvcc holds it to 48 KB.)"""
    ks = tq.mv_plan(K, N, G)
    assert N % 128 == 0
    if N % 256 == 0 and G:
        assert (N // 2) % 128 == 0 and tq.mv_plan(K, N, G) == ks
    assert (N // 128) * ks <= 2 * SMS or ks == 1


@pytest.mark.parametrize("K,N,G,ks", [(4096, 6144, 0, 4), (4096, 4096, 0, 6), (14336, 4096, 0, 6),
                                      (4096, 32000, 0, 1), (4096, 6144, 32, 4), (2048, 2048, 16, 8),
                                      (2048, 2560, 32, 8), (2048, 11008, 16, 2),
                                      (2048, 32256, 16, 1), (64, 128, 32, 1)])
def test_plan_at_the_measured_shapes(K, N, G, ks):
    """The splits measured best on the H100 for the path shapes (PERF.md
    §6): about 1.5 blocks an SM, one split from 132 tiles on."""
    assert tq.mv_plan(K, N, G) == ks


def _i8t(K, N, G, mins=False, seed=0):
    rng = np.random.default_rng(seed)
    lo = -127 if G == 32 else -32
    qw = torch.from_numpy(rng.integers(lo, -lo + 1, (K, N), dtype=np.int8))
    s = rng.random((2 if mins else 1, K // G, N)) * 2e-3 + 1e-4
    if mins:
        s[1] *= 16
    return QTensor("i8t", qw, torch.from_numpy(s.astype(np.float32)).to(torch.bfloat16), None,
                   G, (N, K), GGMLType.Q8_0 if G == 32 else GGMLType.Q6_K)


def _i8c(K, N, seed=0):
    rng = np.random.default_rng(seed)
    qw = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int8))
    s = torch.from_numpy((rng.random((1, N)) * 2e-3 + 1e-4).astype(np.float32))
    return QTensor("i8c", qw, s, None, K, (N, K), GGMLType.Q8_0)


def _x(K, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((1, K), dtype=np.float32)).to(torch.bfloat16)


CASES = [("i8t", 16, False, 2048, 640), ("i8t", 32, False, 2048, 640),
         ("i8t", 16, True, 1024, 384), ("i8t", 32, True, 1088, 256),
         ("i8c", 0, False, 2048, 640), ("i8c", 0, False, 768, 384),
         ("i8t", 32, False, 4096, 128), ("i8c", 0, False, 256, 128)]


@pytest.mark.parametrize("kind,G,mins,K,N", CASES)
def test_mv_split_within_limit_and_mutants_past_it(kind, G, mins, K, N):
    w = _i8c(K, N, seed=K + N) if kind == "i8c" else _i8t(K, N, G, mins, seed=K + G)
    plain = tq.qmm_i8c_plain if kind == "i8c" else tq.qmm_plain
    x = _x(K, seed=300 + K)
    want = plain(x, w)
    limit = 2e-4 * float(want.abs().max())
    assert float((qmm_mv_split(x, w) - want).abs().max()) <= limit
    seen = {what: float((plain(xm, wm) - want).abs().max()) / limit
            for what, (xm, wm) in qmm_mv_mutants(x, w).items()}
    ks = tq.mv_plan(K, N, G)
    for s in {0, ks - 1} if ks > 1 else ():  # the mirror with a split's partial dropped
        seen[f"split {s} dropped"] = float((qmm_mv_split(x, w, drop=s) - want).abs().max()) / limit
    assert len(seen) >= (4 if kind == "i8c" else 5 + mins)
    assert min(seen.values()) >= 8, seen


class _Lib:
    """Stands in for a compiled library: records each call, launches nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def lib(monkeypatch):
    fake = _Lib()
    monkeypatch.setattr(kernels, "library", lambda name, signatures: fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return fake


@pytest.mark.parametrize("G,mins", [(32, False), (16, False), (16, True), (32, True)])
@pytest.mark.parametrize("K,ff", [(1024, 256), (2048, 5504), (4096, 640)])
def test_wrappers_launch_the_plan(lib, G, mins, K, ff):
    """The matvec and the fused gate-up on one [K, 2ff] weight hand the
    library the plan of that weight; the i8c matvec its own; none takes a
    workspace (a tile's splits add in a cluster)."""
    x = torch.zeros(1, K, dtype=torch.bfloat16)
    w = _i8t(K, 2 * ff, G, mins)
    before = dict(tq._tickets)
    tq._launch_i8t(x, w, gateup=False, dq=False)
    tq._launch_i8t(x, w, gateup=True, dq=False)
    tq._launch_i8c(x, _i8c(K, 2 * ff))
    (n0, a0), (n1, a1), (n2, a2) = lib.calls
    assert n0 == n1 == "bt_qmm_i8t_gd" and n2 == "bt_qmm_i8c_mv"
    ks = tq.mv_plan(K, 2 * ff, G)
    # (K, N, G, mins, gateup, KS)
    assert a0[4:10] == (K, 2 * ff, G, int(mins), 0, ks)
    assert a1[4:10] == (K, 2 * ff, G, int(mins), 1, ks)
    assert a2[4:7] == (K, 2 * ff, tq.mv_plan(K, 2 * ff, 0))
    assert tq._tickets == before


def test_wrappers_refuse_a_payload_off_16_bytes(lib):
    """A payload that does not lie on 16 bytes raises instead of launching
    (the kernels' wrappers require it, as the M > 1 tile's do)."""
    K, N = 256, 128
    w = _i8t(K, N, 32)
    raw = torch.empty(K * N + 8, dtype=torch.int8)
    off = raw[8:].view(K, N)
    off.copy_(w.qw)
    x = torch.zeros(1, K, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16 bytes"):
        tq._launch_i8t(x, QTensor("i8t", off, w.scales, None, 32, (N, K), GGMLType.Q8_0),
                       gateup=False, dq=False)
    wc = _i8c(K, N)
    with pytest.raises(ValueError, match="16 bytes"):
        tq._launch_i8c(x, QTensor("i8c", off, wc.scales, None, K, (N, K), GGMLType.Q8_0))
    assert lib.calls == []


def test_mv_splits_tool_on_the_cpu():
    """The split sweep (booster_tpu_torch.tools.mv_splits) on the CPU at
    small rows of every form: each split count checked against the plain
    version (the gate-ups against the matvec + silu·mul); nothing timed."""
    from booster_tpu_torch.tools import mv_splits

    rows = [("i8c", "i8c", 512, 256, 0, False), ("i8", "G32", 512, 256, 32, False),
            ("q6k", "G16", 256, 384, 16, False), ("gateup", "G16 mins", 256, 512, 16, True)]
    res = mv_splits.main(["--device", "cpu"], rows=rows)
    assert [r["path"] for r in res["rows"]] == ["i8c", "i8", "q6k", "gateup"]
    assert [r["plan_splits"] for r in res["rows"]] == [tq.mv_plan(K, N, G)
                                                       for _, _, K, N, G, _ in rows]
    assert all(list(r["split_ms"]) == list(range(1, 9)) and r["ms"] == "not measured"
               for r in res["rows"])
    assert tq.mv_plan is mv_splits.tq.mv_plan and tq.mv_plan.__name__ == "mv_plan"
