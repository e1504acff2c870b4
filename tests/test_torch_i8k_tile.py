"""The int8 K-major tile's plan and arithmetic, on the CPU.

csrc/i8k_tile.cuh runs qmm_i8t.cu's M > 1 matmul and fused gate-up (and
the dq form at M = 1), qmm_i8c.cu's M > 1 matmul and both products of
mlp_i8t.cu.  It splits K over blocks on whole stages of 64 rows, each split
a chain of k16 steps from zero, and adds the splits in split order (a
cluster's blocks through distributed shared memory, or the MLP's last block
through f32 partials).  Every wrapper takes the rows a block and the split
count from
``ops.qmm.i8k_plan``, a function of (M, K, N) alone, which is what keeps the
gate-up equal to the matmul on its fused weight and the whole MLP equal to
its unfused kernels.  These tests hold the plan to what the kernels need,
hold the wrappers to the plan (through a stand-in for the compiled library,
so no card is needed), and hold the tile's sum order, mirrored in plain
torch (``testing.qmm_i8k_split``), to the matmuls' limit (2e-4 of the
largest output) against the plain versions; each wrong kernel of
``testing.qmm_i8k_mutants`` must land 8x past it."""

import types

import numpy as np
import pytest
import torch

from booster_tpu_torch.gguf import GGMLType
from booster_tpu_torch.ops import kernels
from booster_tpu_torch.ops import mlp as tm
from booster_tpu_torch.ops import qmm as tq
from booster_tpu_torch.quant.qtensor import QTensor
from booster_tpu_torch.testing import qmm_i8k_mutants, qmm_i8k_split
from booster_tpu_torch.testing import torch_threads

TICKETS = 4096  # the shared ticket buffer's first size (ops.qmm._ticket_buffer)
SMS = 132

# (K, N) of the i8t and i8c matmuls of the paths: the 7B (qkv, wo, down,
# gate-up 2 x 14336, lm head), the 1.3B Q6_K file (qkv, wo, gate-up 2 x 5504,
# lm head 32256) and TinyLlama with weights="i8" (qkv, wo, down, gate-up)
WIDTHS = [(4096, 6144), (4096, 4096), (14336, 4096), (4096, 28672), (4096, 32000),
          (2048, 6144), (2048, 2048), (2048, 11008), (2048, 32256),
          (2048, 2560), (5632, 2048), (2048, 11264)]
# the rows they run at: the dq form at one row (the whole MLP's decode), a
# single stream's prefill, a 64-stream step, the server's and the tests'
# ragged counts, and the 64 x 32-row batch prefill
ROWS = [1, 16, 64, 100, 130, 2048]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("K,N", WIDTHS)
def test_plan_splits_cover_whole_stages_once(M, K, N):
    bm, ks = tq.i8k_plan(M, K, N)
    assert bm == min(b for b in (16, 32, 64, 128, 256) if b >= min(M, 256))
    assert ks in (1, 2, 4, 8)  # a tile's splits are one cluster
    nst = K // 64
    ranges = [(s * nst // ks, (s + 1) * nst // ks) for s in range(ks)]
    assert ranges[0][0] == 0 and ranges[-1][1] == nst
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all((s1 - s0) * 64 >= 512 for s0, s1 in ranges) or ks == 1
    tiles = -(-M // bm) * (N // 128)
    # at most two blocks an SM (one wave), one or more wherever K allows
    assert ks == 1 or tiles * ks <= 2 * SMS
    assert tiles * ks >= SMS or 2 * ks > K // 512 or 2 * ks > 8 or tiles >= SMS


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("K,N", WIDTHS)
def test_partials_and_tickets_fit(M, K, N):
    """The whole MLP's partials and tickets: one ticket a tile in the shared
    buffer; f32 partials past half the payload's bytes only where fewer
    splits would leave SMs idle."""
    bm, ks = tq.i8k_plan(M, K, N)
    tiles = -(-M // bm) * (N // 128)
    assert tiles <= TICKETS
    assert ks == 1 or 4 * ks * M * N <= K * N // 2 or tiles * (ks // 2) < SMS


@pytest.mark.parametrize("M,K,ff,C", [(m, 4096, 14336, 4096) for m in (1, 16, 64, 100)]
                         + [(m, 2048, 5632, 2048) for m in (1, 16, 64, 100)])
def test_mlp_products_share_the_rows_and_fit_the_workspace(M, K, ff, C):
    """The whole MLP's two products take one BM (a function of M), and its
    workspace (counter, exits, a flag and a ticket per 64 mid columns, a
    ticket per down tile; csrc/mlp_i8t.cu bt_mlp_i8t_ws_ints) fits the
    shared buffer."""
    (bm, _), (bm2, _) = tq.i8k_plan(M, K, 2 * ff), tq.i8k_plan(M, ff, C)
    assert bm == bm2
    mtiles = -(-M // bm)
    assert 2 + 2 * mtiles * (ff // 64) + mtiles * (C // 128) <= TICKETS


@pytest.mark.parametrize("K,N", [(4096, 6144), (4096, 4096), (14336, 4096), (4096, 28672),
                                 (4096, 32000), (2048, 6144), (2048, 11008), (2048, 32256)])
def test_a_64_stream_step_fills_the_card(K, N):
    """At M = 64 the 7B's and the 1.3B's matmuls run at least one block on
    each of the 132 SMs (the 1.3B wo, 2048 → 2048, is held by its K: four
    splits of 512 columns over 16 column tiles, 64 blocks)."""
    bm, ks = tq.i8k_plan(64, K, N)
    assert bm == 64 and (N // 128) * ks >= SMS
    assert tq.i8k_plan(64, 2048, 2048) == (64, 4)


class _Lib:
    """Stands in for a compiled library: records each call, launches nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 64 if name.endswith("_ws_ints") else 0
        return call


@pytest.fixture
def lib(monkeypatch):
    fake = _Lib()
    monkeypatch.setattr(kernels, "library", lambda name, signatures: fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return fake


def _i8t(K, N, G=32, seed=0):
    rng = np.random.default_rng(seed)
    qw = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int8))
    s = torch.from_numpy((rng.random((1, K // G, N)) * 2e-3 + 1e-4).astype(np.float32))
    return QTensor("i8t", qw, s.to(torch.bfloat16), None, G, (N, K),
                   GGMLType.Q8_0 if G == 32 else GGMLType.Q6_K)


def _i8c(K, N, seed=0):
    rng = np.random.default_rng(seed)
    qw = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int8))
    s = torch.from_numpy((rng.random((1, N)) * 2e-3 + 1e-4).astype(np.float32))
    return QTensor("i8c", qw, s, None, K, (N, K), GGMLType.Q8_0)


@pytest.mark.parametrize("M", [2, 16, 64, 100, 2048])
def test_wrappers_launch_the_plan(lib, M):
    """The matmul, the fused gate-up on the same [K, 2ff] weight, the i8c
    matmul and the whole MLP's two products each hand the library (BM, KS)
    = i8k_plan of their own shapes; the MLP f32 partials exactly when KS >
    1, the others none (a tile's splits add in a cluster)."""
    K, ff, C = 1024, 256, 384
    x = torch.zeros(M, K, dtype=torch.bfloat16)
    wgu, wd = _i8t(K, 2 * ff), _i8t(ff, C)
    tq._launch_i8t(x, wgu, gateup=False, dq=True)
    tq._launch_i8t(x, wgu, gateup=True, dq=True)
    tq._launch_i8c(x, _i8c(K, C))
    bm, ks = tq.i8k_plan(M, K, 2 * ff)
    (name0, a0), (name1, a1), (name2, a2) = lib.calls
    assert name0 == name1 == "bt_qmm_i8t_dq" and name2 == "bt_qmm_i8c_mm"
    # (M, K, N, KS, gateup, G, bm)
    assert a0[4:11] == (M, K, 2 * ff, ks, 0, 32, bm)
    assert a1[4:11] == (M, K, 2 * ff, ks, 1, 32, bm)
    assert a2[4:9] == (M, K, C) + tq.i8k_plan(M, K, C)[::-1]
    lib.calls.clear()
    if tm.mlp_fits(ff, K, C, M, 1, 1, 32, 2):
        tm._launch(x, wgu, wd)
        ws = [a for n, a in lib.calls if n == "bt_mlp_i8t_ws_ints"]
        (name, a), = [(n, a) for n, a in lib.calls if n == "bt_mlp_i8t"]
        (_, ks1), (_, ks2) = tq.i8k_plan(M, K, 2 * ff), tq.i8k_plan(M, ff, C)
        assert ws == [(M, ff, C, bm)]
        assert a[10:17] == (M, K, ff, C, ks1, ks2, bm)
        assert (a[5] is None) == (ks1 == 1) and (a[7] is None) == (ks2 == 1)


def _x(M, K, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("kind,G", [("i8t", 16), ("i8t", 32), ("i8c", 0)])
@pytest.mark.parametrize("M", [2, 16, 17, 64, 100])
def test_i8k_split_within_limit_and_mutants_past_it(kind, G, M):
    K, N = 2048, 256
    if kind == "i8c":
        w, plain = _i8c(K, N, seed=M), tq.qmm_i8c_plain
    else:
        w, plain = _i8t(K, N, G, seed=M + G), lambda x, w: tq.qmm_plain(x, w, dq=True)
    x = _x(M, K, seed=200 + M)
    _, ks = tq.i8k_plan(M, K, N)
    assert ks > 1  # the split is exercised
    nst = K // 64
    want = plain(x, w)
    limit = 2e-4 * float(want.abs().max())
    assert float((qmm_i8k_split(x, w, ks) - want).abs().max()) <= limit
    seen = {what: float((plain(xm, wm) - want).abs().max()) / limit
            for what, (xm, wm) in qmm_i8k_mutants(x, w, ((ks - 1) * nst // ks, nst)).items()}
    for s in (0, ks - 1):  # the mirror with a split's partial dropped
        seen[f"split {s} dropped"] = float(
            (qmm_i8k_split(x, w, ks, drop=s) - want).abs().max()) / limit
    assert len(seen) == (5 if kind == "i8c" else 6)
    assert min(seen.values()) >= 8, seen
