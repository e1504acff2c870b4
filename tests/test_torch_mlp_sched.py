"""The whole MLP's queue and the s8 probe kernel's plan, on the CPU.

csrc/mlp_i8t.cuh runs the items of the whole MLP (the fused gate-up's, then
the down product's, each the i8k tile's own code) by their ids in order,
taken one at a time by the running blocks (``ops.mlp.mlp_schedule`` spells
that order out); a down item waits for the ready count of its split (the
gate-up pairs it reads).  csrc/probe_i8.cu's s8mm_kernel (v_dot_only,
k_dot_i8) runs one block a whole tile of ``ops.probes.s8_rows`` rows over
stages of 128 bytes of K.  These tests hold the queue to what keeps the
kernel free of deadlock and its SMs evenly loaded, the workspace to the
shared buffer, the wrappers to the plans (through a stand-in for the
compiled library), and the s8 kernel's stage sums, mirrored in plain torch
(``testing.s8mm_stages``), to the plain version bit for bit.  The s8
kernel's shared memory is the compiled library's to report
(``bt_probe_s8_smem``): tests/test_torch_cuda.py holds it to the card."""

import types

import numpy as np
import pytest
import torch

from booster_tpu_torch.gguf import GGMLType
from booster_tpu_torch.ops import kernels
from booster_tpu_torch.ops import mlp as tm
from booster_tpu_torch.ops import probes
from booster_tpu_torch.quant.qtensor import QTensor
from booster_tpu_torch.testing import mlp_queue_sim, s8mm_stages
from booster_tpu_torch.testing import torch_threads

SMS = 132
TICKETS = 4096  # the shared ticket buffer's first size (ops.qmm._ticket_buffer)
# (M, K, ff, C): the 7B's MLP at generate's M = 1 and 16, a 64-stream step
# and the tests' ragged 100; TinyLlama's (weights="i8") at the same rows
MLPS = [(m, 4096, 14336, 4096) for m in (1, 16, 64, 100)] + [
    (m, 2048, 5632, 2048) for m in (1, 16, 64, 100)]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


def _ids(plan):
    mt, nF, ks1, nC, ks2 = (plan[k] for k in ("mtiles", "nF", "ks1", "nC", "ks2"))
    gu = {(fj, s, m): tm.gateup_id(plan, fj, s, m)
          for fj in range(nF) for s in range(ks1) for m in range(mt)}
    dn = {(s, j, m): tm.down_id(plan, s, j, m)
          for s in range(ks2) for j in range(nC) for m in range(mt)}
    return gu, dn


@pytest.mark.parametrize("M,K,ff,C", MLPS)
def test_queue_holds_every_item_once_after_the_pairs_it_reads(M, K, ff, C):
    """Each item id comes once, and each down item after every gate-up item
    (each K split, the same M tile) of the pairs its split reads; the ids
    are numbered in that order, so the kernel hands them out as a range;
    taken in order by any count of blocks from 1 to 400, a block waits only
    on items that blocks already hold (testing.mlp_queue_sim raises
    otherwise)."""
    plan = tm.mlp_plan(M, K, ff, C)
    gu, dn = _ids(plan)
    assert sorted(gu.values()) == list(range(plan["nA"]))
    assert sorted(dn.values()) == list(range(plan["nA"], plan["nA"] + plan["nD"]))
    items = tm.mlp_schedule(plan)
    assert items == list(range(plan["nA"] + plan["nD"]))
    pos = {it: i for i, it in enumerate(items)}
    for (s, j, m), d in dn.items():
        last = max(pos[gu[(fj, k, m)]] for fj in tm.pairs_of_split(plan, s)
                   for k in range(plan["ks1"]))
        assert last < pos[d]
    for workers in range(1, 401):  # taken in order by any count: none waits on an untaken item
        mlp_queue_sim(plan, items, workers, SMS)


@pytest.mark.parametrize("G", [16, 32])
@pytest.mark.parametrize("M", [1, 64, 2048])
def test_item_bytes_count_the_scale_rows_of_the_group(G, M):
    """An item streams 128 payload bytes a row of its K range and one bf16
    scale row of 128 columns (256 bytes) a group of G rows: at Gemma-2B's
    widths (K 2048, ff 16384, C 2048) group 16 doubles the scale bytes of
    group 32's, and all items together stream the weights' payload and
    scales once an M tile."""
    K, ff, C = 2048, 16384, 2048
    plan = tm.mlp_plan(M, K, ff, C, G)
    assert plan["G"] == G
    gu_rows, dn_rows = K // plan["ks1"], ff // plan["ks2"]
    assert tm.item_bytes(plan, 0) == gu_rows * 128 + gu_rows // G * 256
    assert tm.item_bytes(plan, plan["nA"]) == dn_rows * 128 + dn_rows // G * 256
    total = sum(tm.item_bytes(plan, i) for i in range(plan["nA"] + plan["nD"]))
    assert total == plan["mtiles"] * (K * 2 * ff + ff * C + (K * 2 * ff + ff * C) // G * 2)
    if G == 16:
        g32 = tm.mlp_plan(M, K, ff, C)
        assert tm.item_bytes(plan, 0) - gu_rows * 128 == 2 * (tm.item_bytes(g32, 0)
                                                               - gu_rows * 128)


@pytest.mark.parametrize("nF,ks2", [(nF, ks2) for nF in (4, 5, 28, 88, 224)
                                     for ks2 in (1, 2, 4, 8) if ks2 <= nF])
def test_each_pair_counts_into_the_split_that_reads_it(nF, ks2):
    """The kernel's ready count: pair fj adds one to split
    ((fj + 1)·ks2 - 1) // nF, the split whose stages [s·nF/ks2,
    (s+1)·nF/ks2) of 64 mid columns (i8k::split_range) hold it; a split
    waits for as many pairs as it has stages."""
    plan = {"nF": nF, "ks2": ks2}
    for s in range(ks2):
        for fj in tm.pairs_of_split(plan, s):
            assert tm.split_of_pair(plan, fj) == s
    assert sum(len(tm.pairs_of_split(plan, s)) for s in range(ks2)) == nF


@pytest.mark.parametrize("M,K,ff,C", MLPS)
def test_queue_spreads_the_bytes_over_the_sms(M, K, ff, C):
    """Taken by the blocks the kernel launches (two an SM), by three an SM
    (the residency the tile's shared memory allows at 16 and 32 rows), or by fewer
    blocks than SMs, with every block streaming alike, no SM carries more
    than one gate-up item's bytes over the mean of the SMs that hold
    blocks, and no down item is taken before the gate-up items it reads
    (testing.mlp_queue_sim raises)."""
    plan = tm.mlp_plan(M, K, ff, C)
    gu_bytes = tm.item_bytes(plan, 0)
    for workers in (1, 2, 66, 131, SMS, 2 * SMS, 3 * SMS):
        sim = mlp_queue_sim(plan, tm.mlp_schedule(plan), workers, SMS)
        used = sim["sm_bytes"][:min(workers, SMS)]
        assert sum(sim["sm_bytes"]) == sum(tm.item_bytes(plan, i)
                                           for i in range(plan["nA"] + plan["nD"]))
        assert max(used) - sum(used) / len(used) <= gu_bytes


@pytest.mark.parametrize("M,K,ff,C", MLPS)
def test_workspace_fits_the_shared_buffer(M, K, ff, C):
    """csrc/mlp_i8t.cuh's workspace (bt_mlp_i8t_ws_ints: counter, exits, 8
    ready counts, a ticket per pair and per down tile, each per M tile)
    holds every index the kernel touches and fits the shared ticket
    buffer."""
    plan = tm.mlp_plan(M, K, ff, C)
    mt, nF, nC, ks2 = plan["mtiles"], plan["nF"], plan["nC"], plan["ks2"]
    n = tm.mlp_ws_ints(M, ff, C, plan["bm"])
    assert n == 2 + mt * (8 + nF + nC) <= TICKETS
    assert ks2 <= 8  # a ready count per split of each M tile
    top = 2 + (mt - 1) * 8 + tm.split_of_pair(plan, nF - 1)  # the last ready count
    assert top < 2 + mt * 8
    assert 2 + mt * 8 + mt * nF + mt * nC == n  # pair tickets, then down tickets


class _Lib:
    """Stands in for a compiled library: records each call, launches nothing
    (a workspace of 64 ints)."""

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
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    return fake


def _i8t(K, N, seed=0):
    rng = np.random.default_rng(seed)
    qw = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int8))
    s = torch.from_numpy((rng.random((1, K // 32, N)) * 2e-3 + 1e-4).astype(np.float32))
    return QTensor("i8t", qw, s.to(torch.bfloat16), None, 32, (N, K), GGMLType.Q8_0)


@pytest.mark.parametrize("M", [1, 16, 64, 100])
def test_mlp_wrapper_launches_the_item_range_on_the_library_grid(lib, M):
    """The whole MLP hands the library the plans of its products, the item
    ids [0, nA + nD) and a grid of 0 (the library's own: two blocks an SM);
    the ablations' ranges and block counts pass through."""
    K, ff, C = 1024, 512, 384
    x = torch.zeros(M, K, dtype=torch.bfloat16)
    wgu, wd = _i8t(K, 2 * ff), _i8t(ff, C, seed=1)
    tm._launch(x, wgu, wd)
    tm._launch(x, wgu, wd)
    plan = tm.mlp_plan(M, K, ff, C)
    runs = [a for n, a in lib.calls if n == "bt_mlp_i8t"]
    assert len(runs) == 2
    nA, nD = plan["nA"], plan["nD"]
    for a in runs:
        # (M, K, ff, C, KS1, KS2, bm), the first id, the count, the blocks
        assert a[10:17] == (M, K, ff, C, plan["ks1"], plan["ks2"], plan["bm"])
        assert a[17:20] == (0, nA + nD, 0)
    lib.calls.clear()
    tm._run(x, wgu, wd, 0, nA, workers=7)
    tm._run(x, wgu, wd, nA, nD)
    tm._run(x, wgu, wd, nA)
    assert [a[17:20] for n_, a in lib.calls if n_ == "bt_mlp_i8t"] == [
        (0, nA, 7), (nA, nD, 0), (nA, nD, 0)]


# -- the s8 probe kernel -----------------------------------------------------------

# (M, K, N): v_dot_only's and k_dot_i8's weights at the tools' M = 64, the
# probes' M = 8 and a ragged 100; the CUDA tests' shapes
S8_SHAPES = [(64, 2048, 11264), (64, 4096, 11264), (8, 2048, 11264), (8, 4096, 11264),
             (100, 2048, 11264), (100, 4096, 11264), (16, 1024, 256), (100, 512, 384),
             (64, 256, 128), (3, 384, 256), (33, 1024, 640)]


@pytest.mark.parametrize("M,K,N", S8_SHAPES)
def test_s8_rows_hold_m_with_the_least_padding(M, K, N):
    """The s8 kernel's tile rows: the least of 8, 16, 32 and 64 that holds
    M (the rows past M are zeros that still take the tensor cores' time),
    64 above, where M takes ceil(M / 64) tiles of the [N/128] columns."""
    bm = probes.s8_rows(M)
    assert bm in (8, 16, 32, 64)
    assert bm >= M or bm == 64
    assert bm // 2 < M or bm == 8


def test_s8_tool_shapes():
    """At the tools' shapes: 64 rows at M = 64 (v_dot_only, k_dot_i8), 8 at
    the probes' M = 8, two tiles of 64 at a ragged M = 100."""
    assert [probes.s8_rows(M) for M in (64, 8, 100, 1, 9, 17, 33)] == [64, 8, 64, 8, 16, 32, 64]


@pytest.mark.parametrize("M,K,N", [(8, 2048, 256), (100, 1024, 384), (64, 512, 640),
                                   (3, 384, 256)])
@pytest.mark.parametrize("out_i32", [True, False])
def test_s8_stages_are_exact_and_a_dropped_stage_is_seen(M, K, N, out_i32):
    """The s8 kernel's sum over stages of 128 bytes of K, mirrored in plain
    torch, equals the plain version bit for bit (i32 sums: any order);
    leaving out any one stage changes the output."""
    rng = np.random.default_rng(M + K)
    x = torch.from_numpy(rng.integers(-127, 127, (M, K), dtype=np.int8))
    q = torch.from_numpy(rng.integers(-127, 127, (N, K), dtype=np.int8))
    want = probes.i8mm_plain(x, q, n_major=True, out_i32=out_i32)
    assert torch.equal(s8mm_stages(x, q, out_i32), want)
    for st in range(K // 128):
        assert not torch.equal(s8mm_stages(x, q, out_i32, drop=st), want)


@pytest.fixture
def probe_lib(monkeypatch):
    fake = _Lib()
    monkeypatch.setattr(kernels, "library", lambda name, signatures: fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return fake


@pytest.mark.parametrize("M,K,N", [(64, 2048, 11264), (8, 4096, 11264), (100, 512, 384)])
@pytest.mark.parametrize("out_i32", [True, False])
def test_s8_wrapper_launches_the_plan(probe_lib, M, K, N, out_i32):
    """int8 x against an N-major weight goes to the s8 kernel with the
    tile rows of s8_rows and the output type, and counts as probe_s8mm; int8 x
    against a K-major weight stays on i8mm_kernel."""
    x = torch.zeros(M, K, dtype=torch.int8)
    q = torch.zeros(N, K, dtype=torch.int8)
    kernels.reset_counts()
    out = probes._s8mm(x, q, M, K, N, out_i32)
    assert out.dtype == (torch.int32 if out_i32 else torch.float32)
    (name, a), = probe_lib.calls
    assert name == "bt_probe_s8mm"
    # (M, K, N, bm, out_i32)
    assert a[3:8] == (M, K, N, probes.s8_rows(M), int(out_i32))
    assert kernels.launch_counts["probe_s8mm"] == 1
