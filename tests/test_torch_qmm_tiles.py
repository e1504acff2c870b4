"""The i4t M > 1 and lane-major matmul tiles' plans and arithmetic, on the
CPU.

csrc/qmm_i4t.cu (M > 1) and csrc/qmm_lane.cu split K over blocks on whole
stages (i4t: 32 rows of k of each half, one group at G = 32 and two at
G = 16; lane-major: 64 or 128 columns,
``ops.qmm.lane_stage``), each split of at least 512 columns of K a
chain of k16 mma steps from zero, added by the block that arrives last in
split order.  The wrappers take the rows per block and the split from
``ops.qmm.i4t_plan`` / ``lane_plan``, functions of the shapes only.  These
tests hold the plans to what the kernels need, and the kernels' sum order,
mirrored in plain torch (``testing.qmm_i4t_split``, ``qmm_lane_split``), to
the matmuls' limit (2e-4 of the largest output) against the plain versions;
each wrong kernel of ``testing.qmm_i4t_mutants`` / ``qmm_lane_mutants`` must
land 8x past it.  The int8 lane-major form without a tile table runs
csrc/qmm_lane_i8.cu (``ops.qmm.lane_i8_plan``; its mirrors
``testing.qmm_lane_mv_split`` / ``qmm_lane_mm_split``, its wrong kernels
``qmm_lane_i8_mutants``; tests/test_torch_lane_i8.py)."""

import numpy as np
import pytest
import torch

from booster_tpu_torch.gguf import GGMLType
from booster_tpu_torch.ops import qmm as tq
from booster_tpu_torch.quant.qtensor import QTensor
from booster_tpu_torch.testing import (qmm_i4t_mutants, qmm_i4t_split, qmm_lane_i8_mutants,
                                       qmm_lane_mm_split, qmm_lane_mutants, qmm_lane_mv_split,
                                       qmm_lane_split)
from booster_tpu_torch.testing import torch_threads

TICKETS = 4096  # the shared ticket buffer's first size (ops.qmm._ticket_buffer)

# (M, K, N) of the i4t M > 1 calls of the paths: TinyLlama's 16-row
# prefill (qkv, wo, down, gate-up 2 x 5632), MPT-7B's decode step (64) and
# prefill (64 x 16) at qkv, wo, up, down, Mixtral's qkv, wo and lm head at 64
I4T_SHAPES = [(16, 2048, 2560), (16, 2048, 2048), (16, 5632, 2048), (16, 2048, 11264)] + [
    (M, K, N) for M in (64, 1024)
    for K, N in ((4096, 12288), (4096, 4096), (4096, 16384), (16384, 4096))] + [
    (64, 4096, 6144), (64, 4096, 32000), (1024, 4096, 6144)]
# lane-major: the 1.3B down (i8) at M = 1, 64, 2048; the 7B qkv and down
# at 1, 64, 2048; the grouped Mixtral experts (E = 8) at route_pad's Mp of
# one decode token, 64 and the 64 x 32 prefill
LANE_SHAPES = [(M, 5504, 2048, 0) for M in (1, 64, 2048)] + [
    (M, K, N, 0) for M in (1, 64, 2048) for K, N in ((4096, 6144), (14336, 4096))] + [
    (Mp, K, N, 8) for Mp in (288, 384, 4352) for K, N in ((4096, 14336), (14336, 4096))]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


def _i4t_groups(M, K, N):
    bm, ks = tq.i4t_plan(M, K, N)
    ngh = K // 64
    return bm, ks, [(s * ngh // ks, (s + 1) * ngh // ks) for s in range(ks)]


@pytest.mark.parametrize("M,K,N", I4T_SHAPES)
def test_i4t_splits_cover_whole_groups_once(M, K, N):
    bm, ks, ranges = _i4t_groups(M, K, N)
    assert bm in (32, 64, 128) and ks >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == K // 64
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(g1 - g0 >= 8 for g0, g1 in ranges)  # 512 columns of K or more a split
    blocks = -(-M // bm) * -(-N // 128) * ks
    assert blocks >= 132 or ks == K // 512 or ks == 1  # fills the card where K allows


@pytest.mark.parametrize("M,K,N", I4T_SHAPES)
def test_i4t_gateup_and_matmul_share_the_plan(M, K, N):
    """On one fused weight (N = 2ff) the gate-up and the matmul take one
    (BM, KS) and one ticket per block: the same sums in the same order."""
    assert tq.i4t_launch_plan(M, K, N, True) == tq.i4t_launch_plan(M, K, N, False)
    assert tq.i4t_launch_plan(M, K, N, False)[2] <= TICKETS


@pytest.mark.parametrize("kind", ["i4p", "i8"])
@pytest.mark.parametrize("M,K,N,E", LANE_SHAPES)
def test_lane_splits_cover_whole_stages_and_fit_the_tickets(M, K, N, E, kind):
    """csrc/qmm_lane.cu's plan (the i4p forms, the grouped int8 form): whole
    stages, splits of 512 columns or more, the tickets within the buffer,
    the partials under the weight's bytes.  The int8 form without a tile
    table runs csrc/qmm_lane_i8.cu: the matvec (no split) up to 32 rows, the
    tile's splits on whole 64-k stages, at most 8 (one cluster); at 17-64
    rows past K 8192 the plan keeps this kernel, whose plan then holds."""
    if kind == "i8" and E == 0:
        plan = tq.lane_i8_plan(M, K, N)
        if plan[0] == "mv":
            assert M <= 32 and K % tq.LANE_BK == 0
            return
        if plan[0] == "lane":  # qmm_lane.cu's kernel kept there: its plan below holds
            assert 16 < M <= 64 and K > 8192
        else:
            ks, nst = plan[2], K // tq.LANE_BK
            assert plan[1] in (64, 128, 256) and ks in (1, 2, 4, 8) and K % tq.LANE_BK == 0
            assert ks == 1 or all(((s + 1) * nst // ks - s * nst // ks) * tq.LANE_BK >= 512
                                  for s in range(ks))
            return
    bm, ks = tq.lane_plan(M, K, N, E)
    sk = tq.lane_stage(bm, kind)
    nst = K // sk
    ranges = [(s * nst // ks, (s + 1) * nst // ks) for s in range(ks)]
    assert bm in (32, 64, 128) and sk in (64, 128) and K % sk == 0
    assert ranges[0][0] == 0 and ranges[-1][1] == nst
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all((s1 - s0) * sk >= 512 for s0, s1 in ranges)
    assert -(-M // bm) * (N // 128) <= TICKETS
    # the partials of a split launch stay under the weight's own bytes
    assert ks == 1 or ks * M * N * 4 <= 2 * N * K * (1 if E == 0 else E)


def test_lane_down_at_one_row_fills_the_card():
    """The 1.3B down at M = 1 (N 2048, K 5504) runs csrc/qmm_lane_i8.cu's
    matvec: 16 payload rows a block read whole, so its 128 blocks of 8
    warps sit on 97 % of the 132 SMs without a K split, not 16 tiles."""
    plan = tq.lane_i8_plan(1, 5504, 2048)
    assert plan[0] == "mv"
    blocks = 2048 // tq.LANE_MV_ROWS
    assert 0.95 * 132 <= blocks <= 300


def _i4t(K, N, R, zero, seed):
    rng = np.random.default_rng(seed)
    qw = torch.from_numpy(rng.integers(0, 256, (K // 2, N), dtype=np.uint8))
    s = torch.from_numpy((rng.random((R, K // 64, N)) * 0.02 + 1e-3).astype(np.float32))
    return QTensor("i4t", qw, s.to(torch.bfloat16), None, 32, (N, K), GGMLType.Q4_0, zero=zero)


def _x(M, K, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("zero", [0, 8])
@pytest.mark.parametrize("R", [2, 4])
@pytest.mark.parametrize("M", [2, 16, 17, 64, 100])
def test_i4t_split_within_limit_and_mutants_past_it(M, R, zero):
    K, N = 2048, 256
    w, x = _i4t(K, N, R, zero, seed=M + 10 * R + zero), _x(M, K, seed=M)
    _, ks, ranges = _i4t_groups(M, K, N)
    assert ks > 1  # the split is exercised
    want = tq.qmm_plain(x, w)
    limit = 2e-4 * float(want.abs().max())
    assert float((qmm_i4t_split(x, w, ks) - want).abs().max()) <= limit
    seen = {what: float((tq.qmm_plain(xm, wm) - want).abs().max()) / limit
            for what, (xm, wm) in qmm_i4t_mutants(x, w, ranges[-1]).items()}
    for s in (0, ks - 1):  # the mirror with a split's partial dropped
        seen[f"split {s} dropped"] = float(
            (qmm_i4t_split(x, w, ks, drop=s) - want).abs().max()) / limit
    assert len(seen) == 5 + (zero > 0) + (R == 4)
    assert min(seen.values()) >= 8, seen


@pytest.mark.parametrize("kind,zero", [("i4p", 8), ("i4p", 0), ("i8", 0)])
@pytest.mark.parametrize("M", [2, 16, 17, 64, 100])
def test_lane_split_within_limit_and_mutants_past_it(kind, zero, M):
    K, N = 2048, 256
    rng = np.random.default_rng(M + zero)
    if kind == "i4p":
        qw = torch.from_numpy(rng.integers(0, 256, (N, K // 2), dtype=np.uint8))
        s = rng.random((N, 2, K // 64)) * 0.02 + 1e-3
    else:
        qw = torch.from_numpy(rng.integers(-127, 128, (N, K), dtype=np.int8))
        s = rng.random((N, 1, K // 32)) * 2e-3 + 1e-4
    w = QTensor(kind, qw, torch.from_numpy(s.astype(np.float32)).to(torch.bfloat16), None, 32,
                (N, K), GGMLType.Q4_0 if kind == "i4p" else GGMLType.Q8_0, zero=zero)
    x = _x(M, K, seed=100 + M)
    want = tq.qmm_lane_plain(x, w)
    limit = 2e-4 * float(want.abs().max())
    if kind == "i8":  # csrc/qmm_lane_i8.cu: the matvec up to 16 rows, the tile above
        plan = tq.lane_i8_plan(M, K, N)
        if plan[0] == "mv":
            mirror = lambda drop=None: qmm_lane_mv_split(x, w, drop=drop)  # noqa: E731
            drops = (0, K // tq.LANE_BK - 1)  # a chunk
        else:
            assert plan[2] > 1
            mirror = lambda drop=None: qmm_lane_mm_split(x, w, plan[2], drop=drop)  # noqa: E731
            drops = (0, plan[2] - 1)  # a split
        assert float((mirror() - want).abs().max()) <= limit
        seen = {what: float((tq.qmm_lane_plain(xm, wm) - want).abs().max()) / limit
                for what, (xm, wm) in qmm_lane_i8_mutants(x, w, plan).items()}
        for d in drops:
            seen[f"{d} dropped"] = float((mirror(d) - want).abs().max()) / limit
        assert len(seen) == 5
        assert min(seen.values()) >= 8, seen
        return
    bm, ks = tq.lane_plan(M, K, N)
    sk = tq.lane_stage(bm, kind)
    assert ks > 1
    nst = K // sk
    assert float((qmm_lane_split(x, w, ks, sk) - want).abs().max()) <= limit
    seen = {what: float((tq.qmm_lane_plain(xm, wm) - want).abs().max()) / limit
            for what, (xm, wm) in qmm_lane_mutants(x, w, (0, nst // ks), sk).items()}
    for s in (0, ks - 1):
        seen[f"split {s} dropped"] = float(
            (qmm_lane_split(x, w, ks, sk, drop=s) - want).abs().max()) / limit
    assert len(seen) == 4 + (kind == "i4p")
    assert min(seen.values()) >= 8, seen
