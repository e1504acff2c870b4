"""The int8 lane-major matmul of csrc/qmm_lane_i8.cu on the CPU: its plan,
its two forms' sum order mirrored in plain torch, its wrong kernels, its
wrappers' launch arguments, and parity with the JAX package's ``_qmm_i8``.

The kernel replaces qmm_lane.cu's i8 form without a tile table (the Q8_0
down of llama.cpp's Q6_K mix and the Q5_1 down of its Q5_K_S mix, whose
(ff/32) % 8 != 0 keeps them lane-major): a matvec up to 32 rows (16 payload
rows a block, 8 warps each taking 64-k chunks of all of K, no K split) and
a ``wgmma`` tile above (128 payload rows by 64, 128 or 256 rows of x, K
split in a cluster).  The matvec gives a lane's 4 consecutive payload bytes to A
slots 2u, 2u + 1, 2u + 8, 2u + 9 of a k16 step and reads x in the same
order (``testing.lane_pi``): every product and each group's scale and min
stay the reference's; only the order of the f32 sums moves.  The mirrors
(``testing.qmm_lane_mv_split``, ``qmm_lane_mm_split``) sit within the
matmuls' limit, 2e-4 of the largest output, of ``qmm_lane_plain``; each
wrong kernel of ``testing.qmm_lane_i8_mutants`` and each mirror with a
chunk or a split left out lands 8x past it.  Parity with the reference's
``_qmm_i8`` (interpret mode) is taken at M = 2: its interpret-mode M = 1
row sits 2e-3 off its own M = 2 row (ROADMAP.md, Queue 3)."""

import dataclasses
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, ".")

from booster_tpu.gguf import GGMLType as JT  # noqa: E402
from booster_tpu.ops import pallas_qmm as pq  # noqa: E402
from booster_tpu.quant import qtensor as jqt  # noqa: E402
from booster_tpu.quant import repack_gguf_tensor as jrepack  # noqa: E402
from booster_tpu_torch.gguf import GGMLType as TT  # noqa: E402
from booster_tpu_torch.ops import kernels  # noqa: E402
from booster_tpu_torch.ops import qmm as tq  # noqa: E402
from booster_tpu_torch.quant import qtensor as tqt  # noqa: E402
from booster_tpu_torch.testing import (lane_mv_chunks, lane_pi, q5_1_weight,  # noqa: E402
                                       qmm_lane_i8_mutants, qmm_lane_mm_split,
                                       qmm_lane_mv_split, random_blocks, torch_threads,
                                       without_mins)

QMM_TOL = 2e-4
DOWN = (5504, 2048)  # the DeepSeek-Coder-1.3B down: K, N
SMS = 132


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


@pytest.fixture
def interpret():
    pq.INTERPRET = True
    try:
        yield
    finally:
        pq.INTERPRET = False
        jax.clear_caches()


def _raw(qt, n, k, seed):
    return np.frombuffer(random_blocks(np.random.default_rng(seed), n * k, TT[qt], 0.05),
                         np.uint8)


def _weight(qt, n, k, seed):
    """A real lane-major Q5_1 or Q8_0 weight [n, k] as the port's loader keeps
    it (int8 payload, bf16 prepared planes [n, 1 + mins, k/32])."""
    t = tqt.to_torch(tqt.prepare_kernel_scales(tqt.repack_gguf_tensor(_raw(qt, n, k, seed),
                                                                       TT[qt], (n, k))), "cpu")
    t = tqt.compact_scales(t)
    assert t.kind == "i8" and t.scales.shape == (n, 2 if qt == "Q5_1" else 1, k // 32)
    return t


def _x(m, k, seed):
    x = np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32)
    return x, torch.from_numpy(x).to(torch.bfloat16)


# -- the plan -----------------------------------------------------------------

PLAN_SHAPES = [DOWN, (14336, 4096), (384, 512), (1536, 256)]


@pytest.mark.parametrize("K,N", PLAN_SHAPES)
@pytest.mark.parametrize("M", [1, 2, 8, 9, 16, 17, 32, 33, 64, 100, 2048])
def test_plan_takes_whole_stages_and_one_cluster(M, K, N):
    """The matvec up to 32 rows with the fewest m8 tiles that hold M
    (qmm_lane.cu's kernel at 17-64 rows past K 8192); above, the tile with
    the least of 64 and 128 rows a block that holds M (256 past it), K
    split on whole 64-k stages, at most 8 ways and a power of two (a tile's
    splits are one cluster), each split 512 k or more, the blocks within two
    an SM (one at 256 rows)."""
    plan = tq.lane_i8_plan(M, K, N)
    assert K % tq.LANE_BK == 0
    if 16 < M <= 64 and K > 8192:  # the 7B down: qmm_lane.cu's kernel measured faster
        assert plan == ("lane",)
        return
    if M <= 32:
        assert plan == ("mv", 1 if M <= 8 else 2 if M <= 16 else 4)
        return
    _, bm, ks = plan
    assert bm == next((b for b in (64, 128) if M <= b), 256)
    assert ks in (1, 2, 4, 8)
    nst = K // tq.LANE_BK
    ranges = [(s * nst // ks, (s + 1) * nst // ks) for s in range(ks)]
    assert ranges[0][0] == 0 and ranges[-1][1] == nst
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert ks == 1 or all((s1 - s0) * tq.LANE_BK >= 512 for s0, s1 in ranges)
    tiles = -(-M // bm) * (N // 128)
    assert ks == 1 or tiles * ks <= (1 if bm == 256 else 2) * SMS


def test_matvec_fills_the_card_at_one_row():
    """At the 1.3B down's one row the matvec's blocks (16 payload rows each,
    read whole: no K split, no partials, no zero rows beyond an m8 tile's)
    put 8 warps on 97 % of the 132 SMs, and its warps' chunks cover K once."""
    K, N = DOWN
    assert tq.lane_i8_plan(1, K, N) == ("mv", 1)
    blocks = N // tq.LANE_MV_ROWS
    assert blocks >= 0.95 * SMS and blocks * tq.LANE_MV_WARPS == 1024
    chunks = sorted(c for w in lane_mv_chunks(K) for c in w)
    assert chunks == list(range(K // tq.LANE_BK))
    assert max(map(len, lane_mv_chunks(K))) - min(map(len, lane_mv_chunks(K))) <= 1


def test_the_k_order_is_one_permutation_of_each_16():
    """The matvec's π sends slots 2u, 2u + 1 to k 4u, 4u + 1 and slots 2u +
    8, 2u + 9 to 4u + 2, 4u + 3 of a lane's 16 k: a permutation, so the
    matvec's 4 steps of a chunk cover its 64 k once."""
    pi = lane_pi().tolist()
    assert sorted(pi) == list(range(16))
    assert pi[:8] == [0, 1, 4, 5, 8, 9, 12, 13] and pi[8:] == [2, 3, 6, 7, 10, 11, 14, 15]


# -- the mirrors and the wrong kernels -----------------------------------------


@pytest.fixture(scope="module")
def down_weights():
    K, N = DOWN
    return {"Q5_1": q5_1_weight(N, K, seed=240, device="cpu"),
            "Q8_0": _weight("Q8_0", N, K, seed=241)}


@pytest.mark.parametrize("qt", ["Q5_1", "Q8_0"])
@pytest.mark.parametrize("M", [1, 5, 16, 17, 64, 100])
def test_mirrors_within_limit_and_mutants_past_it(down_weights, qt, M):
    """At the 1.3B down with real Q5_1 and Q8_0 planes: the plan's form's
    mirror (and the tile's at 32 rows a block wherever the plan takes the
    matvec) within the limit of the
    plain version; every wrong kernel (a group's scale and min, or its min
    alone, from the next group; the mins dropped or with the wrong sign;
    the k order on the payload only; a chunk, split or stage left out) and
    the mirror with a chunk or a split dropped 8x past it."""
    K, N = DOWN
    w = down_weights[qt]
    _, x = _x(M, K, seed=300 + M)
    plan = tq.lane_i8_plan(M, K, N)
    want = tq.qmm_lane_plain(x, w)
    limit = QMM_TOL * float(want.abs().max())
    mm = plan if plan[0] == "mm" else tq.lane_i8_plan(M, K, N, bm=32)
    mirrors = {"mm": qmm_lane_mm_split(x, w, mm[2])}
    if M <= 32:
        mirrors["mv"] = qmm_lane_mv_split(x, w)
    assert plan[0] in mirrors
    for form, got in mirrors.items():
        assert float((got - want).abs().max()) <= limit, form
    seen = {what: float((tq.qmm_lane_plain(xm, wm) - want).abs().max()) / limit
            for what, (xm, wm) in qmm_lane_i8_mutants(x, w, plan).items()}
    if plan[0] == "mv":
        seen["the mirror without chunk 0"] = float(
            (qmm_lane_mv_split(x, w, drop=0) - want).abs().max()) / limit
    else:
        seen["the mirror without its last split"] = float(
            (qmm_lane_mm_split(x, w, plan[2], drop=plan[2] - 1) - want).abs().max()) / limit
    assert len(seen) == 4 + 3 * (qt == "Q5_1")
    assert min(seen.values()) >= 8, seen


# -- the wrappers' launches (a stand-in library) ------------------------------


@pytest.fixture
def lib(monkeypatch):
    """A stand-in kernel library that records each call: the wrappers'
    launch code on CPU tensors, as it runs for CUDA ones."""
    calls = []

    class _Lib:
        def __getattr__(self, name):
            return lambda *a: calls.append((name, a)) or 0

    monkeypatch.setattr(kernels, "library", lambda name, signatures: _Lib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(tq, "_ticket_buffer",
                        lambda device, n: torch.zeros(max(n, 1), dtype=torch.int32))
    return calls


@pytest.mark.parametrize("qt", ["Q5_1", "Q8_0"])
def test_wrapper_hands_each_form_its_arguments(lib, qt):
    """The plan's forms reach bt_qmm_lane_i8_mv with (M, K, N, G, mins, mt)
    and bt_qmm_lane_i8_mm with (M, K, N, G, mins, bm, ks), each launch
    counted under its form's name and the weight's shape; a tool's
    ("lane",) runs qmm_lane.cu's kernel under qmm_i8."""
    K, N = 512, 256
    w = _weight(qt, N, K, seed=242)
    mins = int(qt == "Q5_1")
    kernels.reset_counts()
    for M in (1, 9, 17, 64, 300):
        tq.lane_i8_launch(torch.zeros(M, K, dtype=torch.bfloat16), w)
    tq.lane_i8_launch(torch.zeros(3, K, dtype=torch.bfloat16), w, ("lane",))
    assert [name for name, _ in lib] == ["bt_qmm_lane_i8_mv"] * 3 + ["bt_qmm_lane_i8_mm"] * 2 + [
        "bt_qmm_lane"]
    assert [a[4:10] for _, a in lib[:3]] == [(1, K, N, 32, mins, 1), (9, K, N, 32, mins, 2),
                                             (17, K, N, 32, mins, 4)]
    assert [a[4:11] for _, a in lib[3:5]] == [(M, K, N, 32, mins) + tq.lane_i8_plan(M, K, N)[1:]
                                             for M in (64, 300)]
    # bt_qmm_lane's (M, K, N, G, zero, i4, mins)
    assert lib[5][1][8:15] == (3, K, N, 32, 0, 0, mins)
    assert kernels.launch_counts["qmm_i8_mv"] == 3 and kernels.launch_counts["qmm_i8_mm"] == 2
    assert kernels.launch_counts["qmm_i8"] == 1
    assert kernels.shape_counts[("qmm_i8_mm", (K, N))] == 2


def test_wrapper_refuses_what_the_kernels_do_not_take(lib):
    """Raised before any launch: a group of 8, N not a multiple of 128, f32
    planes, a 4-bit weight, more rows than the matvec's m8 tiles hold."""
    w = _weight("Q5_1", 256, 512, seed=243)
    x = torch.zeros(2, 512, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tq.lane_i8_launch(x, dataclasses.replace(w, group=8, scales=torch.zeros(
            256, 2, 64, dtype=torch.bfloat16)))
    with pytest.raises(NotImplementedError):
        tq.lane_i8_launch(x, dataclasses.replace(w, qw=w.qw[:96].contiguous(), shape=(96, 512),
                                                 scales=w.scales[:96].contiguous()))
    with pytest.raises(ValueError):
        tq.lane_i8_launch(x, dataclasses.replace(w, scales=w.scales.float()))
    with pytest.raises(ValueError):
        tq.lane_i8_launch(x, dataclasses.replace(w, kind="i4p"))
    with pytest.raises(ValueError):
        tq.lane_i8_launch(torch.zeros(9, 512, dtype=torch.bfloat16), w, ("mv", 1))
    assert lib == []


# -- parity with the reference ---------------------------------------------------


@pytest.mark.parametrize("qt", ["Q5_1", "Q8_0"])
def test_forms_match_the_reference_qmm_i8(qt, interpret):
    """The reference's ``_qmm_i8`` (interpret mode; with has_mins for Q5_1)
    at K 512, N 256, M = 2, against the port's plain version and both forms'
    mirrors (the matvec; the tile at one split and at two), within 2e-4 of
    its largest output."""
    K, N, M = 512, 256, 2
    raw = _raw(qt, N, K, seed=244)
    jw = jqt.prepare_kernel_scales(jrepack(raw, JT[qt], (N, K))).astype_device()
    tw = _weight(qt, N, K, seed=244)
    assert jw.kind == "i8" and pq._supported(jw, K, M) and tq.lane_supported(tw)
    xn, xt = _x(M, K, seed=245)
    want = np.asarray(pq._qmm_i8(jnp.asarray(xn, jnp.bfloat16), jw), np.float64)
    tol = QMM_TOL * np.abs(want).max()
    for got in (tq.qmm_lane_plain(xt, tw), qmm_lane_mv_split(xt, tw),
                qmm_lane_mm_split(xt, tw, 1), qmm_lane_mm_split(xt, tw, 2)):
        assert np.abs(got.double().numpy() - want).max() <= tol
    if qt == "Q5_1":  # the mins move the output past the limit
        dropped = tq.qmm_lane_plain(xt, without_mins(tw)).double().numpy()
        assert np.abs(dropped - want).max() > 8 * tol
