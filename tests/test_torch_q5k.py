"""The port's Q5_K path (llama.cpp's Q5_K_S mix) against the JAX package on
the CPU, the reference's Pallas kernels in interpret mode: the Q5_K and
Q5_1 formats and repacks bit for bit (the K-major transpose and the bf16
planes too), the int8 matmuls with a mins plane (the K-major tile above
M = 1, the fused gate-up, the whole MLP with mins on both weights, the
lane-major and grouped forms) through their plain versions and the CPU
mirror of the tile's sum order, the wrong kernels of mishandled mins, and
two 2-layer Q5_K_S models: hidden 512, 4 heads of 128 over 2 kv heads,
vocab 512, a Q6_K head; ff 384 (the down falls back to Q5_1, and
(384/32) % 8 = 4 keeps it lane-major) and ff 1024 (every weight K-major
Q5_K: the whole MLP with mins), at the weight scale the random blocks are
sized for (0.05; at 0.3 the reference's own Pallas and XLA paths part by
more than the logit tolerance within three decode steps).

Tolerances: matmul outputs are f32 sums of the same exact products in
another order, within 2e-4 of the largest output; the wrong kernels (the
mins dropped, the mins with the wrong sign: ``testing.qmm_mins_mutants``)
must land 8x past that.  Gate-up outputs are bf16: |port - reference| <=
2^-7 |reference| + 1e-5 max|reference| per element.  The whole MLP's bf16
output within 2^-7 of its largest magnitude (2^-6 at M = 1, where the
reference's kernel takes another form; tests/test_torch_qmm_i8.py).
Logits at 2^-5 of their largest magnitude (tests/test_torch_model.py)."""

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
from booster_tpu.models import load_model as j_load  # noqa: E402
from booster_tpu.models.llama import forward as j_forward  # noqa: E402
from booster_tpu.ops import linear as jlinear  # noqa: E402
from booster_tpu.ops import pallas_attention as pa  # noqa: E402
from booster_tpu.ops import pallas_kv as pk  # noqa: E402
from booster_tpu.ops import pallas_moe as pm  # noqa: E402
from booster_tpu.ops import pallas_qmm as pq  # noqa: E402
from booster_tpu.ops.kv_cache import KVCache as JCache  # noqa: E402
from booster_tpu.quant import dequantize as jdequantize  # noqa: E402
from booster_tpu.quant import qtensor as jqt  # noqa: E402
from booster_tpu.quant import quantize as jquantize  # noqa: E402
from booster_tpu.quant import repack_gguf_tensor as jrepack  # noqa: E402
from booster_tpu.sampling import SamplingParams as JSP  # noqa: E402
from booster_tpu.serving import Engine as JEngine  # noqa: E402
from booster_tpu_torch.gguf import GGMLType as TT  # noqa: E402
from booster_tpu_torch.gguf import GGUFReader  # noqa: E402
from booster_tpu_torch.models import load_model, params_from_numpy  # noqa: E402
from booster_tpu_torch.models.llama import forward  # noqa: E402
from booster_tpu_torch.models.loader import _kernel_layout  # noqa: E402
from booster_tpu_torch.ops import kernels  # noqa: E402
from booster_tpu_torch.ops import mlp as tm_mlp  # noqa: E402
from booster_tpu_torch.ops import moe as tmoe  # noqa: E402
from booster_tpu_torch.ops import qmm as tq  # noqa: E402
from booster_tpu_torch.ops.kv_cache import KVCache  # noqa: E402
from booster_tpu_torch.quant import dequantize as tdequantize  # noqa: E402
from booster_tpu_torch.quant import qtensor as tqt  # noqa: E402
from booster_tpu_torch.quant import quantize as tquantize  # noqa: E402
from booster_tpu_torch.sampling import SamplingParams  # noqa: E402
from booster_tpu_torch.serving import Engine  # noqa: E402
from booster_tpu_torch.testing import (make_model, qmm_i8k_split,  # noqa: E402
                                       qmm_lane_i8_mutants, qmm_lane_mm_split,
                                       qmm_lane_mv_split, qmm_mins_mutants, random_blocks)
from booster_tpu_torch.testing import torch_threads  # noqa: E402

QMM_TOL = 2e-4
LOGIT_TOL = 2 ** -5
MAX_SEQ = 128
C, L = 512, 2  # the small models' hidden width and layers
PROMPT = "hello world the and of to in"
FORMATS = ("Q5_K", "Q5_1")
assert JT.Q5_K == TT.Q5_K and JT.Q5_1 == TT.Q5_1


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


@pytest.fixture
def interpret():
    pq.INTERPRET = pm.INTERPRET = True
    try:
        yield
    finally:
        pq.INTERPRET = pm.INTERPRET = False
        jax.clear_caches()


@pytest.fixture
def pallas():
    jlinear.set_use_pallas(True)
    pq.INTERPRET = pa.INTERPRET = pk.INTERPRET = pm.INTERPRET = True
    try:
        yield
    finally:
        jlinear.set_use_pallas(None)
        pq.INTERPRET = pa.INTERPRET = pk.INTERPRET = pm.INTERPRET = False
        jax.clear_caches()


def _close(got, want, tol):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _close_bf16(got, want):
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-5 * np.abs(want).max())


def _x(m, k, seed=5):
    x = np.random.default_rng(seed + m).standard_normal((m, k)).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _blocks(qt, n, k, seed):
    """Real bytes of an [n, k] weight of type `qt` (``testing.random_blocks``:
    Q5_K's min term as large as its scaled term, Q5_1's m near -16·d)."""
    return np.frombuffer(random_blocks(np.random.default_rng(seed), n * k, TT[qt], 0.05),
                         np.uint8)


def _q5_pair(qt, n, k, seed, kmajor=True):
    """The same real Q5_K or Q5_1 codes, scales and mins through both
    packages' repacks and layouts: K-major i8t with two bf16 planes [2, k/32,
    n] (``kmajor``), else lane-major i8 with prepared planes [n, 2, k/32]
    (the port's in bf16, as its loader keeps a lane-major weight)."""
    raw = _blocks(qt, n, k, seed)
    j = jqt.prepare_kernel_scales(jrepack(raw, JT[qt], (n, k)))
    t = tqt.to_torch(tqt.prepare_kernel_scales(tqt.repack_gguf_tensor(raw, TT[qt], (n, k))),
                     "cpu")
    if kmajor:
        j = jqt.compact_scales(jqt.transpose_qtensor(j))
        t = tqt.compact_scales(tqt.transpose_qtensor(t))
        assert t.kind == j.kind == "i8t" and t.scales.shape == (2, k // 32, n)
        assert np.array_equal(t.scales.view(torch.int16).numpy(),
                              np.asarray(j.scales).view(np.int16))
        return jax.tree.map(jnp.asarray, j), t
    t = tqt.compact_scales(t)
    assert t.kind == j.kind == "i8" and t.scales.shape == (n, 2, k // 32)
    return j.astype_device(), t


def _mutants_seen(plain, x, w):
    """Each mins mutant's distance from the plain output, in limits."""
    want = plain(x, w)
    limit = QMM_TOL * float(want.float().abs().max())
    seen = {what: float((plain(xm, wm).float() - want.float()).abs().max()) / limit
            for what, (xm, wm) in qmm_mins_mutants(x, w).items()}
    assert set(seen) == {"mins dropped", "mins with the wrong sign"}
    return seen


# -- the formats and the repacks ---------------------------------------------


@pytest.mark.parametrize("qt", FORMATS)
@pytest.mark.parametrize("rows,cols,scale", [(64, 512, 0.05), (3, 1024, 3.0)])
def test_q5_format_bit_equal(qt, rows, cols, scale):
    x = np.random.default_rng(rows).standard_normal((rows, cols)).astype(np.float32) * scale
    x[0, :256] = 0.0  # an all-zero block: d = dmin = 0 (Q5_1: eight of them)
    x[1, 256:512] = np.abs(x[1, 256:512])  # no element below zero
    x[2, :32] = -np.abs(x[2, :32]) - 0.01  # an all-negative group
    raw = jquantize(x, JT[qt])
    assert tquantize(x, TT[qt]) == raw
    assert np.array_equal(tdequantize(raw, TT[qt], shape=(rows, cols)),
                          jdequantize(raw, JT[qt], shape=(rows, cols)))


@pytest.mark.parametrize("qt", FORMATS)
@pytest.mark.parametrize("on_torch", [False, True])
def test_q5_repack_bit_equal(qt, on_torch):
    """The torch repack, on numpy bytes (the host) or on a torch tensor (the
    path of a repack on the card), against the reference's (``_repack_q5_k``
    through its C++ repack where the reference built it, else its numpy
    form; ``_repack_q5_1``): i8 at group 32, the codes 0..31, f32 scales and
    mins (Q5_1's mins are -m); then the K-major layout (two bf16 planes) and
    the lane-major prepared planes against the reference's, and the
    dequantized values."""
    n, k = 128, 1024
    raw = _blocks(qt, n, k, 1)
    j = jrepack(raw, JT[qt], (n, k))
    src = torch.frombuffer(bytearray(raw), dtype=torch.uint8) if on_torch else raw
    t = tqt.repack_gguf_tensor(src, TT[qt], (n, k), device="cpu" if on_torch else None)
    assert (t.kind, t.group, t.zero) == (j.kind, j.group, j.zero) == ("i8", 32, 0)
    as_np = (lambda a: a.numpy()) if on_torch else (lambda a: a)
    assert as_np(t.qw).dtype == np.int8 and np.array_equal(as_np(t.qw), np.asarray(j.qw))
    assert as_np(t.qw).min() >= 0 and as_np(t.qw).max() <= 31
    for f in ("scales", "mins"):
        got = as_np(getattr(t, f))
        assert got.dtype == np.float32 and np.array_equal(got, np.asarray(getattr(j, f))), f
    jk = jqt.compact_scales(jqt.transpose_qtensor(jqt.prepare_kernel_scales(j)))
    tk = _kernel_layout(t if on_torch else tqt.to_torch(t, "cpu"))
    assert tk.kind == jk.kind == "i8t" and np.array_equal(tk.qw.numpy(), np.asarray(jk.qw))
    s3, has_mins = tqt.kernel_scales(tk)
    js3, jmins = jqt.kernel_scales(jk)
    assert has_mins and jmins and s3.shape == (2, k // 32, n) and s3.dtype == torch.bfloat16
    assert np.array_equal(s3.view(torch.int16).numpy(), np.asarray(js3).view(np.int16))
    lane = tqt.compact_scales(tqt.prepare_kernel_scales(tqt.to_torch(t, "cpu")))
    jl = jqt.prepare_kernel_scales(j)
    assert lane.scales.shape == (n, 2, k // 32)
    assert torch.equal(lane.scales, torch.from_numpy(np.asarray(jl.scales)).to(torch.bfloat16))
    want = jqt.dequantize_qtensor_np(j)
    assert np.array_equal(tqt.dequantize(tqt.to_torch(t, "cpu"), torch.float32).numpy(), want)
    assert np.array_equal(want, jdequantize(raw, JT[qt], shape=(n, k)))


@pytest.mark.parametrize("qt", FORMATS)
def test_random_blocks_are_a_difference_of_two_terms(qt):
    """Real Q5_K weights are the difference of two terms of one size (the
    mean min within 20 % of the mean scaled code); Q5_1's m lies near
    -16·d; both centre near zero."""
    t = tqt.repack_gguf_tensor(_blocks(qt, 256, 1024, 2), TT[qt], (256, 1024))
    q = t.qw.astype(np.float32).reshape(256, 32, 32)
    scaled = (q * t.scales[:, :, None]).mean()
    assert abs(t.mins.mean() / scaled - 1) < 0.2
    if qt == "Q5_1":
        ratio = t.mins / t.scales  # ±20 %, and the f16 roundings of d and m
        assert 0.79 * 16 <= ratio.min() <= ratio.max() <= 1.21 * 16
    w = tqt.dequantize(tqt.to_torch(t, "cpu"), torch.float32)
    assert abs(float(w.mean())) < 0.1 * float(w.abs().mean())


# -- the K-major (i8t) forms with mins ---------------------------------------


@pytest.mark.parametrize("m", [5, 64])
def test_tqmm_i8_with_mins_matches_pallas(m, interpret):
    """``_tqmm_i8_kernel`` with has_mins (the _MIN_DOT form: f32 group sums of
    bf16 x times bf16 m, subtracted) against the port's plain version and
    the CPU mirror of csrc/i8k_tile.cuh (its K splits, stages and per-stage
    min term), on a real Q5_K qkv-like [768, 512]; the mins mutants 8x past
    the limit."""
    n, k = 768, C
    jw, tw = _q5_pair("Q5_K", n, k, seed=10)
    xj, xt = _x(m, k)
    assert tq._supported_t(tw, k, m) and pq._supported_t(jw, k, m)
    want = np.asarray(pq._tqmm_i8(xj, jw))
    _close(tq.qmm(xt, tw).numpy(), want, QMM_TOL)
    _close(qmm_i8k_split(xt, tw, tq.i8k_plan(m, k, n)[1]).numpy(), want, QMM_TOL)
    _close(qmm_i8k_split(xt, tw, 4).numpy(), want, QMM_TOL)
    assert min(_mutants_seen(tq.qmm_plain, xt, tw).values()) >= 8


@pytest.mark.parametrize("m", [1, 4])
def test_gateup_with_mins_matches_pallas(m, interpret):
    """The fused gate-up on real Q5_K planes at ff 256 over K 512: the
    group-dot form at M = 1 (mins on real planes), the dequant tile's form
    above; equal to the unfused matmul + silu·mul bit for bit."""
    ff, k = 256, C
    jw, tw = _q5_pair("Q5_K", 2 * ff, k, seed=20)
    xj, xt = _x(m, k, seed=7)
    want = pq.qmm_gateup(xj, jw, "silu")
    assert want is not None
    got = tq.qmm_gateup(xt, tw)
    assert got is not None and got.shape == (m, ff)
    _close_bf16(got.float().numpy(), np.asarray(want, np.float32))
    gu = tq.qmm(xt, tw).to(torch.bfloat16)
    assert torch.equal(got, tq.silu(gu[:, :ff]) * gu[:, ff:])
    seen = _mutants_seen(lambda x, w: tq.qmm_gateup_plain(x, w, dq=m > 1), xt, tw)
    assert min(seen.values()) >= 8, seen


@pytest.fixture(scope="module")
def mlp_pair():
    return _q5_pair("Q5_K", 2 * 1024, C, seed=30), _q5_pair("Q5_K", C, 1024, seed=31)


@pytest.mark.parametrize("m", [1, 8, 64])
def test_mlp_with_mins_matches_pallas(mlp_pair, m, interpret):
    """``_mlp_i8_kernel`` with has_mins and d_has_mins against ``qmm_mlp``'s
    plain version (the dequantize-form gate-up with its min term, silu·mul,
    the dequantize-form down with the min term on mid's group sums), and
    that plain version equal to the unfused sequence bit for bit."""
    (jgu, tgu), (jd, td) = mlp_pair
    xj, xt = _x(m, C, seed=13)
    assert tm_mlp.mlp_supported(tgu, td, C, m)
    want = pq.qmm_mlp(xj, jgu, jd, "silu")
    assert want is not None, "the Pallas MLP kernel refused the shape; test is vacuous"
    got = tm_mlp.qmm_mlp(xt, tgu, td)
    assert got is not None and got.dtype == torch.bfloat16 and got.shape == (m, C)
    _close(got.float().numpy(), np.asarray(want, np.float32), 2 ** -6 if m == 1 else 2 ** -7)
    mid = tq.qmm_gateup_plain(xt, tgu, dq=True)
    assert torch.equal(got, tq.qmm_plain(mid, td, dq=True).to(torch.bfloat16))
    for what, (xm, wm) in qmm_mins_mutants(mid, td).items():  # the down's mins mishandled
        wrong = tq.qmm_plain(xm, wm, dq=True).to(torch.bfloat16).float()
        assert (wrong - got.float()).abs().max() > 8 * 2 ** -7 * got.float().abs().max(), what


# -- the lane-major (i8) forms with mins -------------------------------------


@pytest.mark.parametrize("qt,k,m", [("Q5_1", 384, 1), ("Q5_1", 384, 2), ("Q5_1", 384, 64),
                                    ("Q5_K", 768, 2), ("Q5_K", 768, 64)])
def test_lane_major_i8_with_mins_matches_pallas(qt, k, m, interpret):
    """``_qmm_i8_kernel`` with has_mins (each dequantized bf16 value less its
    group's bf16 min, one rounding; Q5_1's mins are -m) against the port's
    lane-major plain version and the CPU mirror of csrc/qmm_lane.cu's split
    sum: Q5_1 at the down's shape of a ff-384 model (K 384: (K/32) % 8 = 4
    keeps it from the K-major kernels), Q5_K at K 768 (a dense weight of
    that width is K-major; an expert stack's rows stay lane-major); decode
    (M = 1) held to the reference's M = 2 form of the row (the deviation of
    its M = 1 row is recorded in ROADMAP.md); the mirror is
    csrc/qmm_lane_i8.cu's form at M (``ops.qmm.lane_i8_plan``), the wrong
    kernels (``testing.qmm_lane_i8_mutants``) 8x past the limit."""
    n = C
    jw, tw = _q5_pair(qt, n, k, seed=40, kmajor=False)
    assert tq.lane_supported(tw) and pq._supported(jw, k, m)
    assert tq.transposable(tw) == pq.transposable(jw) == (qt == "Q5_K")
    xj, xt = _x(max(m, 2), k, seed=9)
    want = np.asarray(pq._qmm_i8(jnp.asarray(xj), jw))[:m]
    _close(tq.qmm(xt[:m], tw).numpy(), want, QMM_TOL)
    plan = tq.lane_i8_plan(m, k, n)  # csrc/qmm_lane_i8.cu's form at m rows
    mirror = (qmm_lane_mv_split(xt[:m], tw) if plan[0] == "mv"
              else qmm_lane_mm_split(xt[:m], tw, plan[2]))
    _close(mirror.numpy(), want, QMM_TOL)
    plain = tq.qmm_lane_plain(xt[:m], tw)
    limit = QMM_TOL * float(plain.abs().max())
    seen = {what: float((tq.qmm_lane_plain(xm, wm) - plain).abs().max()) / limit
            for what, (xm, wm) in qmm_lane_i8_mutants(xt[:m], tw, plan).items()}
    assert {"mins dropped", "mins with the wrong sign"} <= set(seen)
    assert min(seen.values()) >= 8, seen


@pytest.mark.parametrize("n,k", [(256, 512), (512, 256)])  # gate/up, down
def test_grouped_qmm_i8_with_mins_matches_pallas(n, k, interpret):
    """The grouped form over a Q5_K expert stack (4 experts; pallas_moe.py's
    i8 branch with has_mins) under a seeded routing of 12 tokens, with and
    without the count of real rows."""
    E, used_k = 4, 2
    jw, tw = _q5_pair("Q5_K", E * n, k, 50 + k, kmajor=False)
    rng = np.random.default_rng(k)
    topi = np.stack([rng.permutation(E)[:used_k] for _ in range(12)]).astype(np.int32)
    x = (rng.standard_normal((12, k)) * 0.5).astype(np.float32)
    jxp, _, jte = pm.route_pad(jnp.asarray(x, jnp.bfloat16), jnp.asarray(topi), E)
    want = np.asarray(pm.grouped_qmm(jxp, jw, jte, E))
    xp, _, te, used = tmoe.route_pad(torch.from_numpy(x).to(torch.bfloat16),
                                     torch.from_numpy(topi), E)
    _close(tmoe.grouped_qmm(xp, tw, te, E, used).numpy(), want, QMM_TOL)
    _close(tmoe.grouped_qmm(xp, tw, te, E).numpy(), want, QMM_TOL)


# -- the wrappers' launches (a stand-in library) ------------------------------


@pytest.fixture
def lib(monkeypatch):
    """A stand-in kernel library that records each call: the wrappers'
    launch code on CPU tensors, as it runs for CUDA ones."""
    calls = []

    class _Lib:
        def __getattr__(self, name):
            return lambda *a: calls.append((name, a)) or (64 if name.endswith("ws_ints") else 0)

    monkeypatch.setattr(kernels, "library", lambda name, signatures: _Lib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    for mod in (tq, tm_mlp):
        monkeypatch.setattr(mod, "_ticket_buffer",
                            lambda device, n: torch.zeros(max(n, 1), dtype=torch.int32))
    return calls


def test_wrappers_hand_the_mins_forms_to_the_kernels(lib):
    """The i8t matmul and gate-up above M = 1 pass mins = 1 to
    bt_qmm_i8t_dq, the whole MLP mins = 1 to bt_mlp_i8t, the lane-major
    wrapper (i4, mins) = (0, 1) to bt_qmm_lane and mins = 1 to both forms of
    bt_qmm_lane_i8; the M = 1 form keeps its mins flag."""
    _, gu = _q5_pair("Q5_K", 2 * 1024, C, seed=60)
    _, dn = _q5_pair("Q5_K", C, 1024, seed=61)
    _, lane = _q5_pair("Q5_1", C, 384, seed=62, kmajor=False)
    x = torch.zeros(16, C, dtype=torch.bfloat16)
    tq._launch_i8t(x, gu, gateup=False, dq=True)
    tq._launch_i8t(x, gu, gateup=True, dq=True)
    tq._launch_i8t(x[:1], gu, gateup=True, dq=False)
    tm_mlp._launch(x, gu, dn)
    tq.lane_launch(torch.zeros(3, 384, dtype=torch.bfloat16), lane, C, "qmm_i8")
    for m in (3, 40):  # qmm_lane's int8 form: csrc/qmm_lane_i8.cu's matvec, then its tile
        tq.lane_i8_launch(torch.zeros(m, 384, dtype=torch.bfloat16), lane)
    by = {}
    for name, a in lib:
        by.setdefault(name, []).append(a)
    bm, ks = tq.i8k_plan(16, C, 2048)
    # (M, K, N, KS, gateup, G, bm, mins)
    assert [a[4:12] for a in by["bt_qmm_i8t_dq"]] == [(16, C, 2048, ks, g, 32, bm, 1)
                                                      for g in (0, 1)]
    # (K, N, G, mins, gateup)
    assert by["bt_qmm_i8t_gd"][0][4:9] == (C, 2048, 32, 1, 1)
    assert by["bt_mlp_i8t"][0][20] == 1
    # (M, K, N, G, zero, i4, mins)
    assert by["bt_qmm_lane"][0][8:15] == (3, 384, C, 32, 0, 0, 1)
    # (M, K, N, G, mins)
    assert by["bt_qmm_lane_i8_mv"][0][4:9] == (3, 384, C, 32, 1)
    assert by["bt_qmm_lane_i8_mm"][0][4:9] == (40, 384, C, 32, 1)


def test_wrappers_refuse_the_mins_forms_still_not_ported(lib):
    """Mins at group 16 above M = 1 (no format gives them) and a whole MLP
    with mins on one weight only raise; nothing is handed to a plain
    version."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.integers(0, 32, (C, 256), dtype=np.int8))
    s = torch.rand(2, C // 16, 256).to(torch.bfloat16)
    w16 = tqt.QTensor("i8t", q, s, None, 16, (256, C), TT.Q5_K)
    with pytest.raises(NotImplementedError, match="mins at group 16"):
        tq._launch_i8t(torch.zeros(2, C, dtype=torch.bfloat16), w16, gateup=False, dq=True)
    tq._launch_i8t(torch.zeros(1, C, dtype=torch.bfloat16), w16, gateup=False, dq=False)
    _, gu = _q5_pair("Q5_K", 2 * 1024, C, seed=63)
    _, dn = _q5_pair("Q5_K", C, 1024, seed=64)
    dn8 = dataclasses.replace(dn, scales=dn.scales[:1].contiguous(), source_type=TT.Q8_0)
    with pytest.raises(NotImplementedError, match="mins on one of its weights"):
        tm_mlp._launch(torch.zeros(16, C, dtype=torch.bfloat16), gu, dn8)
    assert [n for n, _ in lib] == ["bt_qmm_i8t_gd"]


# -- the model ----------------------------------------------------------------


def _q5ks(path, ff):
    """A 2-layer llama file in llama.cpp's Q5_K_S mix (Q5_K, the head Q6_K,
    Q5_1 where a row holds no super-block)."""
    return make_model(path, vocab_size=512, hidden=C, layers=L, heads=4, kv_heads=2, ff=ff,
                      quant=TT.Q5_K, output_quant=TT.Q6_K, weight_scale=0.05)


@pytest.fixture(scope="module", params=[384, 1024], ids=["ff384", "ff1024"])
def models(request, tmp_path_factory):
    ff = request.param
    path = _q5ks(str(tmp_path_factory.mktemp(f"q5k{ff}") / "t.gguf"), ff)
    return ff, path, j_load(path, weights="native"), load_model(path, device="cpu",
                                                                 weights="native")


def test_file_is_the_q5_k_s_mix(models):
    ff, path, _, _ = models
    reader = GGUFReader(path)
    try:
        types_ = {name: info.ggml_type for name, info in reader.tensors.items()
                  if len(info.shape) == 2}
    finally:
        reader.close()
    assert types_.pop("output.weight") == TT.Q6_K
    down = TT.Q5_1 if ff % 256 else TT.Q5_K
    assert {t for n, t in types_.items() if "ffn_down" in n} == {down}
    assert {t for n, t in types_.items() if "ffn_down" not in n} == {TT.Q5_K}


def test_loader_kinds_equal_reference(models):
    """The reference's choices: wqkv, wo and w_gateup K-major i8t at group
    32 with a mins plane; w_down the same at ff 1024 and lane-major i8 with
    prepared planes (mins after the scales) at ff 384; the head i8t at group
    16 without mins; payloads and planes bit for bit; the Q5_K embedding as
    the reference dequantizes it."""
    ff, _, jm, tm = models
    carried = params_from_numpy(jax.tree.map(np.asarray, jm.params), tm.cfg, device="cpu")
    want = {"wqkv": ("i8t", 32, 2), "wo": ("i8t", 32, 2), "w_gateup": ("i8t", 32, 2),
            "w_down": ("i8", 32, 2) if ff % 256 else ("i8t", 32, 2)}
    for key, (kind, group, planes) in want.items():
        j, a, b = jm.params["layers"][key], carried["layers"][key], tm.params["layers"][key]
        assert (j.kind, j.group) == (b.kind, b.group) == (kind, group), key
        assert tqt.kernel_scales(b.at(0).resolved())[1], key
        assert b.scales.shape[1 if kind == "i8t" else 2] == planes, key
        assert torch.equal(a.qw, b.qw), key
        assert torch.equal(a.scales.float(), b.scales.float()), key
    out = tm.params["output"]
    assert (out.kind, out.group, out.source_type) == ("i8t", 16, TT.Q6_K)
    assert jm.params["output"].kind == "i8t" and out.scales.shape[0] == 1
    assert torch.equal(carried["tok_embd"].view(torch.int16), tm.params["tok_embd"].view(torch.int16))
    dispatch = tm_mlp.mlp_supported(tm.params["layers"]["w_gateup"].at(0),
                                    tm.params["layers"]["w_down"].at(0), C, 1)
    assert dispatch == (ff % 256 == 0)  # the whole MLP with mins only where the down is i8t


def _teacher_forced(jm, tm, prompts, steps, quantized=False):
    """Prefill `prompts` (an id list per slot, [] for an idle one) in one
    32-row batch, then `steps` decode steps with the live slots fed the
    reference's greedy tokens, over a bf16 (or an int8) cache in both
    packages; returns per step the live slots' logits (port, reference).
    A single slot runs twice in the reference (its decode at M = 2): the
    reference's M = 1 rows sit further off its M > 1 rows in interpret mode
    than the port's (ROADMAP.md, Queue 3), so decode is compared with its
    M > 1 form of the same row."""
    cfg = tm.cfg
    live = [b for b, p in enumerate(prompts) if p]
    jprompts = prompts * 2 if len(prompts) == 1 else prompts

    def batch(ps):  # the prompts' rows, their counts and each one's last row
        arr = np.zeros((len(ps), 32), np.int32)
        for b, ids in enumerate(ps):
            arr[b, :len(ids)] = ids
        nv = np.asarray([len(p) for p in ps], np.int32)
        return arr, nv, np.maximum(nv - 1, 0)

    (ta, tnv, tg), (ja, jnv, jg) = batch(prompts), batch(jprompts)
    out = []
    tc = KVCache.create(cfg.n_layers, len(prompts), MAX_SEQ, cfg.n_kv_heads, cfg.head_dim, "cpu",
                        quantized=quantized)
    jc = JCache.create(cfg.n_layers, len(jprompts), MAX_SEQ, cfg.n_kv_heads, cfg.head_dim,
                       quantized=quantized)
    tl, tc = forward(tm.params, cfg, torch.from_numpy(ta), tc, gather_idx=torch.from_numpy(tg),
                     n_valid=torch.from_numpy(tnv))
    jl, jc = j_forward(jm.params, jm.cfg, jnp.asarray(ja), jc, gather_idx=jnp.asarray(jg),
                       n_valid=jnp.asarray(jnv))
    out.append((tl.numpy()[live, -1], np.asarray(jl)[live, -1]))
    step_nv = np.asarray([1 if p else 0 for p in prompts], np.int32)
    jstep_nv = np.asarray([1 if p else 0 for p in jprompts], np.int32)
    for _ in range(steps):
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None] * jstep_nv[:, None]
        tl, tc = forward(tm.params, cfg, torch.from_numpy(nxt[:len(prompts)]), tc,
                         last_only=True, n_valid=torch.from_numpy(step_nv))
        jl, jc = j_forward(jm.params, jm.cfg, jnp.asarray(nxt), jc, last_only=True,
                           n_valid=jnp.asarray(jstep_nv))
        out.append((tl.numpy()[live, -1], np.asarray(jl)[live, -1]))
    want_len = [len(p) + steps if p else 0 for p in prompts]
    assert np.asarray(tc.lengths).tolist() == want_len
    assert np.asarray(jc.lengths).tolist()[:len(prompts)] == want_len
    return out


def _prefill_decode(jm, tm, steps):
    return _teacher_forced(jm, tm, [tm.tokenizer.encode(PROMPT)], steps)


def test_prefill_and_decode_logits_match(models, pallas, monkeypatch):
    """A 32-row prefill and 4 decode steps, prefill against prefill and
    decode against decode; the port's forms counted through their entries:
    the whole MLP at ff 1024 (its M = 32 prefill and its steps), the fused
    gate-up and the lane-major down at ff 384."""
    ff, _, jm, tm = models
    rows = {"mlp": [], "gateup": [], "lane": []}
    orig = (tm_mlp.qmm_mlp_i8t, tq.qmm_i8t_gateup, tq.qmm_lane)

    def spy(key, fn):
        def call(x, *w):
            rows[key].append(x.shape[0])
            return fn(x, *w)
        return call

    monkeypatch.setattr(tm_mlp, "qmm_mlp_i8t", spy("mlp", orig[0]))
    monkeypatch.setattr(tq, "qmm_i8t_gateup", spy("gateup", orig[1]))
    monkeypatch.setattr(tq, "qmm_lane", spy("lane", orig[2]))
    for got, want in _prefill_decode(jm, tm, steps=4):
        _close(got, want, LOGIT_TOL)
    if ff % 256:
        assert rows == {"mlp": [], "gateup": [32] * L + [1] * 4 * L,
                        "lane": [32] * L + [1] * 4 * L}
    else:
        assert rows == {"mlp": [32] * L + [1] * 4 * L, "gateup": [], "lane": []}


def _greedy_equal_or_near_tie(jm, tm, got: list, want: list):
    """Greedy tokens equal up to the first step whose reference top-2 margin
    is within the logit tolerance; that step must be such a near-tie."""
    assert len(got) == len(want)
    same = [a == b for a, b in zip(got, want)]
    if all(same):
        return
    i = same.index(False)
    steps = _prefill_decode(jm, tm, steps=i)
    assert [int(np.argmax(w[0])) for _, w in steps] == want[:i + 1]
    ref = steps[i][1][0]
    top2 = np.sort(ref)[-2:]
    assert top2[1] - top2[0] <= LOGIT_TOL * np.abs(ref).max(), (i, top2)


def test_generate_greedy_tokens_equal(models, pallas):
    _, _, jm, tm = models
    ids = tm.tokenizer.encode(PROMPT)
    want = JEngine(jm, max_batch=1, max_seq=MAX_SEQ, decode_chunk=4).generate(
        ids, JSP(temp=0.0), max_new_tokens=8)
    got = Engine(tm, max_batch=1, max_seq=MAX_SEQ, decode_chunk=4).generate(
        ids, SamplingParams(temp=0.0), max_new_tokens=8)
    assert len(want.token_ids) == 8
    _greedy_equal_or_near_tie(jm, tm, got.token_ids, want.token_ids)


def test_batched_int8_cache_logits_match(models, pallas):
    """The batched path over an int8 cache (4 slots, 2 live: the matmuls at
    M = 4 on decode), teacher-forced with the reference's greedy tokens: the
    live slots' logits at every step within the tolerance, and their greedy
    tokens equal wherever the reference's top-2 margin exceeds it."""
    _, _, jm, tm = models
    tok = tm.tokenizer
    prompts = [tok.encode("stream 0 benchmark prompt"), [], tok.encode("stream 2 benchmark prompt"),
               []]
    for got, want in _teacher_forced(jm, tm, prompts, steps=4, quantized=True):
        _close(got, want, LOGIT_TOL)
        top2 = np.sort(want, -1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > LOGIT_TOL * np.abs(want).max(-1)
        assert (np.argmax(got, -1) == np.argmax(want, -1))[sure].all()
