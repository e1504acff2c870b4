"""The port's Q4_K path against the JAX package on the CPU, the reference's
Pallas kernels in interpret mode: the Q4_K format and repack bit for bit
(the K-major four planes too), the i4t matvec, tile and fused gate-up on
real Q4_K planes (their plain versions and the CPU mirrors of the kernels'
sum orders), the lane-major and grouped i4p matmuls with mins, a small
Q4_K model (hidden 512, 4 heads of 128 over 2 kv heads, ff 1024, vocab 512,
2 layers) through the loader, the forward, ``Engine.generate`` with Janus
and the one-shot CLI, the same model with a Q6_K head (llama.cpp writes
the head so), and a 2-layer Q4_K MoE model's expert FFN.

Tolerances: matmul outputs are f32 sums of the same exact products in
another order, within 2e-4 of the largest output; the wrong kernels
(``testing.qmm_i4t_mutants``, ``qmm_lane_mutants``, ``qmm_mins_mutants``)
must land 8x past that.  Gate-up outputs are bf16: |port - reference| <=
2^-7 |reference| + 1e-5 max|reference| per element.  Logits at 2^-5 of
their largest magnitude (tests/test_torch_model.py).  Janus with janus_hi =
janus_lo = 1 keeps only the top logit (when it is positive), so both
packages' draws are that token and their streams compare as greedy ones:
equal up to the first step whose reference top-2 margin is within the
logit tolerance."""

import dataclasses
import subprocess
import sys

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
from booster_tpu_torch.models import load_model, params_from_numpy  # noqa: E402
from booster_tpu_torch.models.llama import forward  # noqa: E402
from booster_tpu_torch.models.loader import _kernel_layout, _stack_qtensors  # noqa: E402
from booster_tpu_torch.ops import moe as tmoe  # noqa: E402
from booster_tpu_torch.ops import qmm as tq  # noqa: E402
from booster_tpu_torch.ops.kv_cache import KVCache  # noqa: E402
from booster_tpu_torch.quant import dequantize as tdequantize  # noqa: E402
from booster_tpu_torch.quant import qtensor as tqt  # noqa: E402
from booster_tpu_torch.quant import quantize as tquantize  # noqa: E402
from booster_tpu_torch.sampling import SamplingParams  # noqa: E402
from booster_tpu_torch.serving import Engine  # noqa: E402
from booster_tpu_torch.serving import scheduler as tsched  # noqa: E402
from booster_tpu_torch.testing import (i4t_mv_last, make_model, qmm_i4t_mutants,  # noqa: E402
                                       qmm_i4t_mv_split, qmm_i4t_split, qmm_lane_mutants,
                                       qmm_lane_split, qmm_mins_mutants, random_blocks)
from booster_tpu_torch.testing import torch_threads  # noqa: E402

QMM_TOL = 2e-4
LOGIT_TOL = 2 ** -5
MAX_SEQ = 128
C, FF, L = 512, 1024, 2  # the small model's hidden width, ff and layers
PROMPT = "hello world the and of to in"
assert JT.Q4_K == TT.Q4_K


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


def _blocks(n, k, seed):
    """Real Q4_K bytes of an [n, k] weight: random blocks whose min term is
    as large as the scaled term (``testing.random_blocks``)."""
    return np.frombuffer(random_blocks(np.random.default_rng(seed), n * k, TT.Q4_K, 0.05),
                         np.uint8)


# -- the format and the repack -----------------------------------------------


@pytest.mark.parametrize("rows,cols,scale", [(64, 512, 0.05), (3, 1024, 3.0)])
def test_q4_k_format_bit_equal(rows, cols, scale):
    x = np.random.default_rng(rows).standard_normal((rows, cols)).astype(np.float32) * scale
    x[0, :256] = 0.0  # an all-zero block: d = dmin = 0
    x[1, 256:512] = np.abs(x[1, 256:512])  # no group below zero: dmin = 0
    x[2, :32] = -np.abs(x[2, :32]) - 0.01  # an all-negative group
    raw = jquantize(x, JT.Q4_K)
    assert tquantize(x, TT.Q4_K) == raw
    dd = np.frombuffer(raw, np.uint8).reshape(-1, 144)[:, :4].copy().view(np.float16)
    assert (dd[0] == 0).all() and dd[cols // 256 + 1, 1] == 0  # row 1's block 1: dmin 0
    assert np.array_equal(tdequantize(raw, TT.Q4_K, shape=(rows, cols)),
                          jdequantize(raw, JT.Q4_K, shape=(rows, cols)))


@pytest.mark.parametrize("on_torch", [False, True])
def test_q4_k_repack_bit_equal(on_torch):
    """The torch repack, on numpy bytes (the host) or on a torch tensor (the
    path of a repack on the card), against ``_repack_q4_k`` (the C++ repack
    where the reference built it, else its numpy form); then the K-major
    layout (four bf16 planes: the halves' scales, then their mins) and the
    lane-major prepared planes against the reference's."""
    n, k = 128, 1024
    raw = _blocks(n, k, 1)
    j = jrepack(raw, JT.Q4_K, (n, k))
    src = torch.frombuffer(bytearray(raw), dtype=torch.uint8) if on_torch else raw
    t = tqt.repack_gguf_tensor(src, TT.Q4_K, (n, k), device="cpu" if on_torch else None)
    assert (t.kind, t.group, t.zero) == (j.kind, j.group, j.zero) == ("i4p", 32, 0)
    as_np = (lambda a: a.numpy()) if on_torch else (lambda a: a)
    assert np.array_equal(as_np(t.qw), np.asarray(j.qw))
    for f in ("scales", "mins"):
        got = as_np(getattr(t, f))
        assert got.dtype == np.float32 and np.array_equal(got, np.asarray(getattr(j, f))), f
    jk = jqt.compact_scales(jqt.transpose_qtensor(jqt.prepare_kernel_scales(j)))
    tk = _kernel_layout(t if on_torch else tqt.to_torch(t, "cpu"))
    assert tk.kind == jk.kind == "i4t" and np.array_equal(tk.qw.numpy(), np.asarray(jk.qw))
    s3, has_mins = tqt.kernel_scales(tk)
    js3, jmins = jqt.kernel_scales(jk)
    assert has_mins and jmins and s3.shape == (4, k // 64, n)
    assert np.array_equal(s3.view(torch.int16).numpy(), np.asarray(js3).view(np.int16))
    lane = tqt.compact_scales(tqt.prepare_kernel_scales(tqt.to_torch(t, "cpu")))
    jl = jqt.prepare_kernel_scales(j)
    assert lane.scales.shape == (n, 4, k // 64)
    assert torch.equal(lane.scales, torch.from_numpy(np.asarray(jl.scales)).to(torch.bfloat16))
    want = jqt.dequantize_qtensor_np(j)
    assert np.array_equal(tqt.dequantize(tqt.to_torch(t, "cpu"), torch.float32).numpy(), want)


def test_random_blocks_min_term_as_large_as_the_scaled_term():
    """Real Q4_K weights are a difference of two terms of one size: the
    random blocks' mean min equals their mean scaled nibble within 20 %,
    and the weights average near zero."""
    t = tqt.repack_gguf_tensor(_blocks(256, 1024, 2), TT.Q4_K, (256, 1024))
    q = np.concatenate([t.qw & 15, t.qw >> 4], axis=1).astype(np.float32).reshape(256, 32, 32)
    scaled = (q * t.scales[:, :, None]).mean()
    assert abs(t.mins.mean() / scaled - 1) < 0.2
    w = tqt.dequantize(tqt.to_torch(t, "cpu"), torch.float32)
    assert abs(float(w.mean())) < 0.1 * float(w.abs().mean())


# -- the K-major (i4t) kernels' plain versions and mirrors -------------------------


def _i4t_pair(n, k, seed=0, layers=L):
    """The same stacked Q4_K weights [L, n, k] through both packages' load
    pipelines (i4p with mins → prepared → stacked → i4t, four bf16 planes)."""
    raws = [_blocks(n, k, seed + i) for i in range(layers)]
    j = jqt.compact_scales(jqt.transpose_qtensor(jqt.prepare_kernel_scales(
        _stack_j(raws, n, k))))
    t = _kernel_layout(_stack_qtensors([tqt.repack_gguf_tensor(r, TT.Q4_K, (n, k))
                                        for r in raws]))
    assert t.kind == j.kind == "i4t" and t.scales.shape == (layers, 4, k // 64, n)
    assert np.array_equal(t.scales.view(torch.int16).numpy(), np.asarray(j.scales).view(np.int16))
    return jax.tree.map(jnp.asarray, j), tqt.to_torch(t, "cpu")


def _stack_j(raws, n, k):
    from booster_tpu.models.loader import _stack_qtensors as j_stack

    return j_stack([jqt.prepare_kernel_scales(jrepack(r, JT.Q4_K, (n, k))) for r in raws])


def _layer(w, i):
    return dataclasses.replace(w, layer=jnp.int32(i))


@pytest.mark.parametrize("m", [1, 9])
def test_qmm_i4t_matches_pallas(m, interpret):
    """qkv-like [768, 512] on real Q4_K planes: the port's plain version and
    the CPU mirror of the kernel's sum order (the M = 1 matvec of
    csrc/i4mv.cuh, the M > 1 tile of csrc/qmm_i4t.cu) within 2e-4 of the
    reference's ``_tqmm_i4``; every wrong kernel, the mins dropped and the
    mins with the wrong sign among them, 8x past that."""
    n, k = 768, C
    jw, tw = _i4t_pair(n, k, seed=10)
    xj, xt = _x(m, k)
    assert tq._supported_t(tw.at(1), k, m) and pq._supported_t(_layer(jw, 1), k, m)
    want = np.asarray(pq._tqmm_i4(xj, _layer(jw, 1)))
    w1 = tw.at(1)
    _close(tq.qmm(xt, w1).numpy(), want, QMM_TOL)
    ngh = k // 64
    if m == 1:
        ks = tq.i4t_mv_plan(k, n, 32)
        mirror, last = qmm_i4t_mv_split(xt, w1, ks), i4t_mv_last(ngh, ks)
    else:
        ks = tq.i4t_plan(m, k, n)[1]
        mirror, last = qmm_i4t_split(xt, w1, ks), ((ks - 1) * ngh // ks, ngh)
    _close(mirror.numpy(), want, QMM_TOL)
    plain = tq.qmm_plain(xt, w1)
    limit = QMM_TOL * float(plain.abs().max())
    seen = {what: float((tq.qmm_plain(xm, wm) - plain).abs().max()) / limit
            for what, (xm, wm) in {**qmm_i4t_mutants(xt, w1, last),
                                   **qmm_mins_mutants(xt, w1)}.items()}
    assert {"mins dropped", "mins with the wrong sign"} <= set(seen)
    assert min(seen.values()) >= 8, seen


@pytest.mark.parametrize("m", [1, 4])
def test_gateup_with_mins_matches_pallas(m, interpret):
    """The fused gate-up on real Q4_K planes at ff 256 over K 1024 (the
    reference's gate takes it at this width): the group-dot form at M = 1,
    the dequant tile above; equal to the unfused matmul + silu·mul."""
    ff, k = 256, 1024
    jw, tw = _i4t_pair(2 * ff, k, seed=20)
    xj, xt = _x(m, k, seed=7)
    want = pq.qmm_gateup(xj, _layer(jw, 0), "silu")
    assert want is not None
    got = tq.qmm_gateup(xt, tw.at(0))
    assert got is not None and got.shape == (m, ff)
    _close_bf16(got.float().numpy(), np.asarray(want, np.float32))
    gu = tq.qmm(xt, tw.at(0)).to(torch.bfloat16)
    assert torch.equal(got, tq.silu(gu[:, :ff]) * gu[:, ff:])


# -- the lane-major i4p form with mins ---------------------------------------


def _lane_pair(rows, k, seed):
    """An i4p weight with mins through both packages: the reference's
    prepared planes, the port's with bf16 planes as its loader stores
    expert stacks."""
    raw = _blocks(rows, k, seed)
    j = jqt.prepare_kernel_scales(jrepack(raw, JT.Q4_K, (rows, k))).astype_device()
    t = tqt.to_torch(tqt.compact_scales(tqt.prepare_kernel_scales(
        tqt.repack_gguf_tensor(raw, TT.Q4_K, (rows, k)))), "cpu")
    assert t.scales.shape == (rows, 4, k // 64) and t.scales.dtype == torch.bfloat16
    return j, t


@pytest.mark.parametrize("m", [1, 2, 64])
def test_lane_major_with_mins_matches_pallas(m, interpret):
    """``_qmm_i4_kernel`` with has_mins (the expand-and-subtract rounding)
    against the port's lane-major plain version and the CPU mirror of
    csrc/qmm_lane.cu's split sum, at a shape the K-major kernels do not take
    (K 768: (K/2)/32 % 8 != 0); the M = 1 row held to the reference's M = 2
    form of it (tests/test_torch_moe.py); the wrong kernels 8x past."""
    n, k = 256, 768
    jw, tw = _lane_pair(n, k, 30)
    assert not tq.transposable(tw) and tq.lane_supported(tw)
    assert pq._supported(jw, k, m) and not pq.transposable(jw)
    xj, xt = _x(max(m, 2), k, seed=9)
    want = np.asarray(pq._qmm_i4(jnp.asarray(xj), jw))[:m]
    _close(tq.qmm(xt[:m], tw).numpy(), want, QMM_TOL)
    bm, ks = tq.lane_plan(m, k, n)
    sk = tq.lane_stage(bm, "i4p")
    _close(qmm_lane_split(xt[:m], tw, ks, sk).numpy(), want, QMM_TOL)
    plain = tq.qmm_lane_plain(xt[:m], tw)
    limit = QMM_TOL * float(plain.abs().max())
    nst = k // sk
    seen = {what: float((tq.qmm_lane_plain(xm, wm) - plain).abs().max()) / limit
            for what, (xm, wm) in qmm_lane_mutants(xt[:m], tw, (0, max(1, nst // ks)),
                                                   sk).items()}
    assert {"mins dropped", "mins with the wrong sign"} <= set(seen)
    assert min(seen.values()) >= 8, seen


@pytest.mark.parametrize("n,k", [(256, 256), (256, 512)])  # gate/up, down
def test_grouped_qmm_with_mins_matches_pallas(n, k, interpret):
    """The grouped form over a Q4_K expert stack (4 experts) under a seeded
    routing of 12 tokens, with and without the count of real rows."""
    E, used_k = 4, 2
    jw, tw = _lane_pair(E * n, k, 40 + k)
    rng = np.random.default_rng(k)
    topi = np.stack([rng.permutation(E)[:used_k] for _ in range(12)]).astype(np.int32)
    x = (rng.standard_normal((12, k)) * 0.5).astype(np.float32)
    jxp, _, jte = pm.route_pad(jnp.asarray(x, jnp.bfloat16), jnp.asarray(topi), E)
    want = np.asarray(pm.grouped_qmm(jxp, jw, jte, E))
    xp, _, te, used = tmoe.route_pad(torch.from_numpy(x).to(torch.bfloat16),
                                     torch.from_numpy(topi), E)
    _close(tmoe.grouped_qmm(xp, tw, te, E, used).numpy(), want, QMM_TOL)
    _close(tmoe.grouped_qmm(xp, tw, te, E).numpy(), want, QMM_TOL)


def test_lane_launch_takes_i4p_mins_and_refuses_i8_mins(monkeypatch):
    """On CUDA tensors (a stand-in library here) the lane-major wrapper hands
    an i4p weight with mins to csrc/qmm_lane.cu with mins = 1, and an i8
    weight with mins (Q5_K's form, ported since) with (i4, mins) = (0, 1);
    a group the kernel does not take (8) still raises."""
    import types

    from booster_tpu_torch.ops import kernels

    calls = []

    class _Lib:
        def __getattr__(self, name):
            return lambda *a: calls.append((name, a)) or 0

    monkeypatch.setattr(kernels, "library", lambda name, signatures: _Lib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(tq, "_ticket_buffer",
                        lambda device, n: torch.zeros(n, dtype=torch.int32))
    _, tw = _lane_pair(256, 768, 50)
    x = torch.zeros(3, 768, dtype=torch.bfloat16)
    tq.lane_launch(x, tw, 256, "qmm_i4p")
    ((name, args),) = calls
    # (M, K, N, G, zero, i4, mins, bm, ks)
    assert name == "bt_qmm_lane" and args[8:15] == (3, 768, 256, 32, 0, 1, 1)
    s = tw.scales[:, :2].float()
    w8 = tqt.QTensor("i8", torch.zeros(256, 768, dtype=torch.int8),
                     torch.cat([s.reshape(256, 1, -1)] * 2, 1).to(torch.bfloat16), None, 32,
                     (256, 768), TT.Q5_K)
    tq.lane_launch(x, w8, 256, "qmm_i8")
    name, args = calls[1]
    assert name == "bt_qmm_lane" and args[8:15] == (3, 768, 256, 32, 0, 0, 1)
    w8g = dataclasses.replace(w8, group=8, scales=torch.zeros(256, 2, 96, dtype=torch.bfloat16))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tq.lane_launch(x, w8g, 256, "qmm_i8")
    assert len(calls) == 2


# -- the model ----------------------------------------------------------------


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    return make_model(str(tmp_path_factory.mktemp("q4k") / "t.gguf"), vocab_size=512,
                      hidden=C, layers=L, heads=4, kv_heads=2, ff=FF, quant=TT.Q4_K,
                      weight_scale=0.3)


@pytest.fixture(scope="module")
def models(gguf):
    return j_load(gguf, weights="native"), load_model(gguf, device="cpu", weights="native")


def test_loader_kinds_equal_reference(models):
    """Every layer weight and the head K-major i4t with four bf16 planes
    (Q4_K's mins), payloads and planes bit for bit with the reference's;
    the embedding dequantized on the host as the reference loads it."""
    jm, tm = models
    carried = params_from_numpy(jax.tree.map(np.asarray, jm.params), tm.cfg, device="cpu")
    for key in ("wqkv", "wo", "w_gateup", "w_down"):
        j, a, b = jm.params["layers"][key], carried["layers"][key], tm.params["layers"][key]
        assert (j.kind, b.kind, b.zero, b.source_type) == ("i4t", "i4t", 0, TT.Q4_K), key
        assert b.scales.shape[1] == 4, key
        assert torch.equal(a.qw, b.qw), key
        assert torch.equal(a.scales.view(torch.int16), b.scales.view(torch.int16)), key
    assert tm.params["output"].kind == jm.params["output"].kind == "i4t"
    assert torch.equal(carried["tok_embd"].view(torch.int16), tm.params["tok_embd"].view(torch.int16))


def _prefill_decode(jm, tm, steps):
    cfg = tm.cfg
    ids = tm.tokenizer.encode(PROMPT)
    n, T = len(ids), 32
    arr = np.zeros((1, T), np.int32)
    arr[0, :n] = ids
    g, nv = np.asarray([n - 1], np.int32), np.asarray([n], np.int32)
    jc = JCache.create(cfg.n_layers, 1, MAX_SEQ, cfg.n_kv_heads, cfg.head_dim)
    jl, jc = j_forward(jm.params, jm.cfg, jnp.asarray(arr), jc, gather_idx=jnp.asarray(g),
                       n_valid=jnp.asarray(nv))
    tc = KVCache.create(cfg.n_layers, 1, MAX_SEQ, cfg.n_kv_heads, cfg.head_dim, "cpu")
    tl, tc = forward(tm.params, cfg, torch.from_numpy(arr), tc,
                     gather_idx=torch.from_numpy(g), n_valid=torch.from_numpy(nv))
    out = [(tl.numpy(), np.asarray(jl))]
    for _ in range(steps):  # T = 1 steps fed the reference's greedy token
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        jl, jc = j_forward(jm.params, jm.cfg, jnp.asarray(nxt), jc, last_only=True)
        tl, tc = forward(tm.params, cfg, torch.from_numpy(nxt), tc, last_only=True)
        out.append((tl.numpy(), np.asarray(jl)))
    return out


def test_prefill_and_decode_logits_match(models, pallas):
    jm, tm = models
    for got, want in _prefill_decode(jm, tm, steps=3):
        _close(got, want, LOGIT_TOL)


def _equal_or_near_tie(jm, tm, got: list, want: list):
    """Tokens equal up to the first step whose reference top-2 margin is
    within the logit tolerance; that step must be such a near-tie."""
    assert len(got) == len(want)
    same = [a == b for a, b in zip(got, want)]
    if all(same):
        return
    i = same.index(False)
    steps = _prefill_decode(jm, tm, steps=i)
    ref = steps[i][1][0, -1]
    top2 = np.sort(ref)[-2:]
    assert top2[1] - top2[0] <= LOGIT_TOL * np.abs(ref).max(), (i, top2)


def test_generate_janus_top_token_streams_equal(models, pallas):
    """``generate`` with Janus (janus_hi = janus_lo = 1: only the top shaped
    logit stays) in both packages: the same stream, the first sample's top
    logit positive (else every ratio passes the cutoff)."""
    jm, tm = models
    ids = tm.tokenizer.encode(PROMPT)
    (first, _), = _prefill_decode(jm, tm, steps=0)
    assert first[0, -1].max() > 0
    want = JEngine(jm, max_batch=1, max_seq=MAX_SEQ, decode_chunk=4).generate(
        ids, JSP(janus=1, janus_hi=1.0, janus_lo=1.0, seed=3), max_new_tokens=8)
    eng = Engine(tm, max_batch=1, max_seq=MAX_SEQ, decode_chunk=4)
    got = eng.generate(ids, SamplingParams(janus=1, janus_hi=1.0, janus_lo=1.0, seed=3),
                       max_new_tokens=8)
    assert len(want.token_ids) == 8
    _equal_or_near_tie(jm, tm, got.token_ids, want.token_ids)
    # the tables were built once, for the engine
    tables = eng.janus_tables()
    eng.generate(ids, SamplingParams(janus=1, seed=4), max_new_tokens=4)
    assert eng.janus_tables() is tables


def test_janus_refused_by_the_batch_and_the_scheduler(models):
    _, tm = models
    eng = Engine(tm, max_batch=2, max_seq=MAX_SEQ, decode_chunk=4)
    eng.init_batch_state()
    with pytest.raises(NotImplementedError, match="not ported yet"):
        eng.reset_slot(0, SamplingParams(janus=1), seed=0)
    job = tsched.Job(id="j", prompt="hi")
    assert "Janus" in tsched._unported(job, SamplingParams(janus=1))
    assert tsched._unported(job, SamplingParams()) == ""


def test_cli_one_shot_with_janus(gguf):
    """``python -m booster_tpu_torch --janus 1`` runs the one-shot generate
    with Janus: the same text as the library call with the CLI's sampling."""
    r = subprocess.run([sys.executable, "-m", "booster_tpu_torch", "--model", gguf, "--prompt",
                        "hello world", "--n-predict", "6", "--janus", "1", "--seed", "5",
                        "--context", "256", "--device", "cpu"],
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr
    m = load_model(gguf, device="cpu")
    want = Engine(m, max_seq=256, decode_chunk=8).generate(
        m.tokenizer.encode("hello world"),
        SamplingParams(temp=0.1, top_k=8, top_p=0.4, penalty_repeat=1.1, penalty_last_n=64,
                       janus=1, seed=5), max_new_tokens=6)
    assert r.stdout == want.text + "\n"


def test_q6_k_head_over_q4_k_layers(tmp_path, pallas):
    """A Q4_K file whose output.weight is Q6_K (llama.cpp's Q4_K_M writes
    its head so): the head loads as the reference's i8t at group 16 and the
    prefill's logits agree."""
    path = make_model(str(tmp_path / "h.gguf"), vocab_size=512, hidden=C, layers=1, heads=4,
                      kv_heads=2, ff=FF, quant=TT.Q4_K, output_quant=TT.Q6_K, weight_scale=0.3)
    jm, tm = j_load(path, weights="native"), load_model(path, device="cpu", weights="native")
    out = tm.params["output"]
    assert (out.kind, out.group, jm.params["output"].kind) == ("i8t", 16, "i8t")
    assert tm.params["layers"]["wqkv"].source_type == TT.Q4_K
    (got, want), = _prefill_decode(jm, tm, steps=0)
    _close(got, want, LOGIT_TOL)


def test_moe_q4_k_expert_ffn_matches_reference(tmp_path, pallas):
    """A 2-layer Q4_K Mixtral-like file (4 experts of ff 256, 2 used): the
    expert stacks load lane-major i4p with four bf16 planes (the mins) in
    the port, as in the reference, and layer 0's expert FFN agrees."""
    path = make_model(str(tmp_path / "moe.gguf"), vocab_size=512, hidden=256, layers=2,
                      heads=4, kv_heads=2, ff=256, experts=4, experts_used=2,
                      quant=TT.Q4_K, arch="mixtral", weight_scale=0.1)
    jm, tm = j_load(path, weights="native"), load_model(path, device="cpu", weights="native")
    for key in ("gate_exps", "up_exps", "down_exps"):
        t, j = tm.params["layers"][key], jm.params["layers"][key]
        assert (t.kind, j.kind) == ("i4p", "i4p") and t.scales.shape[-2] == 4, key
        assert t.scales.dtype == torch.bfloat16
    keys = ("router", "gate_exps", "up_exps", "down_exps")
    jl = {k: jax.tree.map(lambda a: a[0], jm.params["layers"][k]) for k in keys}
    tl = {k: tm.params["layers"][k].at(0) for k in keys}
    x = (np.random.default_rng(5).standard_normal((2, 9, 256)) * 0.5).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(pm.moe_ffn_grouped(xb, jl, jm.cfg).astype(jnp.float32))
    got = tmoe.moe_ffn_grouped(torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(
        torch.bfloat16), tl, tm.cfg)
    _close(got.float().numpy(), want, 2 ** -7)
