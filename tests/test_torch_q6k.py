"""The port's Q6_K path against the JAX package on the CPU, the reference's
Pallas kernels in interpret mode: the Q6_K format and repack bit for bit,
the i8t kernels' plain versions at group 16, the M = 1 fused gate-up
(``_gateup_i8_gd_kernel``) with and without mins, the lane-major i8 down
matmul at group 32, the loader's kinds, and a small model whose file mixes
Q6_K with Q8_0 ``ffn_down`` as llama.cpp writes it (DeepSeek-Coder-1.3B's
layout at hidden 256, ff 384, 2 heads of 128 over 2 kv heads, vocab 512, 2
layers, linear rope scaling 4) through the forward, ``Engine.generate`` and
the 64-slot batch; and the TinyLlama-layout Q4_0 file whose
``output.weight`` is Q6_K.

Tolerances: matmul outputs are f32 sums of the same exact products in
another order, within 2e-4 of the largest output.  Gate-up outputs are
bf16: g or u may round the other way where their f32 sums straddle a
rounding point, so |port - reference| <= 2^-7 |reference| + 1e-5
max|reference| per element.  Logits at 2^-5 of their largest magnitude
(tests/test_torch_model.py: bf16 intermediates round at other places);
greedy tokens equal up to the first step whose reference top-2 margin is
within that tolerance, which must then be such a near-tie."""

import dataclasses
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
from booster_tpu.models.loader import _stack_qtensors as j_stack  # noqa: E402
from booster_tpu.ops import linear as jlinear  # noqa: E402
from booster_tpu.ops import pallas_attention as pa  # noqa: E402
from booster_tpu.ops import pallas_kv as pk  # noqa: E402
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
from booster_tpu_torch.models.loader import _kernel_layout, _stack_qtensors  # noqa: E402
from booster_tpu_torch.ops import mlp as tm_mlp  # noqa: E402
from booster_tpu_torch.ops import qmm as tq  # noqa: E402
from booster_tpu_torch.ops.kv_cache import KVCache  # noqa: E402
from booster_tpu_torch.quant import dequantize as tdequantize  # noqa: E402
from booster_tpu_torch.quant import qtensor as tqt  # noqa: E402
from booster_tpu_torch.quant import quantize as tquantize  # noqa: E402
from booster_tpu_torch.sampling import SamplingParams  # noqa: E402
from booster_tpu_torch.serving import Engine  # noqa: E402
from booster_tpu_torch.testing import make_model, random_blocks  # noqa: E402
from booster_tpu_torch.testing import torch_threads  # noqa: E402

QMM_TOL = 2e-4
LOGIT_TOL = 2 ** -5
MAX_SEQ = 128
C, FF, L = 256, 384, 2  # the small model's hidden width, ff and layers
PROMPT = "hello world the and of to in"
assert JT.Q6_K == TT.Q6_K and JT.Q8_0 == TT.Q8_0


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


@pytest.fixture
def pallas():
    jlinear.set_use_pallas(True)
    pq.INTERPRET = pa.INTERPRET = pk.INTERPRET = True
    try:
        yield
    finally:
        jlinear.set_use_pallas(None)
        pq.INTERPRET = pa.INTERPRET = pk.INTERPRET = False
        jax.clear_caches()


def _close(got, want, tol):
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _close_bf16(got, want):
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-5 * np.abs(want).max())


def _x(m, k=C, seed=5):
    x = np.random.default_rng(seed + m).standard_normal((m, k)).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _layer(w, i):
    return dataclasses.replace(w, layer=jnp.int32(i))


# -- the format and the repack -----------------------------------------------


@pytest.mark.parametrize("rows,cols,scale", [(64, 512, 0.05), (3, 1024, 3.0)])
def test_q6_k_format_bit_equal(rows, cols, scale):
    x = np.random.default_rng(rows).standard_normal((rows, cols)).astype(np.float32) * scale
    x[0] = 0.0  # an all-zero row: d = 0
    x[1, :16] = 0.0  # an all-zero group
    raw = jquantize(x, JT.Q6_K)
    assert tquantize(x, TT.Q6_K) == raw
    assert np.array_equal(tdequantize(raw, TT.Q6_K, shape=(rows, cols)),
                          jdequantize(raw, JT.Q6_K, shape=(rows, cols)))


@pytest.mark.parametrize("on_torch", [False, True])
def test_q6_k_repack_bit_equal(on_torch):
    """The torch repack, on numpy bytes (the host) or on a torch tensor (the
    path of a repack on the card), against ``_repack_q6_k``; then the
    kernels' layout (prepared, K-major, bf16 planes) against the
    reference's."""
    n, k = 128, 512
    raw = jquantize(np.random.default_rng(1).standard_normal((n, k)).astype(np.float32) * 0.1,
                    JT.Q6_K)
    j = jrepack(raw, JT.Q6_K, (n, k))
    src = torch.frombuffer(bytearray(raw), dtype=torch.uint8) if on_torch else raw
    t = tqt.repack_gguf_tensor(src, TT.Q6_K, (n, k), device="cpu" if on_torch else None)
    assert (t.kind, t.group, j.kind, j.group) == ("i8", 16, "i8", 16)
    tq_, ts = (t.qw.numpy(), t.scales.numpy()) if on_torch else (t.qw, t.scales)
    assert np.array_equal(tq_, np.asarray(j.qw)) and ts.dtype == np.float32
    assert np.array_equal(ts, np.asarray(j.scales))
    jk = jqt.compact_scales(jqt.transpose_qtensor(jqt.prepare_kernel_scales(j)))
    tk = _kernel_layout(t if on_torch else tqt.to_torch(t, "cpu"))
    assert tk.kind == jk.kind == "i8t" and np.array_equal(tk.qw.numpy(), np.asarray(jk.qw))
    assert np.array_equal(tk.scales.view(torch.int16).numpy(),
                          np.asarray(jk.scales).view(np.int16))
    # the dequantized weight at group 16, from either storage form
    want = jqt.dequantize_qtensor_np(j)
    assert np.array_equal(tqt.dequantize(tqt.to_torch(t, "cpu"), torch.float32).numpy(), want)


# -- the i8t kernels' plain versions at group 16 -----------------------------


def _g16_pair(n, k, seed=0):
    """The same stacked Q6_K weights [L, n, k] through both packages' load
    pipelines (i8 g16 → prepared scales → stack → i8t with bf16 planes)."""
    rng = np.random.default_rng(seed)
    raws = [jquantize(rng.standard_normal((n, k)).astype(np.float32) * 0.3, JT.Q6_K)
            for _ in range(L)]
    j = jqt.compact_scales(jqt.transpose_qtensor(jqt.prepare_kernel_scales(
        j_stack([jqt.prepare_kernel_scales(jrepack(r, JT.Q6_K, (n, k))) for r in raws]))))
    t = _kernel_layout(_stack_qtensors([tqt.repack_gguf_tensor(r, TT.Q6_K, (n, k))
                                        for r in raws]))
    assert t.kind == j.kind == "i8t" and t.group == j.group == 16
    return jax.tree.map(jnp.asarray, j), tqt.to_torch(t, "cpu")


@pytest.mark.parametrize("m", [1, 8])
def test_qmm_g16_matches_pallas(m, interpret):
    jw, tw = _g16_pair(3 * C, C)
    xj, xt = _x(m)
    assert tq._supported_t(tw.at(1), C, m)
    for layer in (0, 1):
        want = np.asarray(pq.qmm(xj, _layer(jw, layer)))
        got = tq.qmm(xt, tw.at(layer)).numpy()
        assert got.dtype == np.float32 and got.shape == (m, 3 * C)
        _close(got, want, QMM_TOL)


@pytest.fixture
def gd_spy(monkeypatch):
    """Counts the reference's traces of _gateup_i8_gd_kernel."""
    calls = []
    orig = pq._gateup_i8_gd_kernel

    def spy(*a, **kw):
        calls.append(kw.get("group"))
        return orig(*a, **kw)

    monkeypatch.setattr(pq, "_gateup_i8_gd_kernel", spy)
    return calls


def test_gateup_one_row_matches_pallas_and_unfused(interpret, gd_spy):
    jw, tw = _g16_pair(2 * FF, C, seed=3)
    xj, xt = _x(1, seed=11)
    want = pq.qmm_gateup(xj, _layer(jw, 1), "silu")
    assert want is not None and gd_spy == [16], "the reference's M = 1 gate-up did not run"
    got = tq.qmm_gateup(xt, tw.at(1))
    assert got is not None and got.dtype == torch.bfloat16 and got.shape == (1, FF)
    _close_bf16(got.float().numpy(), np.asarray(want, np.float32))
    gu = tq.qmm(xt, tw.at(1)).to(torch.bfloat16)  # the unfused group-dot matvec
    assert torch.equal(got, tq.silu(gu[:, :FF]) * gu[:, FF:])
    assert torch.equal(tq.qmm_i8t_gateup(xt, tw.at(1)), got)


def _mins_pair(n, k, group, seed=0):
    """A 2-D i8t weight with a mins plane (the form of Q5_K), made from the
    same random codes, scales and mins through both packages."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 32, (n, k)).astype(np.int8)
    s = (rng.random((n, k // group)) * 0.02 + 1e-3).astype(np.float32)
    mn = (rng.random((n, k // group)) * 0.2).astype(np.float32)
    j = jqt.compact_scales(jqt.transpose_qtensor(jqt.prepare_kernel_scales(
        jqt.QTensor("i8", q, s, mn, group, (n, k), JT.Q5_K))))
    t = tqt.compact_scales(tqt.transpose_qtensor(tqt.prepare_kernel_scales(tqt.QTensor(
        "i8", torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(mn), group, (n, k),
        TT.Q5_K))))
    assert t.scales.shape == (2, k // group, n)
    assert np.array_equal(t.scales.view(torch.int16).numpy(), np.asarray(j.scales).view(np.int16))
    return jax.tree.map(jnp.asarray, j), t


@pytest.mark.parametrize("group", [16, 32])
def test_one_row_forms_with_mins_match_pallas(group, interpret, gd_spy):
    """The M = 1 matvec and fused gate-up with a mins plane (c = s·p - m·xs
    per group), which no file of the port has yet: the forms the kernel
    takes with synthetic planes."""
    jw, tw = _mins_pair(2 * FF, 2 * C, group, seed=group)
    xj, xt = _x(1, k=2 * C, seed=21)
    _close(tq.qmm(xt, tw).numpy(), np.asarray(pq.qmm(xj, jw)), QMM_TOL)
    want = pq.qmm_gateup(xj, jw, "silu")
    assert want is not None and gd_spy == [group]
    got = tq.qmm_gateup(xt, tw)
    _close_bf16(got.float().numpy(), np.asarray(want, np.float32))
    gu = tq.qmm(xt, tw).to(torch.bfloat16)
    assert torch.equal(got, tq.silu(gu[:, :FF]) * gu[:, FF:])
    # the mins move the output: a check that ignored them would see it
    no_mins = dataclasses.replace(tw, scales=tw.scales[:1].contiguous())
    assert (tq.qmm(xt, no_mins) - tq.qmm(xt, tw)).abs().max() > 8 * QMM_TOL * got.float().abs().max()


@pytest.mark.parametrize("m", [1, 2, 8])
def test_lane_major_down_matches_pallas(m, interpret):
    """w_down as the Q6_K file's Q8_0 fallback leaves it: lane-major i8 at
    group 32 ((ff/G) % 8 != 0 keeps it from the K-major kernels).  The
    port's row at any M equals the reference's rows at M > 1 within 2e-4;
    the reference's own M = 1 row sits further off its M = 2 row (the
    deviation recorded in ROADMAP.md), so decode is compared with the
    reference's M = 2 form of the same row."""
    raw = jquantize(np.random.default_rng(9).standard_normal((C, FF)).astype(np.float32) * 0.3,
                    JT.Q8_0)
    jw = jax.tree.map(jnp.asarray, jqt.prepare_kernel_scales(jrepack(raw, JT.Q8_0, (C, FF))))
    t = tqt.to_torch(_kernel_layout(tqt.repack_gguf_tensor(raw, TT.Q8_0, (C, FF))), "cpu")
    assert t.kind == "i8" and not tq.transposable(t) and tq.lane_supported(t)
    assert t.scales.dtype == torch.bfloat16
    xj, xt = _x(max(m, 2), k=FF, seed=31)
    ref = np.asarray(pq.qmm(xj, jw))[:m]  # the reference at M >= 2
    got = tq.qmm(xt[:m], t).numpy()
    _close(got, ref, QMM_TOL)
    if m == 1:
        one = np.asarray(pq.qmm(xj[:1], jw))
        dev = float(np.abs(one - ref).max() / np.abs(ref).max())
        assert dev <= 2 ** -7, dev  # the reference's M = 1 row: within bf16 rounding


# -- the model ----------------------------------------------------------------


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    return make_model(str(tmp_path_factory.mktemp("q6k") / "t.gguf"), vocab_size=512,
                      hidden=C, layers=L, heads=2, kv_heads=2, ff=FF, quant=TT.Q6_K,
                      weight_scale=0.3, rope_base=100000.0, rope_scaling=("linear", 4.0),
                      rms_eps=1e-6)


@pytest.fixture(scope="module")
def models(gguf):
    jm = j_load(gguf, weights="native")
    tm = load_model(gguf, device="cpu", weights="native")
    return jm, tm


def test_file_mixes_q6_k_with_q8_0_down(gguf):
    reader = GGUFReader(gguf)
    try:
        types = {name: info.ggml_type for name, info in reader.tensors.items()
                 if len(info.shape) == 2}
        meta = reader.metadata
    finally:
        reader.close()
    assert {t for n, t in types.items() if "ffn_down" in n} == {TT.Q8_0}
    assert {t for n, t in types.items() if "ffn_down" not in n} == {TT.Q6_K}
    assert meta["llama.rope.scaling.type"] == "linear"
    assert meta["llama.rope.scaling.factor"] == 4.0


def test_loader_kinds_equal_reference(models):
    """The reference's choices (loader + transposable): wqkv, wo, w_gateup
    and the head K-major i8t at group 16; w_down lane-major i8 at group 32
    with bf16 planes for the lane-major kernel; payloads and planes bit for
    bit; the token embedding and the linear rope scaling as the reference
    loads them."""
    jm, tm = models
    carried = params_from_numpy(jax.tree.map(np.asarray, jm.params), tm.cfg, device="cpu")
    want = {"wqkv": ("i8t", 16), "wo": ("i8t", 16), "w_gateup": ("i8t", 16), "w_down": ("i8", 32)}
    for key, (kind, group) in want.items():
        j, a, b = jm.params["layers"][key], carried["layers"][key], tm.params["layers"][key]
        assert (j.kind, j.group) == (b.kind, b.group) == (kind, group), key
        assert torch.equal(a.qw, b.qw), key
        assert torch.equal(a.scales.view(torch.int16), b.scales.view(torch.int16)), key
    assert (tm.params["output"].kind, tm.params["output"].group) == ("i8t", 16)
    assert jm.params["output"].kind == "i8t"
    assert torch.equal(carried["tok_embd"].view(torch.int16), tm.params["tok_embd"].view(torch.int16))
    assert (tm.cfg.rope_scaling, tm.cfg.rope_scale, tm.cfg.rms_eps) == ("linear", 4.0,
                                                                        jm.cfg.rms_eps)
    assert np.array_equal(tm.params["rope"]["inv_freq"],
                          np.asarray(jm.params["rope"]["inv_freq"]))
    assert tm.params["rope"]["mscale"] == float(jm.params["rope"]["mscale"]) == 1.0


def test_mlp_dispatch_at_one_row_equals_reference(models, interpret):
    """At M = 1 the whole-MLP kernel declines a G16 gate-up with a G32
    lane-major down (pallas_qmm.py:1320, :1338), and the fused gate-up
    takes it, in both packages."""
    jm, tm = models
    jl, tl = jm.params["layers"], tm.params["layers"]
    xj, xt = _x(1, seed=41)
    jgu, jdn = _layer(jl["w_gateup"], 0), _layer(jl["w_down"], 0)
    assert pq.qmm_mlp(xj, jgu, jdn, "silu") is None
    assert not tm_mlp.mlp_supported(tl["w_gateup"].at(0), tl["w_down"].at(0), C, 1)
    assert tm_mlp.qmm_mlp(xt, tl["w_gateup"].at(0), tl["w_down"].at(0)) is None
    assert pq.qmm_gateup(xj, jgu, "silu") is not None
    assert tq.qmm_gateup(xt, tl["w_gateup"].at(0)) is not None


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
    assert int(tc.lengths[0]) == int(jc.lengths[0]) == n + steps
    return out


def test_prefill_and_decode_logits_match(models, pallas, gd_spy, monkeypatch):
    """Prefill and 6 decode steps; the decode steps run the fused M = 1
    gate-up in both packages (the port's counted through its entry)."""
    jm, tm = models
    rows = []
    orig = tq.qmm_i8t_gateup

    def spy(x, w, *act):
        rows.append(x.shape[0])
        return orig(x, w, *act)

    monkeypatch.setattr(tq, "qmm_i8t_gateup", spy)
    for got, want in _prefill_decode(jm, tm, steps=6):
        _close(got, want, LOGIT_TOL)
    assert gd_spy and set(gd_spy) == {16}
    assert rows.count(1) == 6 * L and rows.count(32) == L


def _greedy_equal_or_near_tie(jm, tm, got: list, want: list):
    """Greedy tokens equal up to the first step whose reference top-2 margin
    is within the logit tolerance; that step must be such a near-tie."""
    assert len(got) == len(want)
    same = [a == b for a, b in zip(got, want)]
    if all(same):
        return
    i = same.index(False)
    steps = _prefill_decode(jm, tm, steps=i)
    assert [int(np.argmax(w[0, -1])) for _, w in steps] == want[:i + 1]
    ref = steps[i][1][0, -1]
    top2 = np.sort(ref)[-2:]
    assert top2[1] - top2[0] <= LOGIT_TOL * np.abs(ref).max(), (i, top2)


def test_generate_greedy_tokens_equal(models, pallas):
    jm, tm = models
    ids = tm.tokenizer.encode(PROMPT)
    want = JEngine(jm, max_batch=1, max_seq=MAX_SEQ, decode_chunk=4).generate(
        ids, JSP(temp=0.0), max_new_tokens=8)
    got = Engine(tm, max_batch=1, max_seq=MAX_SEQ, decode_chunk=4).generate(
        ids, SamplingParams(temp=0.0), max_new_tokens=8)
    assert len(want.token_ids) == 8
    _greedy_equal_or_near_tie(jm, tm, got.token_ids, want.token_ids)


def _run_batch(eng, sp_cls, tok, slots):
    eng.init_batch_state()
    prompts = {}
    for s in slots:
        eng.reset_slot(s, sp_cls(temp=0.0), seed=s)
        prompts[s] = tok.encode(f"stream {s} benchmark prompt")
    first = eng.prefill_slots(prompts)
    toks, _ = eng.decode_slots(first, n_steps=4)
    return first, toks, np.asarray(eng.cache.lengths).tolist()


def test_batch_64_slots_greedy_tokens_equal(models, pallas):
    """The 64-slot batch over an int8 cache (bench_batch's engine), 8 of the
    slots live with greedy sampling: their first and decoded tokens and the
    cache lengths equal the reference's."""
    jm, tm = models
    slots = list(range(0, 64, 8))
    want = _run_batch(JEngine(jm, max_batch=64, max_seq=MAX_SEQ, kv_quantized=True,
                              decode_chunk=4), JSP, jm.tokenizer, slots)
    got = _run_batch(Engine(tm, max_batch=64, max_seq=MAX_SEQ, kv_quantized=True,
                            decode_chunk=4), SamplingParams, tm.tokenizer, slots)
    assert sorted(got[0]) == slots and all(len(got[1][s]) == 4 for s in slots)
    assert got == want


# -- llama.cpp's Q4_0 layout: output.weight in Q6_K ----------------------------


def test_q4_0_file_with_q6_k_head_matches_reference(tmp_path, pallas):
    """A TinyLlama-layout Q4_0 file whose output.weight is Q6_K, as llama.cpp
    writes every Q4_0 file: both packages load it (the head K-major i8t at
    group 16 beside i4t layers) and give the same greedy tokens."""
    path = make_model(str(tmp_path / "q4.gguf"), vocab_size=512, hidden=256, layers=2, heads=2,
                      kv_heads=2, ff=512, quant=TT.Q4_0, output_quant=TT.Q6_K,
                      weight_scale=0.3)
    reader = GGUFReader(path)
    try:
        assert reader.tensors["output.weight"].ggml_type == TT.Q6_K
        assert reader.tensors["blk.0.ffn_down.weight"].ggml_type == TT.Q4_0
    finally:
        reader.close()
    jm = j_load(path, weights="native")
    tm = load_model(path, device="cpu", weights="native")
    assert (tm.params["output"].kind, tm.params["output"].group) == ("i8t", 16)
    assert jm.params["output"].kind == "i8t"
    for key in ("wqkv", "wo", "w_gateup", "w_down"):  # i4t, and i4p where not transposable
        assert tm.params["layers"][key].kind == jm.params["layers"][key].kind, key
    ids = tm.tokenizer.encode(PROMPT)
    want = JEngine(jm, max_batch=1, max_seq=MAX_SEQ, decode_chunk=4).generate(
        ids, JSP(temp=0.0), max_new_tokens=6)
    got = Engine(tm, max_batch=1, max_seq=MAX_SEQ, decode_chunk=4).generate(
        ids, SamplingParams(temp=0.0), max_new_tokens=6)
    assert len(want.token_ids) == 6
    _greedy_equal_or_near_tie(jm, tm, got.token_ids, want.token_ids)


def test_make_model_keeps_f32_fallback_for_other_types(tmp_path):
    """Only Q6_K falls back to Q8_0: a Q4_0 file's rows that are not a
    multiple of 256 stay F32, as tools/make_test_model.py writes them."""
    path = make_model(str(tmp_path / "q4.gguf"), vocab_size=512, hidden=256, layers=1, heads=2,
                      kv_heads=2, ff=384, quant=TT.Q4_0)
    reader = GGUFReader(path)
    try:
        assert reader.tensors["blk.0.ffn_down.weight"].ggml_type == TT.F32
        assert reader.tensors["blk.0.ffn_gate.weight"].ggml_type == TT.Q4_0
    finally:
        reader.close()


def test_random_q6_k_blocks_decode_to_the_weight_scale():
    """draw="blocks" (the full-size smoke file's draws): random Q6_K blocks
    decode to finite values whose spread is that of the weight scale."""
    raw = bytes(random_blocks(np.random.default_rng(0), 256 * 512, TT.Q6_K, 0.05))
    w = tdequantize(raw, TT.Q6_K)
    assert w.shape == (256 * 512,) and np.isfinite(w).all()
    assert 0.02 < float(w.std()) < 0.08
    assert np.array_equal(w, jdequantize(raw, JT.Q6_K))
