"""Gemma's int8-weight paths and its paged server against the JAX package on
the CPU, the reference's Pallas kernels in interpret mode.

The whole MLP with the tanh-GELU (``ops.mlp.qmm_mlp(..., "gelu")``, the
plain version of ``csrc/mlp_i8t.cu``) against the reference's ``qmm_mlp(...,
act="gelu")`` (``_mlp_i8_kernel``) at group 32 (Q8_0 blocks), at group 32
with mins planes (Q5_K blocks) and at group 16 (Q6_K blocks), M = 2, 16 and
64 (the reference's interpret-mode M = 1 rows sit off its M > 1 rows, as
tests/test_torch_q5k.py found), and equal to its unfused sequence bit for
bit.  A 2-layer Gemma-shaped GGUF (hidden 512, 2 heads of 256 over 1 kv
head, ff 512, vocab 512, a Q6_K token table and no ``output.weight``) in
llama.cpp's Q4_0 mix loaded with ``weights="i8"`` (the nibbles widened to
i8t at group 32) and in a uniform Q6_K (i8t at group 16): the loaders'
kinds, the logits at prefill and decode over a bf16 and an int8 cache (the
whole MLP at every M, counted), greedy tokens through ``generate`` and a
4-stream batch.  The paged decode attention and the paged all-layer append
at 256 lanes against the reference's merged paged kernel and
``kv_append_all_layers_paged``, and the paged engine, under the scheduler
and the HTTP server too, on a Gemma model.  (Hidden 512: the reference's
MLP gate wants 16 groups of K at group 32.)

Tolerances: the MLP's bf16 outputs 2^-7 of the largest (f32 sums in another
order; a mid element rounded the other way moves an output by up to 2^-8 of
its product); attention ``testing.paged_attn_limit``; the appends bit for
bit off the scratch page 0; logits 2^-5 of the largest; greedy tokens equal
up to a reference near-tie (tests/test_torch_gemma.py's rule)."""

import json
import sys
from http.client import HTTPConnection

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, ".")

from booster_tpu.gguf import GGMLType as JT  # noqa: E402
from booster_tpu.models import load_model as j_load  # noqa: E402
from booster_tpu.models.llama import forward as j_forward  # noqa: E402
from booster_tpu.ops import kv_cache as jkv  # noqa: E402
from booster_tpu.ops import linear as jlinear  # noqa: E402
from booster_tpu.ops import pallas_attention as pa  # noqa: E402
from booster_tpu.ops import pallas_kv as pk  # noqa: E402
from booster_tpu.ops import pallas_paged_attention as ppa  # noqa: E402
from booster_tpu.ops import pallas_qmm as pq  # noqa: E402
from booster_tpu.ops.kv_cache import KVCache as JCache  # noqa: E402
from booster_tpu.quant import qtensor as jqt  # noqa: E402
from booster_tpu.quant import repack_gguf_tensor as jrepack  # noqa: E402
from booster_tpu.sampling import SamplingParams as JSP  # noqa: E402
from booster_tpu.serving import Engine as JEngine  # noqa: E402
from booster_tpu_torch.gguf import GGMLType as TT  # noqa: E402
from booster_tpu_torch.models import load_model  # noqa: E402
from booster_tpu_torch.models.llama import forward  # noqa: E402
from booster_tpu_torch.models import llama as tllama  # noqa: E402
from booster_tpu_torch.ops import kv_append as tka  # noqa: E402
from booster_tpu_torch.ops import mlp as tm  # noqa: E402
from booster_tpu_torch.ops import paged_attention as tpa  # noqa: E402
from booster_tpu_torch.ops import qmm as tq  # noqa: E402
from booster_tpu_torch.ops.kv_cache import KVCache  # noqa: E402
from booster_tpu_torch.quant import qtensor as tqt  # noqa: E402
from booster_tpu_torch.sampling import SamplingParams  # noqa: E402
from booster_tpu_torch.serving import Engine  # noqa: E402
from booster_tpu_torch.testing import (make_model, paged_attn_case, paged_attn_limit,  # noqa: E402
                                       paged_attn_mutants, qmm_i8k_mutants, random_blocks)
from booster_tpu_torch.testing import torch_threads  # noqa: E402

LOGIT_TOL = 2 ** -5
MLP_TOL = 2 ** -7
MAX_SEQ = 256
C, L, H, HKV, D, FF = 512, 2, 2, 1, 256, 512
PROMPT = "hello world and the end"
GEMMA = dict(vocab_size=512, hidden=C, layers=L, heads=H, kv_heads=HKV, head_dim=D, ff=FF,
             arch="gemma", embd_quant=TT.Q6_K, rms_eps=1e-6)
# the whole MLP's forms by the block format that gives them
FORMS = {"g32": "Q8_0", "g32 mins": "Q5_K", "g16": "Q6_K"}
# the models: (file quantization, load_model's weights) → the layer weights' group
MODELS = {"q4_0 i8": (TT.Q4_0, "i8", 32), "q6_k": (TT.Q6_K, "native", 16)}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def pallas():
    """The reference's Pallas path in interpret mode for the whole module."""
    jlinear.set_use_pallas(True)
    pq.INTERPRET = pa.INTERPRET = pk.INTERPRET = ppa.INTERPRET = True
    try:
        yield
    finally:
        jlinear.set_use_pallas(None)
        pq.INTERPRET = pa.INTERPRET = pk.INTERPRET = ppa.INTERPRET = False
        jax.clear_caches()


def _j(t):
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        return jax.lax.bitcast_convert_type(jnp.asarray(t.view(torch.int16).numpy()), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


# -- the whole MLP with GELU -----------------------------------------------------


def _pair(qt: str, n: int, k: int, seed: int):
    """The same random blocks of an [n, k] weight of type `qt` through both
    packages' repacks and K-major layouts (i8t, bf16 planes)."""
    raw = np.frombuffer(random_blocks(np.random.default_rng(seed), n * k, TT[qt], 0.05), np.uint8)
    j = jqt.compact_scales(jqt.transpose_qtensor(jqt.prepare_kernel_scales(
        jrepack(raw, JT[qt], (n, k)))))
    t = tqt.to_torch(tqt.prepare_kernel_scales(tqt.repack_gguf_tensor(raw, TT[qt], (n, k))),
                     "cpu")
    t = tqt.compact_scales(tqt.transpose_qtensor(t))
    assert t.kind == j.kind == "i8t" and t.group == j.group
    return jax.tree.map(jnp.asarray, j), t


@pytest.fixture(scope="module")
def mlp_weights():
    return {form: (_pair(qt, 2 * FF, C, seed=40 + i), _pair(qt, C, FF, seed=50 + i))
            for i, (form, qt) in enumerate(FORMS.items())}


def _x(m: int, k: int, seed: int):
    x = (np.random.default_rng(seed).standard_normal((m, k)) * 2).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("m", [2, 16, 64])
def test_mlp_gelu_matches_pallas(mlp_weights, form, m, pallas):
    """``_mlp_i8_kernel`` with act "gelu" against ``qmm_mlp(..., "gelu")``'s
    plain version, which equals the unfused sequence (the dequantize-form
    matmul on the fused weight, gelu·mul in bf16, the dequantize-form down)
    bit for bit.  The wrong kernels 8x past their limits: the SiLU epilogue
    on mid (the gate-up items' output, per element as the gate-up's limit:
    on the output a SiLU moves the largest element by only ~7 of its
    2^-7), and the tile's wrong gate-up kernels (testing.qmm_i8k_mutants:
    a group 16 read as 32 among them) on the output."""
    (jgu, tgu), (jd, td) = mlp_weights[form]
    assert (tgu.group, tgu.scales.shape[0]) == ((16, 1) if form == "g16"
                                                else (32, 2 if "mins" in form else 1))
    xj, xt = _x(m, C, seed=m)
    assert tm.mlp_supported(tgu, td, C, m)
    want = pq.qmm_mlp(xj, jgu, jd, "gelu")
    assert want is not None, "the Pallas MLP kernel refused the shape; test is vacuous"
    got = tm.qmm_mlp(xt, tgu, td, "gelu")
    assert got is not None and got.dtype == torch.bfloat16 and got.shape == (m, C)
    _close(got.float().numpy(), np.asarray(want, np.float32), MLP_TOL)
    g = tq.qmm_plain(xt, tgu, dq=True).to(torch.bfloat16)
    mid = tq.gelu(g[:, :FF]) * g[:, FF:]
    assert torch.equal(got, tq.qmm_plain(mid, td, dq=True).to(torch.bfloat16))
    assert torch.equal(got, tm.qmm_mlp_i8t(xt, tgu, td, "gelu"))
    mid, silu = mid.float(), tq.qmm_gateup_plain(xt, tgu, dq=True, act="silu").float()
    assert ((silu - mid).abs() / (2 ** -7 * mid.abs() + 1e-5 * mid.abs().max())).max() >= 8
    limit = MLP_TOL * float(got.float().abs().max())
    nst, ks = C // 64, tq.i8k_plan(m, C, 2 * FF)[1]
    mutants = qmm_i8k_mutants(xt, tgu, ((ks - 1) * nst // ks, nst))
    assert ("group 16 scales read as 32" if form == "g16" else "group 32 scales read as 16") \
        in mutants
    for what, (xm, wm) in mutants.items():
        wrong = tm.qmm_mlp_plain(xm, wm, td, "gelu").float()
        assert float((wrong - got.float()).abs().max()) >= 8 * limit, what


def test_relu_and_the_int8_gelu_gate_ups_still_refused(mlp_weights):
    """ReLU in the whole MLP and in the int8 gate-ups raises "not ported
    yet"; GELU in the int8 gate-ups (the shapes the reference's gate-up
    kernels take) runs, and computes GELU (not SiLU) at M = 1 and above."""
    (_, tgu), (_, td) = mlp_weights["g32"]
    _, xt = _x(2, C, seed=0)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tm.qmm_mlp(xt, tgu, td, "relu")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tq.qmm_gateup(xt, tgu, "relu")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tq.qmm_i8t_gateup(xt[:1], tgu, "relu")
    for x, dq in ((xt, True), (xt[:1], False)):
        g = tq.qmm_plain(x, tgu, dq=dq).to(torch.bfloat16)
        ff = g.shape[-1] // 2
        got = tq.qmm_i8t_gateup(x, tgu, "gelu")
        assert torch.equal(got, tq.gelu(g[:, :ff]) * g[:, ff:])
        assert torch.equal(tq.qmm_gateup(x, tgu, "gelu"), got)
        assert not torch.equal(got, tq.silu(g[:, :ff]) * g[:, ff:])


# -- the models ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("gemma_i8")
    return {name: make_model(str(d / f"gemma_{qt.name}.gguf"), quant=qt, **GEMMA)
            for name, (qt, _, _) in MODELS.items()}


@pytest.fixture(scope="module")
def all_models(ggufs):
    return {name: (j_load(ggufs[name], weights=w), load_model(ggufs[name], device="cpu",
                                                               weights=w))
            for name, (_, w, _) in MODELS.items()}


@pytest.mark.parametrize("name", list(MODELS))
def test_loader_kinds_equal_reference(all_models, name):
    """Every layer weight K-major i8t at the file's group in both packages
    (Q4_0 widened exactly by weights="i8"; Q6_K at group 16), the Q6_K
    token table the tied bf16 head, bit-equal to the reference's."""
    jm, tm_ = all_models[name]
    G = MODELS[name][2]
    got = {k: (v.kind, v.group) for k, v in tm_.params["layers"].items() if hasattr(v, "kind")}
    want = {k: (v.kind, v.group) for k, v in jm.params["layers"].items() if hasattr(v, "kind")}
    assert got == want == dict.fromkeys(("wqkv", "wo", "w_gateup", "w_down"), ("i8t", G))
    assert tm_.params["output"] is None and tm_.cfg.tie_embeddings and tm_.cfg.act == "gelu"
    assert np.array_equal(tm_.params["tok_embd"].view(torch.int16).numpy(),
                          np.asarray(jm.params["tok_embd"]).view(np.int16))
    for key in ("w_gateup", "w_down"):
        assert np.array_equal(tm_.params["layers"][key].qw.numpy(),
                              np.asarray(jm.params["layers"][key].qw))


def _prefill_decode(jm, tm_, steps, quantized):
    """Prefill of the prompt (a 16-row bucket) then `steps` T = 1 steps fed
    the reference's greedy token, both packages: [(port logits, reference
    logits)] of the live slot."""
    cfg = tm_.cfg
    ids = tm_.tokenizer.encode(PROMPT)
    n, T, B = len(ids), 16, 2
    arr = np.zeros((B, T), np.int32)
    arr[0, :n] = ids
    nv = np.zeros(B, np.int32)
    nv[0] = n
    g = np.maximum(nv - 1, 0)
    jc = JCache.create(L, B, MAX_SEQ, HKV, D, quantized=quantized)
    jl, jc = j_forward(jm.params, jm.cfg, jnp.asarray(arr), jc, gather_idx=jnp.asarray(g),
                       n_valid=jnp.asarray(nv))
    tc = KVCache.create(L, B, MAX_SEQ, HKV, D, "cpu", quantized=quantized)
    tl, tc = forward(tm_.params, cfg, torch.from_numpy(arr), tc, gather_idx=torch.from_numpy(g),
                     n_valid=torch.from_numpy(nv))
    out = [(tl.numpy()[:1], np.asarray(jl)[:1])]
    step = (nv > 0).astype(np.int32)
    for _ in range(steps):
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        jl, jc = j_forward(jm.params, jm.cfg, jnp.asarray(nxt), jc, last_only=True,
                           n_valid=jnp.asarray(step))
        tl, tc = forward(tm_.params, cfg, torch.from_numpy(nxt), tc, last_only=True,
                         n_valid=torch.from_numpy(step))
        out.append((tl.numpy()[:1], np.asarray(jl)[:1]))
    assert int(tc.lengths[0]) == int(jc.lengths[0]) == n + steps
    return out


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_prefill_and_decode_logits_match(all_models, pallas, monkeypatch, name, quantized):
    """Prefill and a decode step, prefill against prefill, decode against
    decode; every MLP of the port's run takes the whole-MLP kernel's plain
    version with GELU (M = 32 at the prefill, 2 at the step)."""
    jm, tm_ = all_models[name]
    calls = []
    orig = tm.qmm_mlp_i8t
    monkeypatch.setattr(tm, "qmm_mlp_i8t",
                        lambda x, gu, dn, act="silu": calls.append((x.shape[0], act))
                        or orig(x, gu, dn, act))
    for got, want in _prefill_decode(jm, tm_, steps=1, quantized=quantized):
        _close(got, want, LOGIT_TOL)
    assert calls == [(32, "gelu")] * L + [(2, "gelu")] * L


def _greedy_equal_or_near_tie(got: list, want: list, ref_logits):
    assert len(got) == len(want)
    same = [a == b for a, b in zip(got, want)]
    if all(same):
        return
    i = same.index(False)
    ref = ref_logits(i)
    assert int(np.argmax(ref)) == want[i]
    top2 = np.sort(ref)[-2:]
    assert top2[1] - top2[0] <= LOGIT_TOL * np.abs(ref).max(), (i, top2)


@pytest.mark.parametrize("name", list(MODELS))
def test_generate_greedy_tokens_equal(all_models, pallas, name):
    jm, tm_ = all_models[name]
    ids = tm_.tokenizer.encode(PROMPT)
    want = JEngine(jm, max_batch=1, max_seq=MAX_SEQ, decode_chunk=4).generate(
        ids, JSP(temp=0.0), max_new_tokens=4)
    got = Engine(tm_, max_batch=1, max_seq=MAX_SEQ, decode_chunk=4).generate(
        ids, SamplingParams(temp=0.0), max_new_tokens=4)
    assert len(want.token_ids) == 4
    _greedy_equal_or_near_tie(got.token_ids, want.token_ids,
                              lambda i: _prefill_decode(jm, tm_, i, False)[i][1][0, -1])


def _run_batch(eng, sp_cls, tok, slots, steps):
    eng.init_batch_state()
    prompts = {}
    for s in slots:
        eng.reset_slot(s, sp_cls(temp=0.0), seed=s)
        prompts[s] = tok.encode(f"stream {s} the end")
    first = eng.prefill_slots(prompts)
    toks, _ = eng.decode_slots(first, n_steps=steps)
    return first, toks, np.asarray(eng.cache.lengths).tolist()


@pytest.mark.parametrize("name", list(MODELS))
def test_batch_4_streams_greedy_tokens_equal(all_models, pallas, name):
    """4 streams of the batched slot API over an int8 cache: each stream's
    tokens equal the reference's, the cache lengths too."""
    jm, tm_ = all_models[name]
    slots = [0, 1, 2, 3]
    jfirst, jtoks, jlen = _run_batch(
        JEngine(jm, max_batch=4, max_seq=MAX_SEQ, kv_quantized=True, decode_chunk=2), JSP,
        jm.tokenizer, slots, 2)
    first, toks, lengths = _run_batch(
        Engine(tm_, max_batch=4, max_seq=MAX_SEQ, kv_quantized=True, decode_chunk=2),
        SamplingParams, tm_.tokenizer, slots, 2)
    assert lengths == jlen
    for s in slots:
        assert [first[s]] + toks[s] == [jfirst[s]] + jtoks[s], s


# -- the paged pool at 256 lanes -------------------------------------------------------

PL, PB, PG, PP, PMAXP = 2, 4, 8, 128, 3
PLENS = [300, 257, 128, 1]  # mid-page (rows 0 and 1 share two pages), a page boundary, one row


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("with_self", [False, True], ids=["no-self", "self"])
def test_paged_attention_256_lanes_matches_pallas(pallas, quantized, with_self):
    """The paged decode attention over a 256-lane pool (one kv head of 8
    query heads, head dim 256, scattered pages, two shared) against the
    reference's merged paged kernel, and its wrong kernels (lanes 128-255
    dropped among them) 8x past the limit."""
    args = paged_attn_case(PL, PB, 1, PG, PP, PMAXP, D, D, PLENS, "cpu", seed=11,
                           quantized=quantized, shared=2)
    q, kc, vc, table, layer, lens, _, _, sk, sv, ok, *scales = args
    ks, vs = scales if scales else (None, None)
    q4 = q.float().reshape(PB, 1, PG, D)  # already scaled (scale 1) and bf16-exact
    self_kv = (sk.float(), sv.float(), ok) if with_self else None
    want = ppa.paged_decode_attention_stacked(
        _j(q4), _j(kc), _j(vc), _j(ks), _j(vs), _j(table), jnp.int32(layer), _j(lens), 1.0,
        self_kv=None if self_kv is None else tuple(map(_j, self_kv)))
    got = tpa.paged_decode_attention_stacked(q4, kc, vc, ks, vs, table, layer, lens, 1.0,
                                             self_kv=self_kv)
    if not with_self:
        args = (*args[:10], torch.zeros_like(ok), *args[11:])
    limit = paged_attn_limit(args)
    err = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert (err <= limit.reshape(PB, 1, PG, D).numpy()).all(), err.max()
    plain = tpa.paged_attn_plain(*args)
    mutants = paged_attn_mutants(args)
    assert "lanes 128-255 dropped" in mutants and len(mutants) == (5 if quantized else 4)
    for what, margs in mutants.items():
        assert ((tpa.paged_attn_plain(*margs) - plain).abs() / limit).max() >= 8, what


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_paged_append_256_lanes_matches_pallas(pallas, quantized):
    """The all-layer append through the page tables into a 256-lane pool
    bit for bit against the reference's kv_append_all_layers_paged on every
    page but the scratch page 0, away from the rows its aligned write window
    clobbers after the offset (never read)."""
    rng = np.random.default_rng(12)
    Np = PB * PMAXP + 1
    table = (1 + rng.permutation(Np - 1)).reshape(PB, PMAXP).astype(np.int32)
    kf = rng.normal(size=(PL, Np, 1, PP, D)).astype(np.float32)
    vf = rng.normal(size=(PL, Np, 1, PP, D)).astype(np.float32)
    new_k = (rng.normal(size=(PL, PB, 1, D)) * 3).astype(np.float32)
    new_v = rng.normal(size=(PL, PB, 1, D)).astype(np.float32)
    new_k[0, 0] = 0  # a zero row
    offs = np.array([0, 7 + PP, 2 * PP + 127, PMAXP * PP + 2], np.int32)  # the last: past it
    if quantized:
        (k, ks), (v, vs) = jkv._quantize_kv(jnp.asarray(kf)), jkv._quantize_kv(jnp.asarray(vf))
    else:
        k, v = jnp.asarray(kf, jnp.bfloat16), jnp.asarray(vf, jnp.bfloat16)
        ks = vs = None
    nk, nv = jnp.asarray(new_k, jnp.bfloat16), jnp.asarray(new_v, jnp.bfloat16)
    want = pk.kv_append_all_layers_paged(k, v, nk, nv, jnp.asarray(offs), jnp.asarray(table),
                                         ks, vs)

    def t(a):
        a = np.array(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        return torch.from_numpy(a)

    got = [None if a is None else t(a) for a in (k, v, ks, vs)]
    tka.kv_append_all_layers_paged(got[0], got[1], t(nk), t(nv), torch.from_numpy(offs),
                                   torch.from_numpy(table), got[2], got[3])
    keep = np.ones((Np, PP), bool)
    keep_s = np.ones((Np, PP), bool)
    keep[0] = keep_s[0] = False
    for b, off in enumerate(offs):
        if off // PP < PMAXP:
            page, o = table[b, off // PP], off % PP
            keep[page, o + 1:(o // 8 + 1) * 8] = False
            keep_s[page, o + 1:(o // 128 + 1) * 128] = False
    for g, w, m in zip(got, want, (keep, keep, keep_s, keep_s)):
        if w is None:
            continue
        g = g.float().numpy() if g.dtype == torch.bfloat16 else g.numpy()
        w = np.asarray(w, g.dtype).reshape(g.shape)
        g, w = g.swapaxes(1, 2), w.swapaxes(1, 2)  # [L, Hkv, Np, P, D]
        np.testing.assert_array_equal(g[:, :, m], w[:, :, m])


def _slot_tokens(eng, sp, tok, n_steps=4):
    eng.init_batch_state()
    prompts = {s: tok.encode(t) for s, t in enumerate(["hello world", "one two three the end"])}
    for s in prompts:
        eng.reset_slot(s, sp, seed=s)
    first = eng.prefill_slots(prompts)
    toks, _ = eng.decode_slots(first, n_steps=n_steps)
    return {s: [first[s]] + toks[s] for s in prompts}


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_paged_engine_matches_reference(all_models, pallas, monkeypatch, quantized):
    """Engine(paged=True) on the Gemma model with int8 weights (pages of 128
    rows: the stacked paged path, the paged attention and append at 256
    lanes, counted) gives the reference's paged engine's greedy tokens."""
    jm, tm_ = all_models["q4_0 i8"]
    kw = dict(max_batch=2, max_seq=MAX_SEQ, kv_quantized=quantized, paged=True, page_size=128)
    want = _slot_tokens(JEngine(jm, **kw), JSP(temp=0.0, penalty_repeat=1.0), jm.tokenizer)
    calls = []
    orig = (tpa.paged_attn, tllama.kv_append_all_layers_paged)
    monkeypatch.setattr(tpa, "paged_attn",
                        lambda *a, **k: calls.append(a[1].shape[-1]) or orig[0](*a, **k))
    monkeypatch.setattr(tllama, "kv_append_all_layers_paged",
                        lambda *a, **k: calls.append(-a[0].shape[-1]) or orig[1](*a, **k))
    got = _slot_tokens(Engine(tm_, **kw), SamplingParams(temp=0.0, penalty_repeat=1.0),
                       tm_.tokenizer)
    assert got == want
    assert set(calls) == {D, -D} and calls.count(D) == L * calls.count(-D) > 0


def test_paged_server_answers_a_chat_completion(all_models):
    """A paged int8 engine on the Gemma model under the scheduler and the
    HTTP server (ServerThread) answers one chat completion."""
    from booster_tpu_torch.serving.config import PromptSpec
    from booster_tpu_torch.serving.scheduler import Scheduler
    from booster_tpu_torch.serving.server import ServerThread

    _, tm_ = all_models["q4_0 i8"]
    eng = Engine(tm_, max_batch=2, max_seq=MAX_SEQ, kv_quantized=True, paged=True,
                 page_size=128, decode_chunk=4)
    sched = Scheduler(eng, prompt_spec=PromptSpec(id="default"),
                      default_sampling=SamplingParams(temp=0.0), default_max_tokens=6)
    srv = ServerThread(sched, model_name="gemma")
    try:
        conn = HTTPConnection("127.0.0.1", srv.port, timeout=120)
        conn.request("POST", "/v1/chat/completions", body=json.dumps(
            {"messages": [{"role": "user", "content": "hello"}], "max_tokens": 6}))
        r = conn.getresponse()
        body = json.loads(r.read())
        conn.close()
    finally:
        srv.stop()
    assert r.status == 200 and body["object"] == "chat.completion"
    assert 1 <= body["usage"]["completion_tokens"] <= 6
    assert eng.cache.k.shape[-1] == D and eng.paged
