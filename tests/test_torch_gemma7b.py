"""Gemma-7B's int8 paths against the JAX package on the CPU, the reference's
Pallas kernels in interpret mode.

The int8 fused gate-up with the tanh-GELU (``ops.qmm.qmm_i8t_gateup(...,
"gelu")``, the plain version of ``csrc/qmm_i8t_gelu.cu``'s forms) against
the reference's ``qmm_gateup(..., "gelu")`` (``_gateup_i8_kernel`` above M =
1, ``_gateup_i8_gd_kernel`` at M = 1) at group 32 (Q8_0 blocks), at group 32
with mins planes (Q5_K) and at group 16 (Q6_K), and equal to its unfused
sequence bit for bit.  The whole MLP's gate (``ops.mlp.mlp_fits``, the
reference's ``_pick_bf_mlp``) at Gemma-7B's widths (K = C = 3072, ff 24576):
it declines from M = 142 (132 with mins planes), where the reference runs
the gate-up with GELU.  Two narrow Gemma-shaped files whose ``ffn_down``
has another group than their gate/up in every layer (Q8_0 or Q5_K gate/up
beside a Q6_K down: the whole MLP declines at every M, so the gate-up with
GELU runs at M = 1 and above), and a narrow multi-head Gemma (4 heads of
256 over 4 kv heads: G = 1 at 256 lanes, Gemma-7B's layout) in Q4_0 with
``weights="i8"``: logits at prefill and decode, greedy tokens through
``generate`` and a 4-stream batch, and ``params_from_numpy``.  A file whose
``ffn_down`` is Q6_K in one layer and Q5_K in the next (llama.cpp's
Q5_K_M arrangement) is refused by both loaders.

Tolerances: the gate-up's bf16 outputs 2^-7 of the largest (f32 sums in
another order round g or u the other way); logits 2^-5 of the largest;
greedy tokens equal up to a reference near-tie (tests/test_torch_gemma.py's
rule)."""

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
from booster_tpu.ops import pallas_qmm as pq  # noqa: E402
from booster_tpu.ops.kv_cache import KVCache as JCache  # noqa: E402
from booster_tpu.quant import qtensor as jqt  # noqa: E402
from booster_tpu.quant import repack_gguf_tensor as jrepack  # noqa: E402
from booster_tpu.sampling import SamplingParams as JSP  # noqa: E402
from booster_tpu.serving import Engine as JEngine  # noqa: E402
from booster_tpu_torch.gguf import GGMLType as TT  # noqa: E402
from booster_tpu_torch.models import load_model, params_from_numpy  # noqa: E402
from booster_tpu_torch.models.llama import forward  # noqa: E402
from booster_tpu_torch.ops import mlp as tm  # noqa: E402
from booster_tpu_torch.ops import qmm as tq  # noqa: E402
from booster_tpu_torch.ops.kv_cache import KVCache  # noqa: E402
from booster_tpu_torch.quant import qtensor as tqt  # noqa: E402
from booster_tpu_torch.sampling import SamplingParams  # noqa: E402
from booster_tpu_torch.serving import Engine  # noqa: E402
from booster_tpu_torch.testing import make_model, random_blocks, torch_threads  # noqa: E402

LOGIT_TOL = 2 ** -5
GATEUP_TOL = 2 ** -7
MAX_SEQ = 256
PROMPT = "hello world and the end"
# the gate-up's forms by the block format that gives them; K and ff of its weight
FORMS = {"g32": "Q8_0", "g32 mins": "Q5_K", "g16": "Q6_K"}
K, FF = 512, 256
# Gemma-7B's widths (the public google/gemma-7b config.json): hidden, ff
C7, FF7 = 3072, 24576
# the narrow files: 4 heads of 256 over 4 kv heads (G = 1 at 256 lanes, as
# Gemma-7B), hidden 512, ff 512, vocab 512, a Q6_K token table, 2 layers
C, L, H, HKV, D, FFN = 512, 2, 4, 4, 256, 512
GEMMA = dict(vocab_size=512, hidden=C, layers=L, heads=H, kv_heads=HKV, head_dim=D, ff=FFN,
             arch="gemma", embd_quant=TT.Q6_K, rms_eps=1e-6)
# name → (file quantization, tensor_quant, load_model's weights, w_gateup's
# (group, scale planes), w_down's group): the down of another group than
# the gate-up (the whole MLP declines) or the Q4_0 file widened to int8 (the
# whole MLP takes every M)
MODELS = {"q8_0 + q6_k down": (TT.Q8_0, {"ffn_down.weight": TT.Q6_K}, "native", (32, 1), 16),
          "q5_k + q6_k down": (TT.Q5_K, {"ffn_down.weight": TT.Q6_K}, "native", (32, 2), 16),
          "q4_0 i8": (TT.Q4_0, None, "i8", (32, 1), 32)}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def pallas():
    """The reference's Pallas path in interpret mode for the whole module."""
    jlinear.set_use_pallas(True)
    pq.INTERPRET = pa.INTERPRET = pk.INTERPRET = True
    try:
        yield
    finally:
        jlinear.set_use_pallas(None)
        pq.INTERPRET = pa.INTERPRET = pk.INTERPRET = False
        jax.clear_caches()


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


# -- the int8 gate-up with GELU ------------------------------------------------------


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
def gateup_weights():
    return {form: _pair(qt, 2 * FF, K, seed=70 + i) for i, (form, qt) in enumerate(FORMS.items())}


def _x(m: int, k: int, seed: int):
    x = (np.random.default_rng(seed).standard_normal((m, k)) * 2).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("form,m", [(f, m) for f in FORMS for m in (2, 16, 64)]
                         + [("g32", 1), ("g16", 1)])
def test_gateup_gelu_matches_pallas(gateup_weights, pallas, form, m):
    """``_gateup_i8_kernel`` (M > 1) and ``_gateup_i8_gd_kernel`` (M = 1)
    with act "gelu" against the port's wrapper, whose plain version equals
    the unfused sequence (the matmul of its form on the fused weight, then
    gelu·mul in bf16) bit for bit; at M = 1 against the reference's own M =
    1 run (its interpret-mode M = 1 rows sit off its M > 1 rows).  The SiLU
    epilogue on the same sums is caught: 8x past the limit per element."""
    jw, tw = gateup_weights[form]
    assert (tw.group, tw.scales.shape[0]) == ((16, 1) if form == "g16"
                                              else (32, 2 if "mins" in form else 1))
    xj, xt = _x(m, K, seed=100 + m)
    want = pq.qmm_gateup(xj, jw, "gelu")
    assert want is not None, "the Pallas gate-up refused the shape; test is vacuous"
    got = tq.qmm_i8t_gateup(xt, tw, "gelu")
    assert got.dtype == torch.bfloat16 and got.shape == (m, FF)
    _close(got.float().numpy(), np.asarray(want, np.float32), GATEUP_TOL)
    assert torch.equal(tq.qmm_gateup(xt, tw, "gelu"), got)
    g = tq.qmm_plain(xt, tw, dq=m > 1).to(torch.bfloat16)
    assert torch.equal(got, tq.gelu(g[:, :FF]) * g[:, FF:])
    silu = (tq.silu(g[:, :FF]) * g[:, FF:]).float()
    lim = GATEUP_TOL * got.float().abs() + 1e-5 * got.float().abs().max()
    assert float(((silu - got.float()).abs() / lim).max()) >= 8


# -- the whole MLP's gate at Gemma-7B's widths ----------------------------------------


@pytest.mark.parametrize("group,rows", [(32, 1), (32, 2), (16, 1), (16, 2)])
def test_mlp_gate_at_gemma7b_widths_is_the_reference_s(group, rows):
    """``mlp_fits`` equals ``_pick_bf_mlp(...) != 0`` at K = C = 3072, ff
    24576 for M 1-300: the whole MLP up to a threshold, gate-up + down from
    it on (group 32: 142 rows, 132 with a mins plane; group 16: 137, 122)."""
    got = [tm.mlp_fits(FF7, C7, C7, m, rows, rows, group, 2) for m in range(1, 301)]
    want = [pq._pick_bf_mlp(FF7, C7, C7, m, rows, rows, group, 2) != 0 for m in range(1, 301)]
    assert got == want
    first = got.index(False) + 1
    assert first == {(32, 1): 142, (32, 2): 132, (16, 1): 137, (16, 2): 122}[(group, rows)]
    assert not any(got[first - 1:])


# -- the narrow models ----------------------------------------------------------------


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("gemma7b")
    return {name: make_model(str(d / f"gemma_{i}.gguf"), quant=qt, tensor_quant=tq_, **GEMMA)
            for i, (name, (qt, tq_, _, _, _)) in enumerate(MODELS.items())}


@pytest.fixture(scope="module")
def all_models(ggufs):
    return {name: (j_load(ggufs[name], weights=w), load_model(ggufs[name], device="cpu",
                                                               weights=w))
            for name, (_, _, w, _, _) in MODELS.items()}


@pytest.mark.parametrize("name", list(MODELS))
def test_loader_kinds_and_params_from_numpy(all_models, name):
    """Both loaders give every layer weight K-major i8t, the gate-up at its
    group and planes, the down at its own group, the tied bf16 table and
    no head; 4 kv heads of 256; params_from_numpy carries the reference's
    params across bit for bit."""
    jm, tm_ = all_models[name]
    (gg, planes), dg = MODELS[name][3], MODELS[name][4]
    lay = tm_.params["layers"]
    got = {k: (v.kind, v.group) for k, v in lay.items() if hasattr(v, "kind")}
    want = {k: (v.kind, v.group) for k, v in jm.params["layers"].items() if hasattr(v, "kind")}
    assert got == want
    assert got["w_gateup"] == ("i8t", gg) and got["w_down"] == ("i8t", dg)
    assert lay["w_gateup"].scales.shape[-3] == planes
    assert tm_.params["output"] is None and tm_.cfg.act == "gelu"
    assert (tm_.cfg.n_heads, tm_.cfg.n_kv_heads, tm_.cfg.head_dim) == (H, HKV, D)
    carried = params_from_numpy(jax.tree.map(np.asarray, jm.params), tm_.cfg, device="cpu")
    assert set(carried["layers"]) == set(lay)
    for key, b in lay.items():
        a = carried["layers"][key]
        if hasattr(b, "qw"):
            assert (a.kind, a.group, a.shape) == (b.kind, b.group, b.shape), key
            assert torch.equal(a.qw, b.qw), key
            sa, sb = tqt.kernel_scales(a)[0], tqt.kernel_scales(b)[0]
            assert torch.equal(sa.float(), sb.float()), key
        else:
            assert torch.equal(a, b), key
    assert torch.equal(carried["tok_embd"].view(torch.int16), tm_.params["tok_embd"].view(
        torch.int16))


def _prefill_decode(jm, tm_, steps, quantized, B=2):
    """Prefill of the prompt (a 16-row bucket, in slot 0 of B) then `steps`
    T = 1 steps fed the reference's greedy token, both packages: [(port
    logits, reference logits)] of the live slot."""
    cfg = tm_.cfg
    ids = tm_.tokenizer.encode(PROMPT)
    n, T = len(ids), 16
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
@pytest.mark.parametrize("quantized,B", [(False, 1), (True, 2)], ids=["bf16-1", "int8-2"])
def test_prefill_and_decode_logits_match(all_models, pallas, monkeypatch, name, quantized, B):
    """Prefill and a decode step, prefill against prefill, decode against
    decode, over a bf16 cache of one slot and an int8 cache of two.  The
    files with a down of another group take the int8 gate-up with GELU at
    the prefill's 16·B rows (the dequantize form) and at the step's B (one
    slot: the group-dot form); the Q4_0 file widened to int8 takes the
    whole MLP with GELU at both, and no gate-up."""
    jm, tm_ = all_models[name]
    calls = []
    for mod, fn in ((tq, "qmm_i8t_gateup"), (tm, "qmm_mlp_i8t")):
        orig = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda x, *a, _o=orig, _f=fn: calls.append(
            (_f, x.shape[0], a[-1])) or _o(x, *a))
    for got, want in _prefill_decode(jm, tm_, steps=1, quantized=quantized, B=B):
        _close(got, want, LOGIT_TOL)
    fn = "qmm_mlp_i8t" if MODELS[name][4] == 32 else "qmm_i8t_gateup"
    assert calls == [(fn, 16 * B, "gelu")] * L + [(fn, B, "gelu")] * L


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
def test_generate_greedy_tokens_equal(all_models, pallas, monkeypatch, name):
    """``generate`` (one slot: the decode steps at M = 1) gives the
    reference's greedy tokens; the files with a down of another group run
    the M = 1 gate-up with GELU (the group-dot form) at each step."""
    jm, tm_ = all_models[name]
    rows = []
    orig = tq.qmm_i8t_gateup
    monkeypatch.setattr(tq, "qmm_i8t_gateup",
                        lambda x, w, act="silu": rows.append((x.shape[0], act)) or orig(x, w, act))
    ids = tm_.tokenizer.encode(PROMPT)
    want = JEngine(jm, max_batch=1, max_seq=MAX_SEQ, decode_chunk=4).generate(
        ids, JSP(temp=0.0), max_new_tokens=4)
    got = Engine(tm_, max_batch=1, max_seq=MAX_SEQ, decode_chunk=4).generate(
        ids, SamplingParams(temp=0.0), max_new_tokens=4)
    assert len(want.token_ids) == 4
    if MODELS[name][4] == 32:
        assert rows == []
    else:
        assert (1, "gelu") in rows and set(r[1] for r in rows) == {"gelu"}
    _greedy_equal_or_near_tie(got.token_ids, want.token_ids,
                              lambda i: _prefill_decode(jm, tm_, i, False, B=1)[i][1][0, -1])


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
    """4 streams of the batched slot API over an int8 cache (the prefill at
    4·16 rows, the steps at 4: the M > 1 forms): each stream's tokens equal
    the reference's, the cache lengths too."""
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


# -- llama.cpp's Q5_K_M arrangement -------------------------------------------------


def test_a_down_of_q6_k_then_q5_k_is_refused_by_both_loaders(tmp_path):
    """llama.cpp's use_more_bits gives ``ffn_down`` Q6_K in some layers and
    Q5_K in others of a Q5_K_M file: both repack to int8 of one kind and
    shape, so the reference's loader puts the layers in one run and cannot
    stack their groups (16 and 32); the port's loader raises alike."""
    path = make_model(str(tmp_path / "q5km.gguf"), quant=TT.Q5_K,
                      tensor_quant={"blk.0.ffn_down.weight": TT.Q6_K}, **GEMMA)
    from booster_tpu_torch.gguf import GGUFReader

    reader = GGUFReader(path)
    try:
        types = [reader.tensors[f"blk.{i}.ffn_down.weight"].ggml_type for i in range(L)]
        assert types == [TT.Q6_K, TT.Q5_K]
        assert reader.tensors["blk.0.ffn_up.weight"].ggml_type == TT.Q5_K
    finally:
        reader.close()
    with pytest.raises(ValueError, match="cannot stack heterogeneous layer tensors"):
        j_load(path)
    with pytest.raises(ValueError, match="cannot stack heterogeneous layer tensors"):
        load_model(path, device="cpu")
