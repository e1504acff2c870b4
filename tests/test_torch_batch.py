"""The port's batched serving path against the JAX package's, on the CPU:
bf16 weights (``load_model(weights="bf16")`` and the "auto" rule), the
forward pass over an int8 KV cache (quantized prefill write, the fused
chunked-prefill attention, T = 1 decode with the int8 self term and the
quantizing append) and the engine's slot API (``prefill_slots``,
``decode_slots``, pipelined ``decode_slots_start``/``_finish``) with live
and idle slots.  The reference's Pallas kernels run in interpret mode.

Tolerances: the dense weights are bit-identical.  Logits are compared at
2^-5 of their largest magnitude, as in tests/test_torch_model.py (the two
packages round bf16 intermediates at other places; int8 caches then round
a k or v row to the other side of a quantization step where the bf16 row
differs by an ulp).  Greedy tokens must be equal; this model's logits
(weight scale 0.3) put every top-2 margin far above that tolerance."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, ".")

from booster_tpu.models import load_model as j_load  # noqa: E402
from booster_tpu.models.llama import forward as j_forward  # noqa: E402
from booster_tpu.ops import linear as jlinear  # noqa: E402
from booster_tpu.ops import pallas_attention as pa  # noqa: E402
from booster_tpu.ops import pallas_kv as pk  # noqa: E402
from booster_tpu.ops import pallas_qmm as pq  # noqa: E402
from booster_tpu.ops.kv_cache import KVCache as JCache  # noqa: E402
from booster_tpu.sampling import SamplingParams as JSP  # noqa: E402
from booster_tpu.serving import Engine as JEngine  # noqa: E402
from booster_tpu_torch.models import load_model, params_from_numpy  # noqa: E402
from booster_tpu_torch.models.llama import forward  # noqa: E402
from booster_tpu_torch.ops.kv_cache import KVCache  # noqa: E402
from booster_tpu_torch.sampling import SamplingParams  # noqa: E402
from booster_tpu_torch.serving import Engine  # noqa: E402
from booster_tpu_torch.testing import make_model  # noqa: E402
from booster_tpu_torch.testing import torch_threads  # noqa: E402

LOGIT_TOL = 2 ** -5
MAX_SEQ = 128


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    return make_model(str(tmp_path_factory.mktemp("b") / "t.gguf"), vocab_size=512,
                      hidden=1024, layers=2, heads=16, kv_heads=2, ff=512,
                      weight_scale=0.3)


@pytest.fixture(scope="module")
def models(gguf):
    return j_load(gguf, weights="bf16"), load_model(gguf, device="cpu", weights="bf16")


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


def _kinds(params):
    return {k: v.kind for k, v in params["layers"].items() if hasattr(v, "kind")} | {
        "output": params["output"].kind}


def test_bf16_weights_equal_jax(models):
    jm, tm = models
    got = params_from_numpy(jax.tree.map(np.asarray, jm.params), tm.cfg, device="cpu")
    assert set(_kinds(tm.params).values()) == {"dense"}
    for key in ("wqkv", "wo", "w_gateup", "w_down"):
        a, b = got["layers"][key], tm.params["layers"][key]
        assert a.shape == b.shape and a.qw.dtype == b.qw.dtype == torch.bfloat16
        assert torch.equal(a.qw.view(torch.int16), b.qw.view(torch.int16)), key
    assert torch.equal(got["output"].qw.view(torch.int16), tm.params["output"].qw.view(torch.int16))


@pytest.mark.parametrize("hint", [0, 1, 64])
def test_weights_auto_picks_as_jax(gguf, hint):
    want = _kinds(j_load(gguf, weights="auto", batch_hint=hint).params)
    got = _kinds(load_model(gguf, device="cpu", weights="auto", batch_hint=hint).params)
    assert set(got.values()) == {"i4t" if hint == 1 else "dense"}
    assert got == want


def _close(got, want):
    err = np.abs(got - want).max()
    assert err <= LOGIT_TOL * np.abs(want).max(), (err, np.abs(want).max())


def test_int8_cache_prefill_and_decode_logits_match(models, pallas):
    jm, tm = models
    cfg = tm.cfg
    rows = [tm.tokenizer.encode("hello world the and of to in"), tm.tokenizer.encode("the end")]
    T = 32  # the longer prompt's bucket
    arr = np.zeros((2, T), np.int32)
    for b, ids in enumerate(rows):
        arr[b, :len(ids)] = ids
    nv = np.asarray([len(r) for r in rows], np.int32)
    g = nv - 1
    jc = JCache.create(cfg.n_layers, 2, MAX_SEQ, cfg.n_kv_heads, cfg.head_dim, quantized=True)
    jl, jc = j_forward(jm.params, jm.cfg, jnp.asarray(arr), jc, gather_idx=jnp.asarray(g),
                       n_valid=jnp.asarray(nv))
    tc = KVCache.create(cfg.n_layers, 2, MAX_SEQ, cfg.n_kv_heads, cfg.head_dim, "cpu",
                        quantized=True)
    tl, tc = forward(tm.params, cfg, torch.from_numpy(arr), tc, gather_idx=torch.from_numpy(g),
                     n_valid=torch.from_numpy(nv))
    _close(tl.numpy(), np.asarray(jl))
    assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist() == nv.tolist()

    def deq(c, b, rows_):
        if isinstance(c, KVCache):
            return (c.k[:, b, :, rows_].float() * c.k_scale[:, b, :, rows_]).numpy()
        return np.asarray(c.k[:, b, :, rows_], np.float32) * np.asarray(c.k_scale[:, b, :, rows_])

    for b in range(2):
        _close(deq(tc, b, slice(0, nv[b])), deq(jc, b, slice(0, nv[b])))

    # two T = 1 steps, slot 1 idle in the second (its cache must not advance)
    for live in ([1, 1], [1, 0]):
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        lv = np.asarray(live, np.int32)
        jl, jc = j_forward(jm.params, jm.cfg, jnp.asarray(nxt), jc, last_only=True,
                           n_valid=jnp.asarray(lv))
        tl, tc = forward(tm.params, cfg, torch.from_numpy(nxt), tc, last_only=True,
                         n_valid=torch.from_numpy(lv))
        _close(tl.numpy()[0], np.asarray(jl)[0])
    assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist() == [nv[0] + 2, nv[1] + 1]
    _close(deq(tc, 0, nv[0] + 1), deq(jc, 0, nv[0] + 1))


def _run_batch(eng, sp_cls, tok):
    eng.init_batch_state()
    prompts = {}
    for s in (0, 2):  # slots 1 and 3 stay idle
        eng.reset_slot(s, sp_cls(temp=0.0), seed=s)
        prompts[s] = tok.encode(f"slot {s} prompt text")
    first = eng.prefill_slots(prompts)
    toks, _ = eng.decode_slots(first, n_steps=6)
    h1 = eng.decode_slots_start([0, 2], n_steps=4)  # pipelined: start both, then finish
    h2 = eng.decode_slots_start([0, 2], n_steps=4)
    more = [eng.decode_slots_finish(h)[0] for h in (h1, h2)]
    return first, toks, more, np.asarray(eng.cache.lengths).tolist(), \
        np.asarray(eng.state.prev_pos).tolist()


def test_batched_engine_matches_jax(models, pallas):
    jm, tm = models
    want = _run_batch(JEngine(jm, max_batch=4, max_seq=MAX_SEQ, kv_quantized=True,
                              decode_chunk=8), JSP, jm.tokenizer)
    got = _run_batch(Engine(tm, max_batch=4, max_seq=MAX_SEQ, kv_quantized=True,
                            decode_chunk=8), SamplingParams, tm.tokenizer)
    first, toks, more, lengths, prev_pos = got
    assert sorted(first) == [0, 2] and all(len(toks[s]) == 6 for s in (0, 2))
    assert got == want
    assert lengths[1] == lengths[3] == 0 and prev_pos[1] == prev_pos[3] == 0


def test_sampled_batch_is_deterministic_per_slot_seed(models):
    _, tm = models

    def run(slots):
        eng = Engine(tm, max_batch=4, max_seq=MAX_SEQ, kv_quantized=True, decode_chunk=5)
        eng.init_batch_state()
        prompts = {}
        for s in slots:
            eng.reset_slot(s, SamplingParams(temp=0.9, top_k=40, seed=11), seed=11)
            prompts[s] = tm.tokenizer.encode("hello world")
        first = eng.prefill_slots(prompts)
        return first, eng.decode_slots(first)[0]

    a, b = run([1]), run([0, 1, 3])
    assert a[0][1] == b[0][1] and a[1][1] == b[1][1]  # slot 1 does not see its neighbours
    assert b[1][0] == b[1][1] == b[1][3]  # one seed, one prompt: one stream


def test_generate_over_int8_cache_matches_jax(models, pallas):
    """Single-stream generate keeps working over an int8 cache: fused
    prefill, int8 decode attention and the quantizing append, B = 1."""
    jm, tm = models
    ids = tm.tokenizer.encode("hello world the and of to in")
    want = JEngine(jm, max_batch=1, max_seq=MAX_SEQ, kv_quantized=True,
                   decode_chunk=4).generate(ids, JSP(temp=0.0), max_new_tokens=10)
    got = Engine(tm, max_batch=1, max_seq=MAX_SEQ, kv_quantized=True,
                 decode_chunk=4).generate(ids, SamplingParams(temp=0.0), max_new_tokens=10)
    assert len(want.token_ids) >= 8 and got.token_ids == want.token_ids
