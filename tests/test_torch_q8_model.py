"""The port's Q8_0 path (native i8t weights) against the JAX package on one
small Q8_0 model, on the CPU, the reference's Pallas kernels in interpret
mode: the loader, the llama forward pass with the MLP dispatch (whole-MLP
kernel, then gate-up, then unfused), the batched engine over an int8 cache
and the single-stream generate.

The model is vocab 512, hidden 512, 2 layers, 4 heads over 2 kv heads (head
dim 128), ff 1024: wide enough for every gate of the reference's i8t
kernels ((K/G) % 16 == 0, ff % 512 == 0), and each test shows that the
reference's whole-MLP kernel took the shape.

Tolerances, as in tests/test_torch_model.py: logits at 2^-5 of their
largest magnitude (bf16 intermediates may round at other places and
propagate); greedy tokens must be equal (weight scale 0.3 keeps the top-2
margins far above that)."""

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
from booster_tpu.ops import linear as jlinear  # noqa: E402
from booster_tpu.ops import pallas_attention as pa  # noqa: E402
from booster_tpu.ops import pallas_kv as pk  # noqa: E402
from booster_tpu.ops import pallas_qmm as pq  # noqa: E402
from booster_tpu.ops.kv_cache import KVCache as JCache  # noqa: E402
from booster_tpu.sampling import SamplingParams as JSP  # noqa: E402
from booster_tpu.serving import Engine as JEngine  # noqa: E402
from booster_tpu_torch.gguf import GGMLType as TT  # noqa: E402
from booster_tpu_torch.models import load_model, params_from_numpy  # noqa: E402
from booster_tpu_torch.models.llama import forward  # noqa: E402
from booster_tpu_torch.ops import mlp as tm_mlp  # noqa: E402
from booster_tpu_torch.ops.kv_cache import KVCache  # noqa: E402
from booster_tpu_torch.sampling import SamplingParams  # noqa: E402
from booster_tpu_torch.serving import Engine  # noqa: E402
from booster_tpu_torch.testing import make_model  # noqa: E402
from booster_tpu_torch.testing import torch_threads  # noqa: E402

LOGIT_TOL = 2 ** -5
MAX_SEQ = 128
assert JT.Q8_0 == TT.Q8_0


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    return make_model(str(tmp_path_factory.mktemp("q8") / "t.gguf"), vocab_size=512,
                      hidden=512, layers=2, heads=4, kv_heads=2, ff=1024, quant=TT.Q8_0,
                      weight_scale=0.3)


@pytest.fixture(scope="module")
def models(gguf):
    jm = j_load(gguf, weights="native")
    tm = load_model(gguf, device="cpu", weights="native")
    # the JAX params carried across, bit-equal to the port's own loader's
    carried = params_from_numpy(jax.tree.map(np.asarray, jm.params), tm.cfg, device="cpu")
    for key in ("wqkv", "wo", "w_gateup", "w_down"):
        a, b = carried["layers"][key], tm.params["layers"][key]
        assert a.kind == b.kind == "i8t" and torch.equal(a.qw, b.qw), key
        assert torch.equal(a.scales.view(torch.int16), b.scales.view(torch.int16)), key
    return jm, dataclasses.replace(tm, params=carried)


@pytest.fixture
def pallas(models):
    jlinear.set_use_pallas(True)
    pq.INTERPRET = pa.INTERPRET = pk.INTERPRET = True
    try:
        jm, tm = models
        gu, dn = jm.params["layers"]["w_gateup"], jm.params["layers"]["w_down"]
        probe = pq.qmm_mlp(jnp.ones((1, 512), jnp.bfloat16), dataclasses.replace(gu, layer=0),
                           dataclasses.replace(dn, layer=0), "silu")
        assert probe is not None, "the reference's fused MLP did not engage; test is vacuous"
        assert tm_mlp.qmm_mlp(torch.ones(1, 512, dtype=torch.bfloat16),
                              tm.params["layers"]["w_gateup"].at(0),
                              tm.params["layers"]["w_down"].at(0)) is not None
        yield
    finally:
        jlinear.set_use_pallas(None)
        pq.INTERPRET = pa.INTERPRET = pk.INTERPRET = False
        jax.clear_caches()


def _close(got, want):
    err = np.abs(got - want).max()
    assert err <= LOGIT_TOL * np.abs(want).max(), (err, np.abs(want).max())


def test_prefill_and_decode_logits_match(models, pallas):
    jm, tm = models
    cfg = tm.cfg
    ids = tm.tokenizer.encode("hello world the and of to in")
    n = len(ids)
    T = 32
    arr = np.zeros((1, T), np.int32)
    arr[0, :n] = ids
    g = np.asarray([n - 1], np.int32)
    nv = np.asarray([n], np.int32)
    jc = JCache.create(cfg.n_layers, 1, MAX_SEQ, cfg.n_kv_heads, cfg.head_dim)
    jl, jc = j_forward(jm.params, jm.cfg, jnp.asarray(arr), jc, gather_idx=jnp.asarray(g),
                       n_valid=jnp.asarray(nv))
    tc = KVCache.create(cfg.n_layers, 1, MAX_SEQ, cfg.n_kv_heads, cfg.head_dim, "cpu")
    tl, tc = forward(tm.params, cfg, torch.from_numpy(arr), tc,
                     gather_idx=torch.from_numpy(g), n_valid=torch.from_numpy(nv))
    _close(tl.numpy(), np.asarray(jl))
    for _ in range(8):  # T = 1 steps fed the reference's greedy token
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        jl, jc = j_forward(jm.params, jm.cfg, jnp.asarray(nxt), jc, last_only=True)
        tl, tc = forward(tm.params, cfg, torch.from_numpy(nxt), tc, last_only=True)
        _close(tl.numpy(), np.asarray(jl))
    assert int(tc.lengths[0]) == int(jc.lengths[0]) == n + 8


def _run_batch(eng, sp_cls, tok):
    eng.init_batch_state()
    prompts = {}
    for s in (0, 2):  # slots 1 and 3 stay idle
        eng.reset_slot(s, sp_cls(temp=0.0), seed=s)
        prompts[s] = tok.encode(f"stream {s} benchmark prompt")
    first = eng.prefill_slots(prompts)
    toks, _ = eng.decode_slots(first, n_steps=6)
    return first, toks, np.asarray(eng.cache.lengths).tolist()


def test_batched_engine_matches_jax(models, pallas):
    jm, tm = models
    want = _run_batch(JEngine(jm, max_batch=4, max_seq=MAX_SEQ, kv_quantized=True,
                              decode_chunk=6), JSP, jm.tokenizer)
    got = _run_batch(Engine(tm, max_batch=4, max_seq=MAX_SEQ, kv_quantized=True,
                            decode_chunk=6), SamplingParams, tm.tokenizer)
    assert sorted(got[0]) == [0, 2] and all(len(got[1][s]) == 6 for s in (0, 2))
    assert got == want


def test_generate_greedy_tokens_equal(models, pallas):
    jm, tm = models
    ids = tm.tokenizer.encode("hello world the and of to in")
    want = JEngine(jm, max_batch=1, max_seq=MAX_SEQ, decode_chunk=4).generate(
        ids, JSP(temp=0.0), max_new_tokens=10)
    got = Engine(tm, max_batch=1, max_seq=MAX_SEQ, decode_chunk=4).generate(
        ids, SamplingParams(temp=0.0), max_new_tokens=10)
    assert len(want.token_ids) >= 8
    assert got.token_ids == want.token_ids and got.n_generated == want.n_generated
