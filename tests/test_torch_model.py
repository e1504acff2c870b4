"""The port's loader, llama forward pass and engine against the JAX package
on one synthetic Q4_0 model, on the CPU (the JAX Pallas kernels in
interpret mode, so the reference takes every kernel of the path).

The model is big enough for every kernel gate: hidden 1024, 16 heads over
2 kv heads (head_dim 64, G = 8 as in TinyLlama), ff 512, vocab 512.

Tolerances: the two packages do the same bf16/f32 arithmetic with sums in
other orders, and XLA's jitted forward may keep fused bf16 intermediates at
f32 precision, so a bf16 rounding (2^-8 relative) of an intermediate may
differ and propagate through the layers; logits leave the lm head rounded
to bf16.  Logits and cache rows are compared at 2^-5 of their largest
magnitude; measured differences are one or two bf16 ulps (about 2^-7 of
the largest logit).  Greedy tokens must be identical."""

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
from booster_tpu_torch.quant.qtensor import QTensor  # noqa: E402
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
    return make_model(str(tmp_path_factory.mktemp("m") / "t.gguf"), vocab_size=512,
                      hidden=1024, layers=2, heads=16, kv_heads=2, ff=512,
                      weight_scale=0.3)


@pytest.fixture(scope="module")
def models(gguf):
    return j_load(gguf), load_model(gguf, device="cpu")


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


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _assert_same_params(a, b, path=""):
    if isinstance(a, QTensor):
        assert (a.kind, a.group, a.shape, a.zero, a.source_type) == (
            b.kind, b.group, b.shape, b.zero, b.source_type), path
        for f in ("qw", "scales", "mins"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), path + f
            if x is not None:
                assert x.dtype == y.dtype, path + f
                np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=path + f)
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same_params(a[k], b[k], f"{path}/{k}")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=path)
    else:
        assert a == b, path


def test_params_from_numpy_equals_own_loader(models):
    jm, tm = models
    jparams = jax.tree.map(np.asarray, jm.params)
    got = params_from_numpy(jparams, tm.cfg, device="cpu")
    _assert_same_params(got, tm.params)
    assert tm.cfg == tm.cfg.__class__(**{**jm.cfg.__dict__})


def _close(got, want):
    err = np.abs(got - want).max()
    assert err <= LOGIT_TOL * np.abs(want).max(), (err, np.abs(want).max())


def _prompt(tok):
    return tok.encode("hello world the and of to in")


def test_prefill_and_decode_logits_match(models, pallas):
    jm, tm = models
    cfg = tm.cfg
    ids = _prompt(tm.tokenizer)
    n = len(ids)
    T = 32  # the prompt's power-of-two bucket, as the engines pick it
    arr = np.zeros((1, T), np.int32)
    arr[0, :n] = ids
    nv = np.asarray([n], np.int32)
    g = np.asarray([n - 1], np.int32)

    jc = JCache.create(cfg.n_layers, 1, MAX_SEQ, cfg.n_kv_heads, cfg.head_dim)
    jl, jc = j_forward(jm.params, jm.cfg, jnp.asarray(arr), jc, gather_idx=jnp.asarray(g),
                       n_valid=jnp.asarray(nv))
    tc = KVCache.create(cfg.n_layers, 1, MAX_SEQ, cfg.n_kv_heads, cfg.head_dim, "cpu")
    tl, tc = forward(tm.params, cfg, torch.from_numpy(arr), tc,
                     gather_idx=torch.from_numpy(g), n_valid=torch.from_numpy(nv))
    jl = np.asarray(jl)
    assert tl.shape == jl.shape == (1, 1, cfg.n_vocab)
    _close(tl.numpy(), jl)
    assert int(tc.lengths[0]) == int(jc.lengths[0]) == n
    # the caches hold the same rows (bf16 k/v of the prompt)
    _close(tc.k[:, :, :, :n].float().numpy(), np.asarray(jc.k[:, :, :, :n], np.float32))

    # one T = 1 decode step: stacked cache, deferred append, self term
    nxt = int(np.argmax(jl[0, -1]))
    jl2, jc = j_forward(jm.params, jm.cfg, jnp.asarray([[nxt]], jnp.int32), jc,
                        last_only=True)
    tl2, tc = forward(tm.params, cfg, torch.tensor([[nxt]], dtype=torch.int32), tc,
                      last_only=True)
    jl2 = np.asarray(jl2)
    _close(tl2.numpy(), jl2)
    _close(tc.k[:, :, :, n].float().numpy(), np.asarray(jc.k[:, :, :, n], np.float32))


def test_generate_greedy_tokens_equal(models, pallas):
    jm, tm = models
    ids = _prompt(tm.tokenizer)
    want = JEngine(jm, max_batch=1, max_seq=MAX_SEQ, decode_chunk=4).generate(
        ids, JSP(temp=0.0), max_new_tokens=10)
    got = Engine(tm, max_batch=1, max_seq=MAX_SEQ, decode_chunk=4).generate(
        ids, SamplingParams(temp=0.0), max_new_tokens=10)
    assert len(want.token_ids) >= 8
    assert got.token_ids == want.token_ids
    assert got.text == want.text
    assert got.finish_reason == want.finish_reason


def test_generate_context_shift_matches(tmp_path, pallas):
    """160 greedy tokens through a 128-token cache: the engine's context
    shift (keep n_keep, drop half the rest, re-prefill) fires twice."""
    path = make_model(str(tmp_path / "cs.gguf"), vocab_size=512, hidden=1024, layers=1,
                      heads=16, kv_heads=2, ff=512, weight_scale=0.3)
    jm, tm = j_load(path), load_model(path, device="cpu")
    ids = tm.tokenizer.encode("hello world")
    want = JEngine(jm, max_batch=1, max_seq=MAX_SEQ, decode_chunk=16).generate(
        ids, JSP(temp=0.0), max_new_tokens=160, n_keep=2)
    got = Engine(tm, max_batch=1, max_seq=MAX_SEQ, decode_chunk=16).generate(
        ids, SamplingParams(temp=0.0), max_new_tokens=160, n_keep=2)
    assert len(want.token_ids) == 160
    assert got.token_ids == want.token_ids


def test_generate_sampled_deterministic_per_seed(models):
    _, tm = models
    eng = Engine(tm, max_batch=1, max_seq=MAX_SEQ, decode_chunk=3)
    ids = _prompt(tm.tokenizer)
    sp = SamplingParams(temp=1.5, top_k=40, top_p=0.95, min_p=0.0, seed=7,
                        penalty_repeat=1.2)
    a = eng.generate(ids, sp, max_new_tokens=7)
    b = eng.generate(ids, sp, max_new_tokens=7)
    assert a.token_ids == b.token_ids and a.n_generated == 7


def test_entry_points_refuse_cuda_without_a_card(gguf, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_model(gguf)
