"""The port's MPT path against the JAX package on the CPU, the reference's
Pallas kernels in interpret mode: the per-layer T = 1 append
(``kv_append_decode_stacked`` and its L = 1 view ``kv_append_decode``) bit
for bit on the rows both write, ``update_layer``'s dispatch, ALiBi slopes
and the biased attention, LayerNorm and GELU, the loader's fused rows, and
a small MPT model (hidden 256, 4 heads of 64 stored at 128 lanes, ff 1024,
vocab 512, 2 layers, LayerNorm biases, ALiBi max bias 8) through the
forward over a bf16 and an int8 cache (a length that is a multiple of 128
and one that is not), ``Engine.generate``, the 64-slot batch and the paged
server; the tied head; the plain T = 1 decode of a llama model (TinyLlama
width, one layer) over a cache of 200 rows; and the GPT-2 pre-tokenizer and BPE
against the reference's ``regex`` version.

Tolerances: logits at 2^-5 of their largest magnitude (tests/
test_torch_model.py: bf16 intermediates round at other places).  The MPT
models draw weights at scale 0.1, not the llama tests' 0.3: through a
layer the two packages agree bit for bit but for the lm head's last bf16
rounding (f32 sums in another order) and GELU's tanh (XLA's and torch's
differ by an f32 ulp, which a bf16 rounding turns into one bf16 ulp of a
few elements), and at 0.3 two LayerNorm + GELU layers amplify such a
one-ulp difference to 2.6 % of the largest logit at a decode step (0.3 %
at 0.1).  Greedy tokens are equal up to the first step whose reference
top-2 margin is within the logit tolerance, which must then be such a
near-tie (the batch of 64 slots meets exact bf16 ties).

The split is compared on every character assigned in Python's
``unicodedata`` (Unicode 15.0): ``regex`` carries newer tables, and reads
code points assigned since as letters or numbers where the port (without
``regex``) sees unassigned ones."""

import asyncio
import dataclasses
import importlib
import os
import signal
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import regex
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

sys.path.insert(0, ".")

from booster_tpu.models import load_model as j_load  # noqa: E402
from booster_tpu.models import llama as jllama  # noqa: E402
from booster_tpu.models.llama import forward as j_forward  # noqa: E402
from booster_tpu.ops import kv_cache as jkv  # noqa: E402
from booster_tpu.ops import linear as jlinear  # noqa: E402
from booster_tpu.ops import pallas_attention as pa  # noqa: E402
from booster_tpu.ops import pallas_kv as pk  # noqa: E402
from booster_tpu.ops import pallas_qmm as pq  # noqa: E402
from booster_tpu.ops.kv_cache import KVCache as JCache  # noqa: E402
from booster_tpu.sampling import SamplingParams as JSP  # noqa: E402
from booster_tpu.serving import Engine as JEngine  # noqa: E402
from booster_tpu.tokenizer import bpe as jbpe  # noqa: E402
from booster_tpu.tokenizer import Tokenizer as JTokenizer  # noqa: E402
from booster_tpu_torch.models import llama as tllama  # noqa: E402
from booster_tpu_torch.models import load_model, params_from_numpy  # noqa: E402
from booster_tpu_torch.models.llama import forward  # noqa: E402
from booster_tpu_torch.ops import kv_append as ka  # noqa: E402
from booster_tpu_torch.ops import kv_cache as tkv  # noqa: E402
from booster_tpu_torch.ops.kv_cache import KVCache  # noqa: E402
from booster_tpu_torch.ops.linear import qlinear  # noqa: E402
from booster_tpu_torch.sampling import SamplingParams  # noqa: E402
from booster_tpu_torch.serving import Engine  # noqa: E402
from booster_tpu_torch.testing import make_model  # noqa: E402
from booster_tpu_torch.testing import torch_threads  # noqa: E402
from booster_tpu_torch.tokenizer import Tokenizer  # noqa: E402
from booster_tpu_torch.tokenizer.bpe import gpt2_split  # noqa: E402

jatt = importlib.import_module("booster_tpu.ops.attention")  # the packages export a function
tatt = importlib.import_module("booster_tpu_torch.ops.attention")

LOGIT_TOL = 2 ** -5
MAX_SEQ = 128
C, FF, H, L = 256, 1024, 4, 2
PROMPT = "hello world and the end"
MPT = dict(vocab_size=512, hidden=C, layers=L, heads=H, kv_heads=H, ff=FF, arch="mpt",
           weight_scale=0.1)
CORPUS = [
    "Hello world, it's a test!  It'll do.\n\nThey've   said: 'we're here'.",
    "Привет, мир! Как дела? Всё хорошо.",
    "def f(x):\n    return x ** 2  # square\n\tprint(f(3))\r\n",
    "12345 3.14159 1,000,000 ½ ⅞ Ⅻ ٣٤ 2024-10-17",
    "I'll've they'RE 'S ''s !'s don't CAN'T",
    "emoji 😀👍🏽 🇩🇪 and 家族 日本語のテキスト",
    "separators\x1c\x1d\x1e\x1f a\x1cb \x1f c",
    "nbsp here   and thin 　ideographic",
    "   leading, trailing   ",
    "\n\n\n   \t \n",
    "<|endoftext|>special in the middle<|endoftext|>",
]


def _t(a) -> torch.Tensor:
    """A JAX array as a torch tensor (bf16 through its bit pattern)."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    return make_model(str(tmp_path_factory.mktemp("mpt") / "mpt.gguf"), norm_bias=True, **MPT)


@pytest.fixture(scope="module")
def models(gguf):
    return j_load(gguf), load_model(gguf, device="cpu")


@pytest.fixture(scope="module")
def pallas():
    """The reference's Pallas path in interpret mode, for the whole module
    (its compiled functions are kept between the tests)."""
    jlinear.set_use_pallas(True)
    pq.INTERPRET = pa.INTERPRET = pk.INTERPRET = True
    try:
        yield
    finally:
        jlinear.set_use_pallas(None)
        pq.INTERPRET = pa.INTERPRET = pk.INTERPRET = False
        jax.clear_caches()


# -- the per-layer append ------------------------------------------------------


def _cache_case(quantized, Lc, B, Hc, S, D, seed):
    rng = np.random.default_rng(seed)
    kf = rng.normal(size=(Lc, B, Hc, S, D)).astype(np.float32)
    vf = rng.normal(size=(Lc, B, Hc, S, D)).astype(np.float32)
    if quantized:
        (k, ks), (v, vs) = jkv._quantize_kv(jnp.asarray(kf)), jkv._quantize_kv(jnp.asarray(vf))
        return k, v, ks, vs
    return jnp.asarray(kf, jnp.bfloat16), jnp.asarray(vf, jnp.bfloat16), None, None


def _written_rows(offs, S, B):
    """Rows both versions define: all but those after a slot's offset inside
    the TPU kernel's 8-row payload window and 128-lane scale window (future
    rows, which the TPU kernel overwrites and nothing reads)."""
    keep = np.ones((B, S), bool)
    keep_s = np.ones((B, S), bool)
    for b, off in enumerate(offs):
        o = min(off, S - 1)
        keep[b, o + 1:(o // 8 + 1) * 8] = False
        keep_s[b, o + 1:(o // 128 + 1) * 128] = False
    return keep, keep_s


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("d", [64, 128])
def test_kv_append_layer_matches_pallas(quantized, d, pallas):
    """Offsets at 0, in the middle of a window, at S - 1 and past it
    (clamped), into layer 1 of a 3-layer cache (``kv_append_decode_stacked``)
    and into an L = 1 view (``kv_append_decode``): bit-exact on the compared
    rows, payloads and scales."""
    Lc, B, Hc, S, D = 3, 4, 2, 256, 128
    offs = np.array([0, 13, S - 1, S + 5], np.int32)
    rng = np.random.default_rng(d)
    nk = jnp.asarray(rng.normal(size=(B, 1, Hc, d)) * 2, jnp.bfloat16)
    nv = jnp.asarray(rng.normal(size=(B, 1, Hc, d)) * 2, jnp.bfloat16)
    nk = nk.at[1, 0, 0].set(0.0)  # a zero row: scale 0, payload 0
    keep, keep_s = _written_rows(offs, S, B)
    for layer in (1, None):
        k, v, ks, vs = _cache_case(quantized, Lc if layer else 1, B, Hc, S, D,
                                   seed=d + (layer or 0))
        got = [None if a is None else _t(a) for a in (k, v, ks, vs)]
        if layer is None:  # the L = 1 view
            want = pk.kv_append_decode(k[0], v[0], nk, nv, jnp.asarray(offs),
                                       None if ks is None else ks[0],
                                       None if vs is None else vs[0])
            want = [None if w is None else np.asarray(w)[None] for w in want]
            lay = 0
        else:
            want = [None if w is None else np.asarray(w) for w in pk.kv_append_decode_stacked(
                k, v, nk, nv, jnp.asarray(offs), jnp.int32(layer), ks, vs)]
            lay = layer
        ka.kv_append_layer(got[0][lay], got[1][lay], _t(nk), _t(nv), torch.from_numpy(offs),
                           None if ks is None else got[2][lay],
                           None if vs is None else got[3][lay])
        for g, w, m in zip(got, want, (keep, keep, keep_s, keep_s)):
            if w is None:
                continue
            g, w = _np(g), np.asarray(w, np.float32 if g.dtype == torch.bfloat16 else None)
            w = w.reshape(g.shape)
            assert np.array_equal(g[:, m[:, None].repeat(Hc, 1)], w[:, m[:, None].repeat(Hc, 1)])
            others = [i for i in range(g.shape[0]) if i != lay]
            assert np.array_equal(g[others], w[others])  # the other layers untouched


@pytest.mark.parametrize("S,T,taken", [(128, 1, True), (200, 1, False), (128, 4, False)])
def test_update_layer_dispatch(S, T, taken, monkeypatch, pallas):
    """T = 1 into a lane-aligned cache of a length that is a multiple of 128
    goes to the per-layer append, as the reference's goes to
    ``kv_append_decode``; the rest keep the plain writes.  Both equal the
    reference's update_layer on the compared rows (int8 cache; the
    reference jitted, so its amax / 127 is the reciprocal multiply)."""
    B, Hc, D, d = 2, 2, 128, 64
    calls = []
    orig = ka.kv_append_layer
    monkeypatch.setattr(ka, "kv_append_layer", lambda *a: calls.append(1) or orig(*a))
    k, v, ks, vs = _cache_case(True, 1, B, Hc, S, D, seed=S + T)
    k, v, ks, vs = k[0], v[0], ks[0], vs[0]
    rng = np.random.default_rng(T)
    nk = jnp.asarray(rng.normal(size=(B, T, Hc, d)), jnp.bfloat16)
    nv = jnp.asarray(rng.normal(size=(B, T, Hc, d)), jnp.bfloat16)
    offs = np.array([5, S - T], np.int32)
    want = [np.asarray(w) for w in jax.jit(jkv.update_layer)(k, v, nk, nv, jnp.asarray(offs),
                                                             ks, vs)]
    got = [_t(a) for a in (k, v, ks, vs)]
    tkv.update_layer(got[0], got[1], _t(nk), _t(nv), torch.from_numpy(offs), got[2], got[3])
    assert bool(calls) == taken
    keep, keep_s = _written_rows(offs + T - 1, S, B) if taken else (np.ones((B, S), bool),) * 2
    for g, w, m in zip(got, want, (keep, keep, keep_s, keep_s)):
        g, w = _np(g), w.reshape(g.shape)
        assert np.array_equal(g[m[:, None].repeat(Hc, 1)], w[m[:, None].repeat(Hc, 1)])


# -- attention with ALiBi ---------------------------------------------------------


@pytest.mark.parametrize("n_heads,max_bias", [(32, 8.0), (12, 8.0), (5, 4.0)])
def test_alibi_slopes_exact(n_heads, max_bias):
    want = np.asarray(jatt.alibi_slopes(n_heads, max_bias))
    got = tatt.alibi_slopes(n_heads, max_bias)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("T,q0", [(16, 0), (1, 150)])
def test_attention_with_slopes_matches_jax(T, q0):
    """The masked attention with the ALiBi bias, a prompt chunk and one
    decode row late in the cache: within 2^-7 of the largest output (f32
    softmax sums in another order may flip a bf16 probability)."""
    rng = np.random.default_rng(T)
    B, Hq, Hk, Dh, S = 2, 8, 8, 64, 256
    q = rng.normal(size=(B, T, Hq, Dh)).astype(np.float32)
    k = jnp.asarray(rng.normal(size=(B, Hk, S, Dh)), jnp.bfloat16)
    v = jnp.asarray(rng.normal(size=(B, Hk, S, Dh)), jnp.bfloat16)
    pos = (np.arange(T)[None] + np.array([[q0], [q0 + 7]])).astype(np.int32)
    valid = pos[:, -1] + 1
    slopes = jatt.alibi_slopes(Hq, 8.0)
    want = np.asarray(jax.jit(jatt.attention, static_argnames=("scale",))(
        jnp.asarray(q), k, v, jnp.asarray(pos), jnp.asarray(valid), scale=0.125,
        alibi_slopes=slopes))
    got = tatt.attention(torch.from_numpy(q), _t(k), _t(v), torch.from_numpy(pos),
                         torch.from_numpy(valid), 0.125,
                         alibi_slopes=tatt.alibi_slopes(Hq, 8.0)).numpy()
    assert np.abs(got - want).max() <= 2 ** -7 * np.abs(want).max()
    plain = tatt.attention(torch.from_numpy(q), _t(k), _t(v), torch.from_numpy(pos),
                           torch.from_numpy(valid), 0.125).numpy()
    assert np.abs(plain - want).max() > 2 ** -4 * np.abs(want).max()  # the bias matters


def test_attention_with_slopes_never_chunked(monkeypatch):
    """Past the chunking threshold the reference keeps the dense form when
    slopes are given; so does the port."""
    monkeypatch.setattr(jatt, "_CHUNK_THRESHOLD", 1)
    monkeypatch.setattr(tatt, "_CHUNK_THRESHOLD", 1)
    monkeypatch.setattr(tatt, "_attention_chunked", lambda *a, **kw: pytest.fail("chunked"))
    rng = np.random.default_rng(3)
    q = rng.normal(size=(1, 4, 4, 64)).astype(np.float32)
    k = jnp.asarray(rng.normal(size=(1, 4, 512, 64)), jnp.bfloat16)
    v = jnp.asarray(rng.normal(size=(1, 4, 512, 64)), jnp.bfloat16)
    pos = np.arange(100, 104, dtype=np.int32)[None]
    valid = np.array([104], np.int32)
    want = np.asarray(jatt.attention(jnp.asarray(q), k, v, jnp.asarray(pos), jnp.asarray(valid),
                                     0.125, alibi_slopes=jatt.alibi_slopes(4, 8.0)))
    got = tatt.attention(torch.from_numpy(q), _t(k), _t(v), torch.from_numpy(pos),
                         torch.from_numpy(valid), 0.125, alibi_slopes=tatt.alibi_slopes(4, 8.0))
    assert np.abs(got.numpy() - want).max() <= 2 ** -7 * np.abs(want).max()


# -- LayerNorm, GELU, the FFN -------------------------------------------------------


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    """One bf16 ulp of each (bf16-valued) element: 2^(exponent - 7)."""
    e = np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def test_layer_norm_and_gelu_within_one_bf16_ulp():
    """bf16 outputs within one bf16 ulp; GELU's also within 2^-21·|x|: at
    x < -4, gelu = x·(1 + tanh(z))/2 cancels, and the few f32 ulps by which
    XLA's tanh and torch's differ there show (the reference's own eager and
    jitted forms differ on such elements too)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, C)) * 3).astype(np.float32)
    w, b = rng.standard_normal(C).astype(np.float32), rng.standard_normal(C).astype(np.float32)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    for wj, bj, wt, bt in ((w, b, torch.from_numpy(w), torch.from_numpy(b)),
                           (None, None, None, None)):
        want = np.asarray(jax.jit(jllama.layer_norm, static_argnums=3)(
            xj, None if wj is None else jnp.asarray(wj), None if bj is None else jnp.asarray(bj),
            1e-5), np.float32)
        got = tllama.layer_norm(xt, wt, bt, 1e-5)
        assert got.dtype == torch.bfloat16
        assert (np.abs(got.float().numpy() - want) <= _bf16_ulp(want)).all()
    want = np.asarray(jax.jit(lambda a: jllama._act(a, "gelu"))(xj), np.float32)
    got = tllama._act(xt, "gelu")
    assert got.dtype == torch.bfloat16
    assert (np.abs(got.float().numpy() - want)
            <= _bf16_ulp(want) + 2.0 ** -21 * np.abs(xt.float().numpy())).all()


def test_ungated_ffn_within_one_bf16_ulp(models, pallas):
    """up → GELU → down on the model's layer-0 weights (Q4_0: lane-major up,
    K-major down), the reference's kernels against the port's."""
    jm, tm = models
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, C)).astype(np.float32)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    jl = jm.params["layers"]
    ju = jax.tree.map(lambda a: a[0], jl["w_up"])  # lane-major: the layer's slice
    jd = dataclasses.replace(jl["w_down"], layer=jnp.int32(0))  # K-major: the layer view
    assert (ju.kind, jd.kind) == ("i4p", "i4t")
    want = np.asarray(jax.jit(lambda a: jllama.qlinear(jllama._act(jllama.qlinear(a, ju), "gelu"),
                                                       jd))(xj), np.float32)
    tl = tm.params["layers"]
    got = qlinear(tllama._act(qlinear(xt, tl["w_up"].at(0)), "gelu"), tl["w_down"].at(0))
    assert (np.abs(got.float().numpy() - want) <= _bf16_ulp(want)).all()


# -- the loader ---------------------------------------------------------------------


def test_loader_kinds_fused_rows_and_biases(models):
    """attn_qkv split and fused again (the file's rows in order), the
    ungated FFN, the three LayerNorm biases and MPT's configuration, as
    the reference loads them; params_from_numpy carries them over equal."""
    jm, tm = models
    cfg = tm.cfg
    assert (cfg.arch, cfg.norm_type, cfg.act, cfg.rope_style) == ("mpt", "layer", "gelu", "none")
    assert (cfg.alibi_max_bias, cfg.clamp_kqv, cfg.rms_eps) == (
        jm.cfg.alibi_max_bias, jm.cfg.clamp_kqv, jm.cfg.rms_eps) == (8.0, 0.0, np.float32(1e-5))
    carried = params_from_numpy(jax.tree.map(np.asarray, jm.params), cfg, device="cpu")
    lay = tm.params["layers"]
    assert set(lay) == set(jm.params["layers"]) == {
        "attn_norm", "attn_norm_b", "ffn_norm", "ffn_norm_b", "wqkv", "wo", "w_up", "w_down"}
    for key in ("wqkv", "wo", "w_up", "w_down"):
        j, a, b = jm.params["layers"][key], carried["layers"][key], lay[key]
        assert j.kind == b.kind and b.shape == tuple(j.shape), key
        assert torch.equal(a.qw, b.qw), key
        assert torch.equal(a.scales.view(torch.int16) if a.scales.dtype == torch.bfloat16
                           else a.scales, b.scales.view(torch.int16)
                           if b.scales.dtype == torch.bfloat16 else b.scales), key
    assert lay["wqkv"].shape == (3 * C, C)
    for key in ("attn_norm_b", "ffn_norm_b"):
        assert torch.equal(carried["layers"][key], lay[key])
        assert float(lay[key].abs().max()) > 0
    assert torch.equal(carried["output_norm_b"], tm.params["output_norm_b"])


# -- the model ------------------------------------------------------------------------


def _prefill_decode(jm, tm, steps, quantized=False, S=MAX_SEQ, B=1):
    cfg = tm.cfg
    ids = tm.tokenizer.encode(PROMPT)
    n, T = len(ids), 16
    arr = np.zeros((B, T), np.int32)
    arr[0, :n] = ids
    nv = np.zeros(B, np.int32)
    nv[0] = n
    g = np.maximum(nv - 1, 0)
    jc = JCache.create(cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim, quantized=quantized)
    jl, jc = j_forward(jm.params, jm.cfg, jnp.asarray(arr), jc, gather_idx=jnp.asarray(g),
                       n_valid=jnp.asarray(nv))
    tc = KVCache.create(cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim, "cpu",
                        quantized=quantized)
    tl, tc = forward(tm.params, cfg, torch.from_numpy(arr), tc, gather_idx=torch.from_numpy(g),
                     n_valid=torch.from_numpy(nv))
    out = [(tl.numpy()[:1], np.asarray(jl)[:1])]
    step = (nv > 0).astype(np.int32)
    for _ in range(steps):  # T = 1 steps fed the reference's greedy token
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        jl, jc = j_forward(jm.params, jm.cfg, jnp.asarray(nxt), jc, last_only=True,
                           n_valid=jnp.asarray(step))
        tl, tc = forward(tm.params, cfg, torch.from_numpy(nxt), tc, last_only=True,
                         n_valid=torch.from_numpy(step))
        out.append((tl.numpy()[:1], np.asarray(jl)[:1]))
    assert int(tc.lengths[0]) == int(jc.lengths[0]) == n + steps
    return out


def _close(got, want):
    err = np.abs(got - want).max()
    assert err <= LOGIT_TOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("S", [128, 200])
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_prefill_and_decode_logits_match(models, pallas, monkeypatch, quantized, S):
    """Prefill and 4 decode steps over a bf16 or int8 cache of 128 rows
    (the per-layer append, L per step, no stacked decode kernel) or of 200
    (the plain writes) with 2 idle slots beside the live one."""
    jm, tm = models
    calls = []
    orig = ka.kv_append_layer
    monkeypatch.setattr(ka, "kv_append_layer", lambda *a: calls.append(1) or orig(*a))
    monkeypatch.setattr(tllama, "decode_attention_stacked", lambda *a, **kw: pytest.fail("stacked"))
    for got, want in _prefill_decode(jm, tm, steps=4, quantized=quantized, S=S, B=3):
        _close(got, want)
    assert len(calls) == (4 * L if S % 128 == 0 else 0)


def test_llama_plain_decode_at_200_rows(tmp_path, pallas):
    """The plain T = 1 decode over a cache length that is no multiple of 128:
    a 1-layer llama model of TinyLlama's width (32 heads over 4 kv heads of
    64) over a bf16 cache of 200 rows, whose steps the reference's gates
    send to the masked layer loop with plain row writes."""
    path = make_model(str(tmp_path / "tl.gguf"), vocab_size=512, hidden=2048, layers=1,
                      heads=32, kv_heads=4, ff=5632, weight_scale=0.05)
    jm, tm = j_load(path), load_model(path, device="cpu")
    for got, want in _prefill_decode(jm, tm, steps=2, S=200):
        _close(got, want)


def _greedy_equal_or_near_tie(got: list, want: list, ref_logits):
    """Tokens equal up to the first step whose reference logits (ref_logits[i]
    [V], computed teacher-forced on the reference's own tokens) hold a
    top-2 margin within the logit tolerance."""
    assert len(got) == len(want)
    same = [a == b for a, b in zip(got, want)]
    if all(same):
        return
    i = same.index(False)
    ref = ref_logits(i)
    assert int(np.argmax(ref)) == want[i]
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
    _greedy_equal_or_near_tie(got.token_ids, want.token_ids,
                              lambda i: _prefill_decode(jm, tm, steps=i)[i][1][0, -1])


def _run_batch(eng, sp_cls, tok, slots):
    eng.init_batch_state()
    prompts = {}
    for s in slots:
        eng.reset_slot(s, sp_cls(temp=0.0), seed=s)
        prompts[s] = tok.encode(f"stream {s} benchmark prompt")
    first = eng.prefill_slots(prompts)
    toks, _ = eng.decode_slots(first, n_steps=4)
    return prompts, first, toks, np.asarray(eng.cache.lengths).tolist()


def _batch_reference_logits(jm, prompts, steps):
    """The reference's logits of every live slot at the prefill and each
    step, over the batch's int8 cache, fed its own greedy tokens."""
    B, T = 64, 16
    cfg = jm.cfg
    arr = np.zeros((B, T), np.int32)
    nv = np.zeros(B, np.int32)
    for s, ids in prompts.items():
        arr[s, :len(ids)] = ids
        nv[s] = len(ids)
    jc = JCache.create(cfg.n_layers, B, MAX_SEQ, cfg.n_kv_heads, cfg.head_dim, quantized=True)
    lg, jc = j_forward(jm.params, cfg, jnp.asarray(arr), jc,
                       gather_idx=jnp.asarray(np.maximum(nv - 1, 0)), n_valid=jnp.asarray(nv))
    out = [np.asarray(lg)[:, -1]]
    step = (nv > 0).astype(np.int32)
    for _ in range(steps):
        nxt = np.argmax(out[-1], -1).astype(np.int32)[:, None]
        lg, jc = j_forward(jm.params, cfg, jnp.asarray(nxt), jc, last_only=True,
                           n_valid=jnp.asarray(step))
        out.append(np.asarray(lg)[:, -1])
    return np.stack(out, 1)  # [B, steps + 1, V]


def test_batch_64_slots_greedy_tokens_equal(models, pallas):
    """The 64-slot batch over an int8 cache (bench_batch's engine; MPT's
    decode steps take the per-layer int8 append), 8 slots live with greedy
    sampling: each slot's tokens equal the reference's up to a near-tie of
    the reference's logits, and the cache lengths are equal."""
    jm, tm = models
    slots = list(range(0, 64, 8))
    prompts, jfirst, jtoks, jlen = _run_batch(
        JEngine(jm, max_batch=64, max_seq=MAX_SEQ, kv_quantized=True, decode_chunk=4), JSP,
        jm.tokenizer, slots)
    _, first, toks, lengths = _run_batch(
        Engine(tm, max_batch=64, max_seq=MAX_SEQ, kv_quantized=True, decode_chunk=4),
        SamplingParams, tm.tokenizer, slots)
    assert lengths == jlen and sorted(first) == slots
    ref = None
    for s in slots:
        want, got = [jfirst[s]] + jtoks[s], [first[s]] + toks[s]
        assert len(got) == len(want) == 5
        if got != want and ref is None:
            ref = _batch_reference_logits(jm, prompts, steps=4)
        _greedy_equal_or_near_tie(got, want, lambda i: ref[s, i])


def test_tied_head_and_clamp_match_reference(tmp_path, pallas):
    """A file without output.weight (the head tied to token_embd, as
    llama.cpp falls back) and with attention.clamp_kqv small enough to bite:
    both packages read it alike and agree at prefill and decode."""
    path = make_model(str(tmp_path / "tied.gguf"), output=False, clamp_kqv=0.25, **MPT)
    jm, tm = j_load(path), load_model(path, device="cpu")
    assert tm.params["output"] is None and jm.params.get("output") is None
    assert tm.cfg.clamp_kqv == jm.cfg.clamp_kqv == 0.25
    h = tllama.layer_norm(tm.params["tok_embd"][:8], tm.params["layers"]["attn_norm"][0], None,
                          1e-5)
    qkv = qlinear(h, tm.params["layers"]["wqkv"].at(0))
    assert float(qkv.abs().max()) > 0.25  # the clamp changes some q, k, v
    for got, want in _prefill_decode(jm, tm, steps=3):
        _close(got, want)


def test_other_mpt_options_refused(models):
    _, tm = models
    for change in (dict(n_experts=2), dict(parallel_residual=True), dict(act="silu")):
        with pytest.raises(NotImplementedError):
            tllama._check_ported(dataclasses.replace(tm.cfg, **change))


# -- the paged server -----------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_paged_server_answers_with_reference_tokens(gguf, models, pallas):
    """``python -m booster_tpu_torch --server --paged-kv`` on the MPT file:
    a paged decode with ALiBi takes the reference's masked paged branch
    (append_paged_layer, gather_layer, the attention with slopes).  A greedy
    chat request gets the text and token count that the JAX package's
    scheduler over a paged engine gives the same prompt."""
    import json
    from http.client import HTTPConnection

    from booster_tpu.serving.config import PromptSpec as JPromptSpec
    from booster_tpu.serving.config import _sampling_from_dict
    from booster_tpu.serving.scheduler import Scheduler as JScheduler
    from booster_tpu.serving.server import _chat_to_prompt

    jm, _ = models
    messages = [{"role": "user", "content": "hello world"}]
    body = {"messages": messages, "temperature": 0, "max_tokens": 6}

    async def reference():
        sched = JScheduler(JEngine(jm, max_batch=2, max_seq=256, paged=True, page_size=128,
                                   decode_chunk=4),
                           prompt_spec=JPromptSpec(id="default"), default_max_tokens=6)
        sched.start()
        job = sched.place_job(prompt="", full_prompt=_chat_to_prompt(sched, messages),
                              sampling=_sampling_from_dict({"temperature": 0}), max_tokens=6)
        await sched.wait_job(job.id, timeout=300)
        await sched.shutdown(drain=False)
        return job.output, job.n_generated

    want = asyncio.run(reference())
    port = _free_port()
    proc = subprocess.Popen([sys.executable, "-m", "booster_tpu_torch", "--server", "--device",
                             "cpu", "--host", "127.0.0.1", "--port", str(port), "--model", gguf,
                             "--context", "256", "--slots", "2", "--paged-kv", "--page-size",
                             "128", "--silent"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=os.getcwd())
    try:
        for _ in range(1200):
            try:
                conn = HTTPConnection("127.0.0.1", port, timeout=120)
                conn.request("POST", "/v1/chat/completions", body=json.dumps(body))
                r = json.loads(conn.getresponse().read())
                conn.close()
                break
            except OSError:
                time.sleep(0.1)
        assert r["choices"][0]["message"]["content"] == want[0]
        assert r["usage"]["completion_tokens"] == want[1] == 6
    finally:
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err


def test_cli_one_shot_on_mpt(gguf, models):
    """The one-shot CLI on the MPT file prints the library's greedy text."""
    r = subprocess.run([sys.executable, "-m", "booster_tpu_torch", "--model", gguf, "--prompt",
                        PROMPT, "--n-predict", "4", "--temp", "0", "--device", "cpu",
                        "--context", "128"],
                       capture_output=True, text=True, timeout=300, cwd=os.getcwd())
    assert r.returncode == 0, r.stderr
    assert "4 tokens" in r.stderr
    _, tm = models
    want = Engine(tm, max_seq=128, decode_chunk=8).generate(
        tm.tokenizer.encode(PROMPT), SamplingParams(temp=0.0, penalty_repeat=1.1),
        max_new_tokens=4)
    assert r.stdout == want.text + "\n"


# -- the GPT-2 pre-tokenizer and BPE ---------------------------------------------------


_GPT2 = [regex.compile(jbpe._GPT2)]


@pytest.mark.parametrize("text", CORPUS, ids=range(len(CORPUS)))
def test_gpt2_split_matches_regex(text):
    assert gpt2_split(text) == jbpe._split_cascade(text, _GPT2)


_TEXT = st.text(alphabet=st.one_of(
    st.characters(exclude_categories=("Cs", "Cn")),
    st.sampled_from(list(" \t\n\r'sdtlmrevAz09\x1c\x1f 　!."))), max_size=40)


@settings(max_examples=300, deadline=None)
@given(_TEXT)
def test_gpt2_split_matches_regex_on_any_text(text):
    assert gpt2_split(text) == jbpe._split_cascade(text, _GPT2)


@pytest.fixture(scope="module")
def tokenizers(gguf):
    from booster_tpu.gguf import GGUFReader as JReader

    r = JReader(gguf)
    try:
        md = dict(r.metadata)
    finally:
        r.close()
    return JTokenizer.from_gguf_metadata(md), Tokenizer.from_gguf_metadata(md)


@pytest.mark.parametrize("text", CORPUS, ids=range(len(CORPUS)))
def test_bpe_encode_decode_match_reference(tokenizers, text):
    jt, tt = tokenizers
    ids = tt.encode(text)
    assert ids == jt.encode(text)
    assert tt.decode(ids) == jt.decode(ids)
    assert tt.decode(ids, special=True) == text


@settings(max_examples=100, deadline=None)
@given(_TEXT)
def test_bpe_encode_matches_reference_on_any_text(tokenizers, text):
    jt, tt = tokenizers
    assert tt.encode(text) == jt.encode(text)


def test_other_pre_tokenizers_not_ported(tokenizers):
    _, tt = tokenizers
    with pytest.raises(NotImplementedError, match="not ported yet"):
        Tokenizer(dataclasses.replace(tt.vocab, pre="llama3"))


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_kv_append_layer_wrong_appends_are_seen(quantized):
    """On the CPU the wrapper is its plain version: the check of
    chip_smoke.py and tests/test_torch_cuda.py passes it, and every wrong
    append of testing.kv_append_layer_mutants leaves another cache."""
    from booster_tpu_torch.testing import kv_append_layer_case, kv_append_layer_check

    args = kv_append_layer_case(3, 4, 2, 256, 128, 64, [0, 13, 255, 300], "cpu",
                                quantized=quantized)
    k_all, v_all, layer, new_k, new_v, off, ks, vs = args
    got = [None if t is None else t.clone() for t in (k_all, v_all, ks, vs)]
    ka.kv_append_layer(got[0][layer], got[1][layer], new_k, new_v, off,
                       None if ks is None else got[2][layer], None if vs is None else got[3][layer])
    exact, seen = kv_append_layer_check(args, got)
    assert exact and all(seen.values()) and len(seen) == (5 if quantized else 3), seen
