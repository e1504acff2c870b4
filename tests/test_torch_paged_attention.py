"""The port's paged decode attention, paged all-layer append and chunked
prefill attention against the JAX package's, on the CPU.

The plain paged attention (booster_tpu_torch.ops.paged_attention, the
function the CUDA kernel computes) is held against the reference's Pallas
kernels in interpret mode: the merged kernel (``paged_decode_attention_stacked``),
its per-(row, head) twin ``_paged_attn_kernel_stacked`` (``_MERGED_P`` off)
and the one-layer ``paged_decode_attention``, over bf16 and int8 pools with
scattered tables and shared first pages, the self term on and off, a window
and a softcap.  Tolerance: the kernels walk the columns page by page with an
online softmax while the plain version takes one pass, so a PV weight
bf16(p) may round the other way (2^-8 of itself): |port - reference| <=
2^-8 · 1.01 · Σ_j p_j |v_j| / l + 1e-5 max|out| per element
(``booster_tpu_torch.testing.paged_attn_limit``).  The plain paged append is
bit-exact with ``kv_append_all_layers_paged`` in interpret mode on every page
but the scratch page 0, away from the rows the TPU kernel clobbers after the
offset (its aligned write window; never read).  ``_attention_chunked`` runs
over the reference's threshold, and the wrong kernels of
``booster_tpu_torch.testing`` exceed the limit 8x."""

import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, ".")

import booster_tpu.ops.pallas_kv as pk  # noqa: E402
import booster_tpu.ops.pallas_paged_attention as ppa  # noqa: E402
from booster_tpu.ops import kv_cache as jkv  # noqa: E402
from booster_tpu_torch.ops import attention as tatt  # noqa: E402
from booster_tpu_torch.ops import paged_attention as tpa  # noqa: E402
from booster_tpu_torch.ops.paged_kv import paged_append_all_layers  # noqa: E402
from booster_tpu_torch.testing import (paged_attn_case, paged_attn_limit,  # noqa: E402
                                       paged_attn_mutants)
from booster_tpu_torch.testing import torch_threads  # noqa: E402

jatt = importlib.import_module("booster_tpu.ops.attention")  # the package exports a function
L, B, Hkv, G, P, MAXP, D = 2, 4, 2, 2, 128, 3, 128
LENS = [300, 257, 128, 1]  # mid-page (rows 0 and 1 share two pages), a page boundary, one row


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


@pytest.fixture
def interpret():
    ppa.INTERPRET = pk.INTERPRET = True
    try:
        yield
    finally:
        ppa.INTERPRET = pk.INTERPRET = False
        jax.clear_caches()


def _j(t):
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        return jax.lax.bitcast_convert_type(jnp.asarray(t.view(torch.int16).numpy()), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _case(quantized, win=0, softcap=0.0, seed=0):
    args = paged_attn_case(L, B, Hkv, G, P, MAXP, D, D, LENS, "cpu", seed=seed,
                           quantized=quantized, shared=2, win=win, softcap=softcap)
    q, kc, vc, table, layer, lens, win_, sc, sk, sv, ok, *scales = args
    ks, vs = scales if scales else (None, None)
    q4 = q.float().reshape(B, 1, Hkv * G, D)  # already scaled (scale 1) and bf16-exact
    return args, q4, (kc, vc, ks, vs), table, layer, lens, sk.float(), sv.float(), ok


def _check(got, want, args):
    limit = paged_attn_limit(args).reshape(B, 1, Hkv * G, D).numpy()
    err = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert (err <= limit).all(), (err.max(), (err / limit).max())


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("with_self", [False, True])
def test_paged_attention_matches_merged_kernel(interpret, quantized, with_self):
    args, q, pools, table, layer, lens, sk, sv, ok = _case(quantized, seed=1)
    assert ppa._MERGED_P
    self_kv = (sk, sv, ok) if with_self else None
    want = ppa.paged_decode_attention_stacked(
        _j(q), *map(_j, pools), _j(table), jnp.int32(layer), _j(lens), 1.0,
        self_kv=None if self_kv is None else tuple(map(_j, self_kv)))
    got = tpa.paged_decode_attention_stacked(q, *pools, table, layer, lens, 1.0,
                                             self_kv=self_kv)
    if not with_self:
        args = (*args[:10], torch.zeros_like(ok), *args[11:])
    _check(got, want, args)


def test_paged_attention_window_softcap_and_prep(interpret):
    args, q, pools, table, layer, lens, sk, sv, ok = _case(True, win=100, softcap=30.0, seed=2)
    prep = ppa.paged_decode_prep(_j(lens), jnp.int32(100), B=B, P=P, MAXP=MAXP)
    want = ppa.paged_decode_attention_stacked(
        _j(q), *map(_j, pools), _j(table), jnp.int32(layer), _j(lens), 1.0,
        logit_softcap=30.0, window=jnp.int32(100), self_kv=(_j(sk), _j(sv), _j(ok)), prep=prep)
    got = tpa.paged_decode_attention_stacked(
        q, *pools, table, layer, lens, 1.0, logit_softcap=30.0, window=100,
        self_kv=(sk, sv, ok), prep=tpa.paged_decode_prep(lens, 100, B=B, P=P, MAXP=MAXP))
    _check(got, want, args)


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_attention_matches_stacked_kernel(interpret, quantized, monkeypatch):
    """The per-(row, head) twin of the merged kernel computes the same."""
    monkeypatch.setattr(ppa, "_MERGED_P", False)
    args, q, pools, table, layer, lens, sk, sv, ok = _case(quantized, seed=3)
    want = ppa.paged_decode_attention_stacked(
        _j(q), *map(_j, pools), _j(table), jnp.int32(layer), _j(lens), 1.0,
        self_kv=(_j(sk), _j(sv), _j(ok)))
    got = tpa.paged_decode_attention_stacked(q, *pools, table, layer, lens, 1.0,
                                             self_kv=(sk, sv, ok))
    _check(got, want, args)


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_attention_matches_one_layer_kernel(interpret, quantized):
    """``paged_decode_attention`` over one layer's pool, no self term."""
    args, q, pools, table, layer, lens, sk, sv, ok = _case(quantized, seed=4)
    want = ppa.paged_decode_attention(
        _j(q), *[None if p is None else _j(p[layer]) for p in pools], _j(table), _j(lens), 1.0)
    got = tpa.paged_decode_attention_stacked(q, *pools, table, layer, lens, 1.0)
    _check(got, want, (*args[:10], torch.zeros_like(ok), *args[11:]))


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_wrong_kernels_exceed_the_limit(quantized):
    """Each wrong kernel of testing.paged_attn_mutants moves the output by 8x
    the limit or more (the check of chip_smoke.py can see it)."""
    args = paged_attn_case(L, 8, Hkv, 4, P, 4, D, D, [300, 257, 512, 1, 128, 400, 60, 9], "cpu",
                           seed=5, quantized=quantized, shared=3)
    want = tpa.paged_attn_plain(*args)
    limit = paged_attn_limit(args)
    mutants = paged_attn_mutants(args)
    assert len(mutants) == (4 if quantized else 3)
    for what, margs in mutants.items():
        assert ((tpa.paged_attn_plain(*margs) - want).abs() / limit).max() >= 8, what


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_append_matches_pallas(interpret, quantized):
    rng = np.random.default_rng(6)
    Np = B * MAXP + 1
    table = (1 + rng.permutation(Np - 1)).reshape(B, MAXP).astype(np.int32)
    kf = rng.normal(size=(L, Np, Hkv, P, D)).astype(np.float32)
    vf = rng.normal(size=(L, Np, Hkv, P, D)).astype(np.float32)
    new_k = rng.normal(size=(L, B, Hkv, D)).astype(np.float32)
    new_v = rng.normal(size=(L, B, Hkv, D)).astype(np.float32)
    offs = np.array([0, 7 + P, 2 * P + 127, MAXP * P + 2], np.int32)  # the last: past the table
    if quantized:
        (k, ks), (v, vs) = jkv._quantize_kv(jnp.asarray(kf)), jkv._quantize_kv(jnp.asarray(vf))
    else:
        k, v = jnp.asarray(kf, jnp.bfloat16), jnp.asarray(vf, jnp.bfloat16)
        ks = vs = None
    want = pk.kv_append_all_layers_paged(k, v, jnp.asarray(new_k, jnp.bfloat16),
                                         jnp.asarray(new_v, jnp.bfloat16), jnp.asarray(offs),
                                         jnp.asarray(table), ks, vs)

    def t(a):
        a = np.array(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        return torch.from_numpy(a)

    got = [None if a is None else t(a) for a in (k, v, ks, vs)]
    paged_append_all_layers(got[0], got[1], t(jnp.asarray(new_k, jnp.bfloat16)),
                            t(jnp.asarray(new_v, jnp.bfloat16)), torch.from_numpy(offs),
                            torch.from_numpy(table), got[2], got[3])
    # rows after the offset inside the TPU kernel's aligned window are
    # clobbered there (future rows, never read): leave them out
    keep = np.ones((Np, P), bool)
    keep_s = np.ones((Np, P), bool)
    keep[0] = keep_s[0] = False
    for b, off in enumerate(offs):
        if off // P < MAXP:
            page, o = table[b, off // P], off % P
            keep[page, o + 1:(o // 8 + 1) * 8] = False
            keep_s[page, o + 1:(o // 128 + 1) * 128] = False
    for g, w, m in zip(got, want, (keep, keep, keep_s, keep_s)):
        if w is None:
            continue
        g = g.float().numpy() if g.dtype == torch.bfloat16 else g.numpy()
        w = np.asarray(w, g.dtype).reshape(g.shape)
        g, w = g.swapaxes(1, 2), w.swapaxes(1, 2)  # [L, Hkv, Np, P, D]
        np.testing.assert_array_equal(g[:, :, m], w[:, :, m])


def test_attention_chunked_matches_jax():
    """Past the reference's score budget both take the online-softmax
    branch over 512-column chunks; f32 sums in another order may flip a
    bf16(p), so outputs agree within 2^-7 of the largest."""
    rng = np.random.default_rng(7)
    Bq, T, H, Hk, Dh, S = 1, 1024, 8, 2, 64, 4608
    assert Bq * H * T * S > jatt._CHUNK_THRESHOLD == tatt._CHUNK_THRESHOLD
    q = rng.normal(size=(Bq, T, H, Dh)).astype(np.float32)
    k = rng.normal(size=(Bq, Hk, S, Dh)).astype(np.float32)
    v = rng.normal(size=(Bq, Hk, S, Dh)).astype(np.float32)
    pos = (np.arange(T)[None] + 3000).astype(np.int32)  # a late chunk of a long prompt
    valid = np.array([3000 + 1000], np.int32)
    kb, vb = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    want = jax.jit(jatt.attention, static_argnames=("scale", "logit_softcap"))(
        jnp.asarray(q), kb, vb, jnp.asarray(pos), jnp.asarray(valid), scale=0.125,
        logit_softcap=30.0)
    tb = (torch.from_numpy(k).to(torch.bfloat16), torch.from_numpy(v).to(torch.bfloat16))
    got = tatt.attention(torch.from_numpy(q), *tb, torch.from_numpy(pos),
                         torch.from_numpy(valid), 0.125, logit_softcap=30.0)
    err = np.abs(got.numpy() - np.asarray(want))[:, :1000]  # the valid query rows
    assert err.max() <= 2 ** -7 * np.abs(np.asarray(want)).max(), err.max()
