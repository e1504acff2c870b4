"""The port's decode attention, all-layer KV append and prefill attention
(plain versions, CPU) against the JAX package's (Pallas kernels in interpret
mode).

Tolerances: scores are f32 dots of the same bf16 operands summed in another
order; where an exp lands near a bf16 rounding boundary the PV weight bf16(p)
may round the other way, which moves the output by at most ~2^-8 of a value.
Outputs are compared with atol 2e-3 (values are O(1)); measured 0 here.  The
append is exact on the rows the cache holds."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, ".")

from booster_tpu.ops.attention import attention as j_attention  # noqa: E402
from booster_tpu.ops.attention import build_mask as j_build_mask  # noqa: E402
from booster_tpu.ops import pallas_attention as pa  # noqa: E402
from booster_tpu.ops import pallas_kv as pk  # noqa: E402
from booster_tpu_torch.ops import attention as tattn  # noqa: E402
from booster_tpu_torch.ops import decode_attention as tda  # noqa: E402
from booster_tpu_torch.ops import kv_append as tka  # noqa: E402
from booster_tpu_torch.testing import (decode_attn_case, decode_attn_limit,  # noqa: E402
                                       decode_attn_mutants)
from booster_tpu_torch.testing import torch_threads  # noqa: E402

ATOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


@pytest.fixture(autouse=True)
def interpret():
    pa.INTERPRET = pk.INTERPRET = True
    try:
        yield
    finally:
        pa.INTERPRET = pk.INTERPRET = False
        jax.clear_caches()


def _bf16(a):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _decode_inputs(B, seed=0, L=2, Hkv=2, G=4, S=256, D=64, Dc=128):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, Hkv * G, D)).astype(np.float32)
    kc = np.zeros((L, B, Hkv, S, Dc), np.float32)
    vc = np.zeros((L, B, Hkv, S, Dc), np.float32)
    kc[..., :D] = rng.standard_normal((L, B, Hkv, S, D))
    vc[..., :D] = rng.standard_normal((L, B, Hkv, S, D))
    sk = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    sv = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    return q, kc, vc, sk, sv


@pytest.mark.parametrize("B,lens,ok,window,softcap,self_term", [
    (2, [37, 256], [1, 1], None, 0.0, True),   # merged kernel, full cache row
    (2, [100, 5], [1, 0], 40, 0.0, True),      # window; one row's token not live
    (2, [200, 129], [1, 1], None, 30.0, True),  # softcap
    (2, [64, 1], [1, 1], None, 0.0, False),    # no self term
    (3, [7, 150, 256], [1, 1, 1], 64, 20.0, True),  # per-b kernel (B % 8 != 0)
])
def test_decode_attention_matches_pallas(B, lens, ok, window, softcap, self_term):
    q, kc, vc, sk, sv = _decode_inputs(B)
    D = q.shape[-1]
    lens_a = np.asarray(lens, np.int32)
    ok_a = np.asarray(ok, np.int32)
    qj, qt = _bf16(q)
    kj, kt = _bf16(kc)
    vj, vt = _bf16(vc)
    skj, skt = _bf16(sk)
    svj, svt = _bf16(sv)
    scale = 1.0 / D ** 0.5
    want = pa.decode_attention_stacked(
        qj, kj, vj, None, None, jnp.int32(1), jnp.asarray(lens_a), scale=scale,
        logit_softcap=softcap, window=None if window is None else jnp.int32(window),
        self_kv=(skj, svj, jnp.asarray(ok_a > 0)) if self_term else None)
    got = tda.decode_attention_stacked(
        qt, kt, vt, 1, torch.from_numpy(lens_a), scale=scale, logit_softcap=softcap,
        window=window, self_kv=(skt, svt, torch.from_numpy(ok_a)) if self_term else None)
    assert got.dtype == torch.bfloat16 and got.shape == (B, 1, q.shape[2], D)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("lens", [[79], [1000], [1000, 79, 1]])
def test_decode_attn_check_sees_wrong_kernels(lens):
    """The kernel-vs-plain check of decode attention (the per-element limit
    of testing.decode_attn_limit on testing.decode_attn_case's inputs, as the
    chip smoke run and the CUDA tests use them) fails each of three wrong
    kernels by at least 8x its limit, and the JAX reference passes it."""
    B = len(lens)
    args = decode_attn_case(2, B, 2, 8, 1024, 64, 128, lens, "cpu", seed=B)
    want = tda.decode_attn_plain(*args)
    limit = decode_attn_limit(args)
    for what, margs in decode_attn_mutants(args).items():
        seen = ((tda.decode_attn_plain(*margs) - want).abs() / limit).max()
        assert seen >= 8, (what, float(seen))
    q, kc, vc, layer, lens_t, _, _, sk, sv, ok = args
    ref = pa.decode_attention_stacked(  # f32 q (bf16 values): an f32 result
        jnp.asarray(q.float().numpy()).reshape(B, 1, -1, 128),
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (kc, vc)), None, None,
        jnp.int32(layer), jnp.asarray(lens_t.numpy()), scale=1.0,
        self_kv=(jnp.asarray(sk.float().numpy(), jnp.bfloat16),
                 jnp.asarray(sv.float().numpy(), jnp.bfloat16), jnp.asarray(ok.numpy() > 0)))
    ref = torch.from_numpy(np.array(ref, np.float32)).reshape(want.shape)
    assert ((ref - want).abs() <= limit).all()


def test_kv_append_matches_pallas_on_valid_rows():
    L, B, H, S, Dc, d = 3, 2, 2, 128, 128, 64
    rng = np.random.default_rng(4)
    kc = np.zeros((L, B, H, S, Dc), np.float32)
    kc[..., :d] = rng.standard_normal((L, B, H, S, d))
    vc = kc * 0.5
    nk = rng.standard_normal((L, B, H, d)).astype(np.float32)
    nv = rng.standard_normal((L, B, H, d)).astype(np.float32)
    off = np.asarray([3, 120], np.int32)
    kj, kt = _bf16(kc)
    vj, vt = _bf16(vc)
    nkj, nkt = _bf16(nk)
    nvj, nvt = _bf16(nv)
    wk, wv, _, _ = pk.kv_append_all_layers(kj, vj, nkj, nvj, jnp.asarray(off))
    before = kt.clone()
    tka.kv_append(kt, vt, nkt, nvt, torch.from_numpy(off))
    for b in range(B):
        rows = slice(0, off[b] + 1)  # rows < the new length
        for got, want in ((kt, wk), (vt, wv)):
            np.testing.assert_array_equal(got[:, b, :, rows].float().numpy(),
                                          np.asarray(want[:, b, :, rows], np.float32))
        # the port writes row offsets[b] only
        assert torch.equal(kt[:, b, :, off[b] + 1:], before[:, b, :, off[b] + 1:])
    assert torch.equal(kt[..., d:], torch.zeros_like(kt[..., d:]))


def test_prefill_attention_matches_reference():
    B, T, H, Hkv, S, D = 2, 16, 8, 2, 64, 64
    rng = np.random.default_rng(6)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    kc = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    vc = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    offs = np.asarray([0, 20], np.int32)
    pos = offs[:, None] + np.arange(T, dtype=np.int32)[None, :]
    valid = offs + np.asarray([16, 9], np.int32)
    qj, qt = _bf16(q)
    kj, kt = _bf16(kc)
    vj, vt = _bf16(vc)
    want = j_attention(qj, kj, vj, jnp.asarray(pos), jnp.asarray(valid), scale=0.125,
                       logit_softcap=0.0)
    got = tattn.attention(qt, kt, vt, torch.from_numpy(pos), torch.from_numpy(valid),
                          scale=0.125)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=ATOL)
    mask_j = np.asarray(j_build_mask(jnp.asarray(pos), jnp.asarray(valid), S, 5))
    mask_t = tattn.build_mask(torch.from_numpy(pos), torch.from_numpy(valid), S, 5).numpy()
    np.testing.assert_array_equal(mask_t, mask_j)
