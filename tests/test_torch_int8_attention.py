"""The port's decode attention over an int8 cache and its chunked-prefill
attention (plain versions of the CUDA kernels, CPU) against the JAX
package's (Pallas kernels in interpret mode).

Tolerance: the per-element limit that the kernels are held to on the card
(``booster_tpu_torch.testing.decode_attn_limit`` / ``prefill_attn_limit``):
2^-8·Σ_j p_j·|vs_j·v_j| / l (+1 %) plus 1e-5 of the largest output.  Scores
are f32 dots of the same operands summed in another order, so a PV weight
bf16(p·vs) may round the other way, and with several column tiles the
reference rounds it against a running max; each such weight moves by at
most 2^-8 of itself.  The references are called with f32 q (bf16 values,
scale 1) so that their outputs stay f32."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, ".")

from booster_tpu.ops import pallas_attention as pa  # noqa: E402
from booster_tpu_torch.ops import decode_attention as tda  # noqa: E402
from booster_tpu_torch.ops import prefill_attention as tpa  # noqa: E402
from booster_tpu_torch.testing import (decode_attn_case, decode_attn_limit,  # noqa: E402
                                       decode_attn_mutants, prefill_attn_case,
                                       prefill_attn_limit, prefill_attn_mutants)
from booster_tpu_torch.testing import torch_threads  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


@pytest.fixture(autouse=True)
def interpret():
    pa.INTERPRET = True
    try:
        yield
    finally:
        pa.INTERPRET = False
        jax.clear_caches()


def _j(t: torch.Tensor, dtype=None):
    a = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return jnp.asarray(a, dtype) if dtype is not None else jnp.asarray(a)


@pytest.mark.parametrize("B,win,softcap", [
    (16, None, 0.0),   # merged kernel, bt = 8
    (16, 40, 20.0),    # merged, window and softcap
    (3, None, 30.0),   # per-b twin (B % 8 != 0)
    (3, 64, 0.0),
])
def test_decode_attention_int8_matches_pallas(B, win, softcap):
    rng = np.random.default_rng(B)
    lens = [int(x) for x in rng.integers(1, 250, B)]
    lens[0] = 0  # a slot whose cache is empty: only its self term is valid
    args = list(decode_attn_case(2, B, 2, 8, 256, 64, 128, lens, "cpu", seed=B, quantized=True))
    ok = torch.ones(B, dtype=torch.int32)
    ok[1] = 0  # a slot whose new token is not live
    args[5] = 257 if win is None else win
    args[6] = softcap
    args[9] = ok
    args = tuple(args)
    q, kc, vc, layer, lens_t, _, _, sk, sv, _, ks, vs = args
    want = tda.decode_attn_plain(*args)
    ref = pa.decode_attention_stacked(
        _j(q).reshape(B, 1, -1, 128), _j(kc), _j(vc), _j(ks), _j(vs), jnp.int32(layer),
        _j(lens_t), scale=1.0, logit_softcap=softcap,
        window=None if win is None else jnp.int32(win),
        self_kv=(_j(sk, jnp.bfloat16), _j(sv, jnp.bfloat16), _j(ok) > 0))
    ref = torch.from_numpy(np.array(ref, np.float32)).reshape(want.shape)
    live = (lens_t > 0) | (ok > 0)  # a slot with neither attends to nothing
    limit = decode_attn_limit(args)
    assert ((ref - want).abs() <= limit)[live].all()
    # the inputs let this check see the wrong kernels chip_smoke.py rules out
    for what, margs in decode_attn_mutants(args).items():
        seen = ((tda.decode_attn_plain(*margs) - want).abs() / limit)[live].max()
        assert seen >= 8, (what, float(seen))


def test_decode_attention_stacked_int8_is_the_kernel_level_call():
    B, D = 4, 64
    args = decode_attn_case(2, B, 2, 8, 128, D, 128, [3, 50, 127, 9], "cpu", seed=1,
                            quantized=True)
    q, kc, vc, layer, lens, win, _, sk, sv, ok, ks, vs = args
    got = tda.decode_attention_stacked(
        q[..., :D].reshape(B, 1, 16, D).float(), kc, vc, layer, lens, scale=1.0,
        self_kv=(sk[..., :D], sv[..., :D], ok), k_scale=ks, v_scale=vs)
    want = tda.decode_attn_plain(*args)[..., :D].reshape(B, 1, 16, D)
    assert torch.equal(got, want)


@pytest.mark.parametrize("quantized,T,S,win,softcap,pos0,n_valid", [
    (True, 16, 512, None, 0.0, [0, 0, 0], [16, 9, 1]),       # first chunk, padded rows
    (True, 32, 512, None, 0.0, [200, 37, 0], [32, 5, 20]),   # later chunks over the cache
    (True, 512, 1024, 100, 25.0, [0, 300], [512, 400]),      # 2 query and 2 column tiles
    (False, 16, 256, 24, 0.0, [100, 7, 0], [16, 3, 11]),     # bf16 cache, window
    (False, 512, 1024, None, 30.0, [0, 512], [500, 512]),    # bf16, 2 x 2 tiles, softcap
])
def test_prefill_attention_matches_pallas(quantized, T, S, win, softcap, pos0, n_valid):
    B, Hkv, G, D, Dc = len(pos0), 2, 4 if T > 256 else 8, 64, 128
    q, k, v, ks, vs, p0, lens, _, _ = prefill_attn_case(B, Hkv, G, T, S, D, Dc, pos0, n_valid,
                                                        "cpu", seed=T + S)
    if not quantized:  # the same cache, dequantized to bf16
        k = (k.float() * ks[..., None]).to(torch.bfloat16)
        v = (v.float() * vs[..., None]).to(torch.bfloat16)
        ks = vs = None
    H = Hkv * G
    qx = q.reshape(B, Hkv, G, T, Dc).permute(0, 3, 1, 2, 4).reshape(B, T, H, Dc)[..., :D]
    kx, vx = k.reshape(B, Hkv, S, Dc), v.reshape(B, Hkv, S, Dc)
    ksx = None if ks is None else ks.reshape(B, Hkv, S, 1)
    vsx = None if vs is None else vs.reshape(B, Hkv, S, 1)
    lens_b, p0_b = lens[::Hkv], p0[::Hkv]

    def port(v_):
        return tpa.prefill_attention(qx.float(), kx, v_, ksx, vsx, lens_b, scale=1.0,
                                     logit_softcap=softcap, window=win, pos0=p0_b)

    got = port(vx)
    ref = pa.prefill_attention(
        _j(qx), _j(kx) if quantized else _j(kx, jnp.bfloat16),
        _j(vx) if quantized else _j(vx, jnp.bfloat16),
        None if ksx is None else _j(ksx), None if vsx is None else _j(vsx), _j(lens_b),
        scale=1.0, logit_softcap=softcap, window=None if win is None else jnp.int32(win),
        pos0=_j(p0_b))
    ref = torch.from_numpy(np.array(ref, np.float32))
    assert got.dtype == torch.float32 and got.shape == ref.shape == (B, T, H, D)
    limit = 2 ** -8 * 1.01 * port(vx.abs()) + 1e-5 * got.abs().max()
    for b in range(B):  # the rows below the length
        rows = slice(0, n_valid[b])
        assert ((ref[b, rows] - got[b, rows]).abs() <= limit[b, rows]).all(), b


def test_prefill_attn_check_sees_wrong_kernels():
    """The kernel-vs-plain check of chip_smoke.py for prefill attention
    (testing.prefill_attn_limit on testing.prefill_attn_case's inputs) fails
    a kernel that drops a row's own column, misses the last valid column,
    reads one past the end or ignores the v scales, each by 8x its limit."""
    for pos0, n_valid in (([0, 0], [16, 9]), ([200, 37], [12, 5])):
        args = prefill_attn_case(2, 2, 8, 16, 512, 64, 128, pos0, n_valid, "cpu", seed=3)
        want = tpa.prefill_attn_plain(*args)
        limit = prefill_attn_limit(args)
        for what, margs in prefill_attn_mutants(args).items():
            seen = ((tpa.prefill_attn_plain(*margs) - want).abs() / limit).max()
            assert seen >= 8, (what, float(seen))


@pytest.mark.parametrize("kind", ["decode_bf16", "decode_int8", "prefill_int8"])
def test_checks_see_wrong_kernels_at_head_dim_128(kind):
    """At the 7B head layout (G = 4, head dim 128 filling every lane of the
    cache) the kernel-vs-plain checks of chip_smoke.py fail every wrong
    kernel by 8x their limit, a kernel that ignores lanes 64-127 among them."""
    if kind == "prefill_int8":
        args = prefill_attn_case(2, 2, 4, 32, 512, 128, 128, [0, 200], [32, 9], "cpu", seed=4)
        plain, mutants = tpa.prefill_attn_plain, prefill_attn_mutants(args)
        limit = prefill_attn_limit(args)
    else:
        args = decode_attn_case(2, 2, 2, 4, 512, 128, 128, [30, 500], "cpu", seed=5,
                                quantized=kind == "decode_int8")
        plain, mutants = tda.decode_attn_plain, decode_attn_mutants(args)
        limit = decode_attn_limit(args)
    assert "lanes 64-127 ignored" in mutants
    want = plain(*args)
    for what, margs in mutants.items():
        seen = ((plain(*margs) - want).abs() / limit).max()
        assert seen >= 8, (what, float(seen))
