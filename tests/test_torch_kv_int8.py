"""The port's int8 KV cache against the JAX package's: the per-row
quantizer, the quantized T > 1 cache write and the quantizing all-layer
append (plain version of the CUDA kernel; the reference's Pallas kernel in
interpret mode), and the decode self term's storage round trip.

Tolerance: none.  Both sides compute scale = amax/127 and
round-half-even(x / max(scale, 1e-12)) in f32, so payloads and scales must
be bit-identical, a zero row and a value that lands on .5 after the
division included.  The reference runs its quantizer inside jitted code,
where XLA turns the division by 127 into a multiply by the f32 reciprocal;
the tests jit it as the forward pass does (the eager division differs in
the last bit of a few % of scales)."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, ".")

from booster_tpu.ops import kv_cache as jkv  # noqa: E402
from booster_tpu.ops import pallas_kv as pk  # noqa: E402
from booster_tpu_torch.ops import kv_append as tka  # noqa: E402
from booster_tpu_torch.ops import kv_cache as tkv  # noqa: E402
from booster_tpu_torch.ops.decode_attention import self_row  # noqa: E402
from booster_tpu_torch.testing import torch_threads  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


@pytest.fixture
def interpret():
    pk.INTERPRET = True
    try:
        yield
    finally:
        pk.INTERPRET = False
        jax.clear_caches()


def _rows(shape, seed):
    """bf16-exact f32 rows [..., d] with a zero row first and, in the second
    row, amax 127 and values that divide to exact .5 (2.5 → 2, 3.5 → 4,
    -0.5 → -0 under round-half-even)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 3
    flat = x.reshape(-1, shape[-1])
    flat[0] = 0.0
    flat[1] = 0.25
    flat[1, :4] = [127.0, 2.5, 3.5, -0.5]
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _bf16(a):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def test_quantize_kv_matches_jax():
    x = _rows((64, 5, 2, 128), seed=0)
    jq, js = jax.jit(jkv._quantize_kv)(jnp.asarray(x, jnp.bfloat16))
    tq, ts = tkv._quantize_kv(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts.reshape(-1)[0] == 0 and (tq.reshape(-1, 128)[0] == 0).all()
    assert tq.reshape(-1, 128)[1, :4].tolist() == [127, 2, 4, 0]
    # the reference's compiled scale is not the IEEE quotient in every row
    ieee = torch.from_numpy(np.abs(x).max(-1, keepdims=True)) / 127.0
    assert (ts != ieee).any()


def test_update_layer_quantized_matches_jax():
    B, T, H, S, Dc, d = 3, 16, 2, 128, 128, 64
    new_k = _rows((B, T, H, d), seed=1)
    new_v = _rows((B, T, H, d), seed=2)
    off = np.asarray([0, 37, 120], np.int32)  # the last write starts at S - T
    layer = np.random.default_rng(3).integers(-127, 128, (B, H, S, Dc)).astype(np.int8)
    scales = np.random.default_rng(4).random((B, H, S, 1)).astype(np.float32)
    jk, jv, jks, jvs = jax.jit(jkv.update_layer)(
        jnp.asarray(layer), jnp.asarray(layer), _bf16(new_k)[0], _bf16(new_v)[0],
        jnp.asarray(off), jnp.asarray(scales), jnp.asarray(scales))
    tk, tv = torch.from_numpy(layer.copy()), torch.from_numpy(layer.copy())
    tks, tvs = torch.from_numpy(scales.copy()), torch.from_numpy(scales.copy())
    tkv.update_layer(tk, tv, _bf16(new_k)[1], _bf16(new_v)[1], torch.from_numpy(off), tks, tvs)
    for got, want in ((tk, jk), (tv, jv), (tks, jks), (tvs, jvs)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kv_append_quantized_matches_pallas(interpret):
    L, B, H, S, Dc, d = 3, 4, 2, 256, 128, 64
    rng = np.random.default_rng(5)
    kc = rng.integers(-127, 128, (L, B, H, S, Dc)).astype(np.int8)
    kc[..., d:] = 0
    ks = rng.random((L, B, H, S, 1)).astype(np.float32)
    nk = _rows((L, B, H, d), seed=6)
    nv = _rows((L, B, H, d), seed=7)
    off = np.asarray([0, 77, 255, 300], np.int32)  # the last clamps to S - 1
    wk, wv, wks, wvs = pk.kv_append_all_layers(
        jnp.asarray(kc), jnp.asarray(kc), _bf16(nk)[0], _bf16(nv)[0], jnp.asarray(off),
        jnp.asarray(ks), jnp.asarray(ks))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(kc.copy())
    tks, tvs = torch.from_numpy(ks.copy()), torch.from_numpy(ks.copy())
    tka.kv_append(tk, tv, _bf16(nk)[1], _bf16(nv)[1], torch.from_numpy(off), tks, tvs)
    for b in range(B):
        rows = slice(0, min(off[b], S - 1) + 1)  # rows below the new length
        for got, want in ((tk, wk), (tv, wv), (tks, wks), (tvs, wvs)):
            np.testing.assert_array_equal(got[:, b, :, rows].numpy(),
                                          np.asarray(want[:, b, :, rows]))
    # the port writes row min(offsets[b], S - 1) only
    assert torch.equal(tk[:, 1, :, 78:], torch.from_numpy(kc[:, 1, :, 78:]))
    assert (tks[0, 0, 0, 0] == 0).all() and (tk[0, 0, 0, 0] == 0).all()  # the zero row


def test_self_term_mirror_equals_the_appended_row(interpret):
    """Decode attention folds the new token in as the row the append will
    write: its storage round trip equals the dequantized row the
    reference's quantizing append lands, bit for bit."""
    L, B, H, S, Dc, d = 2, 3, 2, 128, 128, 64
    nk = _rows((L, B, H, d), seed=8)
    off = np.asarray([5, 0, 127], np.int32)
    zero8 = jnp.zeros((L, B, H, S, Dc), jnp.int8)
    zeros = jnp.zeros((L, B, H, S, 1), jnp.float32)
    wk, _, wks, _ = pk.kv_append_all_layers(zero8, zero8, _bf16(nk)[0], _bf16(nk)[0],
                                            jnp.asarray(off), zeros, zeros)
    mirror = self_row(torch.nn.functional.pad(_bf16(nk)[1], (0, Dc - d)), quantized=True)
    for b in range(B):
        row = np.asarray(wk[:, b, :, off[b]], np.float32) * np.asarray(wks[:, b, :, off[b]])
        np.testing.assert_array_equal(mirror[:, b].numpy(), row)
