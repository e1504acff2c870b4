"""The port's paged KV cache (booster_tpu_torch.ops.paged_kv) and in-cache
context shift (ops.kv_cache.shift_slot_cache) against the JAX package's.

The writes, gathers and scatters are bit for bit those of ``jax.jit`` of the
reference functions (jit, because XLA compiles the int8 scale amax / 127 as a
multiply by f32(1/127)), bf16 and int8, on every page but the scratch page
0, where rows that divert there may collide.  The page allocator, driven
through the call sequences of tests/test_paged_kv.py and the engine's, hands
out the same pages with the same refcounts and prefix hits."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, ".")

from booster_tpu.ops import kv_cache as jkv  # noqa: E402
from booster_tpu.ops import paged_kv as jpk  # noqa: E402
from booster_tpu_torch.ops import kv_cache as tkv  # noqa: E402
from booster_tpu_torch.ops import paged_kv as tpk  # noqa: E402
from booster_tpu_torch.testing import torch_threads  # noqa: E402

L, Hkv, P, MAXP, D = 2, 2, 16, 4, 64


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


def _t(a):
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _same(got: torch.Tensor, want, skip_page0_dim=None):
    """Bit-equal (bf16 compared as f32), optionally without index 0 of the
    page dimension."""
    g, w = _np(got), np.asarray(want, np.float32 if got.dtype == torch.bfloat16 else None)
    if skip_page0_dim is not None:
        g = np.delete(g, 0, axis=skip_page0_dim)
        w = np.delete(w, 0, axis=skip_page0_dim)
    np.testing.assert_array_equal(g, w)


def _pools(rng, n_pages, quantized, layers=None):
    shape = ((layers,) if layers else ()) + (n_pages, Hkv, P, 128)
    x = rng.normal(size=shape).astype(np.float32)
    x[..., D:] = 0
    if quantized:
        q, s = jax.jit(jkv._quantize_kv)(jnp.asarray(x))
        return [np.asarray(q), np.asarray(q), np.asarray(s), np.asarray(s)]
    b = np.asarray(jnp.asarray(x, jnp.bfloat16))
    return [b, b.copy(), None, None]


def _table(rng, B, n_pages):
    return (1 + rng.permutation(n_pages - 1)[:B * MAXP]).reshape(B, MAXP).astype(np.int32)


@pytest.mark.parametrize("quantized", [False, True])
def test_create_matches_jax(quantized):
    want = jpk.PagedKVCache.create(L, 3, 100, Hkv, D, quantized=quantized, page_size=P,
                                   n_pages=20)
    got = tpk.PagedKVCache.create(L, 3, 100, Hkv, D, "cpu", quantized=quantized, page_size=P,
                                  n_pages=20)
    for name in ("k", "v", "table", "lengths", "k_scale", "v_scale"):
        w, g = getattr(want, name), getattr(got, name)
        if w is None:
            assert g is None
            continue
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype), name
    assert (got.page_size, got.n_pages, got.max_len, got.quantized) == (
        want.page_size, want.n_pages, want.max_len, want.quantized)


@pytest.mark.parametrize("quantized", [False, True])
def test_append_paged_layer_matches_jax(quantized):
    rng = np.random.default_rng(0)
    B, T, Np = 3, 20, 16
    pools = _pools(rng, Np, quantized)
    table = _table(rng, B, Np)
    new_k = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    new_v = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    offsets = np.array([0, 13, MAXP * P - 5], np.int32)  # crosses pages; runs past the table
    want = jax.jit(jpk.append_paged_layer)(
        *[None if a is None else jnp.asarray(a) for a in pools[:2]],
        jnp.asarray(new_k, jnp.bfloat16), jnp.asarray(new_v, jnp.bfloat16),
        jnp.asarray(offsets), jnp.asarray(table),
        *[None if a is None else jnp.asarray(a) for a in pools[2:]])
    got = [None if a is None else _t(a).clone() for a in pools]
    tpk.append_paged_layer(got[0], got[1], _t(new_k).to(torch.bfloat16),
                           _t(new_v).to(torch.bfloat16), _t(offsets), _t(table), got[2], got[3])
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        _same(g, w, skip_page0_dim=0)


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_append_all_layers_matches_jax(quantized):
    rng = np.random.default_rng(1)
    B, Np = 4, 20
    pools = _pools(rng, Np, quantized, layers=L)
    table = _table(rng, B, Np)
    new_k = rng.normal(size=(L, B, Hkv, D)).astype(np.float32)
    new_v = rng.normal(size=(L, B, Hkv, D)).astype(np.float32)
    offsets = np.array([0, P, 2 * P + 7, MAXP * P + 3], np.int32)
    want = jax.jit(jpk.paged_append_all_layers)(
        *[None if a is None else jnp.asarray(a) for a in pools[:2]],
        jnp.asarray(new_k, jnp.bfloat16), jnp.asarray(new_v, jnp.bfloat16),
        jnp.asarray(offsets), jnp.asarray(table),
        *[None if a is None else jnp.asarray(a) for a in pools[2:]])
    got = [None if a is None else _t(a).clone() for a in pools]
    tpk.paged_append_all_layers(got[0], got[1], _t(new_k).to(torch.bfloat16),
                                _t(new_v).to(torch.bfloat16), _t(offsets), _t(table), got[2],
                                got[3])
    for g, w in zip(got, want):
        if w is not None:
            _same(g, w, skip_page0_dim=1)


@pytest.mark.parametrize("quantized", [False, True])
def test_gather_and_scatter_match_jax(quantized):
    rng = np.random.default_rng(2)
    B, Np = 2, 12
    pools = _pools(rng, Np, quantized)
    table = _table(rng, B, Np)
    for pool in (p for p in pools if p is not None):
        dense = jax.jit(jpk.gather_layer)(jnp.asarray(pool), jnp.asarray(table))
        _same(tpk.gather_layer(_t(pool), _t(table)), dense)
        # write a changed view back through a single-slot private table
        row = table[1:2]
        view = np.asarray(jpk.gather_layer(jnp.asarray(pool), jnp.asarray(row)))
        view = (view[::-1] if view.dtype == np.int8 else view * 2).copy()
        want = jax.jit(jpk.scatter_layer)(jnp.asarray(pool), jnp.asarray(row),
                                          jnp.asarray(view))
        got = tpk.scatter_layer(_t(pool).clone(), _t(row), _t(view).to(_t(pool).dtype))
        _same(got, want)


def _drive(alloc_cls):
    """The allocator call sequences of tests/test_paged_kv.py (refcounts,
    dedup, cached pages, eviction under pressure) and of the engine (scratch
    page, slots growing, prefix adoption and release); the state after
    every call."""
    out = []
    al = alloc_cls(8, page_size=4)

    def snap(x=None):
        out.append((x, al.refcount.tolist(), list(al.free_list), al.n_free, al.stats(),
                    sorted(al._cached)))

    ids = list(range(11))
    a = al.alloc(3)
    snap(a)
    al.publish_prefix(ids, a[:2])
    snap()
    pages, n = al.lookup_prefix(ids + [99])
    al.retain(pages)
    snap((pages, n))
    snap(al.lookup_prefix([7] + ids))
    al.release(a)
    snap(al.lookup_prefix(ids))
    al.release(a[:2])
    snap(al.lookup_prefix(ids))
    p3, _ = al.lookup_prefix(ids)
    al.retain(p3)
    al.release(p3)
    snap(al.alloc(8))
    snap(al.lookup_prefix(ids))
    # the engine's pattern: scratch page 0, two slots, a shared prompt
    al = alloc_cls(24, page_size=4)
    snap(al.alloc(1))
    prompt = list(range(40, 53))
    s0 = al.alloc(4)
    al.publish_prefix(prompt, s0[:3])
    pages, n = al.lookup_prefix(prompt)
    al.retain(pages)
    s1 = pages + al.alloc(2)
    snap((s0, s1, n))
    al.release(s0[3:])
    al.release(s1)
    snap(al.alloc(20))
    snap(al.alloc(3))
    return out


def test_allocator_matches_jax():
    assert _drive(tpk.PageAllocator) == _drive(jpk.PageAllocator)
    ids = list(range(1000, 1600))
    assert tpk.PageAllocator.chain_hashes(ids, 256) == jpk.PageAllocator.chain_hashes(ids, 256)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("style", ["norm", "neox"])
def test_shift_slot_cache_matches_jax(quantized, style):
    rng = np.random.default_rng(3)
    B, S = 2, 64
    jc = jkv.KVCache.create(L, B, S, Hkv, D, quantized=quantized)
    x = rng.normal(size=(L, B, Hkv, S, 128)).astype(np.float32)
    x[..., D:] = 0
    if quantized:
        q, s = jax.jit(jkv._quantize_kv)(jnp.asarray(x))
        q2, s2 = jax.jit(jkv._quantize_kv)(jnp.asarray(x[::-1].copy()))
        jc = jkv.KVCache(k=q, v=q2, lengths=jnp.asarray([50, 40], jnp.int32), k_scale=s,
                         v_scale=s2)
    else:
        jc = jkv.KVCache(k=jnp.asarray(x, jnp.bfloat16),
                         v=jnp.asarray(x[::-1].copy(), jnp.bfloat16),
                         lengths=jnp.asarray([50, 40], jnp.int32))
    tc = tkv.KVCache(*[None if a is None else _t(a) for a in (
        jc.k, jc.v, jc.lengths, jc.k_scale, jc.v_scale)])
    inv_freq = (1.0 / 10000 ** (np.arange(0, D, 2) / D)).astype(np.float32)
    want = jkv.shift_slot_cache(jc, jnp.int32(1), jnp.int32(4), jnp.int32(13),
                                jnp.asarray(inv_freq), style)
    got = tkv.shift_slot_cache(tc, 1, 4, 13, torch.from_numpy(inv_freq), style)
    for name in ("k", "v", "lengths", "v_scale"):
        if getattr(want, name) is not None:
            _same(getattr(got, name), getattr(want, name))
    if quantized:
        # XLA's f32 cos/sin and torch's differ in the last bit for a few %
        # of angles, so a rotated row's amax, and its scale, may move by an
        # ulp (the payload did not move here); the rotation itself is exact
        # given the same tables (below)
        np.testing.assert_allclose(_np(got.k_scale), np.asarray(want.k_scale), rtol=2 ** -22,
                                   atol=0)
    x = rng.normal(size=(3, 5, 128)).astype(np.float32)
    ang = rng.normal(size=D // 2).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    ref = jax.jit(jkv._rot_delta, static_argnums=3)(jnp.asarray(x), jnp.asarray(cos),
                                                     jnp.asarray(sin), style)
    np.testing.assert_array_equal(
        tkv._rot_delta(_t(x), _t(cos), _t(sin), style).numpy(), np.asarray(ref))
