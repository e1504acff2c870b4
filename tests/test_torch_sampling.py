"""The port's sampler chain against the JAX package's on the same logits and
token history: the penalty ring, the repetition penalties, each filter, the
temperature and the whole chain in the params' order.  These are
deterministic given logits and history; only the draw (a torch.Generator
against JAX PRNG keys) is left out.

Tolerances: the kept-token masks must be equal.  Kept logits agree to
rtol 1e-6: both sides do the same f32 operations, but XLA may fuse a
multiply and a subtract, or compute a softmax or cumsum in another order,
which moves a value by an f32 ulp or two (a threshold could then flip a
token only if a cumulative mass landed within ~1e-7 of p, which these
seeded inputs do not)."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, ".")

from booster_tpu.sampling import samplers as js  # noqa: E402
from booster_tpu.sampling.params import SamplingParams as JSP  # noqa: E402
from booster_tpu_torch.sampling import samplers as ts  # noqa: E402
from booster_tpu_torch.sampling.params import SamplingParams  # noqa: E402
from booster_tpu_torch.testing import torch_threads  # noqa: E402

B, V, RING = 3, 512, 64


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


def _logits(seed=0):
    x = (np.random.default_rng(seed).standard_normal((B, V)) * 3).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _history(seed=1):
    """A ring per slot: slot 0 half full, slots 1-2 wrapped past the ring."""
    rng = np.random.default_rng(seed)
    prev = np.full((B, RING), -1, np.int32)
    pos = np.asarray([RING // 2, RING + 17, 3 * RING + 5], np.int32)
    for b in range(B):
        for p in range(max(0, pos[b] - RING), pos[b]):
            prev[b, p % RING] = rng.integers(0, 40)  # few distinct ids: repeats
    return prev, pos


def _same(got: torch.Tensor, want):
    want = np.asarray(want, np.float32)
    got = got.numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    kept = np.isfinite(want)
    np.testing.assert_allclose(got[kept], want[kept], rtol=1e-6, atol=0)


def test_history_ring_and_window_match():
    ids = list(range(5, 5 + 80))  # longer than the ring: it wraps
    jst = js.make_seeded_state(B, RING, 7, ids)
    tst = ts.make_seeded_state(B, RING, 7, ids, "cpu")
    for step in range(3):
        tok = np.asarray([100 + step, 200 + step, 300 + step], np.int32)
        jst = js.accept_token(jst, jnp.asarray(tok))
        tst = ts.accept_token(tst, torch.from_numpy(tok))
    np.testing.assert_array_equal(tst.prev_tokens.numpy(), np.asarray(jst.prev_tokens))
    np.testing.assert_array_equal(tst.prev_pos.numpy(), np.asarray(jst.prev_pos))
    for last_n in (-1, 0, 5, RING):
        np.testing.assert_array_equal(
            ts.history_window_mask(tst.prev_tokens, tst.prev_pos, last_n).numpy(),
            np.asarray(js.history_window_mask(jst.prev_tokens, jst.prev_pos, last_n)))


@pytest.mark.parametrize("repeat,freq,present,last_n", [
    (1.3, 0.0, 0.0, -1), (1.1, 0.2, 0.1, 8), (1.0, 0.5, 0.0, 0), (0.8, 0.0, 0.4, RING)])
def test_penalties_match(repeat, freq, present, last_n):
    jl, tl = _logits()
    prev, pos = _history()
    want = js.apply_penalties(jl, jnp.asarray(prev), repeat, freq, present,
                              prev_pos=jnp.asarray(pos), last_n=last_n)
    got = ts.apply_penalties(tl, torch.from_numpy(prev), repeat, freq, present,
                             prev_pos=torch.from_numpy(pos), last_n=last_n)
    _same(got, want)
    assert not np.array_equal(np.asarray(want), np.asarray(jl)) or last_n == 0


@pytest.mark.parametrize("name,arg", [
    ("top_k_filter", 40), ("top_k_filter", 1), ("top_p_filter", 0.9),
    ("top_p_filter", 0.3), ("min_p_filter", 0.05), ("min_p_filter", 0.3),
    ("tfs_filter", 0.95), ("tfs_filter", 0.5), ("typical_filter", 0.9),
    ("typical_filter", 0.2)])
def test_filter_matches(name, arg):
    jl, tl = _logits(seed=2)
    want = getattr(js, name)(jl, arg)
    got = getattr(ts, name)(tl, arg)
    _same(got, want)
    kept = np.isfinite(np.asarray(want)).sum(-1)
    assert (kept < V).all() and (kept >= 1).all()  # the filter really cut


@pytest.mark.parametrize("kw", [
    dict(temp=0.7), dict(temp=1.0, dynatemp_range=0.5),
    dict(temp=0.8, dynatemp_range=0.6, dynatemp_exponent=2.0)])
def test_temperature_matches(kw):
    jl, tl = _logits(seed=3)
    _same(ts.apply_temp(tl, SamplingParams(**kw)), js.apply_temp(jl, JSP(**kw)))


@pytest.mark.parametrize("seq", ["kfypmt", "tmpyfk"])
def test_filter_chain_matches(seq):
    kw = dict(temp=0.9, top_k=100, top_p=0.9, min_p=0.02, tfs_z=0.97, typical_p=0.95,
              dynatemp_range=0.3, samplers_sequence=seq)
    jl, tl = _logits(seed=4)
    want, p = jl, JSP(**kw)
    for ch in seq:  # the chain of booster_tpu.sampling.samplers.sample
        want = {"k": lambda x: js.top_k_filter(x, p.top_k),
                "f": lambda x: js.tfs_filter(x, p.tfs_z),
                "y": lambda x: js.typical_filter(x, p.typical_p),
                "p": lambda x: js.top_p_filter(x, p.top_p),
                "m": lambda x: js.min_p_filter(x, p.min_p),
                "t": lambda x: js.apply_temp(x, p)}[ch](want)
    _same(ts.apply_filters(tl, SamplingParams(**kw)), want)
