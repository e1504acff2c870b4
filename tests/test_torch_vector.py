"""The port's per-slot vectorized sampler against the JAX package's
(``booster_tpu.sampling.vector``) on the same numpy logits, history and
heterogeneous per-slot params: the params arrays, the filter queue's kept
sets over the shortlist (with and without the tail-free/typical filters),
the full-vocabulary filter, the top-k/top-p/min-p cutoff, dynatemp and the
greedy tokens after per-row penalties.  The draws use another generator
(Philox4x32-10 keyed by the slot's seed at its step count) than JAX's PRNG
keys, so they are checked for what they promise: the Philox known answers,
a slot's draws independent of the other slots, masked rows untouched, and
draws only from the kept set.

Tolerances: kept sets and greedy tokens must be equal; temperatures and
cutoffs agree to rtol 1e-6 (the same f32 operations, which XLA may fuse or
sum in another order)."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, ".")

from booster_tpu.sampling import samplers as js  # noqa: E402
from booster_tpu.sampling import vector as jv  # noqa: E402
from booster_tpu.sampling.params import SamplingParams as JSP  # noqa: E402
from booster_tpu_torch.sampling import samplers as ts  # noqa: E402
from booster_tpu_torch.sampling import vector as tv  # noqa: E402
from booster_tpu_torch.sampling.params import SamplingParams  # noqa: E402
from booster_tpu_torch.testing import torch_threads  # noqa: E402

V, RING = 512, 64
PARAMS = [  # one row per slot: every filter on somewhere, off somewhere
    dict(temp=0.8, top_k=40, top_p=0.95, min_p=0.05),
    dict(temp=0.0, top_k=0, top_p=1.0, min_p=0.0, penalty_repeat=1.3, penalty_last_n=16),
    dict(temp=1.2, top_k=100, top_p=0.7, min_p=0.0, tfs_z=0.9, penalty_freq=0.3),
    dict(temp=0.7, top_k=0, top_p=1.0, min_p=0.1, typical_p=0.8, dynatemp_range=0.4),
    dict(temp=0.0, top_k=5, top_p=0.5, min_p=0.2, penalty_present=0.8, penalty_last_n=-1),
    dict(temp=1.0, top_k=0, top_p=1.0, min_p=0.0, dynatemp_range=0.3, dynatemp_exponent=2.0),
    dict(temp=0.9, top_k=300, top_p=0.99, min_p=0.01, tfs_z=0.97, typical_p=0.95,
         penalize_nl=False, penalty_repeat=1.1),
]
B = len(PARAMS)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


def _vps():
    return (jv.VectorSampling.from_params([JSP(**p) for p in PARAMS]),
            tv.VectorSampling.from_params([SamplingParams(**p) for p in PARAMS]))


def _logits(seed=0):
    x = (np.random.default_rng(seed).standard_normal((B, V)) * 3).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _states(seed=1, recent=None):
    """Seeded history rings; `recent` [B] tokens end each row's history."""
    rng = np.random.default_rng(seed)
    jst = js.make_sampler_state(B, RING)
    tst = ts.make_sampler_state(B, RING)
    for b in range(B):
        ids = [int(t) for t in rng.integers(0, 30, int(rng.integers(0, 3 * RING)))]
        if recent is not None:
            ids += [int(recent[b])] * 2
        jst = js.seed_prompt_row(jst, b, ids)
        ts.seed_prompt_row(tst, b, ids)
    return jst, tst


def test_params_and_state_rows_match():
    jvp, tvp = _vps()
    jvp = jvp.set_slot(3, JSP(temp=0.3, top_k=7, typical_p=0.5))
    tvp.set_slot(3, SamplingParams(temp=0.3, top_k=7, typical_p=0.5))
    for f in ("temp", "top_k", "top_p", "min_p", "tfs_z", "typical_p", "dynatemp_range",
              "dynatemp_exponent", "penalty_repeat", "penalty_freq", "penalty_present",
              "penalty_last_n", "penalize_nl"):
        np.testing.assert_array_equal(getattr(tvp, f).numpy(), np.asarray(getattr(jvp, f)), f)
    jst, tst = _states()
    for f in ("prev_tokens", "prev_pos", "prompt_len"):
        np.testing.assert_array_equal(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)), f)


@pytest.mark.parametrize("features", [(), ("exttail",)])
def test_chain_keep_and_temperature_match(features):
    jvp, tvp = _vps()
    x = np.random.default_rng(2).standard_normal((B, V)).astype(np.float32) * 3
    srt = -np.sort(-x, axis=-1)[:, :256]  # one shortlist fed to both
    jk = np.asarray(jv._chain_keep(jnp.asarray(srt), jvp, features))
    tk = tv._chain_keep(torch.from_numpy(srt), tvp, features)
    np.testing.assert_array_equal(tk.numpy(), jk)
    assert (jk.sum(-1) < 256).any() and (jk.sum(-1) >= 1).all()
    slg = np.where(jk, srt, -np.inf).astype(np.float32)
    np.testing.assert_allclose(
        tv.effective_temp(torch.from_numpy(slg), tvp, features).numpy(),
        np.asarray(jv.effective_temp(jnp.asarray(slg), jvp, features)), rtol=1e-6)


def test_chain_filter_and_cutoff_match():
    jvp, tvp = _vps()
    jl, tl = _logits(3)
    want = np.asarray(jv.chain_filter(jl, jvp, ("exttail",)))
    got = tv.chain_filter(tl, tvp, ("exttail",)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert np.isfinite(got[5]).all()  # a row with no subset filter keeps the vocabulary
    np.testing.assert_allclose(tv.chain_cutoff(tl, tvp).numpy(),
                               np.asarray(jv.chain_cutoff(jl, jvp)), rtol=1e-6)


@pytest.mark.parametrize("features", [(), ("fullv", "exttail")])
def test_greedy_rows_with_penalties_match(features):
    jvp, tvp = _vps()
    jl, tl = _logits(4)
    jst, tst = _states(recent=torch.argmax(tl, -1))  # penalize each row's argmax
    nl = 7
    jtok, jst = jv.sample_vectorized(jl, jst, jvp, features=features, nl_token=nl)
    ttok, tst = tv.sample_vectorized(tl, tst, tvp, features=features, nl_token=nl)
    greedy = np.asarray([p["temp"] <= 0 for p in PARAMS])
    np.testing.assert_array_equal(ttok.numpy()[greedy], np.asarray(jtok)[greedy])
    # the penalties moved the greedy choice of a row (the check has teeth)
    plain = torch.argmax(tl, -1).numpy()
    assert (plain[greedy] != ttok.numpy()[greedy]).any()
    np.testing.assert_array_equal(tst.prev_pos.numpy(), np.asarray(jst.prev_pos))
    np.testing.assert_array_equal(tst.prev_tokens.numpy()[greedy],
                                  np.asarray(jst.prev_tokens)[greedy])


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10."""
    m = 0xFFFFFFFF
    for ctr, key, want in [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((m, m, m, m), (m, m), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]:
        got = ts.philox4x32(tuple(torch.tensor([c]) for c in ctr),
                            tuple(torch.tensor([k]) for k in key))
        assert tuple(int(g) for g in got) == want


def test_slot_draws_independent_of_other_slots():
    _, tvp = _vps()
    _, tst = _states()
    _, tl = _logits(5)
    mask = torch.tensor([True, True, False, True, True, True, True])
    tok, st = tv.sample_vectorized(tl, tst, tvp, mask=mask, features=("exttail",))
    # the other slots change logits, params and masks; slot 3 does not
    # (slot 0 now samples the whole vocabulary: the batch takes "fullv")
    _, tvp2 = _vps()
    for s in (1, 2, 4, 5, 6):
        tvp2.set_slot(s, SamplingParams(temp=1.5, top_k=3))
    tvp2.set_slot(0, SamplingParams(temp=1.0, top_k=0, top_p=1.0, min_p=0.0))
    _, tst2 = _states()
    tl2 = tl.clone()
    tl2[[0, 1, 2, 4, 5, 6]] = torch.randn(6, V)
    mask2 = torch.tensor([True, True, True, True, False, True, False])
    tok2, st2 = tv.sample_vectorized(tl2, tst2, tvp2, mask=mask2,
                                     features=("exttail", "fullv"))
    assert tok[3] == tok2[3]
    assert st.step[3] == st2.step[3] == 1
    assert torch.equal(st.prev_tokens[3], st2.prev_tokens[3])
    # a masked row draws nothing and keeps its ring and step
    _, fresh = _states()
    assert st.step[2] == 0 and st.prev_pos[2] == fresh.prev_pos[2]
    assert torch.equal(st.prev_tokens[2], fresh.prev_tokens[2])


def test_draws_follow_the_kept_distribution():
    """Inverse-CDF draws at evenly spaced uniforms land on each kept token
    in proportion to its probability and never on an excluded one."""
    lg = torch.tensor([[2.0, float("-inf"), 0.0, 1.0, float("-inf")]])
    n = 20000
    u = (torch.arange(n, dtype=torch.float32) + 0.5) / n
    idx = ts.draw_categorical(lg.expand(n, -1), u)
    freq = torch.bincount(idx, minlength=5).float() / n
    assert freq[1] == 0 and freq[4] == 0
    torch.testing.assert_close(freq, torch.softmax(lg[0], -1), atol=1e-3, rtol=0)
    assert (ts.philox_uniform(torch.tensor([5, 5, 6]), torch.tensor([0, 1, 0])) < 1).all()
