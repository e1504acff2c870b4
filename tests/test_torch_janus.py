"""The port's Janus sampling (booster_tpu_torch/sampling/janus.py) against
the JAX package's on the CPU: the byte-level classifiers on a corpus of
pieces, the per-vocab tables on the SPM and the byte-level BPE test
vocabularies, and the shaped logits and shortlist of a step.

The reference draws with ``jax.random.categorical`` under ``jax.vmap``;
the test replaces that draw (the ``jax`` name inside the reference's module
only) by an argmax over the shortlist plus a fixed numpy Gumbel array, and
keeps the shortlist it was given.  The port's shortlist takes the same
noise.  Tolerances: the shaped logits within 1e-6 relative (log1p and pow
of two libraries may differ in the last f32 bit); the shortlists equal but
for at most one entry a row, an entry within 1e-6 of the cutoff (counted),
and the drawn tokens equal where the shortlists are."""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, ".")

from booster_tpu.gguf import GGUFReader as JReader  # noqa: E402
from booster_tpu.sampling import SamplingParams as JSP  # noqa: E402
from booster_tpu.sampling import janus as jjanus  # noqa: E402
from booster_tpu.tokenizer import Tokenizer as JTokenizer  # noqa: E402
from booster_tpu_torch.gguf import GGUFReader  # noqa: E402
from booster_tpu_torch.sampling import SamplingParams  # noqa: E402
from booster_tpu_torch.sampling import janus as tjanus  # noqa: E402
from booster_tpu_torch.tokenizer import Tokenizer  # noqa: E402
from booster_tpu_torch.testing import make_model  # noqa: E402
from booster_tpu_torch.testing import torch_threads  # noqa: E402

V = 512
SHAPE_TOL = 1e-6

CORPUS = [
    b"", b" ", b"  ", b"    ", b"\n", b"\n\n", b"\t", b",", b".", b"-", b":", b";", b"(", b")",
    b" (", b").", b" )", b" \xe2\x80\x94",  # " —"
    b"hello", b" Hello", b"World", b" the", b"a", b"Z", b"x1", b"_",
    "привет".encode(), " Привет".encode(), "ёж".encode(), " Ёлка".encode(), "яблоко".encode(),
    "щ".encode(), "Ё".encode(), "été".encode(), " naïve".encode(), "日本語".encode(),
    " 中文".encode(), "한국".encode(), "😀".encode(), " 😀a".encode(), "αβγ".encode(),
    "mixed слово".encode(), " рус eng".encode(),
    b"0", b"42", b" 7", b"-3", b"+15", b"\t\n 99", b"1.5", b"12a", b" +", b" -", b" *", b" =",
    b"{", b"}", b"[", b"]", b" {", b" }", b" [", b" ]", b"<|end_of_text|>", b"```", b"``",
    b"\xd0", b"\xd1", b"\xd0\x41", b"\xd1\x92", b"\xc3", b"\xe3\x81", b"\xf0", b"\x80\x81",
    b"\xff\xfe", b"\xd0\x81", b"\xd1\x91", b"\xd0\xb0", b"\xd1\x8f", b"\xd0\xaf",
] + [bytes(np.random.default_rng(s).integers(0, 256, s % 7 + 1, dtype=np.uint8))
     for s in range(200)]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


def test_byte_classifiers_equal():
    for p in CORPUS:
        assert tjanus.tok_type(p) == jjanus.tok_type(p), p
        assert tjanus.is_lower(p) == jjanus.is_lower(p), p
        assert tjanus.is_pedantic(p) == jjanus.is_pedantic(p), p
    assert np.array_equal(tjanus._PROBES, jjanus._PROBES)
    # every class occurs in the corpus
    assert {tjanus.tok_type(p) for p in CORPUS} == {0, 2, 3, 4, 20, 30, 40}


@pytest.fixture(scope="module", params=["spm", "bpe"])
def tokenizers(request, tmp_path_factory):
    """Both packages' tokenizers of one test vocabulary: the SPM vocab of
    ``make_model``, or its seeded byte-level BPE vocab (arch mpt)."""
    path = str(tmp_path_factory.mktemp("janus") / f"{request.param}.gguf")
    kw = dict(arch="mpt", heads=4, kv_heads=4) if request.param == "bpe" else {}
    make_model(path, vocab_size=V, hidden=256, layers=1, ff=256, **kw)
    out = []
    for reader_cls, tok_cls in ((GGUFReader, Tokenizer), (JReader, JTokenizer)):
        r = reader_cls(path)
        try:
            out.append(tok_cls.from_gguf_metadata(r.metadata))
        finally:
            r.close()
    return out


@pytest.mark.parametrize("scale", [None, 0.9])
def test_tables_equal(tokenizers, scale):
    tt, jt = tokenizers
    kw = {} if scale is None else {"janus_scale": scale}
    a = tjanus.JanusTables.build(tt, SamplingParams(**kw))
    b = jjanus.JanusTables.build(jt, JSP(**kw))
    for f in ("scales", "types", "pedantic", "factors"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.eos_id == b.eos_id
    # the per-request scale recomputed from the factors, as the engines do
    assert np.array_equal(a.scales_for(0.8), (1.0 - (1.0 - 0.8) * b.factors).astype(np.float32))


def _case(seed, B=4, N=256):
    """Random logits, rings, counts and tables that reach every branch: rows
    whose newest token is Russian, repeats inside and outside the depth
    window, a first sample (nothing generated yet), negative top logits."""
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((B, V)).astype(np.float32)
    logits = 8.0 + 0.2 * noise  # ratios near the cutoffs: long shortlists
    logits[1] = 3 * noise[1] - 20.0  # every logit negative
    logits[2] = 3 * noise[2]  # mixed signs
    classes = np.array([0, 2, 3, 4, 20, 30, 40], np.int32)
    types_ = classes[rng.integers(0, len(classes), V)]
    pedantic = rng.random(V) < 0.1
    factors = rng.choice(np.float32([0.0, 0.1, 0.2, 0.3, 0.5, 1.0]), V).astype(np.float32)
    scales = (1.0 - (1.0 - 0.97) * factors).astype(np.float32)
    prompt_len = rng.integers(1, 40, B).astype(np.int32)
    gen = np.array([0, 5, 150, 260])[:B].astype(np.int32)
    prev_pos = prompt_len + gen
    ring = np.full((B, N), -1, np.int32)
    for b in range(B):
        for p in range(max(0, int(prev_pos[b]) - N), int(prev_pos[b])):
            ring[b, p % N] = rng.integers(0, 24)  # few distinct tokens: repeats
    ru = np.flatnonzero(types_ == 3)
    ring[3, (prev_pos[3] - 1) % N] = ru[0]  # row 3's newest token is Russian
    return logits, ring, prev_pos, prompt_len, scales, types_, pedantic, factors


class _CaptureJax(types.SimpleNamespace):
    """The reference module's `jax` with its draw replaced: vmap of the
    categorical draw keeps the shortlist and returns argmax(shortlist + g)."""

    def __init__(self, gumbel, seen):
        super().__init__()
        self._g, self._seen = gumbel, seen

    def __getattr__(self, name):
        return getattr(jax, name)

    def vmap(self, fn, *a, **kw):
        def draw(keys, shortlist):
            self._seen.append(np.asarray(shortlist))
            return jnp.argmax(shortlist + jnp.asarray(self._g), axis=-1)
        return draw


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("params", [{}, {"janus_depth": 10, "janus_hi": 0.95, "janus_lo": 0.9}])
def test_shortlist_matches_reference(seed, params, monkeypatch):
    logits, ring, prev_pos, prompt_len, scales, types_, pedantic, factors = _case(seed)
    B = logits.shape[0]
    gumbel = -np.log(-np.log(np.random.default_rng(100 + seed).random((B, V)))).astype(
        np.float32)
    seen: list = []
    monkeypatch.setattr(jjanus, "jax", _CaptureJax(gumbel, seen))
    tok_j = np.asarray(jjanus.janus_sample(
        jnp.asarray(logits), jnp.asarray(ring), jnp.asarray(prev_pos), jnp.asarray(prompt_len),
        128, jnp.asarray(scales), jnp.asarray(types_), jnp.asarray(pedantic), 2,
        JSP(janus=1, **params), jnp.zeros((B, 2), jnp.uint32)))
    (short_j,) = seen
    given = logits.copy()
    short_t = tjanus.janus_shortlist(
        torch.from_numpy(logits), torch.from_numpy(ring), torch.from_numpy(prev_pos),
        torch.from_numpy(prompt_len), 128, torch.from_numpy(scales), torch.from_numpy(types_),
        torch.from_numpy(pedantic), 2, SamplingParams(janus=1, **params)).numpy()
    assert np.array_equal(logits, given)  # the caller's logits are not written
    keep_j, keep_t = np.isfinite(short_j), np.isfinite(short_t)
    both = keep_j & keep_t
    assert both.any(axis=1).all()
    np.testing.assert_allclose(short_t[both], short_j[both], rtol=SHAPE_TOL, atol=0)
    differ = keep_j != keep_t
    assert (differ.sum(axis=1) <= 1).all(), differ.sum(axis=1)
    for b, v in zip(*np.nonzero(differ)):  # at the cutoff: the ratio within 1e-6 of it
        top = short_j[b][keep_j[b]].max()
        ratio = float(np.where(keep_j[b, v], short_j[b, v], short_t[b, v])) / top
        sp = SamplingParams(janus=1, **params)
        assert min(abs(ratio - c) for c in (sp.janus_hi, sp.janus_lo)) <= SHAPE_TOL, (b, v)
    tok_t = np.argmax(short_t + gumbel, axis=-1)
    for b in range(B):
        if not differ[b].any():
            assert tok_t[b] == tok_j[b], b
    # the shaping did something: the rows whose top is positive were cut
    # (row 1's top is negative: every ratio is >= 1, nothing is cut), and
    # some shortlists hold many tokens
    n = keep_j.sum(1)
    assert n[1] == V and (n[[0, 2, 3]] < V).all() and n[[0, 2, 3]].max() > 8, n
    assert not np.allclose(short_j[both], np.broadcast_to(logits, short_j.shape)[both])


def test_janus_sample_draws_from_the_shortlist():
    """The draw of ``janus_sample``: a token of the shortlist, at the slot's
    Philox stream (its step advanced), accepted into the ring; with hi = lo
    = 1 and a positive top logit, the top token itself."""
    from booster_tpu_torch.sampling.samplers import make_seeded_state

    logits, ring, prev_pos, prompt_len, scales, types_, pedantic, _ = _case(3)
    tabs = dict(tables_scales=torch.from_numpy(scales), tables_types=torch.from_numpy(types_),
                tables_pedantic=torch.from_numpy(pedantic), eos_id=2)
    for hi_lo, rows in ((0.96, range(4)), (1.0, [0])):
        sp = SamplingParams(janus=1, janus_hi=hi_lo, janus_lo=hi_lo)
        st = make_seeded_state(1, 256, 7, [5, 6, 7], "cpu")
        for b in rows:
            lg = torch.from_numpy(logits[b:b + 1])
            short = tjanus.janus_shortlist(lg, st.prev_tokens, st.prev_pos, st.prompt_len, 64,
                                           params=sp, **tabs)
            tok, st = tjanus.janus_sample(lg, st, 64, sp, **tabs)
            assert torch.isfinite(short[0, int(tok[0])])
            assert int(st.prev_tokens[0, (int(st.prev_pos[0]) - 1) % 256]) == int(tok[0])
            if hi_lo == 1.0:
                assert float(short.max()) > 0 and int(tok[0]) == int(short.argmax())
        assert int(st.step[0]) == len(rows)
