"""The port's paged serving mode (``Engine(paged=True)``) on the CPU: against
the JAX package's paged engine (Pallas kernels in interpret mode) on the same
synthetic GGUF, and against the port's own dense engine, as
tests/test_paged_engine.py holds the reference's; and the port's scheduler
against the JAX package's, dense and paged.

Tolerances: greedy tokens equal; logits within 2^-5 of the largest, as in
tests/test_torch_batch.py (the packages round bf16 intermediates at other
places, and an int8 row may then land on the other side of a step).  This
model's logits (weight scale 0.3) put the top-2 margins far above that."""

import asyncio
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
from booster_tpu.ops import pallas_paged_attention as ppa  # noqa: E402
from booster_tpu.ops.paged_kv import PagedKVCache as JPaged  # noqa: E402
from booster_tpu.sampling import SamplingParams as JSP  # noqa: E402
from booster_tpu.serving import Engine as JEngine  # noqa: E402
from booster_tpu_torch.models import load_model  # noqa: E402
from booster_tpu_torch.models.llama import forward  # noqa: E402
from booster_tpu_torch.ops.paged_kv import PagedKVCache  # noqa: E402
from booster_tpu_torch.sampling import SamplingParams  # noqa: E402
from booster_tpu_torch.serving import Engine  # noqa: E402
from booster_tpu_torch.serving.config import PromptSpec  # noqa: E402
from booster_tpu_torch.serving.scheduler import Scheduler  # noqa: E402
from booster_tpu_torch.testing import make_model  # noqa: E402
from booster_tpu_torch.testing import torch_threads  # noqa: E402

LOGIT_TOL = 2 ** -5
GREEDY = SamplingParams(temp=0.0, penalty_repeat=1.0)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    return make_model(str(tmp_path_factory.mktemp("pe") / "t.gguf"), vocab_size=512, hidden=256,
                      layers=2, heads=4, kv_heads=2, ff=512, weight_scale=0.3)


@pytest.fixture(scope="module")
def model(gguf):
    return load_model(gguf, device="cpu", weights="bf16")


@pytest.fixture
def pallas():
    jlinear.set_use_pallas(True)
    pa.INTERPRET = pk.INTERPRET = ppa.INTERPRET = True
    try:
        yield
    finally:
        jlinear.set_use_pallas(None)
        pa.INTERPRET = pk.INTERPRET = ppa.INTERPRET = False
        jax.clear_caches()


def _batched_generate(eng, sp, prompts, n_steps=10):
    eng.init_batch_state()
    for s in prompts:
        eng.reset_slot(s, sp, seed=s)
    first = eng.prefill_slots(dict(prompts))
    out = {s: [first[s]] for s in prompts}
    last = dict(first)
    for _ in range(n_steps):
        toks, _ = eng.decode_slots(last, n_steps=1)
        for s in prompts:
            out[s].extend(toks[s])
            last[s] = toks[s][-1]
    return out


def _prompts(tok):
    return {s: tok.encode(t) for s, t in enumerate(["hello world", "one two three the end"])}


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_engine_matches_jax(gguf, model, pallas, quantized):
    """Greedy tokens through the slot API, page size 128 (the stacked paged
    path: the merged kernel in the reference, the plain paged attention and
    append here), then the logits of a teacher-forced prefill and two decode
    steps over pools with the same scattered tables."""
    jm = j_load(gguf, weights="bf16")
    kw = dict(max_batch=2, max_seq=256, kv_quantized=quantized, paged=True, page_size=128)
    want = _batched_generate(JEngine(jm, **kw), JSP(temp=0.0, penalty_repeat=1.0),
                             _prompts(jm.tokenizer))
    got = _batched_generate(Engine(model, **kw), GREEDY, _prompts(model.tokenizer))
    assert len(want[1]) == 11 and got == want

    cfg = model.cfg
    table = np.array([[3, 1], [2, 4]], np.int32)
    jc = JPaged.create(cfg.n_layers, 2, 256, cfg.n_kv_heads, cfg.head_dim, quantized=quantized,
                       page_size=128, n_pages=5)
    jc = JPaged(k=jc.k, v=jc.v, table=jnp.asarray(table), lengths=jc.lengths,
                k_scale=jc.k_scale, v_scale=jc.v_scale)
    tc = PagedKVCache.create(cfg.n_layers, 2, 256, cfg.n_kv_heads, cfg.head_dim, "cpu",
                             quantized=quantized, page_size=128, n_pages=5)
    tc.table.copy_(torch.from_numpy(table))
    rows = list(_prompts(model.tokenizer).values())
    arr = np.zeros((2, 16), np.int32)
    for b, ids in enumerate(rows):
        arr[b, :len(ids)] = ids
    nv = np.array([len(r) for r in rows], np.int32)
    jl, jc = j_forward(jm.params, jm.cfg, jnp.asarray(arr), jc, gather_idx=jnp.asarray(nv - 1),
                       n_valid=jnp.asarray(nv))
    tl, tc = forward(model.params, cfg, torch.from_numpy(arr), tc,
                     gather_idx=torch.from_numpy(nv - 1), n_valid=torch.from_numpy(nv))
    for step in range(3):
        err = np.abs(tl.numpy() - np.asarray(jl)).max()
        assert err <= LOGIT_TOL * np.abs(np.asarray(jl)).max(), (step, err)
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        jl, jc = j_forward(jm.params, jm.cfg, jnp.asarray(nxt), jc, last_only=True)
        tl, tc = forward(model.params, cfg, torch.from_numpy(nxt), tc, last_only=True)
    assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist() == (nv + 3).tolist()


@pytest.mark.parametrize("page_size", [16, 128])
def test_paged_matches_dense(model, page_size):
    """bf16 pool: the paged engine gives the dense engine's greedy tokens, with
    pages of 16 rows (decode through the gathered views, as the reference's
    XLA path) and of 128 (the stacked paged path)."""
    dense = _batched_generate(Engine(model, max_batch=2, max_seq=256), GREEDY,
                              _prompts(model.tokenizer))
    paged = _batched_generate(Engine(model, max_batch=2, max_seq=256, paged=True,
                                     page_size=page_size), GREEDY, _prompts(model.tokenizer))
    assert paged == dense


@pytest.mark.parametrize("quantized", [False, True])
def test_gathered_paged_decode_matches_jax(gguf, model, quantized):
    """Pages of 16 rows: both packages decode through slot-dense views
    gathered from the pool (the reference's XLA path); teacher-forced logits
    agree within the tolerance over a prefill and 6 steps.  (Greedy tokens
    are not compared here: at int8 this model has a near tie at step 3 that
    the two packages' bf16 roundings break differently.)"""
    jm = j_load(gguf, weights="bf16")
    cfg = model.cfg
    table = np.zeros((2, 16), np.int32)
    table[:, :2] = [[3, 1], [2, 4]]
    jc = JPaged.create(cfg.n_layers, 2, 256, cfg.n_kv_heads, cfg.head_dim, quantized=quantized,
                       page_size=16, n_pages=5)
    jc = JPaged(k=jc.k, v=jc.v, table=jnp.asarray(table), lengths=jc.lengths,
                k_scale=jc.k_scale, v_scale=jc.v_scale)
    tc = PagedKVCache.create(cfg.n_layers, 2, 256, cfg.n_kv_heads, cfg.head_dim, "cpu",
                             quantized=quantized, page_size=16, n_pages=5)
    tc.table.copy_(torch.from_numpy(table))
    rows = list(_prompts(model.tokenizer).values())
    arr = np.zeros((2, 16), np.int32)
    for b, ids in enumerate(rows):
        arr[b, :len(ids)] = ids
    nv = np.array([len(r) for r in rows], np.int32)
    jl, jc = j_forward(jm.params, jm.cfg, jnp.asarray(arr), jc, gather_idx=jnp.asarray(nv - 1),
                       n_valid=jnp.asarray(nv))
    tl, tc = forward(model.params, cfg, torch.from_numpy(arr), tc,
                     gather_idx=torch.from_numpy(nv - 1), n_valid=torch.from_numpy(nv))
    for step in range(7):
        err = np.abs(tl.numpy() - np.asarray(jl)).max()
        assert err <= LOGIT_TOL * np.abs(np.asarray(jl)).max(), (step, err)
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        jl, jc = j_forward(jm.params, jm.cfg, jnp.asarray(nxt), jc, last_only=True)
        tl, tc = forward(model.params, cfg, torch.from_numpy(nxt), tc, last_only=True)


def test_prefix_pages_shared(model):
    """A second job with the same prompt maps the published pages instead of
    prefilling them; releasing it does not free the pages still in use."""
    eng = Engine(model, max_batch=2, max_seq=256, paged=True, page_size=16)
    eng.init_batch_state()
    ids = eng.tokenizer.encode("the quick brown fox " * 12)
    assert len(ids) >= 33
    eng.reset_slot(0, GREEDY, seed=0)
    first_a = eng.prefill_slots({0: ids})
    eng.publish_slot_prefix(0, ids)
    pages_a = list(eng._slot_pages[0])
    eng.reset_slot(1, GREEDY, seed=1)
    restored = eng.adopt_prefix(1, ids)
    assert restored >= 2 * 16 and eng.prefix_hits == 1
    assert eng._slot_pages[1] == pages_a[:restored // 16]
    assert (eng.page_alloc.refcount[eng._slot_pages[1]] >= 2).all()
    assert eng.cache.table[1, :restored // 16].tolist() == pages_a[:restored // 16]
    first_b = eng.prefill_slots({1: ids[restored:]}, full_history={1: ids})
    assert first_b[1] == first_a[0]
    eng.reset_slot(1, GREEDY, seed=2)
    assert (eng.page_alloc.refcount[pages_a[:restored // 16]] == 1).all()
    assert eng.cache.table[1].tolist() == [0] * eng.cache.table.shape[1]


def test_prefix_survives_release(model):
    """Published pages stay resident after their slot is reset and are
    revived by the next matching admit."""
    eng = Engine(model, max_batch=1, max_seq=256, paged=True, page_size=16)
    eng.init_batch_state()
    ids = eng.tokenizer.encode("alpha beta gamma delta " * 12)
    eng.reset_slot(0, GREEDY, seed=0)
    eng.prefill_slots({0: ids})
    eng.publish_slot_prefix(0, ids)
    eng.reset_slot(0, GREEDY, seed=1)
    assert eng.adopt_prefix(0, ids) >= 16


def test_trim_after_prefill(model):
    """The prefill bucket's padding pages are given back."""
    eng = Engine(model, max_batch=1, max_seq=256, paged=True, page_size=16)
    eng.init_batch_state()
    eng.reset_slot(0, GREEDY, seed=0)
    ids = eng.tokenizer.encode("hello world and the end of the story")
    eng.prefill_slots({0: ids})
    assert len(eng._slot_pages[0]) == -(-len(ids) // 16)
    assert (eng.cache.table[0] != 0).sum() == len(eng._slot_pages[0])


def test_paged_context_shift_matches_dense(model):
    """The paged shift (gather → dense shift → scatter into fresh private
    pages) gives the dense shift's tokens."""
    results = []
    ids = model.tokenizer.encode("hello world one two three four " * 16)[:230]
    for paged in (False, True):
        eng = Engine(model, max_batch=1, max_seq=256, paged=paged, page_size=128)
        eng.init_batch_state()
        eng.reset_slot(0, GREEDY, seed=0)
        first = eng.prefill_slots({0: ids})
        out, last, shifts = [first[0]], first[0], 0
        for _ in range(30):
            if int(eng.slot_lengths[0]) + 1 >= eng.max_seq - 1:
                eng.shift_slot(0, n_keep=4)
                shifts += 1
            toks, _ = eng.decode_slots({0: last}, n_steps=1)
            out.extend(toks[0])
            last = toks[0][-1]
        assert shifts == 1 and int(eng.slot_lengths[0]) < eng.max_seq
        if paged:
            assert len(eng._slot_pages[0]) == -(-int(eng.slot_lengths[0]) // 128)
        results.append(out)
    assert results[0] == results[1]


def test_scheduler_paged(model):
    """Concurrent jobs through the scheduler on a paged engine finish and
    give the dense engine's tokens; the prompts' pages are published."""
    base = "the quick brown fox jumps over the lazy dog " * 4
    prompts = [base + "one", base + "two", base + "three"]

    def run(paged: bool):
        eng = Engine(model, max_batch=2, max_seq=256, paged=paged, page_size=16, decode_chunk=4)

        async def go():
            sched = Scheduler(eng, prompt_spec=PromptSpec(id="default"), default_sampling=GREEDY,
                              default_max_tokens=8, prefix_cache_bytes=0)
            sched.start()
            jobs = [sched.place_job(prompt=p, full_prompt=p) for p in prompts]
            for j in jobs:
                await sched.wait_job(j.id, timeout=300)
            await sched.shutdown(drain=False)
            return jobs

        return asyncio.run(go()), eng

    paged_jobs, paged_eng = run(True)
    dense_jobs, _ = run(False)
    for jp, jd in zip(paged_jobs, dense_jobs):
        assert jp.status == "finished" and jp.token_ids == jd.token_ids
    assert paged_eng.page_alloc.stats()["hashed"] > 0
    assert paged_eng.prefix_hits >= 1  # the third prompt shares the first's full pages


@pytest.mark.parametrize("paged", [False, True])
def test_scheduler_matches_jax(gguf, model, pallas, paged):
    """The same jobs through the JAX package's scheduler and the port's
    (greedy, a shared prompt prefix, a stop string, a job capped by
    max_tokens): the same tokens, outputs and finish reasons."""
    from booster_tpu.serving.config import PromptSpec as JPromptSpec
    from booster_tpu.serving.scheduler import Scheduler as JScheduler

    jm = j_load(gguf, weights="bf16")
    base = "the quick brown fox jumps over the lazy dog " * 3
    specs = [dict(prompt=base + "one"), dict(prompt=base + "two", max_tokens=3),
             dict(prompt="hello world", stop=("e",))]

    def run(sched_cls, spec_cls, eng, sp):
        async def go():
            sched = sched_cls(eng, prompt_spec=spec_cls(id="default"), default_sampling=sp,
                              default_max_tokens=8)
            sched.start()
            jobs = [sched.place_job(**kw) for kw in specs]
            for j in jobs:
                await sched.wait_job(j.id, timeout=300)
            await sched.shutdown(drain=False)
            return [(j.token_ids, j.output, j.finish_reason, j.n_prompt_tokens) for j in jobs]

        return asyncio.run(go())

    kw = dict(max_batch=2, max_seq=256, paged=paged, page_size=128, decode_chunk=4)
    want = run(JScheduler, JPromptSpec, JEngine(jm, **kw), JSP(temp=0.0, penalty_repeat=1.0))
    got = run(Scheduler, PromptSpec, Engine(model, **kw), GREEDY)
    assert got == want
    assert len(want[1][0]) == 3 and want[0][2] in ("stop", "length")
