"""The port's Gemma path against the JAX package on the CPU, the reference's
Pallas kernels in interpret mode: a 2-layer Gemma-shaped GGUF (hidden 256, 2
heads of 256 over 1 kv head, so the q width 512 differs from hidden, as in
Gemma-7B; ff 512, vocab 512, Q4_0 layers, a Q6_K ``token_embd`` and no
``output.weight``) through both loaders and ``params_from_numpy``; the
gated-GELU gate-up (``qmm_gateup(x, w, "gelu")``) at M = 1 and M > 1; decode
attention over a 256-lane bf16 and int8 cache, chunked-prefill attention at
G = 2 and G = 8, and the all-layer appends at 256 lanes; the tied head; the
logits at prefill and decode over both caches; greedy tokens through
``Engine.generate`` and a 4-stream batch; and the CPU mirrors of the
256-lane kernels' sum orders, which must tell each new wrong kernel apart.

Tolerances: the gate-up's bf16 outputs |port - reference| <= 2^-7 |reference|
+ 1e-5 max|reference| per element (a g or u rounded the other way by f32
sums in another order, or an f32 tanh an ulp apart: XLA's and torch's
differ); attention the kernels' per-element limits
(``testing.decode_attn_limit``, ``prefill_attn_limit``); the appends bit for
bit; the tied head 1e-5 of its largest logit (f32 sums of the same exact
products); logits 2^-5 of the largest (tests/test_torch_model.py), decode
compared with decode; greedy tokens equal up to a reference near-tie
(tests/test_torch_mpt.py's rule)."""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, ".")

from booster_tpu.gguf import GGMLType as JT  # noqa: E402
from booster_tpu.models import load_model as j_load  # noqa: E402
from booster_tpu.models.llama import forward as j_forward  # noqa: E402
from booster_tpu.ops import linear as jlinear  # noqa: E402
from booster_tpu.ops import pallas_attention as pa  # noqa: E402
from booster_tpu.ops import pallas_kv as pk  # noqa: E402
from booster_tpu.ops import pallas_qmm as pq  # noqa: E402
from booster_tpu.ops.kv_cache import KVCache as JCache  # noqa: E402
from booster_tpu.quant import qtensor as jqt  # noqa: E402
from booster_tpu.quant import repack_gguf_tensor as jrepack  # noqa: E402
from booster_tpu.sampling import SamplingParams as JSP  # noqa: E402
from booster_tpu.serving import Engine as JEngine  # noqa: E402
from booster_tpu_torch.gguf import GGMLType as TT  # noqa: E402
from booster_tpu_torch.models import llama as tllama  # noqa: E402
from booster_tpu_torch.models import load_model, params_from_numpy  # noqa: E402
from booster_tpu_torch.models.llama import forward  # noqa: E402
from booster_tpu_torch.models.loader import _kernel_layout  # noqa: E402
from booster_tpu_torch.ops import decode_attention as tda  # noqa: E402
from booster_tpu_torch.ops import kv_append as tka  # noqa: E402
from booster_tpu_torch.ops import prefill_attention as tpa  # noqa: E402
from booster_tpu_torch.ops import qmm as tq  # noqa: E402
from booster_tpu_torch.ops.kv_cache import KVCache  # noqa: E402
from booster_tpu_torch.quant import qtensor as tqt  # noqa: E402
from booster_tpu_torch.sampling import SamplingParams  # noqa: E402
from booster_tpu_torch.serving import Engine  # noqa: E402
from booster_tpu_torch.testing import (decode_attn_case, decode_attn_limit,  # noqa: E402
                                       decode_attn_mutants, decode_attn_split, make_model,
                                       prefill_attn_case, prefill_attn_limit,
                                       prefill_attn_mutants, prefill_attn_split, random_blocks)
from booster_tpu_torch.testing import torch_threads  # noqa: E402

LOGIT_TOL = 2 ** -5
MAX_SEQ = 128
C, L, H, HKV, D, FF = 256, 2, 2, 1, 256, 512
PROMPT = "hello world and the end"
GEMMA = dict(vocab_size=512, hidden=C, layers=L, heads=H, kv_heads=HKV, head_dim=D, ff=FF,
             arch="gemma", embd_quant=TT.Q6_K, rms_eps=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    return make_model(str(tmp_path_factory.mktemp("gemma") / "gemma.gguf"), **GEMMA)


@pytest.fixture(scope="module")
def models(gguf):
    return j_load(gguf), load_model(gguf, device="cpu")


@pytest.fixture(scope="module")
def pallas():
    """The reference's Pallas path in interpret mode for the whole module."""
    jlinear.set_use_pallas(True)
    pq.INTERPRET = pa.INTERPRET = pk.INTERPRET = True
    try:
        yield
    finally:
        jlinear.set_use_pallas(None)
        pq.INTERPRET = pa.INTERPRET = pk.INTERPRET = False
        jax.clear_caches()


def _j(t: torch.Tensor, dtype=None):
    a = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return jnp.asarray(a, dtype) if dtype is not None else jnp.asarray(a)


def _np(a) -> np.ndarray:
    return np.asarray(a, np.float32)


# -- the configuration and the loaders ------------------------------------------


def test_config_loader_and_params_from_numpy(gguf, models):
    """Both packages read the file's Gemma quirks alike (the embedding scaled
    by sqrt(n_embd), RMSNorm by (1 + w), tanh-GELU, the tied head, head dim
    256 at 256 lanes, neox rope), load the Q6_K token table as the same
    dense bf16 table and no head; params_from_numpy carries the layers."""
    from booster_tpu_torch.gguf import GGUFReader

    jm, tm = models
    cfg = tm.cfg
    for f in ("arch", "act", "norm_eps_add_one", "tie_embeddings", "embedding_scale",
              "head_dim", "rope_style", "n_heads", "n_kv_heads", "n_ff"):
        assert getattr(cfg, f) == getattr(jm.cfg, f), f
    assert (cfg.arch, cfg.act, cfg.head_dim, cfg.rope_style) == ("gemma", "gelu", D, "neox")
    assert cfg.norm_eps_add_one and cfg.tie_embeddings and cfg.embedding_scale == C ** 0.5
    reader = GGUFReader(gguf)
    try:
        assert "output.weight" not in reader.tensors
        assert reader.tensors["token_embd.weight"].ggml_type == TT.Q6_K
        assert reader.metadata["gemma.attention.key_length"] == D
    finally:
        reader.close()
    assert tm.params["output"] is None and jm.params.get("output") is None
    emb = tm.params["tok_embd"]
    assert emb.dtype == torch.bfloat16 and emb.shape == (512, C)
    assert np.array_equal(emb.view(torch.int16).numpy(),
                          np.asarray(jm.params["tok_embd"]).view(np.int16))
    carried = params_from_numpy(jax.tree.map(np.asarray, jm.params), cfg, device="cpu")
    lay = tm.params["layers"]
    assert set(lay) == set(carried["layers"])
    for key, b in lay.items():
        a = carried["layers"][key]
        if hasattr(b, "qw"):
            assert (a.kind, a.shape) == (b.kind, b.shape) and torch.equal(a.qw, b.qw), key
        else:
            assert torch.equal(a, b), key
    assert lay["wqkv"].shape == ((H + 2 * HKV) * D, C) and lay["wo"].shape == (C, H * D)


@pytest.mark.parametrize("qt", ["Q6_K", "Q4_0", "Q8_0"])
def test_token_table_repacked_equals_the_host_dequantization(qt):
    """The card's load of a quantized token table (loader.dense_table: the
    torch repack, then dequantize, run here on CPU tensors) equals the
    host's numpy dequantization rounded to bf16, the reference's load, bit
    for bit."""
    from booster_tpu_torch.models.loader import _TABLE_REPACKS
    from booster_tpu_torch.quant import dequantize, repack_gguf_tensor
    from booster_tpu_torch.quant.qtensor import dequantize as dequantize_qtensor

    assert TT[qt] in _TABLE_REPACKS
    raw = np.frombuffer(random_blocks(np.random.default_rng(1), 96 * 512, TT[qt], 0.3), np.uint8)
    host = torch.from_numpy(dequantize(raw, TT[qt], shape=(96, 512))).to(torch.bfloat16)
    card = dequantize_qtensor(repack_gguf_tensor(torch.from_numpy(raw.copy()), TT[qt], (96, 512),
                                                 device="cpu"), torch.bfloat16)
    assert torch.equal(card.view(torch.int16), host.view(torch.int16))


def test_first_layers_of_a_file_load_as_a_shallower_file(gguf, models):
    """testing.load_first_layers (parity's 2-layer models read from a
    full-depth file): the first layer of the 2-layer file, as its own
    1-layer model."""
    from booster_tpu_torch.testing import load_first_layers

    _, tm = models
    one = load_first_layers(gguf, 1, device="cpu")
    assert one.cfg.n_layers == 1 and one.metadata["gemma.block_count"] == 1
    for key, v in one.params["layers"].items():
        full = tm.params["layers"][key]
        assert torch.equal(v.qw, full.qw[:1]) if hasattr(v, "qw") else torch.equal(v, full[:1])


def test_gemma2_and_unported_acts_refused(models):
    """gemma2's options (softcaps, windows, post norms) and a gated ReLU
    FFN raise "not ported yet", ReLU on an int8 gate-up too; GELU on an
    int8 gate-up runs where the reference would take its kernel (the
    whole int8 MLP takes GELU too: tests/test_torch_gemma_i8.py)."""
    _, tm = models
    for change in (dict(arch="gemma2"), dict(final_logit_softcap=30.0),
                   dict(attn_logit_softcap=50.0), dict(sliding_window=64),
                   dict(post_norms=True), dict(act="relu")):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            tllama._check_ported(dataclasses.replace(tm.cfg, **change))
    w = tqt.QTensor("i8t", torch.zeros(512, 512, dtype=torch.int8),
                    torch.ones(1, 16, 512, dtype=torch.bfloat16), None, 32, (512, 512),
                    TT.Q8_0)
    x = torch.zeros(1, 512, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tq.qmm_gateup(x, w, "relu")
    gen = torch.Generator().manual_seed(0)
    w = dataclasses.replace(w, qw=torch.randint(-127, 128, (512, 512), dtype=torch.int8,
                                                generator=gen))
    x = torch.linspace(-1, 1, 512).to(torch.bfloat16)[None]
    got = tq.qmm_gateup(x, w, "gelu")
    g = tq.qmm_plain(x, w).to(torch.bfloat16)
    assert torch.equal(got, tq.gelu(g[:, :256]) * g[:, 256:])
    assert got.shape == (1, 256) and bool(got.any())
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tq.act_mul(x, x, "relu")


# -- the gated-GELU gate-up -----------------------------------------------------


def _gateup_pair(K, ff, seed):
    """The same random Q4_0 blocks of a fused [2ff, K] gate-up through both
    packages' repacks and K-major layouts (i4t, bf16 planes)."""
    raw = np.frombuffer(random_blocks(np.random.default_rng(seed), 2 * ff * K, TT.Q4_0, 0.05),
                        np.uint8)
    j = jqt.compact_scales(jqt.transpose_qtensor(jqt.prepare_kernel_scales(
        jrepack(raw, JT.Q4_0, (2 * ff, K)))))
    t = _kernel_layout(tqt.to_torch(tqt.repack_gguf_tensor(raw, TT.Q4_0, (2 * ff, K)), "cpu"))
    assert t.kind == j.kind == "i4t"
    return jax.tree.map(jnp.asarray, j), t


@pytest.mark.parametrize("m", [1, 16])
def test_gelu_gateup_matches_reference(pallas, m):
    """qmm_gateup_plain(act="gelu") (the kernels' plain version, and the
    kernel-level entry on CPU tensors) against the reference's
    ``qmm_gateup(x, w, "gelu")`` (_gateup_i4_gd_kernel at M = 1,
    _gateup_i4_kernel above) at Gemma's tile widths, and the SiLU epilogue
    (the wrong kernel GELU → SiLU) 8x past the limit."""
    K, ff = 1024, 256  # the reference's gate wants 16 groups of each half a block
    jw, tw = _gateup_pair(K, ff, seed=m)
    x = (np.random.default_rng(m).standard_normal((m, K)) * 2).astype(np.float32)
    want = _np(jax.jit(lambda a: pq.qmm_gateup(a, jw, "gelu"))(jnp.asarray(x, jnp.bfloat16)))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = tq.qmm_gateup_plain(xt, tw, act="gelu")
    assert want.shape == (m, ff) and got.dtype == torch.bfloat16
    assert torch.equal(got, tq.qmm_i4t_gateup(xt, tw, "gelu"))
    assert torch.equal(got, tq.qmm_gateup(xt, tw, "gelu"))
    limit = 2 ** -7 * np.abs(want) + 1e-5 * np.abs(want).max()
    assert (np.abs(got.float().numpy() - want) <= limit).all()
    silu = tq.qmm_gateup_plain(xt, tw, act="silu").float().numpy()
    assert (np.abs(silu - want) / limit).max() >= 8


def test_gelu_matches_reference_act():
    """ops.qmm.gelu (the epilogue's op sequence) against the reference's
    ``_act(x, "gelu")`` compiled: within one bf16 ulp plus 2^-21 |x| (XLA's
    f32 tanh and torch's differ by an ulp or two, which a bf16 rounding
    turns into one ulp of a few elements, and which 1 + tanh z, near 0 for
    x below -3.7, leaves as an absolute error of a few 2^-24 |x|)."""
    from booster_tpu.models import llama as jllama

    x = (np.random.default_rng(0).standard_normal(4096) * 4).astype(np.float32)
    want = _np(jax.jit(lambda a: jllama._act(a, "gelu"))(jnp.asarray(x, jnp.bfloat16)))
    got = tq.gelu(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    assert (np.abs(got - want) <= ulp + 2.0 ** -21 * np.abs(x)).all()
    assert (got == want).mean() > 0.9


# -- attention and appends at 256 lanes ----------------------------------------------


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_decode_attention_256_lanes_matches_pallas(pallas, quantized):
    """Decode attention over a 256-lane cache (one kv head of 8 query heads,
    head dim 256) against the reference's decode_attention_stacked, and the
    kernel's CPU mirror (testing.decode_attn_split: 64-column stages over
    bf16, 128 over int8) within the limit at 1 and several slices, its
    wrong kernels (lanes 128-255 dropped among them) 8x past."""
    B, G = 3, 8
    args = decode_attn_case(2, B, 1, G, 256, D, D, [150, 1, 255], "cpu", seed=7,
                            quantized=quantized)
    q, kc, vc, layer, lens, win, _, sk, sv, ok, *sc = args
    want = tda.decode_attn_plain(*args)
    ref = pa.decode_attention_stacked(
        _j(q).reshape(B, 1, G, D), _j(kc), _j(vc), *(_j(s) for s in sc) if sc else (None, None),
        jnp.int32(layer), _j(lens), scale=1.0,
        self_kv=(_j(sk, jnp.bfloat16), _j(sv, jnp.bfloat16), _j(ok) > 0))
    ref = torch.from_numpy(np.array(ref, np.float32)).reshape(want.shape)
    limit = decode_attn_limit(args)
    assert ((ref - want).abs() <= limit).all()
    assert tda.stage_cols(D, quantized) == (128 if quantized else 64)
    for nsplit in (1, tda.decode_splits(1, 1, 1024, quantized, D)):
        assert ((decode_attn_split(args, nsplit) - want).abs() <= limit).all()
    mutants = decode_attn_mutants(args)
    assert "lanes 128-255 dropped" in mutants
    for what, margs in mutants.items():
        seen = float(((tda.decode_attn_plain(*margs) - want).abs() / limit).max())
        assert seen >= 8, (what, seen)


@pytest.mark.parametrize("G,T,pos0", [(2, 32, [0, 200]), (8, 32, [0, 70])])
def test_prefill_attention_256_lanes_matches_pallas(pallas, G, T, pos0):
    """Chunked-prefill attention over a 256-lane int8 cache at G = 2 and
    Gemma's G = 8 against the reference's prefill_attention (its fused gate
    takes D % 128 == 0), and the kernel's CPU mirror (64 query rows a block
    at 256 lanes) within the limit, the lanes 128-255 mutant 8x past."""
    B, S = len(pos0), 256
    n_valid = [T, T // 2]
    q, k, v, ks, vs, p0, lens, win, sc = args = prefill_attn_case(
        B, 1, G, T, S, D, D, pos0, n_valid, "cpu", seed=G)
    assert tpa.prefill_supported(T, S, D, G, 1) and tpa.block_rows(D) == 64
    want = tpa.prefill_attn_plain(*args)
    qx = q.reshape(B, 1, G, T, D).permute(0, 3, 1, 2, 4).reshape(B, T, G, D)
    ref = pa.prefill_attention(_j(qx), _j(k.reshape(B, 1, S, D)), _j(v.reshape(B, 1, S, D)),
                               _j(ks.reshape(B, 1, S, 1)), _j(vs.reshape(B, 1, S, 1)),
                               _j(lens), scale=1.0, pos0=_j(p0))
    ref = torch.from_numpy(np.array(ref, np.float32)).reshape(B, T, G, D).permute(0, 2, 1, 3)
    limit = prefill_attn_limit(args)
    for b in range(B):
        rows = slice(0, n_valid[b])
        assert ((ref[b][:, rows] - want[b][:, rows]).abs() <= limit[b][:, rows]).all()
    assert ((prefill_attn_split(args) - want).abs() <= limit).all()
    mutants = prefill_attn_mutants(args)
    assert "lanes 128-255 dropped" in mutants
    for what, margs in mutants.items():
        seen = float(((tpa.prefill_attn_plain(*margs) - want).abs() / limit).max())
        assert seen >= 8, (what, seen)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_all_layer_append_256_lanes_matches_pallas(pallas, quantized):
    """The all-layer append into a 256-lane cache (2 layers of 4 slots) bit
    for bit against the reference's kv_append_all_layers on the rows both
    define."""
    Lc, B, S = 2, 4, 128
    rng = np.random.default_rng(11)
    kc = rng.standard_normal((Lc, B, 1, S, D)).astype(np.float32)
    nk = (rng.standard_normal((2, Lc, B, 1, D)) * 3).astype(np.float32)
    nk[0, 0, 0] = 0  # a zero row
    off = np.asarray([0, 77, 127, 300], np.int32)  # the last clamps to S - 1
    if quantized:
        from booster_tpu_torch.ops.kv_cache import _quantize_kv

        q, s = _quantize_kv(torch.from_numpy(kc))
        cache = [q, q.clone(), s, s.clone()]
    else:
        cache = [torch.from_numpy(kc).to(torch.bfloat16), torch.from_numpy(-kc).to(
            torch.bfloat16), None, None]
    new = torch.from_numpy(nk).to(torch.bfloat16)
    want = pk.kv_append_all_layers(*(_j(c) if c is not None and c.dtype != torch.bfloat16
                                     else None if c is None else _j(c, jnp.bfloat16)
                                     for c in cache[:2]), _j(new[0], jnp.bfloat16),
                                   _j(new[1], jnp.bfloat16), jnp.asarray(off),
                                   *(() if not quantized else (_j(cache[2]), _j(cache[3]))))
    tka.kv_append(cache[0], cache[1], new[0], new[1], torch.from_numpy(off), cache[2], cache[3])
    for b in range(B):
        rows = slice(0, min(off[b], S - 1) + 1)
        for got, w in zip(cache, want):
            if got is None:
                continue
            np.testing.assert_array_equal(got[:, b, :, rows].float().numpy(),
                                          _np(w)[:, b, :, rows])


def test_tied_head_matches_reference(models):
    """The tied head (``models.llama.tied_head``: bf16 x against the bf16
    table, f32 accumulation and output) against the reference's
    dot_general with preferred_element_type f32, within 1e-5 of the
    largest logit (f32 sums in another order)."""
    jm, tm = models
    x = np.random.default_rng(3).standard_normal((2, 3, C)).astype(np.float32)
    want = _np(jax.lax.dot_general(jnp.asarray(x, jnp.bfloat16),
                                   jm.params["tok_embd"].astype(jnp.bfloat16),
                                   (((2,), (1,)), ((), ())), preferred_element_type=jnp.float32))
    got = tllama.tied_head(torch.from_numpy(x).to(torch.bfloat16), tm.params["tok_embd"])
    assert got.dtype == torch.float32 and got.shape == (2, 3, 512)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


# -- the model --------------------------------------------------------------------


def _prefill_decode(jm, tm, steps, quantized):
    """Prefill of the prompt (a 16-row bucket) then `steps` T = 1 steps fed
    the reference's greedy token, over a cache of MAX_SEQ rows, both
    packages: [(port logits, reference logits)] of the live slot."""
    cfg = tm.cfg
    ids = tm.tokenizer.encode(PROMPT)
    n, T, B = len(ids), 16, 2
    arr = np.zeros((B, T), np.int32)
    arr[0, :n] = ids
    nv = np.zeros(B, np.int32)
    nv[0] = n
    g = np.maximum(nv - 1, 0)
    jc = JCache.create(L, B, MAX_SEQ, HKV, D, quantized=quantized)
    jl, jc = j_forward(jm.params, jm.cfg, jnp.asarray(arr), jc, gather_idx=jnp.asarray(g),
                       n_valid=jnp.asarray(nv))
    tc = KVCache.create(L, B, MAX_SEQ, HKV, D, "cpu", quantized=quantized)
    assert tc.k.shape[-1] == D
    tl, tc = forward(tm.params, cfg, torch.from_numpy(arr), tc, gather_idx=torch.from_numpy(g),
                     n_valid=torch.from_numpy(nv))
    out = [(tl.numpy()[:1], np.asarray(jl)[:1])]
    step = (nv > 0).astype(np.int32)
    for _ in range(steps):
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


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_prefill_and_decode_logits_match(models, pallas, monkeypatch, quantized):
    """Prefill (over the int8 cache through the fused chunked prefill at
    256 lanes) and 2 decode steps (the stacked decode attention at 256
    lanes, the all-layer append after the loop), prefill against prefill,
    decode against decode."""
    jm, tm = models
    calls = []
    orig = tllama.decode_attention_stacked
    monkeypatch.setattr(tllama, "decode_attention_stacked",
                        lambda *a, **kw: calls.append(a[1].shape[-1]) or orig(*a, **kw))
    for got, want in _prefill_decode(jm, tm, steps=2, quantized=quantized):
        _close(got, want)
    assert calls == [D] * (2 * L)


def _greedy_equal_or_near_tie(got: list, want: list, ref_logits):
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
        ids, JSP(temp=0.0), max_new_tokens=5)
    got = Engine(tm, max_batch=1, max_seq=MAX_SEQ, decode_chunk=4).generate(
        ids, SamplingParams(temp=0.0), max_new_tokens=5)
    assert len(want.token_ids) == 5
    _greedy_equal_or_near_tie(got.token_ids, want.token_ids,
                              lambda i: _prefill_decode(jm, tm, i, False)[i][1][0, -1])


def _run_batch(eng, sp_cls, tok, slots, steps):
    eng.init_batch_state()
    prompts = {}
    for s in slots:
        eng.reset_slot(s, sp_cls(temp=0.0), seed=s)
        prompts[s] = tok.encode(f"stream {s} the end")
    first = eng.prefill_slots(prompts)
    toks, _ = eng.decode_slots(first, n_steps=steps)
    return first, toks, np.asarray(eng.cache.lengths).tolist()


def test_batch_4_streams_greedy_tokens_equal(models, pallas):
    """4 streams of the batched slot API over an int8 cache (the fused
    prefill and the 256-lane decode kernels' plain versions): each stream's
    tokens equal the reference's, the cache lengths too."""
    jm, tm = models
    slots = [0, 1, 2, 3]
    jfirst, jtoks, jlen = _run_batch(
        JEngine(jm, max_batch=4, max_seq=MAX_SEQ, kv_quantized=True, decode_chunk=2), JSP,
        jm.tokenizer, slots, 2)
    first, toks, lengths = _run_batch(
        Engine(tm, max_batch=4, max_seq=MAX_SEQ, kv_quantized=True, decode_chunk=2),
        SamplingParams, tm.tokenizer, slots, 2)
    assert lengths == jlen
    for s in slots:
        assert [first[s]] + toks[s] == [jfirst[s]] + jtoks[s], s


def test_cli_one_shot_and_server_refused(gguf, capsys, monkeypatch):
    """``python -m booster_tpu_torch`` runs the Gemma file one-shot on the
    CPU; ``--server --paged-kv --kv-quant`` on it (a 256-lane page pool,
    which no longer raises) sets up and warms up its paged engine and hands
    the scheduler to ``serve``; and a paged engine on the Gemma model under
    the scheduler and the HTTP server (``ServerThread``) answers one chat
    completion."""
    import json
    from http.client import HTTPConnection

    from booster_tpu_torch.__main__ import main
    from booster_tpu_torch.serving import server as srv_mod
    from booster_tpu_torch.serving.config import PromptSpec
    from booster_tpu_torch.serving.scheduler import Scheduler

    assert main(["--model", gguf, "--prompt", "hello", "--n-predict", "3", "--device", "cpu",
                 "--context", "128"]) == 0
    assert capsys.readouterr().out.strip() != ""
    handed = []

    class Served(Exception):
        pass

    async def serve(scheduler, *a, **kw):
        handed.append(scheduler)
        raise Served

    monkeypatch.setattr(srv_mod, "serve", serve)
    with pytest.raises(Served):
        main(["--model", gguf, "--server", "--device", "cpu", "--context", "256", "--slots",
              "2", "--paged-kv", "--kv-quant", "--page-size", "128"])
    eng = handed[0].engine
    assert eng.paged and eng.cache.k.shape[-1] == D and eng.cache.k.dtype == torch.int8
    monkeypatch.undo()
    eng = Engine(load_model(gguf, device="cpu"), max_batch=2, max_seq=MAX_SEQ, paged=True,
                 page_size=128, kv_quantized=True, decode_chunk=4)
    sched = Scheduler(eng, prompt_spec=PromptSpec(id="default"),
                      default_sampling=SamplingParams(temp=0.0), default_max_tokens=4)
    srv = srv_mod.ServerThread(sched, model_name="gemma")
    try:
        conn = HTTPConnection("127.0.0.1", srv.port, timeout=120)
        conn.request("POST", "/v1/chat/completions", body=json.dumps(
            {"messages": [{"role": "user", "content": "hello"}], "max_tokens": 4}))
        r = conn.getresponse()
        body = json.loads(r.read())
        conn.close()
    finally:
        srv.stop()
    assert r.status == 200 and 1 <= body["usage"]["completion_tokens"] <= 4
