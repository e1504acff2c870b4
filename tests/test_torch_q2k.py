"""The port's Q2_K path (llama.cpp's Q2_K mix) against the JAX package on the
CPU, the reference's Pallas kernels in interpret mode: the Q2_K and Q3_K
formats and repacks bit for bit (the K-major transpose and its bf16 planes
too: four for Q2_K, the halves' scales then their mins; two for Q3_K, with
a zero of 4 and scales of either sign), the 4-bit K-major matmul and fused
gate-up at group 16 through their plain versions (the group-dot form at
M = 1, the dequantize form at M = 2 and 16), the CPU mirrors of the
kernels' sum orders at group 16 and their wrong kernels, ``make_model``'s
Q2_K mix as both loaders read it, and 2-layer Q2_K-mix models: hidden 512,
4 heads of 128 over 1 kv head (n_head / n_head_kv = 4: attn_v Q4_K, k's N
of 128 transposable), ff 1024, vocab 512, a Q6_K head; and over 2 kv heads
(a ratio of 2: attn_v Q3_K), at the weight scale the random blocks are sized
for (0.05).

Tolerances: matmul outputs are f32 sums of the same exact products in
another order, within 2e-4 of the largest output; each wrong kernel (the
mins dropped or with the wrong sign, a scale row of the wrong half-group,
group sums over 32 k where 16 are due, the zero term dropped) must land 8x
past that.  Gate-up outputs are bf16: |port - reference| <= 2^-7
|reference| + 1e-5 max|reference| per element.  Logits at 2^-5 of their
largest magnitude (tests/test_torch_model.py); decode is compared with the
reference's M = 2 form of the row, as tests/test_torch_q5k.py does."""

import importlib.util
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
from booster_tpu.ops import pallas_moe as pm  # noqa: E402
from booster_tpu.ops import pallas_qmm as pq  # noqa: E402
from booster_tpu.ops.kv_cache import KVCache as JCache  # noqa: E402
from booster_tpu.quant import dequantize as jdequantize  # noqa: E402
from booster_tpu.quant import qtensor as jqt  # noqa: E402
from booster_tpu.quant import quantize as jquantize  # noqa: E402
from booster_tpu.quant import repack_gguf_tensor as jrepack  # noqa: E402
from booster_tpu.sampling import SamplingParams as JSP  # noqa: E402
from booster_tpu.serving import Engine as JEngine  # noqa: E402
from booster_tpu_torch.gguf import GGMLType as TT  # noqa: E402
from booster_tpu_torch.gguf import GGUFReader  # noqa: E402
from booster_tpu_torch.models import load_model, params_from_numpy  # noqa: E402
from booster_tpu_torch.models.llama import forward  # noqa: E402
from booster_tpu_torch.models.loader import _kernel_layout  # noqa: E402
from booster_tpu_torch.ops import qmm as tq  # noqa: E402
from booster_tpu_torch.ops.kv_cache import KVCache  # noqa: E402
from booster_tpu_torch.quant import dequantize as tdequantize  # noqa: E402
from booster_tpu_torch.quant import qtensor as tqt  # noqa: E402
from booster_tpu_torch.quant import quantize as tquantize  # noqa: E402
from booster_tpu_torch.sampling import SamplingParams  # noqa: E402
from booster_tpu_torch.serving import Engine  # noqa: E402
from booster_tpu_torch.testing import (I4T_MIRROR_MUTANTS, make_model, q2k_mix,  # noqa: E402
                                       qmm_i4t_mutants, qmm_i4t_mv_split, qmm_i4t_split,
                                       qmm_mins_mutants, random_blocks)
from booster_tpu_torch.testing import torch_threads  # noqa: E402

QMM_TOL = 2e-4
LOGIT_TOL = 2 ** -5
MAX_SEQ = 128
C, L = 512, 2  # the small models' hidden width and layers
PROMPT = "hello world the and of to in"
FORMATS = ("Q2_K", "Q3_K")
assert JT.Q2_K == TT.Q2_K and JT.Q3_K == TT.Q3_K


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


@pytest.fixture
def interpret():
    pq.INTERPRET = True
    try:
        yield
    finally:
        pq.INTERPRET = False
        jax.clear_caches()


@pytest.fixture
def pallas():
    jlinear.set_use_pallas(True)
    pq.INTERPRET = pa.INTERPRET = pk.INTERPRET = pm.INTERPRET = True
    try:
        yield
    finally:
        jlinear.set_use_pallas(None)
        pq.INTERPRET = pa.INTERPRET = pk.INTERPRET = pm.INTERPRET = False
        jax.clear_caches()


def _close(got, want, tol):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _x(m, k, seed=5):
    x = np.random.default_rng(seed + m).standard_normal((m, k)).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _blocks(qt, n, k, seed):
    """Real bytes of an [n, k] weight of type `qt` (``testing.random_blocks``:
    Q2_K's min term as large as its scaled term, Q3_K's scales of either
    sign)."""
    return np.frombuffer(random_blocks(np.random.default_rng(seed), n * k, TT[qt], 0.05),
                         np.uint8)


def _i4t_pair(qt, n, k, seed):
    """The same real Q2_K or Q3_K blocks through both packages' repacks and
    K-major layouts (i4t at group 16, bf16 planes), the planes bit-equal."""
    raw = _blocks(qt, n, k, seed)
    j = jqt.compact_scales(jqt.transpose_qtensor(jqt.prepare_kernel_scales(
        jrepack(raw, JT[qt], (n, k)))))
    t = _kernel_layout(tqt.to_torch(tqt.repack_gguf_tensor(raw, TT[qt], (n, k)), "cpu"))
    assert t.kind == j.kind == "i4t" and t.group == j.group == 16
    assert np.array_equal(t.scales.view(torch.int16).numpy(), np.asarray(j.scales).view(np.int16))
    return jax.tree.map(jnp.asarray, j), t


# -- the formats and the repacks ---------------------------------------------


@pytest.mark.parametrize("qt", FORMATS)
@pytest.mark.parametrize("rows,cols,scale", [(64, 512, 0.05), (3, 1024, 3.0)])
def test_format_bit_equal(qt, rows, cols, scale):
    x = np.random.default_rng(rows).standard_normal((rows, cols)).astype(np.float32) * scale
    x[0, :256] = 0.0  # an all-zero super-block: d = dmin = 0
    x[1, 256:512] = np.abs(x[1, 256:512])  # no element below zero
    x[2, :16] = -np.abs(x[2, :16]) - 0.01  # an all-negative group
    raw = jquantize(x, JT[qt])
    assert tquantize(x, TT[qt]) == raw
    assert np.array_equal(tdequantize(raw, TT[qt], shape=(rows, cols)),
                          jdequantize(raw, JT[qt], shape=(rows, cols)))


@pytest.mark.parametrize("qt", FORMATS)
@pytest.mark.parametrize("on_torch", [False, True])
def test_repack_and_planes_bit_equal(qt, on_torch):
    """The torch repack, on numpy bytes (the host) or on a torch tensor (the
    path of a repack on the card), against the reference's
    (``_repack_q2_k``: i4p at group 16, codes 0..3, f32 scales and mins;
    ``_repack_q3_k``: codes 0..7, zero 4, signed f32 scales, no mins); then
    the K-major layout against the reference's transpose: four bf16 planes
    [4, K/32, N] for Q2_K, two for Q3_K; and the dequantized values."""
    n, k = 128, 1024
    raw = _blocks(qt, n, k, 1)
    j = jrepack(raw, JT[qt], (n, k))
    src = torch.frombuffer(bytearray(raw), dtype=torch.uint8) if on_torch else raw
    t = tqt.repack_gguf_tensor(src, TT[qt], (n, k), device="cpu" if on_torch else None)
    zero = 4 if qt == "Q3_K" else 0
    assert (t.kind, t.group, t.zero) == (j.kind, j.group, j.zero) == ("i4p", 16, zero)
    as_np = (lambda a: a.numpy()) if on_torch else (lambda a: a)
    assert as_np(t.qw).dtype == np.uint8 and np.array_equal(as_np(t.qw), np.asarray(j.qw))
    codes = np.concatenate([as_np(t.qw) & 15, as_np(t.qw) >> 4])
    assert codes.max() == (3 if qt == "Q2_K" else 7)
    assert as_np(t.scales).dtype == np.float32
    assert np.array_equal(as_np(t.scales), np.asarray(j.scales))
    if qt == "Q2_K":
        assert np.array_equal(as_np(t.mins), np.asarray(j.mins))
    else:
        assert t.mins is None and j.mins is None
        assert (as_np(t.scales) < 0).any() and (as_np(t.scales) > 0).any()
    jk = jqt.compact_scales(jqt.transpose_qtensor(jqt.prepare_kernel_scales(j)))
    tk = _kernel_layout(t if on_torch else tqt.to_torch(t, "cpu"))
    assert tk.kind == jk.kind == "i4t" and tk.zero == jk.zero == zero
    assert np.array_equal(tk.qw.numpy(), np.asarray(jk.qw))
    s3, has_mins = tqt.kernel_scales(tk)
    js3, jmins = jqt.kernel_scales(jk)
    R = 4 if qt == "Q2_K" else 2
    assert has_mins == jmins == (qt == "Q2_K")
    assert s3.shape == (R, k // 32, n) and s3.dtype == torch.bfloat16
    assert np.array_equal(s3.view(torch.int16).numpy(), np.asarray(js3).view(np.int16))
    want = jqt.dequantize_qtensor_np(j)
    assert np.array_equal(tqt.dequantize(tqt.to_torch(t, "cpu"), torch.float32).numpy(), want)
    assert np.array_equal(want, jdequantize(raw, JT[qt], shape=(n, k)))


def test_random_blocks_are_sized_as_real_ones():
    """Q2_K: the mean min within 20 % of the mean scaled code (a weight is
    the difference of two terms of one size); Q3_K: scales of both signs;
    both centre near zero at about the spread of weight_scale normals."""
    t = tqt.repack_gguf_tensor(_blocks("Q2_K", 256, 1024, 2), TT.Q2_K, (256, 1024))
    q = np.concatenate([t.qw & 15, t.qw >> 4], axis=1).astype(np.float32).reshape(256, 64, 16)
    assert abs(t.mins.mean() / (q * t.scales[:, :, None]).mean() - 1) < 0.2
    for qt in FORMATS:
        t = tqt.repack_gguf_tensor(_blocks(qt, 256, 1024, 3), TT[qt], (256, 1024))
        w = tqt.dequantize(tqt.to_torch(t, "cpu"), torch.float32)
        assert abs(float(w.mean())) < 0.1 * float(w.abs().mean())
        assert 0.03 < float(w.std()) < 0.1


# -- the 4-bit K-major forms at group 16 ---------------------------------------


@pytest.mark.parametrize("qt", FORMATS)
@pytest.mark.parametrize("m", [1, 2, 16])
def test_i4t_group_16_matmul_matches_pallas(qt, m, interpret):
    """``_tqmm_i4_gd_kernel`` (M = 1) and ``_tqmm_i4_kernel`` (M = 2, 16) at
    group 16 on real Q2_K (mins) and Q3_K (zero 4) planes of a [256, 512]
    weight against the port's plain version and the CPU mirror of the
    kernel's sum order at its plan's splits; the wrong kernels 8x past the
    limit."""
    n, k = 256, C
    jw, tw = _i4t_pair(qt, n, k, seed=10 + m)
    xj, xt = _x(m, k)
    assert tq._supported_t(tw, k, m) and pq._supported_t(jw, k, m)
    want = np.asarray(pq._tqmm_i4(xj, jw))
    _close(tq.qmm(xt, tw).numpy(), want, QMM_TOL)
    plan = tq.i4t_mv_plan(k, n, 16) if m == 1 else tq.i4t_plan(m, k, n)[1]
    mirror = qmm_i4t_mv_split if m == 1 else qmm_i4t_split
    _close(mirror(xt, tw, plan).numpy(), want, QMM_TOL)
    plain = tq.qmm_plain(xt, tw)
    limit = QMM_TOL * float(plain.abs().max())
    seen = {what: float((tq.qmm_plain(xm, wm) - plain).abs().max()) / limit
            for what, (xm, wm) in {**qmm_i4t_mutants(xt, tw, (0, 1)),
                                   **qmm_mins_mutants(xt, tw)}.items()}
    assert ("mins dropped" in seen) == (qt == "Q2_K") and ("zero ignored" in seen) == (qt == "Q3_K")
    assert min(seen.values()) >= 8, seen


@pytest.mark.parametrize("qt", FORMATS)
@pytest.mark.parametrize("m", [1, 2, 16])
def test_i4t_group_16_gateup_matches_pallas(qt, m, interpret):
    """The fused gate-up at group 16 (``_gateup_i4_gd_kernel`` at M = 1,
    ``_gateup_i4_kernel`` above) at ff 256 over K 512: Q2_K (the path's
    gate-up) and Q3_K (zero 4, which the kernels take too); equal to the
    unfused matmul + silu·mul bit for bit."""
    ff, k = 256, C
    jw, tw = _i4t_pair(qt, 2 * ff, k, seed=20 + m)
    xj, xt = _x(m, k, seed=7)
    want = pq.qmm_gateup(xj, jw, "silu")
    assert want is not None
    got = tq.qmm_gateup(xt, tw)
    assert got is not None and got.shape == (m, ff)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=2 ** -7,
                               atol=1e-5 * np.abs(np.asarray(want, np.float32)).max())
    gu = tq.qmm(xt, tw).to(torch.bfloat16)
    assert torch.equal(got, tq.silu(gu[:, :ff]) * gu[:, ff:])


@pytest.mark.parametrize("qt", FORMATS)
@pytest.mark.parametrize("m,ks", [(1, 1), (1, 4), (1, 8), (2, 1), (16, 2), (64, 4)])
def test_group_16_mirrors_within_limit_and_mutants_past_it(qt, m, ks):
    """The CPU mirrors of csrc/i4mv.cuh (M = 1) and of qmm_i4t.cu's tile (M
    > 1, a stage two groups of each half) at group 16 within 2e-4 of the
    largest output of qmm_plain at several split counts; each mutant of a
    group-16 term lands 8x past it: a scale row of the wrong half-group (a
    stage's, or a pair's, first group's rows for both groups), group sums
    over 32 k where 16 are due (where the sums are used: the mins, or at
    M = 1 the zero term), the zero term dropped (Q3_K)."""
    K, N = 2048, 256
    w = _kernel_layout(tqt.to_torch(tqt.repack_gguf_tensor(
        _blocks(qt, N, K, 30 + m), TT[qt], (N, K)), "cpu"))
    _, x = _x(m, K, seed=31)
    mirror = qmm_i4t_mv_split if m == 1 else qmm_i4t_split
    want = tq.qmm_plain(x, w)
    limit = QMM_TOL * float(want.abs().max())
    assert float((mirror(x, w, ks) - want).abs().max()) <= limit
    seen = {}
    for what in I4T_MIRROR_MUTANTS:
        if what == "zero term dropped" and not w.zero:
            continue
        if what == "group sums over 32 k" and qt == "Q3_K" and m > 1:
            continue  # the tile's zero is in its unpack: no group sum to take
        seen[what] = float((mirror(x, w, ks, mutant=what) - want).abs().max()) / limit
    assert len(seen) == (3 if qt == "Q3_K" and m == 1 else 2), seen
    assert min(seen.values()) >= 8, seen


def test_plans_split_group_16_weights_on_whole_groups():
    """The tile's splits run on whole stages of 32 payload rows (two groups
    of 16 of each half), whatever the group; the matvec's on whole groups of
    16 (K/32 of each half), at the Llama-3-8B shapes of the Q2_K mix: 6
    splits for q, wo and down, 8 for k."""
    for K, N, ks in ((4096, 4096, 6), (4096, 1024, 8), (14336, 4096, 6)):
        assert tq.i4t_mv_plan(K, N, 16) == ks
    for M, K, N in ((16, 4096, 4096), (64, 14336, 4096), (128, 4096, 28672)):
        bm, ks = tq.i4t_plan(M, K, N)
        nst = K // 64
        spans = [(s + 1) * nst // ks - s * nst // ks for s in range(ks)]
        assert sum(spans) == nst and min(spans) >= 8  # at least 512 columns of K a split


# -- the model ----------------------------------------------------------------


def _q2k(path, kv_heads):
    """A 2-layer llama file in llama.cpp's Q2_K mix."""
    return make_model(path, vocab_size=512, hidden=C, layers=L, heads=4, kv_heads=kv_heads,
                      ff=1024, quant=TT.Q2_K, output_quant=TT.Q6_K,
                      tensor_quant=q2k_mix(4, kv_heads), weight_scale=0.05)


@pytest.fixture(scope="module", params=[1, 2], ids=["kv1", "kv2"])
def models(request, tmp_path_factory):
    kv = request.param
    path = _q2k(str(tmp_path_factory.mktemp(f"q2k{kv}") / "t.gguf"), kv)
    return kv, path, j_load(path, weights="native"), load_model(path, device="cpu",
                                                                weights="native")


def test_file_is_the_q2_k_mix(models):
    """token_embd, attn_q, attn_k, ffn_gate and ffn_up Q2_K; attn_v Q4_K at
    n_head / n_head_kv = 4, Q3_K at 2; attn_output and ffn_down Q3_K; the
    head Q6_K."""
    kv, path, _, _ = models
    reader = GGUFReader(path)
    try:
        types_ = {name.split(".", 2)[-1] if name.startswith("blk.") else name: info.ggml_type
                  for name, info in reader.tensors.items() if len(info.shape) == 2}
    finally:
        reader.close()
    v = TT.Q4_K if kv == 1 else TT.Q3_K
    assert types_ == {"token_embd.weight": TT.Q2_K, "output.weight": TT.Q6_K,
                      "attn_q.weight": TT.Q2_K, "attn_k.weight": TT.Q2_K, "attn_v.weight": v,
                      "attn_output.weight": TT.Q3_K, "ffn_gate.weight": TT.Q2_K,
                      "ffn_up.weight": TT.Q2_K, "ffn_down.weight": TT.Q3_K}


def test_smoke_8b_file_takes_the_q2_k_mix():
    """chip_smoke.py's Llama-3-8B Q2_K file names its per-tensor types: they
    are q2k_mix's at its heads (32 over 8 kv heads, a ratio of 4: attn_v
    Q4_K), with a Q6_K head."""
    spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = smoke.LLAMA3_8B_Q2K
    assert {k: TT[v] for k, v in cfg["tensor_quant"].items()} == q2k_mix(
        cfg["heads"], cfg["kv_heads"])
    assert (cfg["heads"], cfg["kv_heads"], cfg["output_quant"]) == (32, 8, "Q6_K")


def test_loader_kinds_equal_reference(models):
    """Both loaders: q, k and v unfused (their kinds, groups or zeros
    differ), every weight K-major i4t (group 16 with mins for q, k and the
    gate-up; group 16, zero 4 for wo and down; v Q4_K's group 32 with mins,
    or Q3_K's), the head i8t at group 16; payloads and planes bit for bit."""
    kv, _, jm, tm = models
    carried = params_from_numpy(jax.tree.map(np.asarray, jm.params), tm.cfg, device="cpu")
    want = {"wq": (16, 0, 4), "wk": (16, 0, 4),
            "wv": (32, 0, 4) if kv == 1 else (16, 4, 2), "wo": (16, 4, 2),
            "w_gateup": (16, 0, 4), "w_down": (16, 4, 2)}
    for params in (jm.params, tm.params):
        assert "wqkv" not in params["layers"]
    assert set(want) <= set(tm.params["layers"]) and set(want) <= set(jm.params["layers"])
    for key, (group, zero, planes) in want.items():
        j, a, b = jm.params["layers"][key], carried["layers"][key], tm.params["layers"][key]
        assert (j.kind, j.group, j.zero) == (b.kind, b.group, b.zero) == ("i4t", group, zero), key
        assert b.scales.shape[1] == planes, key
        assert torch.equal(a.qw, b.qw), key
        assert torch.equal(a.scales.float(), b.scales.float()), key
    out = tm.params["output"]
    assert (out.kind, out.group, out.source_type) == ("i8t", 16, TT.Q6_K)
    assert jm.params["output"].kind == "i8t"
    assert torch.equal(carried["tok_embd"].view(torch.int16),
                       tm.params["tok_embd"].view(torch.int16))


def _teacher_forced(jm, tm, prompt, steps):
    """Prefill `prompt` in a 32-row batch, then `steps` decode steps fed the
    reference's greedy tokens, over a bf16 cache in both packages; returns
    per step the logits (port, reference).  The reference runs the slot
    twice (its decode at M = 2): its M = 1 rows sit further off its M > 1
    rows in interpret mode than the port's (ROADMAP.md, Queue 3)."""
    cfg = tm.cfg
    arr = np.zeros((1, 32), np.int32)
    arr[0, :len(prompt)] = prompt
    nv = np.asarray([len(prompt)], np.int32)
    tc = KVCache.create(cfg.n_layers, 1, MAX_SEQ, cfg.n_kv_heads, cfg.head_dim, "cpu")
    jc = JCache.create(cfg.n_layers, 2, MAX_SEQ, cfg.n_kv_heads, cfg.head_dim)
    tl, tc = forward(tm.params, cfg, torch.from_numpy(arr), tc, gather_idx=torch.from_numpy(nv - 1),
                     n_valid=torch.from_numpy(nv))
    jl, jc = j_forward(jm.params, jm.cfg, jnp.asarray(np.repeat(arr, 2, 0)), jc,
                       gather_idx=jnp.asarray(np.repeat(nv - 1, 2)), n_valid=jnp.asarray(
                           np.repeat(nv, 2)))
    out = [(tl.numpy()[0, -1], np.asarray(jl)[0, -1])]
    for _ in range(steps):
        nxt = np.full((2, 1), np.argmax(np.asarray(jl)[0, -1]), np.int32)
        tl, tc = forward(tm.params, cfg, torch.from_numpy(nxt[:1]), tc, last_only=True,
                         n_valid=torch.ones(1, dtype=torch.int32))
        jl, jc = j_forward(jm.params, jm.cfg, jnp.asarray(nxt), jc, last_only=True,
                           n_valid=jnp.ones(2, jnp.int32))
        out.append((tl.numpy()[0, -1], np.asarray(jl)[0, -1]))
    return out


def test_prefill_and_decode_logits_match(models, pallas, monkeypatch):
    """A 32-row prefill and 3 decode steps, prefill against prefill and
    decode against decode; the port's forms counted through their entries:
    q, k and v three matmuls a layer, the fused gate-up at every row
    count."""
    kv, _, jm, tm = models
    rows = {"i4t": [], "gateup": []}
    orig = (tq.qmm_i4t, tq.qmm_i4t_gateup)

    def spy(key, fn):
        def call(x, w, *act):
            rows[key].append((x.shape[0], w.group))
            return fn(x, w, *act)
        return call

    monkeypatch.setattr(tq, "qmm_i4t", spy("i4t", orig[0]))
    monkeypatch.setattr(tq, "qmm_i4t_gateup", spy("gateup", orig[1]))
    for got, want in _teacher_forced(jm, tm, tm.tokenizer.encode(PROMPT), steps=3):
        _close(got, want, LOGIT_TOL)
    gv = 32 if kv == 1 else 16
    per = lambda m: [(m, 16), (m, 16), (m, gv), (m, 16)]  # noqa: E731 (q, k, v, wo)
    step = lambda m: per(m) + [(m, 16)]  # noqa: E731 (+ down)
    assert rows["i4t"] == step(32) * L + step(1) * L * 3
    assert rows["gateup"] == [(32, 16)] * L + [(1, 16)] * L * 3


def test_generate_greedy_tokens_equal(models, pallas):
    _, _, jm, tm = models
    ids = tm.tokenizer.encode(PROMPT)
    want = JEngine(jm, max_batch=1, max_seq=MAX_SEQ, decode_chunk=4).generate(
        ids, JSP(temp=0.0), max_new_tokens=6)
    got = Engine(tm, max_batch=1, max_seq=MAX_SEQ, decode_chunk=4).generate(
        ids, SamplingParams(temp=0.0), max_new_tokens=6)
    assert len(want.token_ids) == 6
    assert got.token_ids == want.token_ids
