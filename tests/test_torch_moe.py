"""The port's routed experts (MoE) against the JAX package's, on the CPU,
the reference's Pallas kernels in interpret mode: ``route_pad``,
``moe_route`` (with deliberate ties), the grouped matmul over Q4_0 and
Q8_0 expert stacks, the lane-major matmul (``_qmm_i4``/``_qmm_i8``),
``moe_ffn_grouped``, and 2-layer MoE models (arch ``llama`` with experts
and arch ``mixtral``) through the forward pass, the generate engine and a
4-slot int8-KV batch; the loader's kinds and ``params_from_numpy``.

Small widths: 4 experts of which 2 are used, hidden 256, expert ff 256.

Tolerances.  route_pad is bit-equal.  Routing weights agree within 2 f32
ulps (exp and the sums of two libraries).  The matmuls (grouped and
lane-major) are f32 sums of the same exact products in another order:
within 1e-4 of the output's largest magnitude.  moe_ffn_grouped's output is
bf16 after g and u were rounded to bf16: a g or u whose f32 sums straddle a
rounding boundary rounds the other way, and carries one bf16 ulp of one mid
element into every output through the down sum, so it is held at 2^-7 of
its largest output.  Logits at 2^-5 of their largest magnitude, prefill
against prefill and decode against decode (ROADMAP Queue 3), as in
tests/test_torch_model.py, and greedy tokens equal.  The models' weight
scale is 0.1: at the dense models' 0.3 each layer's expert FFN returns ~300
times its input's magnitude and carries the packages' one-ulp bf16
differences of its input (the jitted reference keeps some intermediates in
f32) to ~7 % of a logit, though given the same input the two FFNs agree
(test_moe_ffn_grouped_matches_reference)."""

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
from booster_tpu.models import llama as jllama  # noqa: E402
from booster_tpu.models.llama import forward as j_forward  # noqa: E402
from booster_tpu.ops import linear as jlinear  # noqa: E402
from booster_tpu.ops import pallas_attention as pa  # noqa: E402
from booster_tpu.ops import pallas_kv as pk  # noqa: E402
from booster_tpu.ops import pallas_moe as pm  # noqa: E402
from booster_tpu.ops import pallas_qmm as pq  # noqa: E402
from booster_tpu.ops.kv_cache import KVCache as JCache  # noqa: E402
from booster_tpu.quant import qtensor as jqt  # noqa: E402
from booster_tpu.quant import quantize as jquantize  # noqa: E402
from booster_tpu.quant import repack_gguf_tensor as jrepack  # noqa: E402
from booster_tpu.sampling import SamplingParams as JSP  # noqa: E402
from booster_tpu.serving import Engine as JEngine  # noqa: E402
from booster_tpu_torch.gguf import GGMLType as TT  # noqa: E402
from booster_tpu_torch.models import llama as tllama  # noqa: E402
from booster_tpu_torch.models import load_model, params_from_numpy  # noqa: E402
from booster_tpu_torch.models.llama import forward  # noqa: E402
from booster_tpu_torch.ops import moe as tmoe  # noqa: E402
from booster_tpu_torch.ops import qmm as tq  # noqa: E402
from booster_tpu_torch.ops.kv_cache import KVCache  # noqa: E402
from booster_tpu_torch.quant import qtensor as tqt  # noqa: E402
from booster_tpu_torch.sampling import SamplingParams  # noqa: E402
from booster_tpu_torch.serving import Engine  # noqa: E402
from booster_tpu_torch.testing import make_model  # noqa: E402
from booster_tpu_torch.testing import torch_threads  # noqa: E402

E, K_USED, C, FF = 4, 2, 256, 256
LOGIT_TOL = 2 ** -5
MM_TOL = 1e-4
MAX_SEQ = 128
FORMATS = {"q4_0": (JT.Q4_0, TT.Q4_0), "q8_0": (JT.Q8_0, TT.Q8_0)}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


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


def _cfg(cls, **kw):
    """A config of each package's class with E experts of which K_USED are used."""
    return cls(**{"arch": "llama", "n_layers": 2, "n_embd": C, "n_heads": 4, "n_kv_heads": 2,
                  "n_ff": FF, "n_vocab": 512, "n_ctx_train": 2048, "head_dim": C // 4,
                  "n_experts": E, "n_experts_used": K_USED, **kw})


def _stack_pair(fmt, n, k, seed=0):
    """One expert stack [E·n, k] through both packages' repacks, prepared;
    the port's with bf16 scale planes, as its loader stores them."""
    jt, tt = FORMATS[fmt]
    w = np.random.default_rng(seed).standard_normal((E * n, k)).astype(np.float32) * 0.3
    raw = jquantize(w, jt)
    j = jqt.prepare_kernel_scales(jrepack(raw, jt, (E * n, k))).astype_device()
    t = tqt.to_torch(tqt.compact_scales(tqt.prepare_kernel_scales(
        tqt.repack_gguf_tensor(raw, tt, (E * n, k)))), "cpu")
    return j, t


def _route(n, seed):
    """Expert choices of n tokens: distinct per token, seeded."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(E)[:K_USED] for _ in range(n)]).astype(np.int32)


def _close(got, want, tol):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


# -- routing -----------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 12, 64])
def test_route_pad_bit_equal(n):
    x = np.random.default_rng(n).standard_normal((n, C)).astype(np.float32)
    topi = _route(n, n)
    jxp, jpos, jte = pm.route_pad(jnp.asarray(x), jnp.asarray(topi), E)
    xp, pos, te, used = tmoe.route_pad(torch.from_numpy(x), torch.from_numpy(topi), E)
    np.testing.assert_array_equal(xp.numpy(), np.asarray(jxp))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(te.numpy(), np.asarray(jte))
    counts = np.bincount(topi.reshape(-1), minlength=E)
    assert int(used[0]) == int(((counts + 31) // 32 * 32).sum())
    assert not xp[int(used[0]):].any()  # every row the kernel skips is zero


@pytest.mark.parametrize("norm_topk", [True, False])
def test_moe_route_ties_rank_the_lower_expert_first(norm_topk):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((64, E)).astype(np.float32)
    # ties at the 2nd/3rd boundary, at the top, and all four equal
    logits[0] = [0.5, 1.25, 0.25, 1.25]
    logits[1] = [2.0, 0.75, 0.75, -1.0]
    logits[2] = [1.0, 1.0, 1.0, 1.0]
    logits[3] = [-0.5, 0.125, -0.5, 0.125]
    lb = jnp.asarray(logits, jnp.bfloat16)
    jv, ji = jllama.moe_route(lb, _cfg(jllama.ModelConfig, moe_norm_topk=norm_topk))
    tv, ti = tllama.moe_route(torch.from_numpy(np.array(lb.astype(jnp.float32))).to(
        torch.bfloat16), _cfg(tllama.ModelConfig, moe_norm_topk=norm_topk))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_max_ulp(tv.numpy(), np.asarray(jv, np.float32), maxulp=2)
    assert ti[0].tolist() == [1, 3] and ti[1].tolist() == [0, 1] and ti[2].tolist() == [0, 1]


# -- the matmuls -------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["q4_0", "q8_0"])
@pytest.mark.parametrize("n,k", [(FF, C), (C, FF)])  # gate/up, down
def test_grouped_qmm_matches_pallas(pallas, fmt, n, k):
    jw, tw = _stack_pair(fmt, n, k)
    x = (np.random.default_rng(1).standard_normal((12, k)) * 0.5).astype(np.float32)
    topi = _route(12, 1)
    jxp, _, jte = pm.route_pad(jnp.asarray(x, jnp.bfloat16), jnp.asarray(topi), E)
    want = np.asarray(pm.grouped_qmm(jxp, jw, jte, E))
    xp, _, te, used = tmoe.route_pad(torch.from_numpy(x).to(torch.bfloat16),
                                     torch.from_numpy(topi), E)
    _close(tmoe.grouped_qmm(xp, tw, te, E, used).numpy(), want, MM_TOL)
    # without the count of real rows every tile is computed: the same output
    _close(tmoe.grouped_qmm(xp, tw, te, E).numpy(), want, MM_TOL)


@pytest.mark.parametrize("fmt", ["q4_0", "q8_0"])
@pytest.mark.parametrize("m", [1, 5, 64])
def test_lane_qmm_matches_pallas(fmt, m, monkeypatch):
    """The lane-major matmul at a shape the K-major kernels do not take, so
    the loader keeps it lane-major and qmm sends it to the lane kernel
    (here its plain version), as the reference's qmm sends it to
    _qmm_i4/_qmm_i8.  At M = 1 the reference's interpret-mode run gives a
    row about 2e-3 of the largest output away from what it gives the same
    row at M = 2 (and from a numpy model of its stated arithmetic); the
    port equals the M = 2 row, so M = 1 is held to that row within 1e-4,
    and to the reference's own M = 1 output within 2^-7."""
    jt, tt = FORMATS[fmt]
    n, k = 128, 768 if fmt == "q4_0" else 384  # (K/2 or K)/32 % 8 != 0: not transposable
    w = np.random.default_rng(m).standard_normal((n, k)).astype(np.float32) * 0.3
    raw = jquantize(w, jt)
    jw = jqt.prepare_kernel_scales(jrepack(raw, jt, (n, k))).astype_device()
    from booster_tpu_torch.models.loader import _kernel_layout
    tw = tqt.to_torch(_kernel_layout(tqt.repack_gguf_tensor(raw, tt, (n, k))), "cpu")
    assert tw.kind == ("i4p" if fmt == "q4_0" else "i8") and tw.scales.dtype == torch.bfloat16
    x = (np.random.default_rng(7).standard_normal((m, k)) * 0.5).astype(np.float32)
    fn = pq._qmm_i4 if fmt == "q4_0" else pq._qmm_i8
    pq.INTERPRET = True
    try:
        assert pq._supported(jw, k, m) and not pq.transposable(jw)
        want = np.asarray(fn(jnp.asarray(x, jnp.bfloat16), jw))
        if m == 1:
            own = want
            want = np.asarray(fn(jnp.asarray(np.repeat(x, 2, 0), jnp.bfloat16), jw))[:1]
    finally:
        pq.INTERPRET = False
        jax.clear_caches()
    calls = []
    plain = tq.qmm_lane_plain
    monkeypatch.setattr(tq, "qmm_lane_plain", lambda *a: calls.append(1) or plain(*a))
    got = tq.qmm(torch.from_numpy(x).to(torch.bfloat16), tw)
    assert calls == [1]
    _close(got.numpy(), want, MM_TOL)
    if m == 1:
        _close(got.numpy(), own, 2 ** -7)


def _layer0(jm, tm):
    """Layer 0 of both models' MoE params (the JAX one sliced to 2-D)."""
    keys = ("router", "gate_exps", "up_exps", "down_exps")
    jl = {k: jax.tree.map(lambda a: a[0], jm.params["layers"][k]) for k in keys}
    tl = {k: tm.params["layers"][k].at(0) for k in keys}
    return jl, tl


@pytest.mark.parametrize("fmt", ["q4_0", "q8_0"])
def test_moe_ffn_grouped_matches_reference(models, pallas, fmt):
    jm, tm = models[fmt]
    jl, tl = _layer0(jm, tm)
    x = (np.random.default_rng(5).standard_normal((2, 9, C)) * 0.5).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(pm.moe_ffn_grouped(xb, jl, jm.cfg).astype(jnp.float32))
    got = tmoe.moe_ffn_grouped(torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(
        torch.bfloat16), tl, tm.cfg)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 9, C)
    _close(got.float().numpy(), want, 2 ** -7)


def test_expert_stacks_the_loader_does_not_make_raise(models):
    """The loader keeps expert stacks lane-major (or dense); K-major stacks,
    which no loader makes, raise instead of taking another FFN path."""
    jm, tm = models["q4_0"]
    jl, _ = _layer0(jm, tm)
    tl = {"router": tm.params["layers"]["router"].at(0)}
    for key in ("gate_exps", "up_exps", "down_exps"):
        j = jax.tree.map(np.asarray, jl[key])
        tl[key] = tqt.transpose_qtensor(tqt.QTensor(
            "i4p", torch.from_numpy(j.qw), torch.from_numpy(j.scales), None, j.group,
            j.shape, TT.Q4_0, zero=j.zero))
    assert not tmoe.moe_supported(tl)
    x = torch.zeros(1, 5, C, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tllama._moe_ffn(x, tl, tm.cfg)


# -- the models --------------------------------------------------------------


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe")
    return {"q4_0": make_model(str(d / "llama.gguf"), vocab_size=512, hidden=C, layers=2,
                               heads=4, kv_heads=2, ff=FF, experts=E, experts_used=K_USED,
                               weight_scale=0.1),
            "q8_0": make_model(str(d / "mixtral.gguf"), vocab_size=512, hidden=C, layers=2,
                               heads=4, kv_heads=2, ff=FF, experts=E, experts_used=K_USED,
                               quant=TT.Q8_0, arch="mixtral", rope_base=1e6,
                               weight_scale=0.1)}


@pytest.fixture(scope="module")
def models(gguf):
    """Per format (Q4_0 as arch llama, Q8_0 as arch mixtral): the JAX model
    and the port's, whose params are the JAX params carried across (checked
    equal to the port's own loader's)."""
    out = {}
    for fmt, path in gguf.items():
        jm = j_load(path, weights="native")
        tm = load_model(path, device="cpu", weights="native")
        carried = params_from_numpy(jax.tree.map(np.asarray, jm.params), tm.cfg, device="cpu")
        for key, a in carried["layers"].items():
            b = tm.params["layers"][key]
            if hasattr(a, "kind"):
                assert a.kind == b.kind and torch.equal(a.qw, b.qw), key
                if a.scales is not None:
                    assert a.scales.dtype == b.scales.dtype, key
                    assert torch.equal(a.scales.float(), b.scales.float()), key
        out[fmt] = (jm, dataclasses.replace(tm, params=carried))
    return out


@pytest.mark.parametrize("fmt", ["q4_0", "q8_0"])
def test_loader_keeps_experts_lane_major(tmp_path, fmt):
    """Expert stacks stay i4p/i8 with bf16 scale planes whatever `weights`
    says; attention goes K-major where the kernels take it (hidden 512)."""
    lane, kmaj = ("i4p", "i4t") if fmt == "q4_0" else ("i8", "i8t")
    path = make_model(str(tmp_path / "m.gguf"), vocab_size=512, hidden=512, layers=2, heads=4,
                      kv_heads=2, ff=FF, experts=E, experts_used=K_USED, draw="blocks",
                      quant=FORMATS[fmt][1])
    for weights, attn in (("native", kmaj), ("bf16", "dense"), ("auto", "dense")):
        m = load_model(path, device="cpu", weights=weights)
        lay = m.params["layers"]
        assert m.cfg.n_experts == E and m.cfg.n_experts_used == K_USED
        assert {lay[k].kind for k in ("gate_exps", "up_exps", "down_exps")} == {lane}
        assert lay["gate_exps"].qw.shape == (2, E * FF, 256 if fmt == "q4_0" else 512)
        rows = 2 if fmt == "q4_0" else 1
        assert lay["down_exps"].scales.shape == (2, E * 512, rows, FF // (32 * rows))
        assert lay["down_exps"].scales.dtype == torch.bfloat16
        assert lay["wqkv"].kind == lay["wo"].kind == attn and lay["router"].kind == "dense"
        assert not {"w_gate", "w_up", "w_down", "w_gateup"} & set(lay)


def test_params_from_numpy_carries_the_expert_stacks(models, gguf):
    """The JAX loader's expert stacks carried across equal the port's
    loader's: payload bit for bit, scale planes after the bf16 rounding
    that both kernels apply (the port stores them so)."""
    for fmt, (jm, tm) in models.items():
        mine = load_model(gguf[fmt], device="cpu", weights="native").params["layers"]
        for key in ("gate_exps", "up_exps", "down_exps"):
            j = jax.tree.map(np.asarray, jm.params["layers"][key])
            a, b = tm.params["layers"][key], mine[key]
            assert a.kind == b.kind == j.kind and a.shape == b.shape == tuple(j.shape)
            assert torch.equal(a.qw, b.qw) and np.array_equal(a.qw.numpy(), j.qw)
            assert a.scales.dtype == b.scales.dtype == torch.bfloat16
            assert torch.equal(a.scales, b.scales)
            assert torch.equal(a.scales, torch.from_numpy(j.scales).to(torch.bfloat16))


def test_experts_repacked_on_a_device_equal_the_host_repack():
    rng = np.random.default_rng(4)
    for jt, tt in FORMATS.values():
        raw = jquantize(rng.standard_normal((E * 64, C)).astype(np.float32), jt)
        host = tqt.repack_gguf_tensor(raw, tt, (E, 64, C))
        dev = tqt.repack_gguf_tensor(raw, tt, (E, 64, C), device="cpu")
        ref = jrepack(raw, jt, (E * 64, C))
        assert torch.is_tensor(dev.qw) and isinstance(host.qw, np.ndarray)
        np.testing.assert_array_equal(dev.qw.numpy(), host.qw)
        np.testing.assert_array_equal(host.qw, np.asarray(ref.qw))
        np.testing.assert_array_equal(dev.scales.numpy(), np.asarray(ref.scales))


def test_read_into_equals_the_mapped_bytes(gguf):
    """The loader stages expert stacks through file reads on a GPU: the
    bytes read equal the mapped ones, and a short file raises."""
    from booster_tpu_torch.gguf import GGUFReader

    with GGUFReader(gguf["q4_0"]) as r:
        info = r.tensors["blk.1.ffn_down_exps.weight"]
        buf = np.zeros(info.nbytes + 7, np.uint8)
        r.read_into(info, buf)
        np.testing.assert_array_equal(buf[:info.nbytes], r.tensor_bytes(info))
        from booster_tpu_torch.gguf.reader import GGUFError

        with pytest.raises(GGUFError):  # a tensor said to end past the file's end
            r.read_into(dataclasses.replace(info, offset=r._files[0].mm.size() - 16), buf)


def test_unported_moe_options_raise():
    base = _cfg(tllama.ModelConfig, arch="mixtral")
    tllama._check_ported(base)
    for kw in ({"n_shared_experts": 1}, {"n_expert_groups": 2, "n_group_used": 1},
               {"moe_scale": 2.5}, {"n_dense_layers": 1}, {"n_experts_used": 0},
               {"arch": "qwen2moe"}):
        with pytest.raises(NotImplementedError):
            tllama._check_ported(dataclasses.replace(base, **kw))


class _RouterSpy:
    """Records the router logits each package routes, per forward call (one
    [N, E] array per layer), through monkeypatched ``moe_route``s (the
    reference's reports through an ordered debug callback)."""

    def __init__(self, monkeypatch):
        self.port, self.ref = [], []
        t_orig, j_orig = tllama.moe_route, jllama.moe_route

        def t_spy(lg, cfg):
            self.port.append(lg.float().numpy().copy())
            return t_orig(lg, cfg)

        def j_spy(lg, cfg):
            jax.debug.callback(lambda a: self.ref.append(np.asarray(a, np.float32)), lg,
                               ordered=True)
            return j_orig(lg, cfg)

        monkeypatch.setattr(tllama, "moe_route", t_spy)
        monkeypatch.setattr(jllama, "moe_route", j_spy)
        jax.clear_caches()  # retrace the reference with its spy

    def flips(self) -> list:
        """Since the last call: (layer, row) of each token whose chosen
        experts differ between the packages, each checked to be a near-tie
        at the k-th place that the packages' router logit difference decides
        either way: in both packages the k-th and (k+1)-th logits lie within
        twice the row's largest difference, itself within 2^-5 of the row's
        largest logit."""
        jax.effects_barrier()
        out = []
        for layer, (a, b) in enumerate(zip(self.port, self.ref)):
            a, b = a.reshape(-1, E), b.reshape(-1, E)
            for r in range(a.shape[0]):
                sa = np.argsort(-a[r], kind="stable")
                sb = np.argsort(-b[r], kind="stable")
                if set(sa[:K_USED]) == set(sb[:K_USED]):
                    continue
                d = np.abs(a[r] - b[r]).max()
                assert d <= LOGIT_TOL * np.abs(b[r]).max(), (layer, r, a[r], b[r])
                for lg, o in ((a[r], sa), (b[r], sb)):
                    assert lg[o[K_USED - 1]] - lg[o[K_USED]] <= 2 * d, (layer, r, a[r], b[r])
                out.append((layer, r))
        self.port.clear()
        self.ref.clear()
        return out


@pytest.mark.parametrize("fmt", ["q4_0", "q8_0"])
def test_prefill_and_decode_logits_match(models, pallas, fmt, monkeypatch):
    """Each step's compared logits (the gathered prompt row, then each decode
    row) within 2^-5, except at a step where the packages routed that row
    to other experts at a bf16 near-tie of the router logits (where either
    choice is right); at most one such step."""
    jm, tm = models[fmt]
    cfg = tm.cfg
    assert cfg.arch == ("llama" if fmt == "q4_0" else "mixtral") and cfg.n_experts == E
    spy = _RouterSpy(monkeypatch)
    ids = tm.tokenizer.encode("hello world the and of to in")
    n = len(ids)
    T = 32  # the prompt's bucket
    arr = np.zeros((1, T), np.int32)
    arr[0, :n] = ids
    g = np.asarray([n - 1], np.int32)
    nv = np.asarray([n], np.int32)
    jc = JCache.create(cfg.n_layers, 1, MAX_SEQ, cfg.n_kv_heads, cfg.head_dim)
    jl, jc = j_forward(jm.params, jm.cfg, jnp.asarray(arr), jc, gather_idx=jnp.asarray(g),
                       n_valid=jnp.asarray(nv))
    tc = KVCache.create(cfg.n_layers, 1, MAX_SEQ, cfg.n_kv_heads, cfg.head_dim, "cpu")
    tl, tc = forward(tm.params, cfg, torch.from_numpy(arr), tc,
                     gather_idx=torch.from_numpy(g), n_valid=torch.from_numpy(nv))
    flipped = []

    def check(row):
        if row in {r for _, r in spy.flips()}:
            flipped.append(row)
        else:
            _close(tl.numpy(), np.asarray(jl), LOGIT_TOL)

    check(n - 1)
    for _ in range(6):  # T = 1 steps fed the reference's greedy token
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        jl, jc = j_forward(jm.params, jm.cfg, jnp.asarray(nxt), jc, last_only=True)
        tl, tc = forward(tm.params, cfg, torch.from_numpy(nxt), tc, last_only=True)
        check(0)
    assert len(flipped) <= 1, flipped
    assert int(tc.lengths[0]) == int(jc.lengths[0]) == n + 6


@pytest.mark.parametrize("fmt", ["q4_0", "q8_0"])
def test_generate_greedy_tokens_equal(models, pallas, fmt):
    jm, tm = models[fmt]
    ids = tm.tokenizer.encode("hello world the and of to in")
    want = JEngine(jm, max_batch=1, max_seq=MAX_SEQ, decode_chunk=4).generate(
        ids, JSP(temp=0.0), max_new_tokens=8)
    got = Engine(tm, max_batch=1, max_seq=MAX_SEQ, decode_chunk=4).generate(
        ids, SamplingParams(temp=0.0), max_new_tokens=8)
    assert len(want.token_ids) >= 6
    assert got.token_ids == want.token_ids and got.n_generated == want.n_generated


def _run_batch(eng, sp_cls, tok):
    eng.init_batch_state()
    prompts = {}
    for s in (0, 2):  # slots 1 and 3 stay idle
        eng.reset_slot(s, sp_cls(temp=0.0), seed=s)
        prompts[s] = tok.encode(f"stream {s} benchmark prompt")
    first = eng.prefill_slots(prompts)
    toks, _ = eng.decode_slots(first, n_steps=6)
    return first, toks, np.asarray(eng.cache.lengths).tolist()


def test_batched_int8_engine_matches_jax(models, pallas):
    jm, tm = models["q4_0"]
    want = _run_batch(JEngine(jm, max_batch=4, max_seq=MAX_SEQ, kv_quantized=True,
                              decode_chunk=6), JSP, jm.tokenizer)
    got = _run_batch(Engine(tm, max_batch=4, max_seq=MAX_SEQ, kv_quantized=True,
                            decode_chunk=6), SamplingParams, tm.tokenizer)
    assert sorted(got[0]) == [0, 2] and all(len(got[1][s]) == 6 for s in (0, 2))
    assert got == want
