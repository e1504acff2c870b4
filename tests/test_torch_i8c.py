"""The port's i8 and i8c weight forms (``weights="i8"``, ``weights="i8c"``)
against the JAX package, on the CPU, the reference's Pallas kernels in
interpret mode: ``repack_weights(.., "i8")`` and ``channel_quantize`` bit for
bit, the i8c matmul's plain version against ``_tqmm_i8c`` (2-D and through a
layer view) and the dequantize path where the reference's gate refuses the
shape, the loader's i8c and i8 params bit for bit (llama and Mixtral), the
llama forward and engines on an i8c model, the reference's i8c-vs-native
logit delta replayed, and the CLI's ``--allow-lossy`` rule.

Tolerances: the i8c matmul's outputs are f32 sums of the same exact
products in another order, times the same f32 scale, so they agree to 2e-4
of the largest output (chip_smoke.py's "qmm" check).  Logits as in
tests/test_torch_model.py: 2^-5 of their largest magnitude; greedy tokens
equal."""

import dataclasses
import json
import signal
import socket
import subprocess
import sys
import time
from http.client import HTTPConnection

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
from booster_tpu.quant import quantize as jquantize  # noqa: E402
from booster_tpu.quant import repack_gguf_tensor as jrepack  # noqa: E402
from booster_tpu.sampling import SamplingParams as JSP  # noqa: E402
from booster_tpu.serving import Engine as JEngine  # noqa: E402
from booster_tpu_torch.__main__ import main as cli_main  # noqa: E402
from booster_tpu_torch.gguf import GGMLType as TT  # noqa: E402
from booster_tpu_torch.models import load_model, params_from_numpy  # noqa: E402
from booster_tpu_torch.models.llama import forward  # noqa: E402
from booster_tpu_torch.ops import qmm as tq  # noqa: E402
from booster_tpu_torch.ops.kv_cache import KVCache  # noqa: E402
from booster_tpu_torch.quant import qtensor as tqt  # noqa: E402
from booster_tpu_torch.sampling import SamplingParams  # noqa: E402
from booster_tpu_torch.serving import Engine  # noqa: E402
from booster_tpu_torch.testing import make_model  # noqa: E402
from booster_tpu_torch.testing import torch_threads  # noqa: E402

QMM_TOL = 2e-4
LOGIT_TOL = 2 ** -5
MAX_SEQ = 128
FORMATS = {"q8_0": (JT.Q8_0, TT.Q8_0), "q4_0": (JT.Q4_0, TT.Q4_0)}
RECIP = np.float32(1 / 127)  # the reciprocal a CUDA divide by a CPU scalar multiplies by


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


@pytest.fixture
def pallas():
    jlinear.set_use_pallas(True)
    pq.INTERPRET = pa.INTERPRET = pk.INTERPRET = True
    try:
        yield
    finally:
        jlinear.set_use_pallas(None)
        pq.INTERPRET = pa.INTERPRET = pk.INTERPRET = False
        jax.clear_caches()


def _hazard_scales(n: int) -> np.ndarray:
    """n f16 scales d for which the IEEE f32 division (8·d) / 127 differs
    from (8·d) · f32(1/127), the reciprocal multiply that CUDA makes of a
    division by a CPU scalar.  (For 127·d, the largest |value| of a Q8_0
    row, the two agree for every f16 d.)"""
    d = np.arange(1, 0x7C00, dtype=np.uint16).view(np.float16).astype(np.float32)
    d = d[(d > 1e-4) & (d < 1e-2)]
    amax = d * np.float32(8)
    bad = d[(amax / np.float32(127)) != (amax * RECIP)]
    return bad[np.linspace(0, bad.size - 1, n).astype(int)]


def _source(fmt: str, n=256, k=512, seed=0):
    """Raw GGUF bytes of an [n, k] weight: rows 0-7 each hold one value -8·d
    of a hazard scale d and smaller ones (Q4_0 stores d exactly, so the
    row's largest |value| is 8·d), row 8 is all zero (the 1e-12 floor), the
    rest normal."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n, k)).astype(np.float32) * 0.05
    d = _hazard_scales(8)
    w[:8] = rng.uniform(-6.5, 6.5, size=(8, k)).astype(np.float32) * d[:, None]
    w[:8, 5] = -8 * d
    w[8] = 0.0
    return jquantize(w, FORMATS[fmt][0])


@pytest.mark.parametrize("fmt", ["q8_0", "q4_0"])
def test_channel_quantize_bit_equal(fmt):
    n, k = 256, 512
    raw = _source(fmt, n, k)
    want = jqt.channel_quantize(jrepack(raw, FORMATS[fmt][0], (n, k)))
    got = tqt.channel_quantize(tqt.repack_gguf_tensor(raw, FORMATS[fmt][1], (n, k)))
    assert got.kind == want.kind == "i8c" and got.transposed and got.group == want.group == k
    assert got.qw.shape == (k, n) and got.scales.shape == (1, n)
    assert got.scales.dtype == torch.float32 and got.qw.dtype == torch.int8
    assert np.array_equal(got.qw.numpy(), want.qw)
    assert np.array_equal(got.scales.numpy().view(np.int32), want.scales.view(np.int32))
    s = got.scales.numpy()[0]
    assert s[8] == np.float32(1e-12) and not got.qw[:, 8].any()  # the all-zero row
    # on the Q4_0 rows built for it, the reciprocal multiply differs from
    # the scales the check holds bit-equal
    w = jqt.dequantize_qtensor_np(jrepack(raw, FORMATS[fmt][0], (n, k)))
    amax = np.abs(w).max(axis=1)
    recip = np.maximum(amax * RECIP, np.float32(1e-12)) != s
    if fmt == "q4_0":
        assert np.array_equal(amax[:8], 8 * _hazard_scales(8)) and recip[:8].all()


def test_channel_quantize_refuses_compacted_scales():
    raw = _source("q8_0")
    qt = tqt.repack_gguf_tensor(raw, TT.Q8_0, (256, 512))
    with pytest.raises(ValueError, match="f32 scales"):
        tqt.channel_quantize(dataclasses.replace(
            qt, scales=torch.from_numpy(qt.scales).to(torch.bfloat16)))


@pytest.mark.parametrize("fmt", ["q4_0", "q8_0"])
def test_repack_i8_bit_equal(fmt):
    n, k = 128, 256
    raw = _source(fmt, n, k, seed=1)
    want = jqt.repack_weights(jrepack(raw, FORMATS[fmt][0], (n, k)), "i8")
    got = tqt.repack_weights(tqt.repack_gguf_tensor(raw, FORMATS[fmt][1], (n, k)), "i8")
    assert got.kind == want.kind == "i8" and got.zero == want.zero == 0
    assert got.qw.dtype == np.int8 and np.array_equal(got.qw, want.qw)
    assert np.array_equal(got.scales, want.scales) and got.mins is want.mins is None


def _i8c_pair(n, k, layers=None, seed=2):
    """An i8c weight from Q8_0 through both packages; with `layers`, stacked
    [L, K, N] and viewed at its last layer."""
    raws = [_source("q8_0", n, k, seed + i) for i in range(layers or 1)]
    js = [jqt.channel_quantize(jrepack(r, JT.Q8_0, (n, k))) for r in raws]
    ts = [tqt.channel_quantize(tqt.repack_gguf_tensor(r, TT.Q8_0, (n, k))) for r in raws]
    if layers is None:
        return jax.tree.map(jnp.asarray, js[0]), ts[0]
    j = dataclasses.replace(js[0], qw=jnp.asarray(np.stack([q.qw for q in js])),
                            scales=jnp.asarray(np.stack([q.scales for q in js])),
                            layer=jnp.int32(layers - 1))
    t = dataclasses.replace(ts[0], qw=torch.stack([q.qw for q in ts]),
                            scales=torch.stack([q.scales for q in ts])).at(layers - 1)
    return j, t


@pytest.mark.parametrize("layers", [None, 2])
@pytest.mark.parametrize("m", [1, 3, 64, 300])
def test_qmm_i8c_plain_matches_pallas(pallas, m, layers):
    n, k = 256, 512
    jw, tw = _i8c_pair(n, k, layers)
    assert pq._supported_i8c(jw, k) and tq._supported_i8c(tw, k)
    x = np.random.default_rng(m).standard_normal((m, k)).astype(np.float32)
    want = np.asarray(pq.qmm(jnp.asarray(x, jnp.bfloat16), jw))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = tq.qmm_i8c(xt, tw).numpy()
    err = np.abs(got - want).max()
    assert err <= QMM_TOL * np.abs(want).max(), (err, np.abs(want).max())
    assert np.array_equal(tq.qmm(xt, tw).numpy(), got)  # the dispatch takes the kernel


def test_i8c_refused_shape_takes_the_dequantize_path(pallas):
    n, k = 128, 128  # K % 256 != 0: both packages' gates refuse it
    jw, tw = _i8c_pair(n, k)
    assert not pq._supported_i8c(jw, k) and not tq._supported_i8c(tw, k)
    x = np.random.default_rng(9).standard_normal((2, k)).astype(np.float32)
    want = np.asarray(pq.qmm(jnp.asarray(x, jnp.bfloat16), jw))
    got = tq.qmm(torch.from_numpy(x), tw).numpy()
    wd = tqt.dequantize(tw, torch.bfloat16)  # bf16(q·s) [N, K], as the reference's
    assert torch.equal(wd, torch.from_numpy(np.asarray(
        jqt.dequantize_qtensor(jw, jnp.float32))).to(torch.bfloat16))
    assert np.abs(got - want).max() <= QMM_TOL * np.abs(want).max()


# -- the models --------------------------------------------------------------


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    d = tmp_path_factory.mktemp("i8c")
    return {
        # 7B-like: Q8_0, head dim 128; every weight passes the i8c gate
        "q8_0": make_model(str(d / "q8.gguf"), vocab_size=512, hidden=512, layers=2, heads=4,
                           kv_heads=2, ff=1024, quant=TT.Q8_0, weight_scale=0.3),
        # the reference's test_i8c_model_logit_delta model (Q4_0)
        "q4_0": make_model(str(d / "q4.gguf"), vocab_size=512, hidden=512, layers=2, heads=8,
                           kv_heads=4, ff=1024),
        "mixtral": make_model(str(d / "moe.gguf"), vocab_size=512, hidden=256, layers=2,
                              heads=4, kv_heads=2, ff=256, experts=4, experts_used=2,
                              arch="mixtral", weight_scale=0.1),
    }


def _carry(path, weights):
    """(the JAX model, the port's own load, the JAX params carried across)."""
    jm = j_load(path, weights=weights)
    tm = load_model(path, device="cpu", weights=weights)
    carried = params_from_numpy(jax.tree.map(np.asarray, jm.params), tm.cfg, device="cpu")
    return jm, tm, carried


def _assert_same(a, b, key):
    assert a.kind == b.kind and a.shape == b.shape and a.group == b.group, key
    assert torch.equal(a.qw, b.qw), key
    assert a.scales.dtype == b.scales.dtype, key
    assert torch.equal(a.scales.view(torch.int16) if a.scales.dtype == torch.bfloat16
                       else a.scales.view(torch.int32),
                       b.scales.view(torch.int16) if b.scales.dtype == torch.bfloat16
                       else b.scales.view(torch.int32)), key


@pytest.fixture(scope="module")
def q8_i8c(gguf):
    jm, tm, carried = _carry(gguf["q8_0"], "i8c")
    for key in ("wqkv", "wo", "w_gateup", "w_down"):
        _assert_same(carried["layers"][key], tm.params["layers"][key], key)
    _assert_same(carried["output"], tm.params["output"], "output")
    return jm, dataclasses.replace(tm, params=carried)


@pytest.mark.parametrize("which", ["q8_0", "q4_0", "mixtral"])
def test_loader_i8c_bit_equal_to_reference(gguf, which):
    """Every i8c tensor (the fused, de-interleaved qkv, wo, gate-up, down and
    the head) bit-equal to the reference's; Mixtral's expert stacks and its
    dense router untouched."""
    jm, tm, carried = _carry(gguf[which], "i8c")
    lay, mine = carried["layers"], tm.params["layers"]
    assert tm.cfg.rope_deinterleaved
    i8c = ["wqkv", "wo"] + (["w_gateup", "w_down"] if which != "mixtral" else [])
    for key in i8c:
        assert mine[key].kind == "i8c" and mine[key].scales.shape == (2, 1, mine[key].shape[0])
        assert mine[key].scales.dtype == torch.float32
        _assert_same(lay[key], mine[key], key)
    assert tm.params["output"].kind == "i8c"
    _assert_same(carried["output"], tm.params["output"], "output")
    if which == "mixtral":
        native = load_model(gguf[which], device="cpu", weights="native").params["layers"]
        assert mine["router"].kind == "dense"
        for key in ("gate_exps", "up_exps", "down_exps"):
            assert mine[key].kind == "i4p"
            _assert_same(mine[key], native[key], key)


def test_loader_i8_bit_equal_to_reference(gguf):
    """weights="i8" on Q4_0: the nibbles widened, then K-major i8t at group
    32 with bf16 scale planes, as the reference loads them."""
    jm, tm, carried = _carry(gguf["q4_0"], "i8")
    for key in ("wqkv", "wo", "w_gateup", "w_down"):
        assert tm.params["layers"][key].kind == "i8t"
        _assert_same(carried["layers"][key], tm.params["layers"][key], key)
    assert tm.params["output"].kind == "i8t"
    _assert_same(carried["output"], tm.params["output"], "output")


def _prefill_decode(jm, tm, steps=6):
    cfg = tm.cfg
    ids = tm.tokenizer.encode("hello world the and of to in")
    n, T = len(ids), 32
    arr = np.zeros((1, T), np.int32)
    arr[0, :n] = ids
    g, nv = np.asarray([n - 1], np.int32), np.asarray([n], np.int32)
    jc = JCache.create(cfg.n_layers, 1, MAX_SEQ, cfg.n_kv_heads, cfg.head_dim)
    jl, jc = j_forward(jm.params, jm.cfg, jnp.asarray(arr), jc, gather_idx=jnp.asarray(g),
                       n_valid=jnp.asarray(nv))
    tc = KVCache.create(cfg.n_layers, 1, MAX_SEQ, cfg.n_kv_heads, cfg.head_dim, "cpu")
    tl, tc = forward(tm.params, cfg, torch.from_numpy(arr), tc,
                     gather_idx=torch.from_numpy(g), n_valid=torch.from_numpy(nv))
    out = [(tl.numpy(), np.asarray(jl))]
    for _ in range(steps):  # T = 1 steps fed the reference's greedy token
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        jl, jc = j_forward(jm.params, jm.cfg, jnp.asarray(nxt), jc, last_only=True)
        tl, tc = forward(tm.params, cfg, torch.from_numpy(nxt), tc, last_only=True)
        out.append((tl.numpy(), np.asarray(jl)))
    assert int(tc.lengths[0]) == int(jc.lengths[0]) == n + steps
    return out


def _close(got, want):
    err = np.abs(got - want).max()
    assert err <= LOGIT_TOL * np.abs(want).max(), (err, np.abs(want).max())


def test_i8c_prefill_and_decode_logits_match(q8_i8c, pallas):
    jm, tm = q8_i8c
    lay = jm.params["layers"]
    x = jnp.ones((1, 512), jnp.bfloat16)
    for key in ("wqkv", "wo", "w_gateup", "w_down"):  # the reference takes its kernel
        w = dataclasses.replace(lay[key], layer=0)
        assert pq._supported_i8c(w, w.shape[1]), key
        assert tq._supported_i8c(tm.params["layers"][key].at(0), w.shape[1]), key
    assert pq.qmm_gateup(x, dataclasses.replace(lay["w_gateup"], layer=0), "silu") is None
    for got, want in _prefill_decode(jm, tm):
        _close(got, want)


def test_i8_prefill_and_decode_logits_match(gguf, pallas):
    jm, _, carried = _carry(gguf["q4_0"], "i8")
    tm = load_model(gguf["q4_0"], device="cpu", weights="i8")
    for got, want in _prefill_decode(jm, dataclasses.replace(tm, params=carried), steps=4):
        _close(got, want)


def test_i8c_generate_greedy_tokens_equal(q8_i8c, pallas):
    """Greedy tokens equal up to the first step whose reference top-2 margin
    is within the logit tolerance (there the logits, within 2^-5, may rank
    the two the other way, and the streams part); that step must be such a
    near-tie."""
    jm, tm = q8_i8c
    ids = tm.tokenizer.encode("hello world the and of to in")
    want = JEngine(jm, max_batch=1, max_seq=MAX_SEQ, decode_chunk=4).generate(
        ids, JSP(temp=0.0), max_new_tokens=8)
    got = Engine(tm, max_batch=1, max_seq=MAX_SEQ, decode_chunk=4).generate(
        ids, SamplingParams(temp=0.0), max_new_tokens=8)
    assert len(want.token_ids) == len(got.token_ids) == 8
    same = [a == b for a, b in zip(got.token_ids, want.token_ids)]
    if all(same):
        return
    i = same.index(False)
    steps = _prefill_decode(jm, tm, steps=i)  # the reference's greedy tokens fed back
    assert [int(np.argmax(w[0, -1])) for _, w in steps] == want.token_ids[:i + 1]
    ref = steps[i][1][0, -1]
    top2 = np.sort(ref)[-2:]
    assert top2[1] - top2[0] <= LOGIT_TOL * np.abs(ref).max(), (i, top2)


def _run_batch(eng, sp_cls, tok):
    eng.init_batch_state()
    prompts = {}
    for s in (0, 2):  # slots 1 and 3 stay idle
        eng.reset_slot(s, sp_cls(temp=0.0), seed=s)
        prompts[s] = tok.encode(f"stream {s} benchmark prompt")
    first = eng.prefill_slots(prompts)
    toks, _ = eng.decode_slots(first, n_steps=6)
    return first, toks, np.asarray(eng.cache.lengths).tolist()


def test_i8c_batched_int8_engine_matches_jax(q8_i8c, pallas):
    jm, tm = q8_i8c
    want = _run_batch(JEngine(jm, max_batch=4, max_seq=MAX_SEQ, kv_quantized=True,
                              decode_chunk=6), JSP, jm.tokenizer)
    got = _run_batch(Engine(tm, max_batch=4, max_seq=MAX_SEQ, kv_quantized=True,
                            decode_chunk=6), SamplingParams, tm.tokenizer)
    assert sorted(got[0]) == [0, 2] and all(len(got[1][s]) == 6 for s in (0, 2))
    assert got == want


def test_i8c_model_logit_delta(gguf):
    """The reference's test_i8c_model_logit_delta on the port: --weights i8c
    logits stay close to the exact model's (the same top token, a mean
    delta under 5 % of the mean |logit|)."""
    def run(mode):
        m = load_model(gguf["q4_0"], device="cpu", weights=mode)
        cache = KVCache.create(m.cfg.n_layers, 1, 32, m.cfg.n_kv_heads, m.cfg.head_dim, "cpu")
        lg, _ = forward(m.params, m.cfg, torch.tensor([[1, 9, 23, 77]], dtype=torch.int32),
                        cache, last_only=True)
        return lg[0, -1].float().numpy()

    exact, i8c = run("native"), run("i8c")
    assert int(np.argmax(exact)) == int(np.argmax(i8c))
    assert np.abs(i8c - exact).mean() / np.abs(exact).mean() < 0.05


@pytest.mark.parametrize("lossy,rc", [(False, 2), (True, 0)])
def test_cli_i8c_requires_allow_lossy(gguf, caplog, lossy, rc):
    args = ["--model", gguf["q4_0"], "--prompt", "hi", "--weights", "i8c", "--silent",
            "--n-predict", "2", "--context", "128", "--device", "cpu"]
    assert cli_main(args + (["--allow-lossy"] if lossy else [])) == rc
    assert ("--allow-lossy" in caplog.text) == (not lossy)


def test_server_answers_with_i8c_weights(gguf):
    """``--server --weights i8c --allow-lossy --device cpu`` loads through
    the same load_model call, answers a chat completion, and drains on
    SIGTERM."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen([sys.executable, "-m", "booster_tpu_torch", "--server", "--device",
                             "cpu", "--host", "127.0.0.1", "--port", str(port), "--model",
                             gguf["q8_0"], "--context", "256", "--predict", "4", "--silent",
                             "--weights", "i8c", "--allow-lossy"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def post(path, body):
        conn = HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            conn.request("POST", path, body=json.dumps(body))
            r = conn.getresponse()
            return r.status, json.loads(r.read().decode())
        finally:
            conn.close()

    try:
        for _ in range(1200):
            try:
                conn = HTTPConnection("127.0.0.1", port, timeout=5)
                conn.request("GET", "/health")
                if conn.getresponse().status == 200:
                    break
            except OSError:
                time.sleep(0.1)
            finally:
                conn.close()
        status, body = post("/v1/chat/completions",
                            {"messages": [{"role": "user", "content": "hello"}]})
        assert status == 200 and 0 < body["usage"]["completion_tokens"] <= 4
    finally:
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err
