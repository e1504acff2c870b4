"""The port's Q8_0 quantizer, repack (i8), K-major transpose (i8t), compacted
scale planes and dequantize against the JAX package's, on the CPU, and the
loader's choice of native i8t weights.

All comparisons here are exact: the port keeps copies of lossless host code."""

import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, ".")

from booster_tpu.gguf import GGMLType as JT  # noqa: E402
from booster_tpu.quant import dequantize as jdeq  # noqa: E402
from booster_tpu.quant import qtensor as jqt  # noqa: E402
from booster_tpu.quant import quantize as jquantize  # noqa: E402
from booster_tpu.quant import repack_gguf_tensor as jrepack  # noqa: E402
from booster_tpu_torch.gguf import GGMLType as TT  # noqa: E402
from booster_tpu_torch.gguf import GGUFReader  # noqa: E402
from booster_tpu_torch.models import load_model  # noqa: E402
from booster_tpu_torch.models.loader import resolve_weights  # noqa: E402
from booster_tpu_torch.quant import formats as tformats  # noqa: E402
from booster_tpu_torch.quant import qtensor as tqt  # noqa: E402
from booster_tpu_torch.testing import make_model as tmake  # noqa: E402
from tools.make_test_model import make_model as jmake  # noqa: E402
from booster_tpu_torch.testing import torch_threads  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


def _bits(a) -> np.ndarray:
    """uint16 pattern of a bf16 array (numpy ml_dtypes or torch)."""
    if torch.is_tensor(a):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _x(n=96, k=512, seed=0):
    x = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32) * 0.3
    x[0, :32] = 0.0  # an all-zero block: d = 0
    x[1, :32] = np.arange(32, dtype=np.float32) - 16.5  # halves after the scaling
    x[2, :32] = 127.0  # every value at the scale
    return x


def test_q8_0_quantize_bytes_equal():
    x = _x()
    raw = tformats.quantize(x, TT.Q8_0)
    assert raw == jquantize(x, JT.Q8_0)
    np.testing.assert_array_equal(tformats.dequantize(raw, TT.Q8_0, x.shape),
                                  jdeq(raw, JT.Q8_0, shape=x.shape))


def test_make_model_q8_0_bytes_equal(tmp_path):
    kw = dict(vocab_size=512, hidden=512, layers=1, heads=4, kv_heads=2, ff=1024,
              quant=None, seed=4, weight_scale=0.3)
    a = jmake(str(tmp_path / "jax.gguf"), **(kw | {"quant": JT.Q8_0}))
    b = tmake(str(tmp_path / "torch.gguf"), **(kw | {"quant": TT.Q8_0}))
    assert open(a, "rb").read() == open(b, "rb").read()
    r = GGUFReader(b)
    assert r.tensors["blk.0.ffn_down.weight"].ggml_type == TT.Q8_0
    r.close()


def _pair(n=256, k=1024, seed=1):
    raw = jquantize(_x(n, k, seed), JT.Q8_0)
    return jrepack(raw, JT.Q8_0, (n, k)), tqt.repack_gguf_tensor(raw, TT.Q8_0, (n, k))


def test_repack_payload_and_scales_bit_equal():
    j, t = _pair()
    assert (t.kind, t.group, t.shape, t.zero, t.mins) == ("i8", 32, (256, 1024), 0, None)
    assert (j.kind, j.group, j.shape, j.zero, j.mins) == ("i8", 32, (256, 1024), 0, None)
    assert t.qw.dtype == np.int8
    np.testing.assert_array_equal(t.qw, np.asarray(j.qw))
    np.testing.assert_array_equal(t.scales, np.asarray(j.scales))


def test_transpose_and_compact_bit_equal():
    j, t = _pair(seed=2)
    jp, tp = jqt.prepare_kernel_scales(j), tqt.prepare_kernel_scales(t)
    assert tp.scales.shape == (256, 1, 1024 // 32)
    np.testing.assert_array_equal(tp.scales, np.asarray(jp.scales))
    jt, tt = jqt.transpose_qtensor(jp), tqt.transpose_qtensor(tp)
    assert tt.kind == jt.kind == "i8t" and tt.transposed and tt.scale_rows == 1
    assert tt.qw.shape == (1024, 256) and tt.scales.shape == (1, 1024 // 32, 256)
    np.testing.assert_array_equal(tt.qw, np.asarray(jt.qw))
    np.testing.assert_array_equal(tt.scales, np.asarray(jt.scales))
    jc, tc = jqt.compact_scales(jt), tqt.compact_scales(tt)
    assert tc.scales.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(tc.scales), _bits(jc.scales))
    s3, has_mins = tqt.kernel_scales(tc)
    assert s3.shape == (1, 32, 256) and not has_mins


@pytest.mark.parametrize("form", ["i8", "i8t"])
def test_dequantize_bit_equal(form):
    j, t = _pair(seed=3)
    j, t = jqt.prepare_kernel_scales(j), tqt.prepare_kernel_scales(t)
    if form == "i8t":
        j = jqt.compact_scales(jqt.transpose_qtensor(j))
        t = tqt.compact_scales(tqt.transpose_qtensor(t))
    want = np.asarray(jqt.dequantize_qtensor(j, dtype=jnp.bfloat16))
    tt = tqt.to_torch(t, "cpu")
    np.testing.assert_array_equal(_bits(tqt.dequantize(tt, torch.bfloat16)), _bits(want))
    np.testing.assert_array_equal(tqt.dequantize(tt, torch.float32).numpy(),
                                  jqt.dequantize_qtensor_np(j))


def test_weights_auto_keeps_q8_0_native_at_7b():
    """The 7B shape (7.24 B values, 14.5 GB as bf16) is over the 6 GiB rule."""
    shapes = {"token_embd.weight": (32000, 4096), "output.weight": (32000, 4096)}
    for i in range(32):
        for name, shape in (("attn_q", (4096, 4096)), ("attn_k", (1024, 4096)),
                            ("attn_v", (1024, 4096)), ("attn_output", (4096, 4096)),
                            ("ffn_gate", (14336, 4096)), ("ffn_up", (14336, 4096)),
                            ("ffn_down", (4096, 14336))):
            shapes[f"blk.{i}.{name}.weight"] = shape
    reader = SimpleNamespace(tensors={k: SimpleNamespace(shape=v) for k, v in shapes.items()})
    assert sum(int(np.prod(s)) for s in shapes.values()) > 7.2e9
    assert resolve_weights(reader, "auto", 0) == "native"
    assert resolve_weights(reader, "auto", 64) == "native"


def test_loader_transposes_q8_0_to_i8t(tmp_path):
    path = tmake(str(tmp_path / "q8.gguf"), vocab_size=512, hidden=512, layers=2, heads=4,
                 kv_heads=2, ff=1024, quant=TT.Q8_0, weight_scale=0.3)
    m = load_model(path, device="cpu", weights="native")
    kinds = {k: v.kind for k, v in m.params["layers"].items() if hasattr(v, "kind")}
    assert set(kinds) == {"wqkv", "wo", "w_gateup", "w_down"}
    assert set(kinds.values()) == {"i8t"} and m.params["output"].kind == "i8t"
    gu = m.params["layers"]["w_gateup"]
    assert gu.qw.shape == (2, 512, 2048) and gu.qw.dtype == torch.int8
    assert gu.scales.shape == (2, 1, 16, 2048) and gu.scales.dtype == torch.bfloat16
