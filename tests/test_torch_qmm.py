"""The port's i4t matmul and fused gate+up (plain versions, CPU) against the
JAX package's Pallas kernels run in interpret mode.

Tolerances: qmm's outputs are f32 sums of the same exact products taken in
another order, so they agree to 1e-5 of the output's largest magnitude
(measured ~2e-7).  Gate-up's bf16 outputs may differ by one bf16 rounding of
g or u where those sums straddle a rounding boundary: rtol 2^-7."""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, ".")

from booster_tpu.gguf import GGMLType as JT  # noqa: E402
from booster_tpu.models.loader import _stack_qtensors as j_stack  # noqa: E402
from booster_tpu.ops import pallas_qmm as pq  # noqa: E402
from booster_tpu.quant import qtensor as jqt  # noqa: E402
from booster_tpu.quant import quantize as jquantize  # noqa: E402
from booster_tpu.quant import repack_gguf_tensor as jrepack  # noqa: E402
from booster_tpu_torch.gguf import GGMLType as TT  # noqa: E402
from booster_tpu_torch.models.loader import _kernel_layout, _stack_qtensors  # noqa: E402
from booster_tpu_torch.ops import qmm as tq  # noqa: E402
from booster_tpu_torch.quant import qtensor as tqt  # noqa: E402
from booster_tpu_torch.testing import torch_threads  # noqa: E402

N, K, L = 256, 1024, 2
QMM_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


@pytest.fixture(autouse=True)
def interpret():
    pq.INTERPRET = True
    try:
        yield
    finally:
        pq.INTERPRET = False
        jax.clear_caches()


def _q4_0_pair(n=N, k=K, seed=0):
    """The same stacked Q4_0 weights through both packages' load pipelines."""
    rng = np.random.default_rng(seed)
    raws = [jquantize(rng.standard_normal((n, k)).astype(np.float32) * 0.3, JT.Q4_0)
            for _ in range(L)]
    j = jqt.compact_scales(jqt.transpose_qtensor(jqt.prepare_kernel_scales(
        j_stack([jqt.prepare_kernel_scales(jrepack(r, JT.Q4_0, (n, k))) for r in raws]))))
    t = _kernel_layout(_stack_qtensors([tqt.repack_gguf_tensor(r, TT.Q4_0, (n, k))
                                        for r in raws]))
    return jax.tree.map(jnp.asarray, j), tqt.to_torch(t, "cpu")


def _mins_pair(seed=1):
    """A synthetic i4t tensor with affine mins, built from the same numpy
    arrays on both sides."""
    rng = np.random.default_rng(seed)
    packed = jqt._pack_nibbles_planar(rng.integers(0, 16, size=(N, K), dtype=np.uint8))
    sc = rng.random((N, K // 32)).astype(np.float32) * 0.05 + 0.01
    mn = rng.standard_normal((N, K // 32)).astype(np.float32) * 0.1
    j = jqt.compact_scales(jqt.transpose_qtensor(jqt.prepare_kernel_scales(
        jqt.QTensor("i4p", packed, sc, mn, 32, (N, K), JT.Q4_K))))
    t = tqt.compact_scales(tqt.transpose_qtensor(tqt.prepare_kernel_scales(
        tqt.QTensor("i4p", packed, sc, mn, 32, (N, K), TT.Q4_K))))
    return jax.tree.map(jnp.asarray, j), tqt.to_torch(t, "cpu")


def _x(m, seed=5):
    x = np.random.default_rng(seed + m).standard_normal((m, K)).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _close(got, want, tol):
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("m", [1, 16])
def test_qmm_q4_0_stacked_layer(m):
    jw, tw = _q4_0_pair()
    xj, xt = _x(m)
    assert tq._supported_t(tw.at(1), K, m)
    for layer in (0, 1):
        want = np.asarray(pq.qmm(xj, dataclasses.replace(jw, layer=jnp.int32(layer))))
        got = tq.qmm(xt, tw.at(layer)).numpy()
        assert got.dtype == np.float32 and got.shape == (m, N)
        _close(got, want, QMM_TOL)


@pytest.mark.parametrize("m", [1, 16])
def test_qmm_affine_mins(m):
    jw, tw = _mins_pair()
    assert tw.scales.shape[0] == 4  # two scale rows + two min rows
    xj, xt = _x(m, seed=9)
    _close(tq.qmm(xt, tw).numpy(), np.asarray(pq.qmm(xj, jw)), QMM_TOL)


def test_qmm_unsupported_shape_takes_dequant_path():
    jw, tw = _q4_0_pair(n=96, k=256)  # N % 128 != 0: the kernel's gate refuses
    assert not tq._supported_t(tw.at(0), 256, 1)
    xt = torch.randn(3, 256, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    want = xt.float() @ tqt.dequantize(tw.at(0), torch.bfloat16).float().t()
    assert torch.equal(tq.qmm(xt, tw.at(0)), want)


@pytest.mark.parametrize("m", [1, 16])
def test_gateup_matches_pallas_and_unfused(m):
    jw, tw = _q4_0_pair(seed=3)  # [2ff = 256, K]: gate rows 0..127, up 128..255
    xj, xt = _x(m, seed=11)
    wj = dataclasses.replace(jw, layer=jnp.int32(1))
    want = pq.qmm_gateup(xj, wj, "silu")
    assert want is not None, "the Pallas gate-up refused the shape; test is vacuous"
    got = tq.qmm_gateup(xt, tw.at(1))
    assert got is not None and got.dtype == torch.bfloat16 and got.shape == (m, N // 2)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6 * np.abs(want).max())
    # fused equals the port's own unfused path bit for bit
    gu = tq.qmm(xt, tw.at(1)).to(torch.bfloat16)
    unfused = tq.silu(gu[:, :N // 2]) * gu[:, N // 2:]
    assert torch.equal(got, unfused)


def test_gateup_gate_refuses_like_reference():
    _, tw = _q4_0_pair(n=192, k=1024)  # ff = 96: not a multiple of 128
    assert tq.qmm_gateup(torch.zeros(1, K, dtype=torch.bfloat16), tw.at(0)) is None
