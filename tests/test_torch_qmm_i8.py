"""The port's i8t (Q8_0) matmul, fused gate-up and whole-MLP kernel (plain
versions, CPU) against the JAX package's Pallas kernels run in interpret
mode, and the port's copies of the reference's dispatch rules.

Tolerances: qmm's outputs are f32 sums of the same products in another
order (the group-dot form at M = 1, the bf16-dequantized weight at M > 1),
so they agree to 2e-4 of the output's largest magnitude.  Gate-up and MLP
outputs are bf16: g or u may round the other way where their f32 sums
straddle a rounding boundary, so |port - reference| <= 2^-7 |reference| +
1e-5 max|reference| per element (chip_smoke.py's "gateup" check); the MLP's
down sum carries such a flip of one mid element into every output, so it is
held at 2^-7 of its largest output.  At M = 1 the reference's own MLP
kernel gives a row 2 bf16 ulps (2^-6.8 of the largest output) away from
what it gives the same row at M = 8, which the port equals there; so M = 1
is held at 2^-6."""

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
from booster_tpu_torch.ops import mlp as tm  # noqa: E402
from booster_tpu_torch.ops import qmm as tq  # noqa: E402
from booster_tpu_torch.quant import qtensor as tqt  # noqa: E402
from booster_tpu_torch.testing import torch_threads  # noqa: E402

K, C, FF, L = 512, 512, 1024, 2  # the small Q8_0 model's widths
QMM_TOL = 2e-4


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


def _q8_pair(n, k, seed=0):
    """The same stacked Q8_0 weights [L, n, k] through both packages' load
    pipelines (i8 → prepared scales → stack → i8t with bf16 scale planes)."""
    rng = np.random.default_rng(seed)
    raws = [jquantize(rng.standard_normal((n, k)).astype(np.float32) * 0.3, JT.Q8_0)
            for _ in range(L)]
    j = jqt.compact_scales(jqt.transpose_qtensor(jqt.prepare_kernel_scales(
        j_stack([jqt.prepare_kernel_scales(jrepack(r, JT.Q8_0, (n, k))) for r in raws]))))
    t = _kernel_layout(_stack_qtensors([tqt.repack_gguf_tensor(r, TT.Q8_0, (n, k))
                                        for r in raws]))
    assert t.kind == j.kind == "i8t"
    return jax.tree.map(jnp.asarray, j), tqt.to_torch(t, "cpu")


def _x(m, k=K, seed=5):
    x = np.random.default_rng(seed + m).standard_normal((m, k)).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _close(got, want, tol):
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _close_bf16(got, want):
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-5 * np.abs(want).max())


def _layer(w, i):
    return dataclasses.replace(w, layer=jnp.int32(i))


@pytest.mark.parametrize("m", [1, 8, 64])
def test_qmm_matches_pallas(m):
    jw, tw = _q8_pair(1024, K)
    xj, xt = _x(m)
    assert tq._supported_t(tw.at(1), K, m)
    for layer in (0, 1):
        want = np.asarray(pq.qmm(xj, _layer(jw, layer)))
        got = tq.qmm(xt, tw.at(layer)).numpy()
        assert got.dtype == np.float32 and got.shape == (m, 1024)
        _close(got, want, QMM_TOL)


def test_qmm_dq_form_at_one_row_matches_pallas():
    """The M = 1 dequantize form (the whole-MLP kernel's) against the
    reference's dequant kernel on that row, taken as one row of M = 8."""
    jw, tw = _q8_pair(1024, K, seed=1)
    xj, xt = _x(8)
    want = np.asarray(pq.qmm(xj, _layer(jw, 0)))[:1]
    _close(tq.qmm_plain(xt[:1], tw.at(0), dq=True).numpy(), want, QMM_TOL)


def test_gateup_matches_pallas_and_unfused():
    jw, tw = _q8_pair(2 * FF, K, seed=3)
    xj, xt = _x(8, seed=11)
    want = pq.qmm_gateup(xj, _layer(jw, 1), "silu")
    assert want is not None, "the Pallas gate-up refused the shape; test is vacuous"
    got = tq.qmm_gateup(xt, tw.at(1))
    assert got is not None and got.dtype == torch.bfloat16 and got.shape == (8, FF)
    _close_bf16(got.float().numpy(), np.asarray(want, np.float32))
    gu = tq.qmm(xt, tw.at(1)).to(torch.bfloat16)
    assert torch.equal(got, tq.silu(gu[:, :FF]) * gu[:, FF:])


def test_gateup_at_one_row_is_not_ported():
    """The M = 1 gate-up (_gateup_i8_gd_kernel), which raised here before
    the Q6_K slice ported it: now the group-dot form, equal to the M = 1
    matvec + silu·mul bit for bit and to the reference within bf16
    rounding."""
    jw, tw = _q8_pair(2 * FF, K, seed=3)
    xj, xt = _x(1, seed=11)
    got = tq.qmm_gateup(xt, tw.at(0))
    assert got is not None and got.dtype == torch.bfloat16 and got.shape == (1, FF)
    gu = tq.qmm(xt, tw.at(0)).to(torch.bfloat16)
    assert torch.equal(got, tq.silu(gu[:, :FF]) * gu[:, FF:])
    want = pq.qmm_gateup(xj, _layer(jw, 0), "silu")
    _close_bf16(got.float().numpy(), np.asarray(want, np.float32))


@pytest.fixture(scope="module")
def mlp_pair():
    return _q8_pair(2 * FF, K, seed=6), _q8_pair(C, FF, seed=7)


@pytest.mark.parametrize("m", [1, 8, 64])
def test_mlp_matches_pallas(mlp_pair, m):
    (jgu, tgu), (jd, td) = mlp_pair
    xj, xt = _x(m, seed=13)
    for layer in (0, 1):
        want = pq.qmm_mlp(xj, _layer(jgu, layer), _layer(jd, layer), "silu")
        assert want is not None, "the Pallas MLP kernel refused the shape; test is vacuous"
        got = tm.qmm_mlp(xt, tgu.at(layer), td.at(layer))
        assert got is not None and got.dtype == torch.bfloat16 and got.shape == (m, C)
        want = np.asarray(want, np.float32)
        _close(got.float().numpy(), want, 2 ** -6 if m == 1 else 2 ** -7)


@pytest.mark.parametrize("m", [1, 8])
def test_mlp_plain_is_gateup_then_down(mlp_pair, m):
    (_, tgu), (_, td) = mlp_pair
    _, xt = _x(m, seed=17)
    mid = tq.qmm_gateup_plain(xt, tgu.at(1), dq=True)
    want = tq.qmm_plain(mid, td.at(1), dq=True).to(torch.bfloat16)
    assert torch.equal(tm.qmm_mlp_plain(xt, tgu.at(1), td.at(1)), want)
    if m > 1:  # the same sequence as the public ops
        assert torch.equal(tq.qmm_gateup(xt, tgu.at(1)), mid)


def test_layer_views_equal_2d_tensors(mlp_pair):
    (_, tgu), (_, td) = mlp_pair
    _, xt = _x(8, seed=19)

    def flat(w, i):
        r = w.at(i).resolved()
        return dataclasses.replace(r, qw=r.qw.clone(), scales=r.scales.clone())

    for i in (0, 1):
        assert torch.equal(tq.qmm(xt, tgu.at(i)), tq.qmm(xt, flat(tgu, i)))
        assert torch.equal(tq.qmm(xt[:1], tgu.at(i)), tq.qmm(xt[:1], flat(tgu, i)))
        assert torch.equal(tq.qmm_gateup(xt, tgu.at(i)), tq.qmm_gateup(xt, flat(tgu, i)))
        assert torch.equal(tm.qmm_mlp(xt, tgu.at(i), td.at(i)),
                           tm.qmm_mlp(xt, flat(tgu, i), flat(td, i)))
    # the reference's rule: a stacked payload without a layer view is refused
    assert tm.qmm_mlp(xt, tgu, td) is None and tq.qmm_gateup(xt, tgu) is None


@pytest.mark.parametrize("ff,k,c", [(14336, 4096, 4096), (1024, 512, 512), (11008, 4096, 4096),
                                    (5632, 2048, 2048), (768, 512, 256), (512, 1536, 384)])
def test_dispatch_rules_equal_reference(ff, k, c):
    """The port's copies of _pick_bf_mlp and _pick_tiles_gateup decide as
    the reference does at every M the paths give them."""
    for m in (1, 8, 16, 64, 128, 256, 512, 2048):
        assert tm.mlp_fits(ff, k, c, m, 1, 1, 32, 2) == (
            pq._pick_bf_mlp(ff, k, c, m, 1, 1, 32, 2) != 0), (ff, m)
        assert tq._gateup_fits(ff, k, m, 1, 32, 2, 2, 9) == (
            pq._pick_tiles_gateup(ff, k, m, 1, 32, 2, 2, 9)[1] != 0), (ff, m)
    # the 7B shape: the MLP kernel up to M = 64, gate-up + down at M = 2048
    assert tm.mlp_fits(14336, 4096, 4096, 64, 1, 1, 32, 2)
    assert not tm.mlp_fits(14336, 4096, 4096, 2048, 1, 1, 32, 2)
    assert tq._gateup_fits(14336, 4096, 2048, 1, 32, 2, 2, 9)


def test_mlp_refuses_4_bit_weights():
    rng = np.random.default_rng(0)
    raw = jquantize(rng.standard_normal((256, 512)).astype(np.float32), JT.Q4_0)
    w = tqt.to_torch(_kernel_layout(_stack_qtensors(
        [tqt.repack_gguf_tensor(raw, TT.Q4_0, (256, 512))])), "cpu")
    assert w.kind == "i4t"
    assert tm.qmm_mlp(torch.zeros(1, 512, dtype=torch.bfloat16), w.at(0), w.at(0)) is None


def test_dq_splits():
    # the 7B shapes (ops.qmm.i8k_plan): one split of 256-row tiles at the
    # batch prefill, enough blocks of 64 rows at decode
    assert tq.i8k_plan(2048, 4096, 6144) == (256, 1)
    assert tq.i8k_plan(64, 4096, 6144) == (64, 4)
    assert tq.i8k_plan(64, 14336, 4096) == (64, 8)
    for m, k, n in ((1, 4096, 28672), (64, 4096, 32000), (16, 512, 1024), (8, 64, 128)):
        bm, ks = tq.i8k_plan(m, k, n)
        assert bm == (16 if m <= 16 else 64) and 1 <= ks <= max(1, k // 512)