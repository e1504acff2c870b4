"""The min term of the M > 1 tensor-core tiles with mins (csrc/qmm_i4t.cu
at groups 32 and 16: Q4_K, Q2_K; csrc/i8k_tile.cuh at group 32: Q5_K)
through its plain mirror on the CPU.  The tiles split each f32 group sum
xs of bf16 x into three bf16 parts (``ops.qmm.min_split``, the kernels'
bf16_ops.cuh split3) and run [hi | mid | lo] against [-m; -m; -m] as extra
rows of K (``ops.qmm.min_term``).

Held here: hi + mid + lo == xs exactly over random, large, tiny and
negative group sums at the Q4_K, Q2_K and Q5_K shapes; the three-part min
term within 2^-16 of sum_g |xs_g·m_g| of the f64 product at every output
(and the reference's own two-dot form, ``_min_corr`` of
booster_tpu/ops/pallas_qmm.py, within the same bound); the one-part split
(xs rounded to bf16, the rounding the reference warns of), the next
group's mins and the min term dropped each outside it; the plain matmul
on a weight whose payload sits at its zero point computes the min term
alone within it."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, ".")

from booster_tpu.ops.pallas_qmm import _min_corr  # noqa: E402
from booster_tpu_torch.ops import qmm as tq  # noqa: E402
from booster_tpu_torch.quant.qtensor import kernel_scales  # noqa: E402
from booster_tpu_torch.testing import (min_term_alone, min_term_reference,  # noqa: E402
                                       min_term_weight, q2k_weight, q4k_weight, q5k_weight,
                                       qmm_min_term_mutants)

# (format, group, K, weight maker): the path shapes' K (Llama-3-8B's 4096
# for Q4_K and Q2_K, DeepSeek-Coder-1.3B's 2048 for Q5_K), a narrow N
FORMATS = {"q4k": (32, 4096, q4k_weight), "q2k": (16, 4096, q2k_weight),
           "q5k": (32, 2048, q5k_weight)}
N = 64


def _x(M, K, kind, seed):
    """bf16 x [M, K]: normal draws scaled by kind (random, large, tiny), or
    all negative."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((M, K)).astype(np.float32)
    v = {"random": v, "large": v * 1e30, "tiny": v * 1e-30, "negative": -np.abs(v)}[kind]
    return torch.from_numpy(v).to(torch.bfloat16)


@pytest.fixture(scope="module")
def weights():
    return {f: make(N, K, seed=40 + i, device="cpu")
            for i, (f, (_, K, make)) in enumerate(FORMATS.items())}


@pytest.mark.parametrize("kind", ["random", "large", "tiny", "negative"])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_three_parts_add_up_to_the_group_sum_exactly(fmt, kind):
    G, K, _ = FORMATS[fmt]
    x = _x(8, K, kind, seed=len(kind))
    xs = x.float().reshape(8, -1, G).sum(-1)
    hi, mid, lo = tq.min_split(xs)
    for p in (hi, mid, lo):  # each a bf16 value
        assert torch.equal(p.to(torch.bfloat16).float(), p)
    assert torch.equal(hi.double() + mid.double() + lo.double(), xs.double())
    assert torch.equal((hi + mid) + lo, xs)  # exact in f32 too
    assert not torch.equal(hi, xs)  # the sums need more than one part


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_split_min_term_within_bound_and_mutants_outside(fmt, weights):
    """The three-part min term within 2^-16 of sum |xs·m| of the f64
    product at every output; the one-part split, the next group's mins and
    the min term dropped past it (the factor each lands at is stated)."""
    w = weights[fmt]
    K = FORMATS[fmt][1]
    x = _x(19, K, "random", seed=3)
    ref, bound = min_term_reference(x, w)
    got = min_term_alone(x, w)
    assert bool(((got.double() - ref).abs() <= bound).all())
    seen = {what: float(((out.double() - ref).abs() / bound).max())
            for what, out in qmm_min_term_mutants(x, w).items()}
    assert set(seen) == {"one-part split (xs rounded to bf16)", "the next group's mins",
                         "min term dropped"}
    for what, v in seen.items():
        assert v > 2, f"{fmt}: {what} at {v:.3g} of the bound"


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_two_parts_fall_between(fmt, weights):
    """One part short of three keeps 16 bits of xs: its worst output sits
    nearer the bound than the three-part split's, the one-part split's far
    past it (the finding the kernels' header records: the third part is
    kept)."""
    w = weights[fmt]
    x = _x(19, FORMATS[fmt][1], "random", seed=5)
    ref, bound = min_term_reference(x, w)
    err = {p: float(((min_term_alone(x, w, p).double() - ref).abs() / bound).max())
           for p in (1, 2, 3)}
    assert err[3] <= err[2] < 1 < err[1]


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_reference_min_dot_within_bound(fmt, weights):
    """The reference's two-dot min term (``_min_corr``: f32 group sums by an
    expander dot, then f32 against f32(bf16 m)) on the same x and mins,
    and the port's split form, both within the bound of the f64 product."""
    w = weights[fmt].resolved()
    G, K, _ = FORMATS[fmt]
    x = _x(5, K, "random", seed=7)
    ref, bound = min_term_reference(x, w)
    s3, _ = kernel_scales(w)
    m = s3[2:4].reshape(-1, N) if w.kind == "i4t" else s3[1]
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    jm = jnp.asarray(m.float().numpy()).astype(jnp.bfloat16)
    j = np.asarray(jax.jit(lambda a, b: _min_corr(a, b, G))(xj, jm), dtype=np.float64)
    assert bool(((torch.from_numpy(-j) - ref).abs() <= bound).all())
    assert bool(((min_term_alone(x, w).double() - ref).abs() <= bound).all())


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_plain_matmul_at_zero_point_is_the_min_term(fmt, weights):
    """``qmm`` on the CPU (the plain version) on a weight whose every nibble
    or byte is its zero point: the main dot is 0 and the output is the min
    term alone, within the bound (at M > 1, the tiles' form)."""
    w = weights[fmt]
    x = _x(33, FORMATS[fmt][1], "random", seed=9)
    ref, bound = min_term_reference(x, w)
    got = tq.qmm(x, min_term_weight(w))
    assert got.shape == ref.shape
    assert bool(((got.double() - ref).abs() <= bound).all())


def test_mins_tiles_tool_at_small_shapes():
    """tools/mins_tiles.py on the CPU (the plain versions; nothing timed):
    each form at each tile height it would try, checked against its plain
    version and, for a gate-up, against the matmul + silu·mul."""
    from booster_tpu_torch.tools import mins_tiles

    res = mins_tiles.main(["--device", "cpu", "--small"])
    assert res["card"] == "cpu" and res["rows"]
    assert {r["bm"] for r in res["rows"]} >= {16, 32, 64}
    assert all(r["ms"] == "not measured" for r in res["rows"])
