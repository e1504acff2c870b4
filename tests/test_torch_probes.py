"""The i8 stream probes of the port (booster_tpu_torch.ops.probes and
booster_tpu_torch.tools) against the JAX package's tools on the CPU.

Each JAX tool (tools/kernel_micro.py, cast_probe.py, mmq_probe.py,
qmm_gap.py, qmm_probe.py) runs once at a small size under the reference's
TPU interpret mode (``pltpu.force_tpu_interpret_mode``), its ``timeit``
patched to call the step once and ``pallas_call`` patched to record each
call's numpy inputs and output; kernel_micro stops after its read step
(a sentinel from the patched ``timeit``), whose shape its ``main`` fixes.
Each of the 21 Pallas functions' recorded inputs then go through the
port's plain version (what the kernels of csrc/probe_i8.cu are held to on
the card).

Tolerances.  The column sums and the integer dots are bit-exact (integer
sums, and bf16-rounded block sums of integers, are exact in f32).  The
bf16-x forms and the per-group rescales are f32 sums of the same products
in another order (with the same bf16 roundings of the dequantized weight):
within 2e-4 of the output's largest magnitude, chip_smoke.py's "qmm"
check.

The port's tools then run end to end with ``--device cpu`` at a tiny size
(each rung once through the plain versions, every time "not measured"),
and refuse to run without CUDA unless the CPU is asked for."""

import sys

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

sys.path.insert(0, ".")

from booster_tpu_torch.ops import probes  # noqa: E402
from booster_tpu_torch.tools import (cast_probe, kernel_micro, mmq_probe, qmm_clean,  # noqa: E402
                                     qmm_gap, qmm_probe, timing)
from tools import cast_probe as j_cast  # noqa: E402
from tools import kernel_micro as j_micro  # noqa: E402
from tools import mmq_probe as j_mmq  # noqa: E402
from tools import qmm_gap as j_gap  # noqa: E402
from tools import qmm_probe as j_probe  # noqa: E402
from booster_tpu_torch.testing import torch_threads  # noqa: E402

REL = 2e-4  # of the largest |reference|: f32 sums of the same products in another order


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


class _Stop(Exception):
    """Raised by kernel_micro's patched timeit after its read step."""


def _t(a: np.ndarray) -> torch.Tensor:
    """A recorded numpy array (bf16 as ml_dtypes) as a CPU torch tensor."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def recorded():
    """{tool: [(kernel name, inputs, output), ...]} of the JAX tools' Pallas
    calls at small sizes, in interpret mode."""
    recs: list = []
    orig = pl.pallas_call

    def recording(kernel, *a, **kw):
        f = orig(kernel, *a, **kw)

        def call(*args):
            out = f(*args)
            name = getattr(kernel, "func", kernel).__name__
            recs.append((name, [np.asarray(x) for x in args], np.asarray(out)))
            return out
        return call

    def once(name, fn, carry, *rest, **kw):
        fn(carry, *rest)

    def once_then_stop(name, fn, *args, **kw):
        fn(*args)
        if name.startswith("raw u8 read"):
            raise _Stop

    out = {}
    with pytest.MonkeyPatch.context() as mp, pltpu.force_tpu_interpret_mode():
        mp.setattr(pl, "pallas_call", recording)
        mp.setattr(j_cast, "N", 2048)
        mp.setattr(j_cast, "K", 512)
        mp.setattr(j_cast, "BM", 16)
        mp.setattr(j_cast, "timeit", once)
        j_cast.main()
        out["cast_probe"], recs[:] = list(recs), []
        mp.setattr(j_gap, "timeit", once)
        mp.setattr(sys, "argv", ["qmm_gap", "--m", "16", "--n", "256", "--k", "512",
                                 "--bk", "256", "--bn", "128", "--variants",
                                 "v0,v1,v2,v3,v4,v5,v6,v7"])
        j_gap.main()
        out["qmm_gap"], recs[:] = list(recs), []
        for name, v in (("M", 16), ("N", 256), ("K", 2048), ("BN", 128)):
            mp.setattr(j_probe, name, v)
        mp.setattr(j_probe, "timeit", once)
        j_probe.main()
        out["qmm_probe"], recs[:] = list(recs), []
        rng = np.random.default_rng(0)
        w = jax.numpy.asarray(rng.integers(-127, 127, (512, 256)), jax.numpy.int8)
        j_mmq.int_mm(jax.numpy.asarray(rng.integers(-127, 127, (16, 512)), jax.numpy.int8), w,
                     jax.numpy.int32, bn=128, bk=256)
        j_mmq.int_mm(jax.numpy.asarray(rng.normal(size=(16, 512)), jax.numpy.bfloat16), w,
                     jax.numpy.float32, bn=128, bk=256)
        out["mmq_probe"], recs[:] = list(recs), []
        mp.setattr(j_micro, "timeit", once_then_stop)
        with pytest.raises(_Stop):
            j_micro.main()
        out["kernel_micro"], recs[:] = list(recs), []
    return out


def _exact(got: torch.Tensor, want: np.ndarray) -> None:
    w = _t(want)
    assert got.dtype == w.dtype and got.shape == w.shape
    assert torch.equal(got, w)


def _close(got: torch.Tensor, want: np.ndarray) -> None:
    w = _t(want).double()
    assert got.shape == w.shape
    assert float((got.double() - w).abs().max()) <= REL * float(w.abs().max())


# -- A: the column sums --------------------------------------------------------

def test_read_kernel_is_the_exact_u8_column_sum(recorded):
    (name, (big,), out), = recorded["kernel_micro"]
    assert name == "_read_kernel" and big.shape == (11264, 1024) and big.dtype == np.uint8
    _exact(probes.colsum_plain(_t(big), "i32"), out)


@pytest.mark.parametrize("fn,mode", [("k_sum_i32", "i32"), ("k_sum_f32", "f32"),
                                     ("k_sum_bf16", "bf16")])
def test_cast_probe_sums_are_exact(recorded, fn, mode):
    ((q,), out), = [(a, o) for n, a, o in recorded["cast_probe"] if n == fn]
    _exact(probes.colsum_plain(_t(q), mode, cast_probe.BN), out)


# -- B and C over cast_probe's N-major weight ----------------------------------

@pytest.mark.parametrize("fn", ["k_dot", "k_dot_sub", "k_dot_mixed", "k_dot_i8"])
def test_cast_probe_dots(recorded, fn):
    ((q, x), out), = [(a, o) for n, a, o in recorded["cast_probe"] if n == fn]
    got = probes.i8mm_plain(_t(x), _t(q), n_major=True)
    (_exact if fn == "k_dot_i8" else _close)(got, out)


@pytest.mark.parametrize("out_i32", [True, False], ids=["a_i8_i32", "b_bf16_f32"])
def test_mmq_int_mm(recorded, out_i32):
    (name, (x, w), out), = [r for r in recorded["mmq_probe"] if (r[2].dtype == np.int32)
                            == out_i32]
    assert name == "kern"
    got = mmq_probe.int_mm_plain(_t(x), _t(w), torch.int32 if out_i32 else torch.float32)
    (_exact if out_i32 else _close)(got, out)


# -- qmm_gap's ladder ------------------------------------------------------------

def _gap(recorded, v):
    (args, out), = [(a, o) for n, a, o in recorded["qmm_gap"] if n == f"{v}_kern"]
    return [_t(a) for a in args], out


@pytest.mark.parametrize("v", ["v0", "v1"])
def test_qmm_gap_unscaled(recorded, v):
    (x, q), out = _gap(recorded, v)
    _close(probes.i8mm_plain(x, q), out)


def test_qmm_gap_v2_scale_plane(recorded):
    (x, q, s), out = _gap(recorded, "v2")
    _close(probes.i8mm_plain(x, q, s=s, scale="plane"), out)


def test_qmm_gap_v3_group_scales(recorded):
    (x, q, s), out = _gap(recorded, "v3")
    _close(probes.i8mm_plain(x, q, s=s, scale="group"), out)


def test_qmm_gap_v5_reordered_scales(recorded):
    """v5's scale row of K row r in block b is b·bk/32 + r % (bk/32) (bk 256
    here); read as v3 it is another function."""
    (x, q, s), out = _gap(recorded, "v5")
    _close(probes.i8mm_plain(x, q, s=s, scale="reorder", bk=256), out)
    as_v3 = probes.i8mm_plain(x, q, s=s, scale="group")
    assert float((as_v3.double() - _t(out).double()).abs().max()) > 8 * REL * float(
        np.abs(out).max())


@pytest.mark.parametrize("v,group", [("v4", 32), ("v6", 32), ("v7", 128)])
def test_qmm_gap_group_rescale(recorded, v, group):
    (x, q, s), out = _gap(recorded, v)
    assert (x.dtype == torch.int8) == (v == "v4")
    _close(probes.i8mm_group_plain(x, q, s, group=group), out)


# -- qmm_probe's N-major variants ------------------------------------------------

def _probe(recorded, fn):
    return [([_t(a) for a in args], out) for n, args, out in recorded["qmm_probe"]
            if n == fn]


def test_qmm_probe_current_at_each_sub(recorded):
    runs = _probe(recorded, "v_current")
    assert len(runs) == 3  # sub 256, 512, 2048: one function
    for (x, q, s), out in runs:
        _close(probes.i8mm_plain(x, q, n_major=True, s=s, scale="group"), out)


def test_qmm_probe_cast_only(recorded):
    ((x, q, _), out), = _probe(recorded, "v_cast_only")
    _close(probes.i8mm_plain(x, q, n_major=True), out)


def test_qmm_probe_dot_only_is_exact(recorded):
    ((x, q, _), out), = _probe(recorded, "v_dot_only")
    _exact(probes.i8mm_plain(x, q, n_major=True, out_i32=True), out)


def test_qmm_probe_group_dots(recorded):
    ((x, q, s), out), = _probe(recorded, "v_group_dots")
    assert s.dtype == torch.float32  # f32 scales, not rounded to bf16
    _close(probes.i8mm_group_plain(x, q, s, n_major=True), out)


def test_every_pallas_function_was_recorded(recorded):
    names = {n for recs in recorded.values() for n, _, _ in recs}
    assert names == {"_read_kernel", "k_sum_i32", "k_sum_f32", "k_sum_bf16", "k_dot",
                     "k_dot_sub", "k_dot_i8", "k_dot_mixed", "kern", "v0_kern", "v1_kern",
                     "v2_kern", "v3_kern", "v4_kern", "v5_kern", "v6_kern", "v7_kern",
                     "v_current", "v_cast_only", "v_dot_only", "v_group_dots"}


# -- the plain versions' own rules -----------------------------------------------

def test_bf16_block_sums_round_each_block():
    """k_sum_bf16 rounds each 1024-row block's sum to bf16 (8 bits): a block
    of 1024 rows of 127 sums to 130048 and rounds to 130048, one of 1024
    rows of 1 plus one 3 sums to 1026 and rounds to 1024."""
    q = torch.ones(2048, 1024, dtype=torch.int8)
    q[0] = 3
    q[1024:] = 127
    got = probes.colsum_plain(q, "bf16")
    assert float(got[0, 0]) == 1024.0 + 130048.0
    assert float(probes.colsum_plain(q, "f32")[0, 0]) == 1026.0 + 130048.0


def test_split_count_is_a_function_of_the_shape():
    assert probes.splits(64, 4096, 4096) == 9  # 32 column tiles, ~264 blocks
    assert probes.splits(64, 4096, 11264) == 3
    assert probes.splits(64, 256, 128) == 1  # one unit of 128 rows per split at least twice
    assert probes.splits(64, 4096, 28672) == 2


def test_wrappers_take_the_plain_versions_on_the_cpu():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(-127, 127, (4, 256), dtype=np.int8))
    q = torch.from_numpy(rng.integers(-127, 127, (256, 128), dtype=np.int8))
    s = torch.from_numpy(rng.random((8, 128)).astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(probes.i8mm(x, q, out_i32=True), probes.i8mm_plain(x, q, out_i32=True))
    assert torch.equal(probes.i8mm_group(x, q, s), probes.i8mm_group_plain(x, q, s))
    assert torch.equal(probes.colsum(q, "i32", 128), probes.colsum_plain(q, "i32", 128))


# -- the port's tools, end to end on the CPU -------------------------------------

TOOLS = {
    "kernel_micro": (kernel_micro, ["--layers", "4", "--batch", "4", "--seq", "128", "--rows",
                                    "2048", "--qmm-shapes", "256:128:qkv,128:256:down"], 9),
    "cast_probe": (cast_probe, ["--n", "2048", "--k", "512", "--bm", "16"], 7),
    "mmq_probe": (mmq_probe, ["--m", "16", "--shapes", "256:512:qkv,128:384:down"], 4),
    "qmm_gap": (qmm_gap, ["--m", "16", "--n", "256", "--k", "512", "--bk", "256", "--variants",
                          "v0,v1,v2,v3,v4,v5,v6,v7"], 8),
    "qmm_probe": (qmm_probe, ["--m", "16", "--n", "256", "--k", "128"], 6),
    "qmm_clean": (qmm_clean, ["--shapes", "256:512:qkv", "--bm", "4", "--dense"], 8),
}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_runs_on_the_cpu(tool, capsys):
    mod, args, n_rungs = TOOLS[tool]
    res = mod.main(["--device", "cpu", *args])
    assert res["tool"] == tool and res["card"] == "cpu"
    assert len(res["rungs"]) == n_rungs
    for r in res["rungs"]:
        assert r["ok"] and r["ms"] == r["warm_ms"] == timing.NOT_MEASURED
        assert r["gb_s"] == timing.NOT_MEASURED and r["launches"] == 0
        assert r["bound_ms"] >= 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 + n_rungs and all("not measured" in ln for ln in lines[1:])


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_needs_cuda_unless_the_cpu_is_asked_for(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TOOLS[tool][0].main([])


def test_qmm_clean_refuses_q4_k():
    """q4_K, the one format of the JAX tool that the port refused, now runs
    in both layouts (the lane-major form with its mins); a format the tool
    does not know is still refused."""
    res = qmm_clean.main(["--device", "cpu", "--fmts", "q4_K", "--shapes", "256:512:qkv"])
    assert [r["name"] for r in res["rungs"][1:]] == ["q4_K qkv lane [256x512]",
                                                     "q4_K qkv kmaj [256x512]"]
    assert all(r["ok"] for r in res["rungs"])
    with pytest.raises(SystemExit):
        qmm_clean.main(["--device", "cpu", "--fmts", "q5_K"])


def test_qmm_gap_ignores_the_tpu_tile_knobs():
    a = qmm_gap.main(["--device", "cpu", "--m", "16", "--n", "128", "--k", "256", "--bk",
                      "128", "--variants", "v5"])
    b = qmm_gap.main(["--device", "cpu", "--m", "16", "--n", "128", "--k", "256", "--bk",
                      "128", "--variants", "v5", "--bn", "512", "--sub", "64"])
    assert [r["bound_ms"] for r in a["rungs"]] == [r["bound_ms"] for r in b["rungs"]]


def test_measure_times_nothing_on_the_cpu():
    m = timing.measure(lambda: None, torch.device("cpu"))
    assert m == {"ms": "not measured", "warm_ms": "not measured", "calls": 0}
    assert timing.bound(3.35e9, 0) == (1.0, "bytes")
    assert timing.bound(0, 989e9) == (1.0, "operations")
