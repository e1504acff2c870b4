"""The scale-expansion and i4 probes of the port (booster_tpu_torch.ops.probes,
ops.probes_i4 and booster_tpu_torch.tools) against the JAX package's tools
on the CPU.

The Pallas functions of tools/expander_probe.py, tqmm_probe.py,
nibble_probe.py and groupdot_probe.py run once each at a small size under
the reference's TPU interpret mode (``pltpu.force_tpu_interpret_mode``),
with ``pallas_call`` patched to record each call's numpy inputs and output
(each call compiled with XLA's ``xla_allow_excess_precision`` off, so that
bf16 intermediates round where the Pallas body rounds them, as on the TPU):
expander_probe's part 1 through its own ``part1_semantics`` (its ``check``
patched to call the kernel without ``jax.jit``, so the call is recorded),
part 2's and tqmm_probe's kernels through their ``make_qmm`` /
``make_tqmm_*`` at a small N and K (their ``main`` fixes 4096), nibble_probe's
``main`` with its module sizes patched and groupdot_probe's ``run_i4`` /
``run_i8`` at N 512, K 4096 (two K steps of its grid), each ``timeit``
patched to call the step once.  Every function's recorded inputs then go
through the port's plain version, what the kernels of csrc/probe_i8.cu and
csrc/probe_i4.cu are held to on the card.

The JAX ``take`` variants do not trace in the reference ("captures
constants"), so the port's take (the repeat) is held to the tool's
``expand_ref`` and to jnp.repeat's recorded output, the same function.

Tolerances.  Exact: the expansion (part 1), the dequantized tiles, the
i8mask step against the current one (the same numbers: 16·(hi - 8) and
s1/16 are exact), castonly's block sums (integer sums below 2^24 here).
The matmuls are f32 sums of the same bf16-rounded products in another
order: within 2e-4 of the output's largest magnitude (chip_smoke.py's
"qmm" check).

The port's tools then run end to end with ``--device cpu`` at a tiny size
and refuse to run without CUDA unless the CPU is asked for."""

import sys

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

sys.path.insert(0, ".")

import jax.numpy as jnp  # noqa: E402

from booster_tpu_torch.ops import kernels, probes, probes_i4  # noqa: E402
from booster_tpu_torch.tools import (expander_probe, groupdot_probe, nibble_probe,  # noqa: E402
                                     timing, tqmm_probe)
from tools import expander_probe as j_exp  # noqa: E402
from tools import groupdot_probe as j_gd  # noqa: E402
from tools import nibble_probe as j_nib  # noqa: E402
from tools import tqmm_probe as j_tq  # noqa: E402
from booster_tpu_torch.testing import torch_threads  # noqa: E402

REL = 2e-4  # of the largest |reference|: f32 sums of the same products in another order
# XLA's CPU compile may keep a bf16 product in f32 where the next op widens
# it again (excess precision); off, every bf16 op of a Pallas body rounds
# where the body says, as on the TPU
EXACT_BF16 = {"xla_allow_excess_precision": False}
N2, K2, G, BM = 256, 512, 32, 8  # expander part 2's and tqmm's small sizes
# expander part 2's (variant, SUB, BN): SUB a multiple of SG = K2 / 32 for ptile
PART2 = (("dot_f32", 256, 128), ("dot_bf16", 256, 128), ("reshape", 256, 128),
         ("jrepeat", 256, 128), ("ptile", 256, 128), ("ptile", 128, 256), ("noscale", 256, 128),
         ("castonly", 256, 128), ("castonly", 128, 256), ("gloop", 256, 128))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


def _t(a: np.ndarray) -> torch.Tensor:
    """A recorded numpy array (bf16 as ml_dtypes) as a CPU torch tensor."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def recorded():
    """{tool: [(tag, inputs, output), ...]} of the JAX tools' Pallas calls at
    small sizes in interpret mode; "failed": {tag: error} of the calls that
    did not trace."""
    recs: list = []
    orig = pl.pallas_call

    def recording(kernel, *a, **kw):
        f = orig(kernel, *a, **kw)

        def call(*args):
            out = jax.jit(f).lower(*args).compile(EXACT_BF16)(*args)
            name = getattr(kernel, "func", kernel).__name__
            recs.append([name, [np.asarray(x) for x in args], np.asarray(out)])
            return out
        return call

    out: dict = {"failed": {}}

    def tagged(tag, fn, *args):
        n = len(recs)
        try:
            fn(*args)
        except Exception as e:  # noqa: BLE001 — the reference's take does not trace
            out["failed"][tag] = str(e)
        for r in recs[n:]:
            r[0] = tag

    def check(name, fn, *args, want):  # part1_semantics's check, without jax.jit
        tagged(name, fn, *args)

    def once(name, fn, carry, *rest, **kw):
        fn(carry, *rest)

    with pytest.MonkeyPatch.context() as mp, pltpu.force_tpu_interpret_mode():
        mp.setattr(pl, "pallas_call", recording)
        mp.setattr(j_exp, "check", check)
        j_exp.part1_semantics()
        out["expander1"], recs[:] = list(recs), []
        rng = np.random.default_rng(0)
        qw = jnp.asarray(rng.integers(-127, 127, (N2, K2)), jnp.int8)
        x = jnp.asarray(rng.normal(size=(BM, K2)), jnp.bfloat16)
        s_nk = rng.random((N2, K2 // G)).astype(np.float32) * 0.02
        for variant, sub, bn in PART2 + (("take", 256, 128),):
            qmm, _ = j_exp.make_qmm(N2, K2, G, BM, variant, SUB=sub, BN=bn)
            s = jnp.asarray(s_nk.T.copy() if variant == "gloop" else s_nk)
            tagged(f"{variant} {sub} {bn}", qmm, x, qw, s)
        out["expander2"], recs[:] = list(recs), []
        qk = jnp.asarray(rng.integers(-127, 127, (K2, N2)), jnp.int8)
        sk = jnp.asarray(rng.random((K2 // G, N2)).astype(np.float32) * 0.02)
        for variant in ("sub_reshape", "sub_repeat", "sub_ptile", "noscale"):
            tagged(variant, j_tq.make_tqmm_i8(N2, K2, G, BM, variant, SUB=256, BN=128), x, qk, sk)
        half = K2 // 2
        packed = jnp.asarray(rng.integers(0, 256, (half, N2)), jnp.uint8)
        s4 = jnp.asarray(rng.random((2, half // G, N2)).astype(np.float32) * 0.02)
        x3 = jnp.asarray(rng.normal(size=(BM, 2, half)), jnp.bfloat16)
        tagged("tqmm_i4", j_tq.make_tqmm_i4(N2, K2, G, BM, SUB=128, BN=128), x3, packed, s4)
        out["tqmm"], recs[:] = list(recs), []
        for name, v in (("N", 1408), ("K", 512), ("HALF", 256), ("PAYLOAD", 1408 * 256)):
            mp.setattr(j_nib, name, v)
        mp.setattr(j_nib, "timeit", once)
        j_nib.main()
        out["nibble"], recs[:] = list(recs), []
        mp.setattr(j_gd, "timeit", once)
        j_gd.run_i4("gd_i4", 512, 4096, False, (1, 2), False)
        j_gd.run_i4("gd_i4m", 512, 4096, True, (1, 2), False)
        j_gd.run_i8("gd_i8", 512, 4096, False, (1, 2), False)
        j_gd.run_i8("gd_i8raw", 512, 4096, True, (1, 2), False)
        out["groupdot"], recs[:] = list(recs), []
    return out


def _exact(got: torch.Tensor, want: np.ndarray) -> None:
    w = _t(want)
    assert got.dtype == w.dtype and got.shape == w.shape
    assert torch.equal(got, w)


def _err(got: torch.Tensor, want) -> tuple:
    w = (_t(want) if isinstance(want, np.ndarray) else want).double()
    assert got.shape == w.shape
    return float((got.double() - w).abs().max()), REL * float(w.abs().max())


def _close(got: torch.Tensor, want) -> None:
    err, limit = _err(got, want)
    assert err <= limit


def _far(got: torch.Tensor, want) -> None:
    """A wrong function: more than 8x the limit away."""
    err, limit = _err(got, want)
    assert err > 8 * limit


def _one(recorded, tool, tag):
    (args, out), = [(a, o) for n, a, o in recorded[tool] if n == tag]
    return [_t(a) for a in args], out


# -- expander_probe part 1: the expansion alone (#1, #2) -------------------------

@pytest.mark.parametrize("tag,bf16", [("reshape (bcast+merge, sublane g)", False),
                                      ("jnp.repeat", False), ("one-hot dot bf16", True)])
def test_expansion_repeats_each_scale(recorded, tag, bf16):
    (s,), out = _one(recorded, "expander1", tag)
    _exact(probes_i4.expand_plain(s, 32, 256, bf16=bf16), out)


def test_expansion_tile_semantics(recorded):
    (s,), out = _one(recorded, "expander1", "pltpu.repeat (tile semantics)")
    _exact(probes_i4.expand_plain(s, 32, 256, tile=True), out)
    assert not torch.equal(probes_i4.expand_plain(s, 32, 256), _t(out))


def test_take_is_the_repeat(recorded):
    """The reference's take does not trace; the port's take is the repeat,
    held to the tool's expand_ref and to jnp.repeat's recorded output."""
    assert "captures constants" in recorded["failed"]["jnp.take const idx"]
    (s,), rep = _one(recorded, "expander1", "jnp.repeat")
    got = probes_i4.expand_plain(s, 32, 256)
    _exact(got, j_exp.expand_ref(s.numpy(), 32)[:, :256])
    _exact(got, rep)


# -- expander_probe part 2: the N-major i8 matvec (#3-#7) ------------------------

@pytest.mark.parametrize("variant", ["dot_f32", "dot_bf16", "reshape", "jrepeat"])
def test_make_qmm_group_scales(recorded, variant):
    (x, q, s), out = _one(recorded, "expander2", f"{variant} 256 128")
    assert s.dtype == torch.float32 and tuple(s.shape) == (N2, K2 // G)
    got = probes.i8mm_plain(x, q, n_major=True, s=s, scale="group")
    _close(got, out)
    _far(probes.i8mm_plain(x, q, n_major=True, s=torch.roll(s, 1, 1), scale="group"), out)


def test_make_qmm_take_is_jrepeat(recorded):
    assert "captures constants" in recorded["failed"]["take 256 128"]
    (x, q, s), out = _one(recorded, "expander2", "jrepeat 256 128")
    _close(probes.i8mm_plain(x, q, n_major=True, s=s, scale="group"), out)


@pytest.mark.parametrize("sub,bn", [(256, 128), (128, 256)])
def test_make_qmm_ptile_is_periodic(recorded, sub, bn):
    """ptile's scales tile with period SG: column k takes s[n, k % SG]
    (whatever SUB and BN, SUB a multiple of SG)."""
    (x, q, s), out = _one(recorded, "expander2", f"ptile {sub} {bn}")
    _close(probes.i8mm_plain(x, q, n_major=True, s=s, scale="tile"), out)
    _far(probes.i8mm_plain(x, q, n_major=True, s=s, scale="group"), out)


def test_make_qmm_noscale(recorded):
    (x, q, _), out = _one(recorded, "expander2", "noscale 256 128")
    _close(probes.i8mm_plain(x, q, n_major=True), out)


@pytest.mark.parametrize("sub,bn", [(256, 128), (128, 256)])
def test_make_qmm_castonly_block_sums(recorded, sub, bn):
    (x, q, _), out = _one(recorded, "expander2", f"castonly {sub} {bn}")
    got = probes.blocksum_plain(q, x.shape[0], bn, sub)
    _exact(got, out)
    assert not torch.equal(probes.blocksum_plain(q, x.shape[0], sub, bn), got)


def test_make_qmm_gloop(recorded):
    """gloop's scales come pre-transposed [SG, N]: the group form reads them
    through the transposed view."""
    (x, q, s), out = _one(recorded, "expander2", "gloop 256 128")
    assert tuple(s.shape) == (K2 // G, N2)
    _close(probes.i8mm_group_plain(x, q, s.t(), n_major=True), out)
    _far(probes.i8mm_group_plain(x, q, torch.ones_like(s).t(), n_major=True), out)


# -- tqmm_probe: K-major i8 with f32 scales (#8-#10), split-half i4 (#11) ----------

@pytest.mark.parametrize("variant", ["sub_reshape", "sub_repeat"])
def test_tqmm_i8_group_scales(recorded, variant):
    (x, q, s), out = _one(recorded, "tqmm", variant)
    assert s.dtype == torch.float32 and tuple(s.shape) == (K2 // G, N2)
    _close(probes.i8mm_plain(x, q, s=s, scale="group"), out)
    _far(probes.i8mm_plain(x, q, s=torch.roll(s, 1, 0), scale="group"), out)


def test_tqmm_i8_sub_ptile(recorded):
    (x, q, s), out = _one(recorded, "tqmm", "sub_ptile")
    _close(probes.i8mm_plain(x, q, s=s, scale="tile"), out)
    _far(probes.i8mm_plain(x, q, s=s, scale="group"), out)


def test_tqmm_i8_noscale(recorded):
    (x, q, _), out = _one(recorded, "tqmm", "noscale")
    _close(probes.i8mm_plain(x, q), out)


def test_tqmm_i4_split_half(recorded):
    (x3, q, s), out = _one(recorded, "tqmm", "tqmm_i4")
    _close(probes_i4.i4mm_plain(x3, q, s), out)
    _close(probes_i4.qmm_i4t_plain(x3, probes_i4.i4t_weight(q, s)), out)  # the serving kernel's
    swapped = torch.stack([s[1], s[0]])
    _far(probes_i4.i4mm_plain(x3, q, swapped), out)


# -- nibble_probe (#12-#15) ---------------------------------------------------------

def _steps(recorded):
    """nibble_probe's six steps: (bm, mode) → (x3, q, s), output, in main's order."""
    runs = [(a, o) for n, a, o in recorded["nibble"] if n == "kernel"]
    assert len(runs) == 6
    keys = [(bm, mode) for bm in (8, 64) for mode in ("current", "i8mask", "affine")]
    return {k: ([_t(a) for a in args], o) for k, (args, o) in zip(keys, runs)}


@pytest.mark.parametrize("bm", [8, 64])
@pytest.mark.parametrize("mode", ["current", "i8mask", "affine"])
def test_nibble_steps(recorded, bm, mode):
    (x3, q, s), out = _steps(recorded)[(bm, mode)]
    assert x3.shape[0] == bm and s.shape[0] == probes_i4.SCALE_ROWS[mode]
    _close(probes_i4.i4mm_plain(x3, q, s, mode), out)


@pytest.mark.parametrize("bm", [8, 64])
def test_nibble_i8mask_is_current_bit_for_bit(recorded, bm):
    steps = _steps(recorded)
    (x3, q, s_cur), cur = steps[(bm, "current")]
    (_, _, s_sub), sub = steps[(bm, "i8mask")]
    assert np.array_equal(cur, sub)
    assert torch.equal(probes_i4.i4mm_plain(x3, q, s_sub, "i8mask"),
                       probes_i4.i4mm_plain(x3, q, s_cur, "current"))


def test_nibble_affine_rounds_elsewhere(recorded):
    steps = _steps(recorded)
    (x3, q, s_aff), aff = steps[(8, "affine")]
    (_, _, s_cur), _ = steps[(8, "current")]
    w_aff = probes_i4.nibble_tiles_plain(q, s_aff, "affine")[0]
    w_cur = probes_i4.nibble_tiles_plain(q, s_cur, "current")[0]
    assert not torch.equal(w_aff, w_cur)  # bf16(bf16(lo·s0) - bf16(8·s0)) is another number


@pytest.mark.parametrize("i,mode", [(0, "i8mask"), (1, "affine"), (2, "current")])
def test_nibble_check_tiles_are_exact(recorded, i, mode):
    (q, s), out = [([_t(a) for a in args], o) for n, args, o in recorded["nibble"]
                   if n == "k"][i]
    assert tuple(q.shape) == (256, 128) and s.shape[0] == probes_i4.SCALE_ROWS[mode]
    _exact(torch.stack(probes_i4.nibble_tiles_plain(q, s, mode)), out)


# -- groupdot_probe (#16-#18) -------------------------------------------------------

@pytest.mark.parametrize("tag,fmt", [("_gd_i4_kernel", "i4"), ("_gd_i4m_kernel", "i4m")])
def test_groupdot_i4(recorded, tag, fmt):
    (x, q, s), out = _one(recorded, "groupdot", tag)
    _close(probes_i4.groupdot_plain(x, q, s, fmt), out)
    if fmt == "i4":
        _far(probes_i4.groupdot_plain(x, q, torch.cat([s, 0 * s]), "i4m"), out)  # the zero dropped
    else:
        _far(probes_i4.groupdot_plain(x, q, torch.cat([s[:2], 0 * s[2:]]), "i4m"), out)


def test_groupdot_i8_raw_and_cast(recorded):
    runs = [([_t(a) for a in args], o) for n, args, o in recorded["groupdot"]
            if n == "_gd_i8_kernel"]
    assert len(runs) == 2  # raw False and True: one function
    for (x, q, s), out in runs:
        _close(probes_i4.groupdot_plain(x, q, s, "i8"), out)


def test_every_pallas_function_was_recorded(recorded):
    names = {tool: sorted({n for n, _, _ in recs}) for tool, recs in recorded.items()
             if tool not in ("failed",)}
    assert names["expander1"] == sorted(["reshape (bcast+merge, sublane g)", "jnp.repeat",
                                         "pltpu.repeat (tile semantics)", "one-hot dot bf16"])
    assert names["expander2"] == sorted({f"{v} {s} {b}" for v, s, b in PART2})
    assert names["tqmm"] == ["noscale", "sub_ptile", "sub_repeat", "sub_reshape", "tqmm_i4"]
    assert names["nibble"] == ["k", "kernel"]
    assert names["groupdot"] == ["_gd_i4_kernel", "_gd_i4m_kernel", "_gd_i8_kernel"]
    assert set(recorded["failed"]) == {"jnp.take const idx", "take 256 128"}


# -- the plain versions' own rules --------------------------------------------------

def test_blocksum_is_exact_past_2_24():
    """castonly's tile sums are integers summed in i32: 1024 x 1024 x 127
    passes 2^24, where an f32 sum would round."""
    q = torch.full((1024, 1024), 127, dtype=torch.int8)
    got = probes.blocksum_plain(q, 2, 1024, 1024)
    assert float(got[0, 0]) == float(torch.tensor(1024 * 1024 * 127, dtype=torch.float32)
                                     * torch.tensor(1e-9, dtype=torch.float32))


@pytest.mark.parametrize("tile,want", [(False, 8 * (8 + 256) * 4), (True, 8 * (128 + 256) * 4)])
def test_expansion_bytes_count_the_columns_read(tile, want):
    # part 1: a repeat of g 32 to 256 columns reads s[:, :8], a tile all 128
    assert probes_i4.expand_bytes(8, 128, 32, 256, tile) == want
    s = torch.arange(8 * 128, dtype=torch.float32).reshape(8, 128)
    cols = probes_i4.expand_plain(s, 32, 256, tile).unique().numel() // 8
    assert 4 * 8 * (cols + 256) == want


def test_recount_moves_one_launch_to_the_probe_key():
    kernels.reset_counts()
    kernels.count("qmm_i4t_dq", (256, 128))
    kernels.count("qmm_i4t_dq", (256, 128))
    kernels.recount("qmm_i4t_dq", "probe_qmm_i4t_dq", (256, 128))
    assert kernels.launch_counts["qmm_i4t_dq"] == 1
    assert kernels.launch_counts["probe_qmm_i4t_dq"] == 1
    kernels.recount("qmm_i4t_dq", "probe_qmm_i4t_dq", (256, 128))
    assert kernels.shape_counts == {("probe_qmm_i4t_dq", (256, 128)): 2}
    kernels.reset_counts()


def test_i4mm_split_count_is_a_function_of_the_shape():
    assert probes_i4.i4mm_splits(8, 4096, 4096) == 9  # 32 column tiles
    assert probes_i4.i4mm_splits(64, 2048, 11264) == 3
    assert probes_i4.i4mm_splits(8, 128, 128) == 1  # two groups of payload rows


def test_wrappers_take_the_plain_versions_on_the_cpu():
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.integers(0, 256, (256, 128), dtype=np.uint8))
    s = torch.from_numpy(rng.random((3, 8, 128)).astype(np.float32))
    x3 = torch.from_numpy(rng.normal(size=(4, 2, 256)).astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(probes_i4.i4mm(x3, q, s, "affine"), probes_i4.i4mm_plain(x3, q, s, "affine"))
    assert all(torch.equal(a, b) for a, b in zip(probes_i4.nibble_tiles(q, s, "affine"),
                                                 probes_i4.nibble_tiles_plain(q, s, "affine")))
    assert torch.equal(probes_i4.expand(s[0], 32, 64), probes_i4.expand_plain(s[0], 32, 64))
    x1 = x3[:1].contiguous()
    assert torch.equal(probes_i4.groupdot(x1, q, s[:2].contiguous(), "i4"),
                       probes_i4.groupdot_plain(x1, q, s[:2].contiguous(), "i4"))
    w = probes_i4.i4t_weight(q, s[:2])
    assert torch.equal(probes_i4.qmm_i4t(x3, w), probes_i4.qmm_i4t_plain(x3, w))
    qi = q.view(torch.int8)
    assert torch.equal(probes.blocksum(qi, 2, 128, 128), probes.blocksum_plain(qi, 2, 128, 128))


# -- the port's tools, end to end on the CPU ----------------------------------------

TOOLS = {
    "expander_probe": (expander_probe, ["--n", "1024", "--k", "1024"], 15),
    "tqmm_probe": (tqmm_probe, ["--n", "256", "--k", "512"], 12),
    "nibble_probe": (nibble_probe, ["--n", "256", "--k", "512"], 17),
    "groupdot_probe": (groupdot_probe, ["--shapes", "256:512:gateup,128:1024:down"], 12),
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
        assert r["bound_ms"] >= 0 and r["kernel"] is not None
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 + n_rungs and all("not measured" in ln for ln in lines[1:])


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_needs_cuda_unless_the_cpu_is_asked_for(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TOOLS[tool][0].main([])


def test_expander_bm_runs_part_2_alone():
    res = expander_probe.main(["--device", "cpu", "--bm", "4", "--n", "1024", "--k", "1024"])
    assert len(res["rungs"]) == 10 and res["rungs"][0]["name"].startswith("qmm[dot_f32")
