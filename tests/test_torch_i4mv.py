"""The M = 1 i4t matvec's plan and arithmetic, and the appends' launches, on
the CPU.

csrc/i4mv.cuh runs qmm_i4t.cu's matvec and fused gate-up at one row of x:
a warp takes one group at a time (G payload rows hold group g of both
halves) and runs its dots on the tensor cores, the groups of a K split
dealt to a block's 8 warps in turn; a block adds its warps in order, and a
128-column tile's KS splits, one cluster, add in split order.  The wrapper
takes KS from ``ops.qmm.i4t_mv_plan``, a function of (K, N, G) alone, which
keeps the fused gate-up equal to the matvec on its fused weight.  These
tests hold the plan to what the kernel needs, the wrapper to the plan and
to every shape a path sends it (through a stand-in for the compiled
library, so no card is needed), and the sum order, mirrored in plain torch
(``testing.qmm_i4t_mv_split``), to the matmuls' limit (2e-4 of the largest
output) against the plain version; each wrong kernel of
``testing.qmm_i4t_mutants`` must land 8x past it.  csrc/kv_append.cu runs one
warp a row, 8 rows a block: the wrappers hand the library the shapes from
which every row gets a warp, at D up to 1024."""

import types

import numpy as np
import pytest
import torch

from booster_tpu_torch.gguf import GGMLType
from booster_tpu_torch.ops import kernels
from booster_tpu_torch.ops import kv_append as ka
from booster_tpu_torch.ops import qmm as tq
from booster_tpu_torch.quant.qtensor import QTensor
from booster_tpu_torch.testing import (i4t_mv_groups, i4t_mv_last, qmm_i4t_mutants,
                                       qmm_i4t_mv_split)
from booster_tpu_torch.testing import torch_threads

G = 32  # Q4_0's group, the only one the kernel takes yet

# (K, N) of the M = 1 i4t calls of the paths: TinyLlama's generate (qkv,
# wo, down, lm head), MPT-7B's generate_mpt (qkv, wo, up, down), Mixtral's
# generate_moe (qkv, wo, lm head), and groupdot_probe's down on the same
# kernel; the fused gate-ups [K, 2ff]: TinyLlama's (ff 5632), which the
# probe tool also runs
MATVECS = [(2048, 2560), (2048, 2048), (5632, 2048), (2048, 32000),
           (4096, 12288), (4096, 4096), (4096, 16384), (16384, 4096),
           (4096, 6144), (4096, 32000)]
GATEUPS = [(2048, 11264)]
# ragged: fewer groups than warps, a group count no power of two, splits of
# a group a warp or fewer, one tile
RAGGED = [(64, 128), (512, 128), (1088, 384), (1024, 384), (5632, 640), (16384, 128)]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


@pytest.mark.parametrize("K,N", MATVECS + GATEUPS + RAGGED)
def test_plan_groups_cover_each_group_once(K, N):
    """Every group of each half in exactly one warp of one split; the splits
    contiguous and in order; the warps of a split within one group of each
    other, each with one at least where there are splits; at most 8 splits
    (one cluster) and at most two blocks an SM once there is more than one."""
    ks = tq.i4t_mv_plan(K, N, G)
    assert 1 <= ks <= 8
    ngh = K // (2 * G)
    splits = i4t_mv_groups(ngh, ks)
    assert len(splits) == ks and all(len(warps) == 8 for warps in splits)
    assert sorted(g for warps in splits for gs in warps for g in gs) == list(range(ngh))
    spans = [(min(g for gs in warps for g in gs), max(g for gs in warps for g in gs) + 1)
             for warps in splits]
    assert spans[0][0] == 0 and spans[-1][1] == ngh
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    for warps in splits:
        n = [len(gs) for gs in warps]
        assert max(n) - min(n) <= 1 and (min(n) >= 1 or ks == 1)
        assert all(gs == sorted(gs) for gs in warps)
    assert (N // 128) * ks <= 2 * 132 or ks == 1
    assert i4t_mv_last(ngh, ks)[0] == (spans[-1][0] if ks > 1 else ngh - 1)


@pytest.mark.parametrize("K,N,ks", [(2048, 2560, 4), (2048, 2048, 4), (5632, 2048, 8),
                                    (2048, 32000, 1), (2048, 11264, 2), (4096, 12288, 1),
                                    (4096, 4096, 6), (4096, 16384, 1), (16384, 4096, 6),
                                    (4096, 6144, 4), (4096, 32000, 1)])
def test_plan_at_the_path_shapes(K, N, ks):
    """One split from 93 column tiles on (MPT-7B's qkv and up, the lm
    heads); below, mv_plan's rule over the groups: about 1.5 blocks an SM,
    at most 8 splits, at least a group a warp (the fused gate-up's 88
    tiles: 2)."""
    assert tq.i4t_mv_plan(K, N, G) == ks


def _i4t(K, N, R, zero, seed):
    rng = np.random.default_rng(seed)
    qw = torch.from_numpy(rng.integers(0, 256, (K // 2, N), dtype=np.uint8))
    s = torch.from_numpy((rng.random((R, K // 64, N)) * 0.02 + 1e-3).astype(np.float32))
    return QTensor("i4t", qw, s.to(torch.bfloat16), None, G, (N, K), GGMLType.Q4_0, zero=zero)


def _x(K, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((1, K), dtype=np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("zero", [0, 8])
@pytest.mark.parametrize("R", [2, 4])
@pytest.mark.parametrize("K,N", [(2048, 640), (1088, 384), (4096, 128)])
def test_mv_split_within_limit_and_mutants_past_it(K, N, R, zero):
    """The mirror at the plan's splits (4, 4 and 8 here) within 2e-4 of the
    largest output of qmm_plain; the nibbles swapped, the scale rows a group
    off, the zero ignored, the mins dropped and the last split (its groups
    of both halves) left out land 8x past that, as does the mirror with its
    first or last split's sum dropped."""
    w, x = _i4t(K, N, R, zero, seed=K + N + R + zero), _x(K, seed=K + zero)
    ks = tq.i4t_mv_plan(K, N, G)
    assert ks > 1  # the split is exercised
    want = tq.qmm_plain(x, w)
    limit = 2e-4 * float(want.abs().max())
    assert float((qmm_i4t_mv_split(x, w, ks) - want).abs().max()) <= limit
    seen = {what: float((tq.qmm_plain(xm, wm) - want).abs().max()) / limit
            for what, (xm, wm) in qmm_i4t_mutants(x, w, i4t_mv_last(K // 64, ks)).items()}
    for s in (0, ks - 1):
        seen[f"split {s} dropped"] = float(
            (qmm_i4t_mv_split(x, w, ks, drop=s) - want).abs().max()) / limit
    assert len(seen) == 5 + (zero > 0) + (R == 4)
    assert min(seen.values()) >= 8, seen


@pytest.mark.parametrize("ks", [1, 3, 8])
def test_mv_split_at_any_split_count(ks):
    """The mirror at split counts other than the plan's (one split, whose
    last group is the one the check leaves out; a count that does not divide
    the groups; eight) stays within the limit, and a missing last group
    lands 8x past it."""
    K, N = 1088, 256
    w, x = _i4t(K, N, 2, 8, seed=ks), _x(K, seed=ks)
    want = tq.qmm_plain(x, w)
    limit = 2e-4 * float(want.abs().max())
    assert float((qmm_i4t_mv_split(x, w, ks) - want).abs().max()) <= limit
    xm, wm = qmm_i4t_mutants(x, w, i4t_mv_last(K // 64, ks))["one K split's partial dropped"]
    assert float((tq.qmm_plain(xm, wm) - want).abs().max()) >= 8 * limit


class _Lib:
    """Stands in for a compiled library: records each call, launches nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def lib(monkeypatch):
    fake = _Lib()
    monkeypatch.setattr(kernels, "library", lambda name, signatures: fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return fake


def _shell(K, N, R, zero):
    """An i4t weight of the path's shape whose bytes are never read (the
    stand-in library launches nothing)."""
    qw = torch.empty(K // 2, N, dtype=torch.uint8)
    s = torch.empty(R, K // 64, N, dtype=torch.bfloat16)
    return QTensor("i4t", qw, s, None, G, (N, K), GGMLType.Q4_0, zero=zero)


@pytest.mark.parametrize("R,zero", [(2, 8), (4, 0)])
@pytest.mark.parametrize("K,N,gateup", [(K, N, False) for K, N in MATVECS]
                         + [(K, N, True) for K, N in GATEUPS])
def test_every_path_shape_is_taken_with_its_plan(lib, K, N, gateup, R, zero):
    """qmm's gates send each path shape to the kernel (the reference's
    _supported_t, or its gate-up gate), and the wrapper hands the library
    the plan of the [K, N] weight (the gate-up: of the fused weight, as the
    matvec on it) with no workspace: no partials, no tickets."""
    w = _shell(K, N, R, zero)
    assert tq._gateup_supported(w, K, 1) if gateup else tq._supported_t(w, K, 1)
    x = torch.zeros(1, K, dtype=torch.bfloat16)
    before = dict(tq._tickets)
    out = tq._launch(x, w, gateup)
    assert out.shape == (1, N // 2 if gateup else N)
    assert out.dtype == (torch.bfloat16 if gateup else torch.float32)
    ((name, args),) = lib.calls
    assert name == "bt_qmm_i4t" and len(args) == 13
    # (K, N, R, zero, G, gateup, act, KS): act 0, SiLU
    assert args[4:12] == (K, N, R, zero, G, int(gateup), 0, tq.i4t_mv_plan(K, N, G))
    assert tq._tickets == before


def test_wrapper_refuses_what_the_matvec_does_not_take(lib):
    """At M = 1: N (or ff) not a multiple of 128, a group other than 16 and
    32 and a payload off 16 bytes raise, and nothing is launched."""
    x = torch.zeros(1, 1024, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="multiple of 128"):
        tq._launch(x, _shell(1024, 192, 2, 8), gateup=False)
    with pytest.raises(NotImplementedError, match="multiple of 128"):
        tq._launch(x, _shell(1024, 384, 2, 8), gateup=True)  # ff 192
    w = _shell(1024, 256, 2, 8)
    w8 = QTensor("i4t", w.qw, torch.empty(2, 64, 256, dtype=torch.bfloat16), None, 8,
                 (256, 1024), GGMLType.Q4_0, zero=8)
    with pytest.raises(NotImplementedError, match="group 8: not ported yet"):
        tq._launch(x, w8, gateup=False)
    raw = torch.empty(512 * 256 + 8, dtype=torch.uint8)
    off = QTensor("i4t", raw[8:].view(512, 256), w.scales, None, G, (256, 1024),
                  GGMLType.Q4_0, zero=8)
    with pytest.raises(ValueError, match="16 bytes"):
        tq._launch(x, off, gateup=False)
    assert lib.calls == []


def test_mv_splits_tool_takes_the_i4t_rows():
    """The split sweep (booster_tpu_torch.tools.mv_splits) on the CPU at
    small i4t rows, a matvec with the zero and a fused gate-up with mins:
    each split count checked against the plain version (the gate-up against
    the matvec + silu·mul) with i4t_mv_plan's count beside it; nothing timed."""
    from booster_tpu_torch.tools import mv_splits

    rows = [("i4t", "i4t", 1024, 256, 32, False), ("i4t gateup", "i4t mins", 512, 512, 32, True)]
    res = mv_splits.main(["--device", "cpu"], rows=rows)
    assert [r["plan_splits"] for r in res["rows"]] == [tq.i4t_mv_plan(1024, 256, 32),
                                                       tq.i4t_mv_plan(512, 512, 32)]
    assert all(list(r["split_ms"]) == list(range(1, 9)) and r["ms"] == "not measured"
               for r in res["rows"])


# -- the appends ---------------------------------------------------------------

APPEND_ROWS = 8  # rows (warps) a block of csrc/kv_append.cu (its kRows)


def append_grid(L: int, rows: int, D: int, quantized: bool) -> tuple:
    """The launch csrc/kv_append.cu makes for `rows` = B·H new rows a layer of
    L layers at storage width D: (grid (row blocks, L), threads a block,
    passes of a warp over its row).  One warp a row, APPEND_ROWS rows a
    block; the int8 form's warp takes D = 128·P lanes in P passes of 4
    lanes a lane (D a multiple of 128 up to 1024), the bf16 form's copies
    16-byte chunks (one pass)."""
    if quantized and (D % 128 or not 128 <= D <= 1024):
        raise ValueError(f"the int8 append takes D a multiple of 128 up to 1024, not {D}")
    return (-(-rows // APPEND_ROWS), L), 32 * APPEND_ROWS, D // 128 if quantized else 1


def _covers_each_row_once(grid, threads, rows, L):
    blocks, layers = grid
    warps = threads // 32
    assert warps == APPEND_ROWS and layers == L
    assert blocks * warps >= rows > (blocks - 1) * warps


def _rows(shape, d, L=None):
    lead = shape if L is None else (L, *shape)
    return (torch.zeros(*lead, d, dtype=torch.bfloat16),) * 2


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("L,B,H,d", [(22, 1, 4, 64), (32, 64, 8, 128), (1, 3, 5, 100),
                                     (2, 1, 1, 128)])
def test_all_layer_append_hands_the_library_its_rows(lib, quantized, L, B, H, d):
    """The all-layer append (bf16 and int8 at D = 128): the library gets the
    cache's (L, B, H, S, D) and the rows' d; one warp a row covers every
    (layer, slot, head) once."""
    S, D = 16, 128
    dt = torch.int8 if quantized else torch.bfloat16
    k, v = torch.zeros(L, B, H, S, D, dtype=dt), torch.zeros(L, B, H, S, D, dtype=dt)
    ks = vs = torch.zeros(L, B, H, S, 1) if quantized else None
    nk, nv = _rows((B, H), d, L)
    ka._launch_all(k, v, nk, nv, torch.zeros(B, dtype=torch.int32), ks, vs)
    ((name, args),) = lib.calls
    assert name == ("bt_kv_append_i8" if quantized else "bt_kv_append")
    dims = args[7:13] if quantized else args[5:11]
    assert dims == (L, B, H, S, D, d)
    grid, threads, passes = append_grid(L, B * H, D, quantized)
    _covers_each_row_once(grid, threads, B * H, L)
    assert passes == 1


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("B,H,D,d", [(64, 32, 128, 128), (1, 32, 128, 64), (4, 2, 256, 200),
                                     (3, 3, 640, 640), (2, 5, 1024, 1000), (64, 32, 1024, 512)])
def test_layer_append_hands_the_library_its_rows(lib, quantized, B, H, D, d):
    """The per-layer append at storage widths 128-1024: one warp a row of
    the layer, the int8 form's warp in D/128 passes."""
    S = 8
    dt = torch.int8 if quantized else torch.bfloat16
    k, v = torch.zeros(B, H, S, D, dtype=dt), torch.zeros(B, H, S, D, dtype=dt)
    ks = vs = torch.zeros(B, H, S, 1) if quantized else None
    nk, nv = _rows((B, 1, H), d)
    ka._launch_layer(k, v, nk, nv, torch.zeros(B, dtype=torch.int32), ks, vs)
    ((name, args),) = lib.calls
    assert name == ("bt_kv_append_layer_i8" if quantized else "bt_kv_append_layer")
    assert (args[7:12] if quantized else args[5:10]) == (B, H, S, D, d)
    grid, threads, passes = append_grid(1, B * H, D, quantized)
    _covers_each_row_once(grid, threads, B * H, 1)
    assert passes * 128 == D if quantized else passes == 1


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_paged_append_hands_the_library_its_rows(lib, quantized):
    """The paged append at the server's layout (32 layers, 64 slots of 8
    heads, pages of 256 rows, 16 pages a slot): the pool's and the table's
    shapes, one warp a row."""
    L, B, H, P, maxp, D = 32, 64, 8, 256, 16, 128
    Np = 2
    dt = torch.int8 if quantized else torch.bfloat16
    pk, pv = torch.zeros(L, Np, H, P, D, dtype=dt), torch.zeros(L, Np, H, P, D, dtype=dt)
    pks = pvs = torch.zeros(L, Np, H, P, 1) if quantized else None
    nk, nv = _rows((B, H), D, L)
    table = torch.zeros(B, maxp, dtype=torch.int32)
    ka._launch_paged(pk, pv, nk, nv, torch.zeros(B, dtype=torch.int32), table, pks, pvs)
    ((name, args),) = lib.calls
    assert name == ("bt_kv_append_paged_i8" if quantized else "bt_kv_append_paged")
    assert args[-9:-1] == (L, B, H, Np, P, maxp, D, D)
    _covers_each_row_once(*append_grid(L, B * H, D, quantized)[:2], B * H, L)


def test_appends_refuse_widths_not_ported(lib):
    """The int8 appends take D a multiple of 128 (the per-layer form up to
    1024, the all-layer and paged forms 128 and 256): anything else raises,
    nothing launches; a 256-lane pool launches the paged form."""
    row = torch.zeros(1, 1, 1, 64, dtype=torch.bfloat16)
    off = torch.zeros(1, dtype=torch.int32)
    for D in (64, 192, 1152):
        k = torch.zeros(1, 1, 4, D, dtype=torch.int8)
        s = torch.zeros(1, 1, 4, 1)
        with pytest.raises(NotImplementedError, match="not ported yet"):
            ka._launch_layer(k, k.clone(), row, row, off, s, s.clone())
    k = torch.zeros(1, 1, 1, 4, 384, dtype=torch.int8)
    s = torch.zeros(1, 1, 1, 4, 1)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ka._launch_all(k, k.clone(), row, row, off, s, s.clone())
    ps = torch.zeros(1, 2, 1, 4, 1)
    pool = torch.zeros(1, 2, 1, 4, 384, dtype=torch.int8)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ka._launch_paged(pool, pool.clone(), row, row, off, torch.ones(1, 1, dtype=torch.int32),
                         ps, ps.clone())
    assert lib.calls == []
    pool = torch.zeros(1, 2, 1, 4, 256, dtype=torch.int8)
    ka._launch_paged(pool, pool.clone(), row, row, off, torch.ones(1, 1, dtype=torch.int32),
                     ps, ps.clone())
    (name, a), = lib.calls
    assert name == "bt_kv_append_paged_i8" and a[14:16] == (256, 64)  # D, d
