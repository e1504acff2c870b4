"""Tests of the port's CUDA kernels that need an NVIDIA GPU.  They skip here
without one (the `cuda` marker) and run on the card with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Each kernel is held against its plain version on the card at a small shape,
with the tolerances of chip_smoke.py's CHECKS; the wrappers must raise, not
fall back, when the kernels cannot be built."""

import dataclasses
import sys

import pytest
import torch

sys.path.insert(0, ".")

from booster_tpu_torch.gguf import GGMLType  # noqa: E402
from booster_tpu_torch.ops import decode_attention as da  # noqa: E402
from booster_tpu_torch.ops import kernels  # noqa: E402
from booster_tpu_torch.ops import kv_append as ka  # noqa: E402
from booster_tpu_torch.ops import mlp as tm  # noqa: E402
from booster_tpu_torch.ops import paged_attention as pga  # noqa: E402
from booster_tpu_torch.ops import prefill_attention as pa  # noqa: E402
from booster_tpu_torch.ops import probes, probes_i4  # noqa: E402
from booster_tpu_torch.ops import qmm as tq  # noqa: E402
from booster_tpu_torch.ops.kv_cache import _quantize_kv  # noqa: E402
from booster_tpu_torch.quant.qtensor import QTensor  # noqa: E402
from booster_tpu_torch.testing import (decode_attn_case, decode_attn_limit,  # noqa: E402
                                       kv_append_layer_case, kv_append_layer_check,
                                       paged_attn_case, paged_attn_limit, prefill_attn_case,
                                       prefill_attn_limit)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _w8(L, K, N, gen, group=32, mins=False):
    """A stacked random i8t weight [L, K, N] with bf16 scales (Q8_0's form;
    Q6_K's at group 16), and with `mins` a mins plane (Q5_K's form)."""
    qw = torch.randint(-128, 128, (L, K, N), dtype=torch.int8, device="cuda", generator=gen)
    s = torch.rand((L, 2 if mins else 1, K // group, N), device="cuda", generator=gen) * 0.02
    return QTensor("i8t", qw, (s + 1e-3).to(torch.bfloat16), None, group, (N, K),
                   GGMLType.Q6_K if group == 16 else GGMLType.Q8_0)


def _w(L, K, N, gen, mins=False):
    qw = torch.randint(0, 256, (L, K // 2, N), dtype=torch.uint8, device="cuda", generator=gen)
    s = torch.rand((L, 4 if mins else 2, K // 64, N), device="cuda", generator=gen) * 0.02
    return QTensor("i4t", qw, s.to(torch.bfloat16), None, 32, (N, K), GGMLType.Q4_0,
                   zero=0 if mins else 8)


@pytest.mark.parametrize("m,mins", [(1, False), (5, False), (16, False), (1, True), (9, True)])
def test_qmm_kernel_matches_plain(cuda, m, mins):
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = _w(2, 1024, 384, gen, mins)
    x = torch.randn(m, 1024, device="cuda", generator=gen).to(torch.bfloat16)
    got, want = tq.qmm_i4t(x, w.at(1)), tq.qmm_plain(x, w.at(1))
    assert (got - want).abs().max() <= 2e-4 * want.abs().max()


@pytest.mark.parametrize("m", [1, 16])
def test_gateup_kernel_fused_equals_unfused(cuda, m):
    gen = torch.Generator(device="cuda").manual_seed(1)
    w = _w(2, 1024, 512, gen)
    x = torch.randn(m, 1024, device="cuda", generator=gen).to(torch.bfloat16)
    got = tq.qmm_i4t_gateup(x, w.at(0))
    gu = tq.qmm_i4t(x, w.at(0)).to(torch.bfloat16)
    assert torch.equal(got, tq.silu(gu[:, :256]) * gu[:, 256:])


@pytest.mark.parametrize("mins", [False, True], ids=["R2", "R4"])
@pytest.mark.parametrize("m", [2, 17, 33, 100, 600])
def test_qmm_i4t_tile_at_ragged_m(cuda, m, mins):
    """The M > 1 tensor-core tile at each row tile (32, 64, 128 rows: M 2-33,
    100, 600) with a ragged last m16 tile, two or four scale planes, and the
    mins and split checks of testing.qmm_i4t_mutants past 8x the limit."""
    from booster_tpu_torch.testing import qmm_i4t_mutants

    gen = torch.Generator(device="cuda").manual_seed(30 + m)
    w = _w(2, 1024, 384, gen, mins).at(1)
    x = torch.randn(m, 1024, device="cuda", generator=gen).to(torch.bfloat16)
    got, want = tq.qmm_i4t(x, w), tq.qmm_plain(x, w)
    limit = 2e-4 * want.abs().max()
    assert (got - want).abs().max() <= limit
    _, ks = tq.i4t_plan(m, 1024, 384)
    ngh = 1024 // 64
    for what, (xm, wm) in qmm_i4t_mutants(x, w, ((ks - 1) * ngh // ks, ngh)).items():
        assert (tq.qmm_plain(xm, wm) - want).abs().max() > 8 * limit, what


@pytest.mark.parametrize("m", [64, 1024])
@pytest.mark.parametrize("k,n", [(4096, 12288), (16384, 4096)])
def test_qmm_i4t_tile_at_mpt_widths(cuda, m, k, n):
    """MPT-7B's qkv and down at a batch step (64 rows) and its prefill (1024)."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    w = _w(1, k, n, gen).at(0)
    x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
    got, want = tq.qmm_i4t(x, w), tq.qmm_plain(x, w)
    assert (got - want).abs().max() <= 2e-4 * want.abs().max()


@pytest.mark.parametrize("m", [16, 64, 1024])
def test_gateup_tile_fused_equals_unfused(cuda, m):
    """The fused gate-up tile (64 gate and 64 up columns a block) equals the
    matmul on the fused weight + silu·mul bit for bit, split alike
    (i4t_launch_plan), at TinyLlama's width."""
    gen = torch.Generator(device="cuda").manual_seed(32)
    w = _w(1, 2048, 2 * 5632, gen).at(0)
    x = torch.randn(m, 2048, device="cuda", generator=gen).to(torch.bfloat16)
    got = tq.qmm_i4t_gateup(x, w)
    gu = tq.qmm_i4t(x, w).to(torch.bfloat16)
    assert torch.equal(got, tq.silu(gu[:, :5632]) * gu[:, 5632:])


def _replays_equal(fn):
    """fn twice, then a CUDA graph of it replayed: the same output every time,
    and the shared ticket buffer zero after."""
    first = fn()
    assert torch.equal(fn(), first)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn()
    for _ in range(3):
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)
    tickets = tq._tickets.get(first.device)  # None where no kernel of the run takes them
    assert tickets is None or int(tickets.abs().sum()) == 0
    return first


@pytest.mark.parametrize("gateup", [False, True])
def test_qmm_i4t_split_tickets_reset_across_graph_replays(cuda, gateup):
    gen = torch.Generator(device="cuda").manual_seed(33)
    w = _w(1, 4096, 1024, gen).at(0)
    x = torch.randn(16, 4096, device="cuda", generator=gen).to(torch.bfloat16)
    assert tq.i4t_plan(16, 4096, 1024)[1] > 1
    kern = tq.qmm_i4t_gateup if gateup else tq.qmm_i4t
    _replays_equal(lambda: kern(x, w))


@pytest.mark.parametrize("mins", [False, True], ids=["R2", "R4"])
@pytest.mark.parametrize("k,n", [(2048, 2560), (5632, 2048), (1088, 384), (64, 128),
                                 (16384, 256)])
def test_i4t_matvec_equals_its_mirror(cuda, k, n, mins):
    """The M = 1 matvec (csrc/i4mv.cuh) at path and ragged shapes (fewer
    groups than warps, group counts no power of two, 8 splits): within 2e-4
    of the largest output of the plain version, within a tenth of that of
    the CPU mirror of its sum order (testing.qmm_i4t_mv_split; the tensor
    cores' k16 sums by torch's), equal to itself on a second launch; the
    check sees the last split (or group) left out."""
    from booster_tpu_torch.testing import i4t_mv_last, qmm_i4t_mutants, qmm_i4t_mv_split

    gen = torch.Generator(device="cuda").manual_seed(46)
    w = _w(2, k, n, gen, mins).at(1)
    x = torch.randn(1, k, device="cuda", generator=gen).to(torch.bfloat16)
    got, want = tq.qmm_i4t(x, w), tq.qmm_plain(x, w)
    limit = 2e-4 * want.abs().max()
    assert (got - want).abs().max() <= limit
    assert torch.equal(got, tq.qmm_i4t(x, w))
    ks = tq.i4t_mv_plan(k, n, 32)
    wc = dataclasses.replace(w.resolved(), qw=w.resolved().qw.cpu(),
                             scales=w.resolved().scales.cpu(), layer=None)
    assert (got.cpu() - qmm_i4t_mv_split(x.cpu(), wc, ks)).abs().max() <= limit.cpu() / 10
    xm, wm = qmm_i4t_mutants(x, w, i4t_mv_last(k // 64, ks))["one K split's partial dropped"]
    assert (tq.qmm_plain(xm, wm) - want).abs().max() > 8 * limit


@pytest.mark.parametrize("gateup", [False, True])
def test_i4t_matvec_repeats_across_graph_replays(cuda, gateup):
    """The M = 1 i4t matvec's and gate-up's cluster split sums give the same
    bits in eager calls and CUDA-graph replays, and leave the shared ticket
    buffer zero (they take none)."""
    gen = torch.Generator(device="cuda").manual_seed(47)
    x = torch.randn(1, 2048, device="cuda", generator=gen).to(torch.bfloat16)
    tq._ticket_buffer(x.device, 1)
    w = _w(1, 2048, 2 * 2048, gen).at(0)
    assert tq.i4t_mv_plan(2048, 2 * 2048, 32) > 1
    kern = tq.qmm_i4t_gateup if gateup else tq.qmm_i4t
    _replays_equal(lambda: kern(x, w))


@pytest.mark.parametrize("mins", [False, True], ids=["R2", "R4"])
def test_i4t_gateup_at_tinyllama_width_equals_matvec_then_silu_mul(cuda, mins):
    """The M = 1 fused gate-up at TinyLlama's [2048, 2 x 5632] (and with a
    mins plane) equals the matvec on its fused weight + silu·mul bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(48)
    w = _w(1, 2048, 2 * 5632, gen, mins).at(0)
    x = torch.randn(1, 2048, device="cuda", generator=gen).to(torch.bfloat16)
    got = tq.qmm_i4t_gateup(x, w)
    gu = tq.qmm_i4t(x, w).to(torch.bfloat16)
    assert torch.equal(got, tq.silu(gu[:, :5632]) * gu[:, 5632:])


def test_i4t_cluster_launch_refuses_a_bad_split_count(cuda):
    """The library refuses 0 and 9 splits (a cluster holds at most 8) with an
    error code and launches nothing; the next launch runs as before."""
    gen = torch.Generator(device="cuda").manual_seed(49)
    w = _w(1, 1024, 256, gen).at(0).resolved()
    x = torch.randn(1, 1024, device="cuda", generator=gen).to(torch.bfloat16)
    want = tq.qmm_i4t(x, w)
    out = torch.full_like(want, 7.0)
    lib = kernels.library("qmm_i4t", tq._SIGNATURES)
    stream = torch.cuda.current_stream().cuda_stream
    for ks in (0, 9):
        rc = lib.bt_qmm_i4t(x.data_ptr(), w.qw.data_ptr(), w.scales.data_ptr(), out.data_ptr(),
                            1024, 256, 2, 8, 32, 0, 0, ks, stream)
        assert rc != 0
    torch.cuda.synchronize()
    assert bool((out == 7.0).all())
    assert torch.equal(tq.qmm_i4t(x, w), want)


def _g16_weight(fmt, N, K, seed):
    """A real Q2_K (mins) or Q3_K (zero 4, signed scales) weight [N, K],
    repacked on the card: K-major i4t at group 16."""
    from booster_tpu_torch.testing import q2k_weight, q3k_weight

    return (q2k_weight if fmt == "q2k" else q3k_weight)(N, K, seed, "cuda")


@pytest.mark.parametrize("fmt", ["q2k", "q3k"])
@pytest.mark.parametrize("m", [1, 16, 64, 128, 512, 2048])
def test_i4t_group_16_matmul_matches_plain_and_mirror(cuda, fmt, m):
    """qmm_i4t.cu at group 16 (i4mv.cuh's matvec at M = 1, the tile above)
    on real Q2_K (mins) and Q3_K (zero 4) planes, the tile at 32, 64 and 128
    rows a block (M = 512 and 2048: 128): within 2e-4 of the largest
    output of qmm_plain and within a tenth of that of the CPU mirror of its
    sum order at the plan's splits; each mirror mutant of a group-16 term
    (a scale row of the wrong half-group, group sums over 32 k, the zero
    term dropped where there is a zero) lands 8x past the limit; the launch
    counts under the form's own name."""
    from booster_tpu_torch.testing import I4T_MIRROR_MUTANTS, qmm_i4t_mv_split, qmm_i4t_split

    K, N = 2048, 1024
    w = _g16_weight(fmt, N, K, seed=m)
    gen = torch.Generator(device="cuda").manual_seed(m)
    x = torch.randn(m, K, device="cuda", generator=gen).to(torch.bfloat16)
    kernels.reset_counts()
    got, want = tq.qmm_i4t(x, w), tq.qmm_plain(x, w)
    name = tq.i4t_count_name(False, m, 16, fmt == "q2k")
    assert kernels.launch_counts[name] == 1 and "g16" in name
    limit = 2e-4 * want.abs().max()
    assert (got - want).abs().max() <= limit
    wc = dataclasses.replace(w, qw=w.qw.cpu(), scales=w.scales.cpu())
    if m == 1:
        ks = tq.i4t_mv_plan(K, N, 16)
        mirror = lambda mutant=None: qmm_i4t_mv_split(x.cpu(), wc, ks, mutant=mutant)  # noqa
    else:
        ks = tq.i4t_plan(m, K, N)[1]
        mirror = lambda mutant=None: qmm_i4t_split(x.cpu(), wc, ks, mutant=mutant)  # noqa
    assert (got.cpu() - mirror()).abs().max() <= limit.cpu() / 10
    for what in I4T_MIRROR_MUTANTS:
        if what == "zero term dropped" and not w.zero or what == "group sums over 32 k" and (
                m > 1 and fmt == "q3k"):  # the tile's zero is in its unpack, not in xs
            continue
        assert (mirror(what) - want.cpu()).abs().max() >= 8 * limit.cpu(), what


@pytest.mark.parametrize("fmt", ["q2k", "q3k"])
@pytest.mark.parametrize("m", [1, 16, 64, 128, 512, 2048])
def test_i4t_group_16_gateup_equals_matmul_then_silu_mul(cuda, fmt, m):
    """The fused gate-up at group 16 (Q2_K's mins; Q3_K's zero 4, which no
    path reaches) equals qmm_i4t on its fused weight + silu·mul bit for bit,
    at M = 1 and in the tile at 32, 64 and 128 rows a block."""
    K, ff = 2048, 512
    w = _g16_weight(fmt, 2 * ff, K, seed=10 + m)
    gen = torch.Generator(device="cuda").manual_seed(10 + m)
    x = torch.randn(m, K, device="cuda", generator=gen).to(torch.bfloat16)
    kernels.reset_counts()
    got = tq.qmm_i4t_gateup(x, w)
    assert kernels.launch_counts[tq.i4t_count_name(True, m, 16, fmt == "q2k")] == 1
    gu = tq.qmm_i4t(x, w).to(torch.bfloat16)
    assert torch.equal(got, tq.silu(gu[:, :ff]) * gu[:, ff:])


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("d,D", [(128, 384), (384, 384), (640, 640), (1000, 1024),
                                 (1024, 1024), (99, 128)])
def test_kv_append_layer_kernel_at_wide_rows(cuda, quantized, d, D):
    """The per-layer append at storage widths 384-1024 (the int8 warp in
    D/128 passes) and at d = 99 (loads of one element), exact against the
    plain version, each wrong append seen."""
    args = kv_append_layer_case(3, 3, 5, 64, D, d, [0, 13, 70], "cuda", seed=d + D,
                                quantized=quantized)
    k_all, v_all, layer, new_k, new_v, off, ks, vs = args
    got = [None if t is None else t.clone() for t in (k_all, v_all, ks, vs)]
    ka.kv_append_layer(got[0][layer], got[1][layer], new_k, new_v, off,
                       None if ks is None else got[2][layer],
                       None if vs is None else got[3][layer])
    exact, seen = kv_append_layer_check(args, got)
    assert exact and all(seen.values()), seen


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("d", [128, 62])
def test_kv_append_all_layers_exact_at_any_row_width(cuda, quantized, d):
    """The all-layer append at d = 128 (whole 8- and 16-byte moves) and 62
    (element by element) over 9 rows a layer (a block of 8 rows and one
    more), equal to the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(50)
    L, B, H, S, D = 2, 3, 3, 64, 128
    base = torch.randn(L, B, H, S, D, device="cuda", generator=gen)
    if quantized:
        k, ks = _quantize_kv(base)
        cache = [k, k.clone(), ks, ks.clone()]
    else:
        cache = [base.to(torch.bfloat16), base.to(torch.bfloat16), None, None]
    out = [cache, [None if t is None else t.clone() for t in cache]]
    new = (torch.randn(2, L, B, H, d, device="cuda", generator=gen) * 3).to(torch.bfloat16)
    off = torch.tensor([0, 63, 90], dtype=torch.int32, device="cuda")
    ka.kv_append(out[0][0], out[0][1], new[0], new[1], off, out[0][2], out[0][3])
    ka.kv_append_plain(out[1][0], out[1][1], new[0], new[1], off, out[1][2], out[1][3])
    for got, want in zip(*out):
        assert got is None or torch.equal(got, want)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_kv_append_paged_scratch_rule(cuda, quantized):
    """A row whose offset lies past the slot's page table lands on the
    scratch page 0 at row 0 (the TPU kernel's rule), its scale beside it;
    the slot's own pages stay as they were."""
    gen = torch.Generator(device="cuda").manual_seed(51)
    L, B, H, P, MAXP, D, d = 2, 2, 3, 128, 2, 128, 64
    Np = B * MAXP + 1
    table = torch.arange(1, Np, dtype=torch.int32, device="cuda").reshape(B, MAXP)
    new = (torch.randn(2, L, B, H, d, device="cuda", generator=gen) * 3).to(torch.bfloat16)
    off = torch.tensor([MAXP * P + 5, 3], dtype=torch.int32, device="cuda")  # slot 0 past it
    base = torch.randn(L, Np, H, P, D, device="cuda", generator=gen)
    if quantized:
        k, ks = _quantize_kv(base)
        pool = [k, k.clone(), ks, ks.clone()]
    else:
        pool = [base.to(torch.bfloat16), base.to(torch.bfloat16), None, None]
    before = [None if t is None else t.clone() for t in pool]
    ka.kv_append_all_layers_paged(*pool[:2], new[0], new[1], off, table, *pool[2:])
    for c in (0, 1):
        row = torch.nn.functional.pad(new[c][:, 0].float(), (0, D - d))  # [L, H, D]
        if quantized:
            q, s = _quantize_kv(row)
            assert torch.equal(pool[c][:, 0, :, 0], q)
            assert torch.equal(pool[2 + c][:, 0, :, 0], s)
        else:
            assert torch.equal(pool[c][:, 0, :, 0], row.to(torch.bfloat16))
        assert torch.equal(pool[c][:, 1:3], before[c][:, 1:3])  # slot 0's pages


@pytest.mark.parametrize("lens,ok,win,softcap", [
    ([1000, 79, 1], [1, 1, 1], 1025, 0.0), ([0, 70, 200], [1, 0, 1], 64, 30.0)])
def test_decode_attn_kernel_matches_plain(cuda, lens, ok, win, softcap):
    # a self term and edge columns the check can see (testing.decode_attn_case)
    q, kc, vc, layer, lens_t, _, _, sk, sv, _ = decode_attn_case(
        2, len(lens), 2, 8, 1024, 64, 128, lens, "cuda", seed=2)
    args = (q, kc, vc, layer, lens_t, win, softcap, sk, sv,
            torch.tensor(ok, dtype=torch.int32, device="cuda"))
    got, want = da.decode_attn(*args), da.decode_attn_plain(*args)
    # each bf16(p) may round the other way against the kernel's running max
    assert ((got - want).abs() <= decode_attn_limit(args)).all()


@pytest.mark.parametrize("lens,ok,win,softcap", [
    ([500, 30, 1, 0], [1, 1, 1, 1], 513, 0.0), ([0, 70, 200, 511], [1, 0, 1, 1], 64, 30.0)])
def test_decode_attn_int8_kernel_matches_plain(cuda, lens, ok, win, softcap):
    args = list(decode_attn_case(2, len(lens), 4, 8, 512, 64, 128, lens, "cuda", seed=6,
                                 quantized=True))
    args[5], args[6] = win, softcap
    args[9] = torch.tensor(ok, dtype=torch.int32, device="cuda")
    got, want = da.decode_attn(*args), da.decode_attn_plain(*args)
    live = (args[4] > 0) | (args[9] > 0)  # a slot with neither attends to nothing
    assert ((got - want).abs() <= decode_attn_limit(args))[live].all()


def test_kv_append_int8_kernel_is_exact(cuda):
    gen = torch.Generator(device="cuda").manual_seed(7)
    L, B, H, S, D = 3, 4, 2, 256, 128
    k, ks = _quantize_kv(torch.randn(L, B, H, S, D, device="cuda", generator=gen))
    new = (torch.randn(2, L, B, H, 64, device="cuda", generator=gen) * 3).to(torch.bfloat16)
    new[0, 0, 0, 0] = 0  # a zero row
    new[0, 0, 0, 1, :4] = torch.tensor([127.0, 2.5, 3.5, -0.5])  # .5 after the division
    off = torch.tensor([0, 100, 255, 400], dtype=torch.int32, device="cuda")
    out = [(k.clone(), k.clone(), ks.clone(), ks.clone()) for _ in range(2)]
    ka.kv_append(out[0][0], out[0][1], new[0], new[1], off, out[0][2], out[0][3])
    ka.kv_append_plain(out[1][0], out[1][1], new[0], new[1], off, out[1][2], out[1][3])
    for got, want in zip(*out):
        assert torch.equal(got, want)


@pytest.mark.parametrize("pos0,n_valid,T,S", [
    ([0, 0, 0], [16, 9, 1], 16, 512), ([200, 37, 0], [32, 5, 20], 32, 512),
    ([0, 700], [100, 128], 128, 1024)])
def test_prefill_attn_kernel_matches_plain(cuda, pos0, n_valid, T, S):
    args = prefill_attn_case(len(pos0), 4, 8, T, S, 64, 128, pos0, n_valid, "cuda", seed=8)
    got, want = pa.prefill_attn(*args), pa.prefill_attn_plain(*args)
    assert ((got - want).abs() <= prefill_attn_limit(args)).all()


@pytest.mark.parametrize("T,pos0,n_valid", [(32, [0, 200], [32, 7]), (16, [5, 0], [16, 1])])
def test_prefill_attn_kernel_at_one_query_head_per_kv_head(cuda, T, pos0, n_valid):
    """MHA (G = 1) at the prompt buckets: one tile of T rows per (slot,
    head), its one or two m16 tiles shared by the 8 warps."""
    args = prefill_attn_case(len(pos0), 3, 1, T, 512, 128, 128, pos0, n_valid, "cuda", seed=9)
    got, want = pa.prefill_attn(*args), pa.prefill_attn_plain(*args)
    assert ((got - want).abs() <= prefill_attn_limit(args)).all()


@pytest.mark.parametrize("G,T", [(1, 16), (1, 32), (4, 32), (8, 32), (8, 20)])
def test_prefill_attn_kernel_with_window_and_softcap(cuda, G, T):
    """A window shorter than the cache and a softcap, at G = 1, 4 and 8 (and
    a last tile shorter than TQ: T 20 at G 8)."""
    args = list(prefill_attn_case(3, 2, G, T, 512, 128, 128, [0, 200, 400], [T, 7, T], "cuda",
                                  seed=15 + G))
    args[7], args[8] = 64, 30.0
    got, want = pa.prefill_attn(*args), pa.prefill_attn_plain(*args)
    assert ((got - want).abs() <= prefill_attn_limit(tuple(args))).all()


@pytest.mark.parametrize("win,softcap", [(1025, 0.0), (300, 30.0)])
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("lens", [1000, 79, 1, 0, 255, 256, 257])
def test_decode_attn_kernel_split_over_the_cache(cuda, lens, G, quantized, win, softcap):
    """B = 1: the live range split over decode_splits(1, 4, 1024, *) = 8
    blocks of whole 128-column stages (lens 255, 256, 257 sit at a slice
    boundary), merged by the last block with the self term."""
    assert da.decode_splits(1, 4, 1024, quantized) == 8
    args = list(decode_attn_case(2, 1, 4, G, 1024, 128, 128, [lens], "cuda", seed=16 + lens,
                                 quantized=quantized))
    args[5], args[6] = win, softcap
    got, want = da.decode_attn(*args), da.decode_attn_plain(*args)
    assert ((got - want).abs() <= decode_attn_limit(tuple(args))).all()


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_decode_attn_split_tickets_reset_across_graph_replays(cuda, quantized):
    """The last block of a split call resets its ticket: the same call twice,
    then a CUDA graph of it replayed, gives the same output every time and
    leaves the tickets zero."""
    args = decode_attn_case(2, 1, 8, 4, 2048, 128, 128, [2000], "cuda", seed=17,
                            quantized=quantized)
    first = _replays_equal(lambda: da.decode_attn(*args))
    assert ((first - da.decode_attn_plain(*args)).abs() <= decode_attn_limit(args)).all()


@pytest.mark.parametrize("quantized", [False, True])
def test_decode_attn_kernel_at_one_query_head_per_kv_head(cuda, quantized):
    args = decode_attn_case(2, 3, 4, 1, 512, 128, 128, [300, 1, 511], "cuda", seed=10,
                            quantized=quantized)
    got, want = da.decode_attn(*args), da.decode_attn_plain(*args)
    assert ((got - want).abs() <= decode_attn_limit(args)).all()


def test_kv_append_kernel_matches_plain(cuda):
    gen = torch.Generator(device="cuda").manual_seed(3)
    k = torch.randn(3, 2, 2, 256, 128, device="cuda", generator=gen).to(torch.bfloat16)
    v = -k
    nk = torch.randn(3, 2, 2, 64, device="cuda", generator=gen).to(torch.bfloat16)
    off = torch.tensor([0, 255], dtype=torch.int32, device="cuda")
    k1, v1, k2, v2 = k.clone(), v.clone(), k.clone(), v.clone()
    ka.kv_append(k1, v1, nk, nk * 2, off)
    ka.kv_append_plain(k2, v2, nk, nk * 2, off)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("d,D", [(64, 128), (128, 128), (256, 256)])
def test_kv_append_layer_kernel_is_exact(cuda, quantized, d, D):
    """The per-layer append equals its plain version bit for bit (payloads,
    scales, every other layer), at offsets 0, mid-window, S - 1 and past it,
    and differs from each wrong append of testing.kv_append_layer_mutants."""
    args = kv_append_layer_case(3, 4, 2, 256, D, d, [0, 13, 255, 300], "cuda", seed=d,
                                quantized=quantized)
    k_all, v_all, layer, new_k, new_v, off, ks, vs = args
    got = [None if t is None else t.clone() for t in (k_all, v_all, ks, vs)]
    ka.kv_append_layer(got[0][layer], got[1][layer], new_k, new_v, off,
                       None if ks is None else got[2][layer],
                       None if vs is None else got[3][layer])
    exact, seen = kv_append_layer_check(args, got)
    assert exact and all(seen.values()), seen


def test_wrappers_raise_when_kernels_cannot_build(cuda, monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    gen = torch.Generator(device="cuda").manual_seed(4)
    w = _w(1, 1024, 128, gen)
    x = torch.randn(1, 1024, device="cuda", generator=gen).to(torch.bfloat16)
    with pytest.raises(RuntimeError, match="nvcc"):
        tq.qmm_i4t(x, w.at(0))
    k = torch.zeros(1, 1, 1, 128, 128, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="nvcc"):
        ka.kv_append(k, k.clone(), torch.zeros(1, 1, 1, 64, device="cuda",
                                                 dtype=torch.bfloat16),
                     torch.zeros(1, 1, 1, 64, device="cuda", dtype=torch.bfloat16),
                     torch.zeros(1, dtype=torch.int32, device="cuda"))


def test_wrappers_refuse_shapes_not_ported(cuda):
    gen = torch.Generator(device="cuda").manual_seed(5)
    w = _w(1, 1024, 128, gen)
    w8 = QTensor("i4t", w.qw[0], torch.zeros(2, 64, 128, device="cuda", dtype=torch.bfloat16),
                 None, 8, (128, 1024), GGMLType.Q4_0, zero=8)
    x = torch.zeros(1, 1024, device="cuda", dtype=torch.bfloat16)
    for m in (1, 16):  # groups 16 and 32 are ported; group 8 is not, at either form
        with pytest.raises(NotImplementedError, match="group 8: not ported yet"):
            tq.qmm_i4t(torch.zeros(m, 1024, device="cuda", dtype=torch.bfloat16), w8)
    q = torch.zeros(1, 1, 8, 64, device="cuda", dtype=torch.bfloat16)
    k = torch.zeros(1, 1, 1, 128, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        da.decode_attn(q, k, k, 0, torch.ones(1, dtype=torch.int32, device="cuda"), 129)
    k8 = torch.zeros(1, 1, 128, 64, device="cuda", dtype=torch.int8)
    s8 = torch.zeros(1, 1, 128, 1, device="cuda")
    row = torch.zeros(1, 1, 1, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="not ported yet"):  # int8 at D % 128 != 0
        ka.kv_append_layer(k8, k8.clone(), row, row,
                           torch.zeros(1, dtype=torch.int32, device="cuda"), s8, s8.clone())
    qp = torch.zeros(1, 8, 16, 128, device="cuda", dtype=torch.bfloat16)
    kp = torch.zeros(1, 128, 128, device="cuda", dtype=torch.bfloat16)
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    with pytest.raises(NotImplementedError, match="not ported yet"):  # bf16 cache
        pa.prefill_attn(qp, kp, kp, None, None, one * 0, one, 200)


@pytest.mark.parametrize("m,k,n", [(1, 1024, 384), (1, 4096, 256), (5, 1024, 384),
                                   (64, 512, 256), (70, 2048, 128), (200, 256, 512)])
def test_qmm_i8t_kernel_matches_plain(cuda, m, k, n):
    gen = torch.Generator(device="cuda").manual_seed(10)
    w = _w8(2, k, n, gen)
    x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
    for dq in ((False, True) if m == 1 else (False,)):
        got, want = tq.qmm_i8t(x, w.at(1), dq=dq), tq.qmm_plain(x, w.at(1), dq=dq)
        assert (got - want).abs().max() <= 2e-4 * want.abs().max()


@pytest.mark.parametrize("m", [2, 16, 130])
def test_gateup_i8t_kernel_equals_dq_then_silu_mul(cuda, m):
    gen = torch.Generator(device="cuda").manual_seed(11)
    w = _w8(2, 1024, 512, gen)
    x = torch.randn(m, 1024, device="cuda", generator=gen).to(torch.bfloat16)
    got = tq.qmm_i8t_gateup(x, w.at(1))
    want = tq.qmm_gateup_plain(x, w.at(1))
    d = (got.float() - want.float()).abs()
    assert (d <= 2 ** -7 * want.float().abs() + 1e-5 * want.float().abs().max()).all()
    gu = tq.qmm_i8t(x, w.at(1)).to(torch.bfloat16)
    assert torch.equal(got, tq.silu(gu[:, :256]) * gu[:, 256:])


@pytest.mark.parametrize("m,k,n", [(1, 2048, 384), (1, 512, 256), (5, 1024, 384),
                                   (64, 2048, 256)])
def test_qmm_i8t_group_16_kernel_matches_plain(cuda, m, k, n):
    gen = torch.Generator(device="cuda").manual_seed(15)
    w = _w8(2, k, n, gen, group=16)
    x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
    got, want = tq.qmm_i8t(x, w.at(1)), tq.qmm_plain(x, w.at(1))
    assert (got - want).abs().max() <= 2e-4 * want.abs().max()


@pytest.mark.parametrize("group,mins,k,ff", [(16, False, 2048, 384), (32, False, 1024, 256),
                                             (16, True, 512, 128), (32, True, 4096, 640)])
def test_gateup_gd_kernel_equals_gd_then_silu_mul(cuda, group, mins, k, ff):
    """The M = 1 fused gate-up (_gateup_i8_gd_kernel's port) equals the M =
    1 matvec kernel + silu·mul bit for bit, and its plain version within
    bf16 rounding."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    w = _w8(2, k, 2 * ff, gen, group=group, mins=mins)
    x = torch.randn(1, k, device="cuda", generator=gen).to(torch.bfloat16)
    kernels.reset_counts()
    got = tq.qmm_i8t_gateup(x, w.at(1))
    assert kernels.launch_counts["qmm_i8t_gateup_gd"] == 1
    gu = tq.qmm_i8t(x, w.at(1)).to(torch.bfloat16)
    assert torch.equal(got, tq.silu(gu[:, :ff]) * gu[:, ff:])
    want = tq.qmm_gateup_plain(x, w.at(1))
    d = (got.float() - want.float()).abs()
    assert (d <= 2 ** -7 * want.float().abs() + 1e-5 * want.float().abs().max()).all()


_RAGGED_KN = [(1088, 384), (2112, 640), (64, 128), (5632, 2048), (768, 1152), (14336, 256)]


@pytest.mark.parametrize("kind,k,n", [(kind, k, n) for kind in ("i8t G32", "i8t G16",
                                                               "i8t G16 mins", "i8c")
                                      for k, n in _RAGGED_KN if kind != "i8c" or k % 256 == 0])
def test_matvec_at_ragged_n_and_k(cuda, kind, k, n):
    """The M = 1 matvec (csrc/i8mv.cuh) at N not a multiple of 256 and K
    not a power of two (splits of uneven whole chunks, some warps idle), through
    its K splits, against the plain version; a second launch repeats it."""
    gen = torch.Generator(device="cuda").manual_seed(43)
    if kind == "i8c":  # K a multiple of 256
        w, kern, plain = _w8c(2, k, n, gen).at(1), tq.qmm_i8c, tq.qmm_i8c_plain
    else:
        w = _w8(2, k, n, gen, group=16 if "G16" in kind else 32, mins="mins" in kind).at(1)
        kern, plain = tq.qmm_i8t, tq.qmm_plain
    x = torch.randn(1, k, device="cuda", generator=gen).to(torch.bfloat16)
    got, want = kern(x, w), plain(x, w)
    assert (got - want).abs().max() <= 2e-4 * want.abs().max()
    assert torch.equal(got, kern(x, w))


@pytest.mark.parametrize("what", ["i8t", "i8t G16", "gateup", "i8c"])
def test_matvec_repeats_across_graph_replays(cuda, what):
    """The M = 1 matvec's cluster split sums give the same bits in eager
    calls and CUDA-graph replays, and leave the shared ticket buffer zero
    (they take none)."""
    gen = torch.Generator(device="cuda").manual_seed(44)
    x = torch.randn(1, 2048, device="cuda", generator=gen).to(torch.bfloat16)
    tq._ticket_buffer(x.device, 1)
    w = (_w8c(1, 2048, 2048, gen).at(0) if what == "i8c"
         else _w8(1, 2048, 2048, gen, group=16 if what.endswith("G16") else 32).at(0))
    assert tq.mv_plan(2048, 2048, 0 if what == "i8c" else w.group) > 1
    kern = {"gateup": tq.qmm_i8t_gateup, "i8c": tq.qmm_i8c}.get(what, tq.qmm_i8t)
    _replays_equal(lambda: kern(x, w))


@pytest.mark.parametrize("group,mins,k,ff", [(16, False, 2048, 5504), (32, False, 4096, 1408),
                                             (16, True, 1088, 640), (32, False, 64, 128)])
def test_gateup_gd_kernel_equals_gd_at_ragged_shapes(cuda, group, mins, k, ff):
    """The M = 1 fused gate-up stays the matvec on its fused weight +
    silu·mul bit for bit where the plan splits K and leaves warps idle."""
    gen = torch.Generator(device="cuda").manual_seed(45)
    w = _w8(1, k, 2 * ff, gen, group=group, mins=mins).at(0)
    x = torch.randn(1, k, device="cuda", generator=gen).to(torch.bfloat16)
    got = tq.qmm_i8t_gateup(x, w)
    gu = tq.qmm_i8t(x, w).to(torch.bfloat16)
    assert torch.equal(got, tq.silu(gu[:, :ff]) * gu[:, ff:])


@pytest.mark.parametrize("m", [1, 16, 64, 100])
def test_mlp_i8t_kernel_equals_gateup_then_down(cuda, m):
    gen = torch.Generator(device="cuda").manual_seed(12)
    wgu, wd = _w8(2, 512, 2048, gen), _w8(2, 1024, 384, gen)
    x = torch.randn(m, 512, device="cuda", generator=gen).to(torch.bfloat16)
    got = tm.qmm_mlp_i8t(x, wgu.at(0), wd.at(0))
    want = tm.qmm_mlp_plain(x, wgu.at(0), wd.at(0))
    assert (got.float() - want.float()).abs().max() <= 2 ** -7 * want.float().abs().max()
    gu = tq.qmm_i8t(x, wgu.at(0), dq=True).to(torch.bfloat16)
    mid = tq.silu(gu[:, :1024]) * gu[:, 1024:]
    if m > 1:
        assert torch.equal(mid, tq.qmm_i8t_gateup(x, wgu.at(0)))
    assert torch.equal(got, tq.qmm_i8t(mid, wd.at(0), dq=True).to(torch.bfloat16))
    assert torch.equal(got, tm.qmm_mlp_i8t(x, wgu.at(0), wd.at(0)))  # the counters reset


def test_i8t_wrappers_refuse_shapes_not_ported(cuda):
    gen = torch.Generator(device="cuda").manual_seed(13)
    w = _w8(1, 1024, 256, gen)
    x = torch.zeros(1, 1024, device="cuda", dtype=torch.bfloat16)
    x2 = torch.zeros(2, 1024, device="cuda", dtype=torch.bfloat16)
    w64 = QTensor("i8t", w.qw[0], torch.zeros(1, 16, 256, device="cuda", dtype=torch.bfloat16),
                  None, 64, (256, 1024), GGMLType.Q8_0)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tq.qmm_i8t(x, w64)
    wm = _w8(1, 1024, 256, gen, group=16, mins=True).at(0)
    with pytest.raises(NotImplementedError, match="not ported yet"):  # mins at M > 1
        tq.qmm_i8t(x2, wm)
    w16, d16 = _w8(1, 1024, 256, gen, group=16).at(0), _w8(1, 128, 1024, gen, group=16).at(0)
    xr = torch.randn(1, 1024, device="cuda", generator=gen).to(torch.bfloat16)
    assert torch.equal(tm.qmm_mlp_i8t(xr, w16, d16), tm.qmm_mlp_plain(xr, w16, d16))  # group 16
    with pytest.raises(NotImplementedError, match="not ported yet"):  # mins at group 16
        tm.qmm_mlp_i8t(x, wm, _w8(1, 128, 1024, gen, group=16, mins=True).at(0))
    with pytest.raises(NotImplementedError, match="not ported yet"):  # ReLU
        tm.qmm_mlp_i8t(x, w16, d16, "relu")
    w96 = QTensor("i8t", w.qw[0, :, :96].contiguous(), w.scales[0, :, :, :96].contiguous(),
                  None, 32, (96, 1024), GGMLType.Q8_0)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tq.qmm_i8t(x, w96)


@pytest.mark.parametrize("kind", ["i8t G32", "i8t G16", "i8c"])
@pytest.mark.parametrize("m,n", [(17, 384), (100, 640), (130, 384), (16, 128), (64, 384)])
def test_i8k_tile_at_ragged_m_and_n(cuda, kind, m, n):
    """The int8 K-major tile (csrc/i8k_tile.cuh) at ragged M (rows past M
    zero and never written; BM 32, 128, 256) and N not a multiple of 256,
    with its K splits (one cluster a tile), against the plain version; the
    ordered split sums repeat."""
    gen = torch.Generator(device="cuda").manual_seed(40)
    k = 2048
    if kind == "i8c":
        w, kern, plain = _w8c(2, k, n, gen).at(1), tq.qmm_i8c, tq.qmm_i8c_plain
    else:
        w = _w8(2, k, n, gen, group=16 if kind.endswith("G16") else 32).at(1)
        kern, plain = tq.qmm_i8t, tq.qmm_plain
    x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
    assert tq.i8k_plan(m, k, n)[1] > 1  # the split is exercised
    got, want = kern(x, w), plain(x, w)
    assert (got - want).abs().max() <= 2e-4 * want.abs().max()
    assert torch.equal(got, kern(x, w))


@pytest.mark.parametrize("m", [64, 2048])
def test_i8k_gateup_equals_dq_then_silu_mul(cuda, m):
    """The fused gate-up on the tile (64 gate and 64 up columns a block) is
    the matmul on its fused weight + silu·mul, bit for bit, at a batch step
    and a batch prefill."""
    gen = torch.Generator(device="cuda").manual_seed(41)
    w = _w8(1, 2048, 2 * 640, gen).at(0)
    x = torch.randn(m, 2048, device="cuda", generator=gen).to(torch.bfloat16)
    got = tq.qmm_i8t_gateup(x, w)
    gu = tq.qmm_i8t(x, w).to(torch.bfloat16)
    assert torch.equal(got, tq.silu(gu[:, :640]) * gu[:, 640:])


@pytest.mark.parametrize("what", ["i8t", "gateup", "i8c", "mlp"])
def test_i8k_splits_repeat_across_graph_replays(cuda, what):
    """The tile's split sums (a cluster's, or the whole MLP's through its
    tickets and counters, which its last blocks reset) give the same bits
    in eager calls and CUDA-graph replays, and leave the shared ticket
    buffer zero."""
    gen = torch.Generator(device="cuda").manual_seed(42)
    x = torch.randn(16, 1024, device="cuda", generator=gen).to(torch.bfloat16)
    tq._ticket_buffer(x.device, 1)
    if what == "mlp":
        wgu, wd = _w8(1, 1024, 2 * 1024, gen).at(0), _w8(1, 1024, 1024, gen).at(0)
        assert tq.i8k_plan(16, 1024, 1024)[1] > 1
        _replays_equal(lambda: tm.qmm_mlp_i8t(x, wgu, wd))
        return
    w = _w8c(1, 1024, 1024, gen).at(0) if what == "i8c" else _w8(1, 1024, 1024, gen).at(0)
    assert tq.i8k_plan(16, 1024, 1024)[1] > 1
    kern = {"i8t": tq.qmm_i8t, "gateup": tq.qmm_i8t_gateup, "i8c": tq.qmm_i8c}[what]
    _replays_equal(lambda: kern(x, w))


def _w8c(L, K, N, gen):
    """A stacked random i8c weight [L, K, N] with f32 channel scales [L, 1, N]."""
    qw = torch.randint(-127, 128, (L, K, N), dtype=torch.int8, device="cuda", generator=gen)
    s = torch.rand((L, 1, N), device="cuda", generator=gen) * 0.02 + 1e-3
    return QTensor("i8c", qw, s, None, K, (N, K), GGMLType.Q8_0)


@pytest.mark.parametrize("m,k,n", [(1, 256, 128), (1, 4096, 384), (5, 1024, 384),
                                   (64, 512, 256), (130, 2048, 128), (300, 768, 512)])
def test_qmm_i8c_kernel_matches_plain(cuda, m, k, n):
    gen = torch.Generator(device="cuda").manual_seed(14)
    w = _w8c(2, k, n, gen)
    x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
    for view in (w.at(1), w.at(1).resolved()):  # the layer view and a 2-D weight
        got, want = tq.qmm_i8c(x, view), tq.qmm_i8c_plain(x, view)
        assert (got - want).abs().max() <= 2e-4 * want.abs().max()
        assert torch.equal(got, tq.qmm_i8c(x, view))  # the ordered split sums repeat


def test_i8c_wrapper_refuses_shapes_not_ported(cuda):
    gen = torch.Generator(device="cuda").manual_seed(15)
    x = torch.zeros(1, 128, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="not ported yet"):  # K % 256
        tq.qmm_i8c(x, _w8c(1, 128, 128, gen).at(0))
    x = torch.zeros(1, 256, device="cuda", dtype=torch.bfloat16)
    w = _w8c(1, 256, 128, gen).at(0).resolved()
    with pytest.raises(ValueError, match="f32"):  # compacted scales
        tq.qmm_i8c(x, dataclasses.replace(w, scales=w.scales.to(torch.bfloat16)))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("win,softcap,with_self", [(0, 0.0, True), (100, 30.0, True),
                                                  (0, 0.0, False)])
def test_paged_attn_kernel_matches_plain(cuda, quantized, win, softcap, with_self):
    # scattered pages, two shared by slots 0-2, lengths mid-page, on a page
    # boundary and of one row (testing.paged_attn_case)
    args = paged_attn_case(2, 8, 2, 4, 128, 4, 128, 128, [300, 257, 512, 1, 128, 400, 60, 9],
                           "cuda", seed=14, quantized=quantized, shared=3, win=win,
                           softcap=softcap)
    if not with_self:
        args = (*args[:8], None, None, None, *args[11:])
    got, want = pga.paged_attn(*args), pga.paged_attn_plain(*args)
    limit = paged_attn_limit(args if with_self else (
        *args[:8], torch.zeros_like(got[:, :, 0]).to(torch.bfloat16),
        torch.zeros_like(got[:, :, 0]).to(torch.bfloat16),
        torch.zeros(8, dtype=torch.int32, device="cuda"), *args[11:]))
    assert ((got - want).abs() <= limit).all()


@pytest.mark.parametrize("quantized", [False, True])
def test_kv_append_paged_kernel_is_exact(cuda, quantized):
    """The paged append against its plain version (the scatter) run on the
    CPU from the same pool: equal on every page but the scratch page 0;
    offsets on a page boundary, on a page's last row and past the table."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    L, B, H, P, MAXP, D = 3, 4, 2, 128, 4, 128
    Np = B * MAXP + 1
    table = (1 + torch.randperm(Np - 1, generator=torch.Generator().manual_seed(0))).reshape(
        B, MAXP).to("cuda", torch.int32)
    new = (torch.randn(2, L, B, H, 64, device="cuda", generator=gen) * 3).to(torch.bfloat16)
    new[0, 0, 0, 0] = 0  # a zero row
    off = torch.tensor([0, P, 2 * P + 127, MAXP * P + 3], dtype=torch.int32, device="cuda")
    k = torch.randn(L, Np, H, P, D, device="cuda", generator=gen)
    if quantized:
        k, ks = _quantize_kv(k)
        pool = [k, k.clone(), ks, ks.clone()]
    else:
        pool = [k.to(torch.bfloat16), k.to(torch.bfloat16), None, None]
    plain = [None if t is None else t.cpu() for t in pool]
    ka.kv_append_all_layers_paged(*pool[:2], new[0], new[1], off, table, *pool[2:])
    ka.kv_append_all_layers_paged(*plain[:2], new[0].cpu(), new[1].cpu(), off.cpu(),
                                  table.cpu(), *plain[2:])
    for got, want in zip(pool, plain):
        if got is not None:
            assert torch.equal(got[:, 1:].cpu(), want[:, 1:])


def _lane(kind, R, K, gen, mins=False):
    """A random lane-major weight [R, K] (i4p or i8) with bf16 prepared scale
    planes (Q4_0's and Q8_0's form; with `mins`, affine rows too)."""
    i4 = kind == "i4p"
    if i4:
        qw = torch.randint(0, 256, (R, K // 2), dtype=torch.uint8, device="cuda", generator=gen)
    else:
        qw = torch.randint(-127, 128, (R, K), dtype=torch.int8, device="cuda", generator=gen)
    rows = (2 if i4 else 1) * (2 if mins else 1)
    s = torch.rand((R, rows, K // (32 * (2 if i4 else 1))), device="cuda", generator=gen)
    return QTensor(kind, qw, (s * 0.02 + 1e-3).to(torch.bfloat16), None, 32, (R, K),
                   GGMLType.Q4_0 if i4 else GGMLType.Q8_0, zero=8 if i4 else 0)


@pytest.mark.parametrize("kind", ["i4p", "i8"])
@pytest.mark.parametrize("m,k,n", [(1, 768, 128), (5, 1024, 384), (40, 512, 256),
                                   (600, 512, 256)])
def test_qmm_lane_kernel_matches_plain(cuda, kind, m, k, n):
    gen = torch.Generator(device="cuda").manual_seed(20)
    w = _lane(kind, n, k, gen)
    x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
    kernels.reset_counts()
    got, want = tq.qmm_lane(x, w), tq.qmm_lane_plain(x, w)
    torch.cuda.synchronize()
    assert (got - want).abs().max() <= 2e-4 * want.abs().max()
    name = "qmm_i4p" if kind == "i4p" else tq.lane_i8_count_name(tq.lane_i8_plan(m, k, n))
    assert kernels.launch_counts[name] == 1


@pytest.mark.parametrize("kind", ["i4p", "i8"])
@pytest.mark.parametrize("n_tok", [1, 9, 64])
def test_grouped_kernel_matches_plain(cuda, kind, n_tok):
    """The grouped kernel over route_pad's buffer of seeded routings:
    within qmm's limit of its plain version, and exactly zero on the
    padding tiles it skips; the tile table ignored or the expert taken off
    by one would fail by far."""
    from booster_tpu_torch.ops import moe

    gen = torch.Generator(device="cuda").manual_seed(21)
    E, K, Ne = 4, 512, 256
    w = _lane(kind, E * Ne, K, gen)
    x = torch.randn(n_tok, K, device="cuda", generator=gen).to(torch.bfloat16)
    topi = torch.topk(torch.randn(n_tok, E, device="cuda", generator=gen), 2).indices
    xp, pos, te, used = moe.route_pad(x, topi.to(torch.int32), E)
    kernels.reset_counts()
    got = moe.grouped_qmm(xp, w, te, E, used)
    want = moe.grouped_qmm_plain(xp, w, te, E, used)
    torch.cuda.synchronize()
    limit = 2e-4 * want.abs().max()
    assert (got - want).abs().max() <= limit
    assert not got[int(used[0]):].any()
    assert kernels.launch_counts[f"moe_qmm_{kind}"] == 1
    wrong = moe.grouped_qmm_plain(xp, w, (te + 1) % E, E, used)
    assert (wrong - want).abs().max() > 100 * limit


@pytest.mark.parametrize("m", [1, 64])
def test_qmm_lane_k_split_at_the_down(cuda, m):
    """The 1.3B down (i8, K 5504, N 2048) at M = 1 and 64 in the forms of
    lane_i8_plan (csrc/qmm_lane_i8.cu): at one row the matvec, whose 16-row
    blocks stream whole rows (128 blocks, no K split); at 64 the wgmma tile,
    K split over a cluster of its 16 column tiles' blocks; within the limit
    of the plain version, one launch a call, the same bits across graph
    replays, and every wrong kernel of testing.qmm_lane_i8_mutants 8x past
    the limit."""
    from booster_tpu_torch.testing import qmm_lane_i8_mutants

    gen = torch.Generator(device="cuda").manual_seed(34)
    w = _lane("i8", 2048, 5504, gen)
    x = torch.randn(m, 5504, device="cuda", generator=gen).to(torch.bfloat16)
    plan = tq.lane_i8_plan(m, 5504, 2048)
    assert plan[0] == ("mv" if m == 1 else "mm")
    assert (2048 // tq.LANE_MV_ROWS if m == 1 else 16 * plan[2]) >= 128
    kernels.reset_counts()
    got = _replays_equal(lambda: tq.qmm_lane(x, w))
    assert kernels.launch_counts[tq.lane_i8_count_name(plan)] == 3  # two calls, the captured one
    want = tq.qmm_lane_plain(x, w)
    limit = 2e-4 * want.abs().max()
    assert (got - want).abs().max() <= limit
    for what, (xm, wm) in qmm_lane_i8_mutants(x, w, plan).items():
        assert (tq.qmm_lane_plain(xm, wm) - want).abs().max() > 8 * limit, what


@pytest.mark.parametrize("kind", ["i4p", "i8"])
@pytest.mark.parametrize("n_tok,k_used", [(1, 2), (1024, 2)])
def test_grouped_kernel_blocks_of_several_tiles(cuda, kind, n_tok, k_used):
    """The grouped form at one decode token (its K split over the padding
    estimate) and at 2048 routed rows of 4 experts (128-row blocks of four
    expert tiles that may hold two experts' runs), zero past rows_used, and
    the same bits across graph replays."""
    from booster_tpu_torch.ops import moe

    gen = torch.Generator(device="cuda").manual_seed(35)
    E, K, Ne = 4, 1024, 256
    w = _lane(kind, E * Ne, K, gen)
    x = torch.randn(n_tok, K, device="cuda", generator=gen).to(torch.bfloat16)
    topi = torch.topk(torch.randn(n_tok, E, device="cuda", generator=gen), k_used).indices
    xp, pos, te, used = moe.route_pad(x, topi.to(torch.int32), E)
    bm, ks = tq.lane_plan(xp.shape[0], K, Ne, E)
    assert bm == (32 if n_tok == 1 else 128) and ks > 1
    got = _replays_equal(lambda: moe.grouped_qmm(xp, w, te, E, used))
    want = moe.grouped_qmm_plain(xp, w, te, E, used)
    assert (got - want).abs().max() <= 2e-4 * want.abs().max()
    assert not got[int(used[0]):].any()


def _lane_i8_forms(m):
    """Every form of csrc/qmm_lane_i8.cu that takes m rows (the matvec up to
    32 rows; the tile at each height and at one and at several splits, at
    256 rows at two)."""
    out = [("mv", mt) for mt in (1, 2, 4) if m <= 8 * mt]
    return out + [("mm", bm, ks) for bm in (32, 64, 128) for ks in (1, 4)] + [("mm", 256, 2)]


@pytest.mark.parametrize("group,offset", [(32, 0), (16, 1), (64, 0)])
@pytest.mark.parametrize("mins", [False, True])
@pytest.mark.parametrize("m", [1, 7, 16, 23, 100])
def test_lane_i8_forms_match_plain(cuda, m, mins, group, offset):
    """Every form of the int8 lane-major kernels (the matvec with 1, 2 and 4
    m8 tiles where they hold M; the tile at 32, 64
    and 128 rows a block, at one split and at a cluster of 4, and at 256
    rows at 2) within 2e-4 of the largest output of
    the plain version, at K 1536 (24 chunks: 3 a warp; 24 stages) and N 256,
    groups 32, 16 and 64, with and without a mins plane, the planes' base
    off 4-byte alignment (offset 1: a scale's word is found from its
    element), each form counted under its own name."""
    gen = torch.Generator(device="cuda").manual_seed(60 + m)
    k, n = 1536, 256
    w = _lane("i8", n, k, gen, mins=mins)
    if group != 32 or offset:
        rows = 2 if mins else 1
        flat = torch.rand(offset + n * rows * (k // group), device="cuda", generator=gen)
        s = (flat[offset:] * 0.02 + 1e-3).to(torch.bfloat16)
        buf = torch.empty(offset + s.numel(), dtype=torch.bfloat16, device="cuda")
        buf[offset:] = s
        planes = buf[offset:].view(n, rows, k // group)
        assert planes.is_contiguous() and planes.data_ptr() % 4 == 2 * offset
        w = dataclasses.replace(w, group=group, scales=planes)
    x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
    want = tq.qmm_lane_plain(x, w)
    limit = 2e-4 * want.abs().max()
    for form in _lane_i8_forms(m):
        kernels.reset_counts()
        got = tq.lane_i8_launch(x, w, form)
        torch.cuda.synchronize()
        assert (got - want).abs().max() <= limit, form
        assert kernels.launch_counts[tq.lane_i8_count_name(form)] == 1


@pytest.mark.parametrize("mins", [False, True])
@pytest.mark.parametrize("m", [1, 16, 64, 2048])
def test_lane_i8_plan_forms_at_the_down(cuda, m, mins):
    """The plan's form at the 1.3B down (5504 → 2048; real Q5_1 planes, and
    the same weight without its mins plane: the Q8_0 down's form) against
    its CPU mirror (testing.qmm_lane_mv_split / qmm_lane_mm_split, the
    kernels' sum order in plain torch) and the plain version, both within
    2e-4 of the largest output; the mirror with a chunk or a split left out
    8x past it."""
    from booster_tpu_torch.testing import (q5_1_weight, qmm_lane_mm_split, qmm_lane_mv_split,
                                           without_mins)

    k, n = 5504, 2048
    w = q5_1_weight(n, k, seed=90 + m, device="cuda")
    w = w if mins else without_mins(w)
    gen = torch.Generator(device="cuda").manual_seed(90 + m)
    x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
    plan = tq.lane_i8_plan(m, k, n)
    got = tq.qmm_lane(x, w)
    want = tq.qmm_lane_plain(x, w)
    limit = 2e-4 * want.abs().max()
    assert (got - want).abs().max() <= limit
    xc, wc = x.cpu(), dataclasses.replace(w, qw=w.qw.cpu(), scales=w.scales.cpu())
    if plan[0] == "mv":
        mirror, wrong = qmm_lane_mv_split(xc, wc), qmm_lane_mv_split(xc, wc, drop=0)
    else:
        mirror = qmm_lane_mm_split(xc, wc, plan[2])
        wrong = qmm_lane_mm_split(xc, wc, plan[2], drop=plan[2] - 1)
    assert (got.cpu() - mirror).abs().max() <= limit.cpu()
    assert (wrong - want.cpu()).abs().max() > 8 * limit.cpu()


def test_lane_i8_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """csrc/qmm_lane_i8.cu's wrapper raises, never falls back: a group of 8,
    N not a multiple of 128, f32 planes, x off 16 bytes, an i4p weight, more
    rows than the matvec's m8 tiles hold, a bad tile height or split count
    (the library refuses the launch)."""
    gen = torch.Generator(device="cuda").manual_seed(23)
    x = torch.randn(3, 512, device="cuda", generator=gen).to(torch.bfloat16)
    w = _lane("i8", 128, 512, gen, mins=True)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tq.lane_i8_launch(x, dataclasses.replace(w, group=8, scales=torch.zeros(
            128, 2, 64, device="cuda", dtype=torch.bfloat16)))
    with pytest.raises(NotImplementedError):  # N not a multiple of 128
        tq.lane_i8_launch(x, _lane("i8", 96, 512, gen))
    with pytest.raises(ValueError):  # f32 scale planes (not compacted)
        tq.lane_i8_launch(x, dataclasses.replace(w, scales=w.scales.float()))
    with pytest.raises(ValueError):  # x off 16 bytes
        tq.lane_i8_launch(torch.zeros(3 * 512 + 1, device="cuda", dtype=torch.bfloat16)[1:]
                          .view(3, 512), w)
    with pytest.raises(ValueError):  # a 4-bit weight
        tq.lane_i8_launch(x, _lane("i4p", 128, 512, gen))
    with pytest.raises(ValueError):  # 9 rows, one m8 tile
        tq.lane_i8_launch(torch.zeros(9, 512, device="cuda", dtype=torch.bfloat16), w,
                          ("mv", 1))
    for form in (("mm", 48, 1), ("mm", 64, 9), ("mv", 3)):
        with pytest.raises((RuntimeError, ValueError)):
            tq.lane_i8_launch(torch.zeros(2, 512, device="cuda", dtype=torch.bfloat16), w, form)
        torch.cuda.synchronize()


def test_lane_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    gen = torch.Generator(device="cuda").manual_seed(22)
    x = torch.randn(2, 512, device="cuda", generator=gen).to(torch.bfloat16)
    w8 = _lane("i8", 128, 512, gen, mins=True)  # Q5_K's form runs; a group of 8 does not
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tq.qmm_lane(x, dataclasses.replace(w8, group=8, scales=torch.zeros(
            128, 2, 64, device="cuda", dtype=torch.bfloat16)))
    with pytest.raises(ValueError):  # f32 scale planes (not compacted)
        w = _lane("i8", 128, 512, gen)
        tq.qmm_lane(x, QTensor("i8", w.qw, w.scales.float(), None, 32, (128, 512),
                               GGMLType.Q8_0))
    with pytest.raises(NotImplementedError):  # N not a multiple of 128
        tq.qmm_lane(x, _lane("i8", 96, 512, gen))


# -- the i8 stream probes' kernels (csrc/probe_i8.cu) -------------------------

# (int8 x, N-major weight, scale, scale dtype, i32 out): every form the
# probe tools run
PROBE_MM_FORMS = [
    (False, True, "none", None, False), (True, True, "none", None, False),
    (True, True, "none", None, True), (True, False, "none", None, True),
    (False, False, "none", None, False), (False, False, "plane", torch.bfloat16, False),
    (False, False, "group", torch.bfloat16, False),
    (False, False, "reorder", torch.bfloat16, False),
    (False, True, "group", torch.float32, False)]
# (int8 x, N-major weight, scale dtype, group)
PROBE_GROUP_FORMS = [(True, False, torch.bfloat16, 32), (True, True, torch.float32, 32),
                     (False, False, torch.bfloat16, 32), (False, False, torch.bfloat16, 128)]


def _probe_operands(gen, M, K, N, x_i8, n_major):
    x = (torch.randint(-127, 127, (M, K), dtype=torch.int8, device="cuda", generator=gen)
         if x_i8 else torch.randn(M, K, device="cuda", generator=gen).to(torch.bfloat16))
    q = torch.randint(-127, 127, (N, K) if n_major else (K, N), dtype=torch.int8, device="cuda",
                      generator=gen)
    return x, q


def _probe_scales(gen, scale, dtype, K, N, n_major):
    shape = {"plane": (K, N), "group": (N, K // 32) if n_major else (K // 32, N),
             "reorder": (K // 32, N)}[scale]
    return (torch.rand(shape, device="cuda", generator=gen) + 0.5).to(dtype)


@pytest.mark.parametrize("mode", ["i32", "f32", "bf16"])
@pytest.mark.parametrize("dtype,rows,cols", [(torch.uint8, 2048, 1024), (torch.int8, 3072, 2048)])
def test_probe_colsum_kernel_is_exact(cuda, mode, dtype, rows, cols):
    gen = torch.Generator(device="cuda").manual_seed(30)
    lo, hi = (0, 256) if dtype == torch.uint8 else (-127, 127)
    q = torch.randint(lo, hi, (rows, cols), dtype=dtype, device="cuda", generator=gen)
    kernels.reset_counts()
    for _ in range(2):  # the second launch finds the scratch the first left zero
        got = probes.colsum(q, mode)
        torch.cuda.synchronize()
        assert torch.equal(got, probes.colsum_plain(q, mode))
    assert kernels.launch_counts["probe_colsum"] == 2


@pytest.mark.parametrize("form", PROBE_MM_FORMS)
@pytest.mark.parametrize("m,k,n", [(16, 1024, 256), (100, 512, 384), (64, 256, 128)])
def test_probe_i8mm_kernel_matches_plain(cuda, form, m, k, n):
    x_i8, n_major, scale, sdt, out_i32 = form
    gen = torch.Generator(device="cuda").manual_seed(31)
    x, q = _probe_operands(gen, m, k, n, x_i8, n_major)
    s = None if scale == "none" else _probe_scales(gen, scale, sdt, k, n, n_major)
    kw = dict(n_major=n_major, s=s, scale=scale, bk=256, out_i32=out_i32)
    got = probes.i8mm(x, q, **kw)
    want = probes.i8mm_plain(x, q, **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    if x_i8:
        assert torch.equal(got, want)
    else:
        assert (got - want).abs().max() <= 2e-4 * want.abs().max()
    assert torch.equal(probes.i8mm(x, q, **kw), got)  # the split sums repeat bit for bit


@pytest.mark.parametrize("form", PROBE_GROUP_FORMS)
@pytest.mark.parametrize("m,k,n", [(16, 1024, 256), (100, 512, 384)])
def test_probe_i8mm_group_kernel_matches_plain(cuda, form, m, k, n):
    x_i8, n_major, sdt, group = form
    gen = torch.Generator(device="cuda").manual_seed(32)
    x, q = _probe_operands(gen, m, k, n, x_i8, n_major)
    s = _probe_scales(gen, "group", sdt, k, n, n_major)
    got = probes.i8mm_group(x, q, s, n_major=n_major, group=group)
    want = probes.i8mm_group_plain(x, q, s, n_major=n_major, group=group)
    torch.cuda.synchronize()
    limit = 2e-4 * want.abs().max()
    assert (got - want).abs().max() <= limit
    dropped = probes.i8mm_group_plain(x, q, torch.ones_like(s), n_major=n_major, group=group)
    assert (got - dropped).abs().max() > 8 * limit  # the rescale is seen


def test_probe_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    gen = torch.Generator(device="cuda").manual_seed(33)
    x, q = _probe_operands(gen, 16, 512, 256, False, False)
    with pytest.raises(NotImplementedError):  # i32 out of a bf16 x
        probes.i8mm(x, q, out_i32=True)
    with pytest.raises(NotImplementedError):  # f32 reordered scales
        probes.i8mm(x, q, s=_probe_scales(gen, "reorder", torch.float32, 512, 256, False),
                    scale="reorder", bk=256)
    with pytest.raises(NotImplementedError):  # N not a multiple of 128
        probes.i8mm(x, q[:, :192].contiguous())
    with pytest.raises(NotImplementedError):  # a group of 64
        probes.i8mm_group(x, q, _probe_scales(gen, "group", torch.bfloat16, 512, 256, False),
                          group=64)
    with pytest.raises(NotImplementedError):  # C not a multiple of 1024
        probes.colsum(q, "i32")


# -- the scale-expansion and i4 probes' kernels (csrc/probe_i8.cu's new forms,
# csrc/probe_i4.cu) ------------------------------------------------------------

# (N-major weight, scale): the f32 forms expander_probe and tqmm_probe run
PROBE_F32_FORMS = [(True, "tile"), (False, "group"), (False, "tile")]


@pytest.mark.parametrize("n_major,scale", PROBE_F32_FORMS)
@pytest.mark.parametrize("m,k,n", [(8, 1024, 256), (64, 512, 384), (100, 2048, 128)])
def test_probe_i8mm_f32_scales_match_plain(cuda, n_major, scale, m, k, n):
    gen = torch.Generator(device="cuda").manual_seed(34)
    x, q = _probe_operands(gen, m, k, n, False, n_major)
    s = _probe_scales(gen, "group", torch.float32, k, n, n_major) * 0.01
    got = probes.i8mm(x, q, n_major=n_major, s=s, scale=scale)
    want = probes.i8mm_plain(x, q, n_major=n_major, s=s, scale=scale)
    torch.cuda.synchronize()
    limit = 2e-4 * want.abs().max()
    assert (got - want).abs().max() <= limit
    other = "group" if scale == "tile" else "tile"  # the other scale rule is seen
    wrong = probes.i8mm_plain(x, q, n_major=n_major, s=s, scale=other)
    assert (got - wrong).abs().max() > 8 * limit


@pytest.mark.parametrize("transposed", [True, False])
def test_probe_group_form_reads_scales_through_their_strides(cuda, transposed):
    """expander_probe's gloop: scales [K/32, N] over an N-major weight, as
    the transposed view of a contiguous plane."""
    gen = torch.Generator(device="cuda").manual_seed(35)
    x, q = _probe_operands(gen, 8, 1024, 384, False, True)
    s = _probe_scales(gen, "group", torch.float32, 1024, 384, False)  # [K/32, N]
    s = s.t() if transposed else s.t().contiguous()
    kernels.reset_counts()
    got = probes.i8mm_group(x, q, s, n_major=True)
    want = probes.i8mm_group_plain(x, q, s, n_major=True)
    torch.cuda.synchronize()
    limit = 2e-4 * want.abs().max()
    assert (got - want).abs().max() <= limit
    assert (got - probes.i8mm_group_plain(x, q, s.t().contiguous().reshape(s.shape),
                                          n_major=True)).abs().max() > 8 * limit
    key = ("probe_i8mm_group", ("bf16.n.g32" + (".sT" if transposed else ""), 1024, 384))
    assert kernels.shape_counts == {key: 1}


@pytest.mark.parametrize("bn,sub", [(1024, 1024), (512, 256), (128, 512)])
def test_probe_blocksum_kernel_is_exact(cuda, bn, sub):
    gen = torch.Generator(device="cuda").manual_seed(36)
    q = torch.randint(-127, 127, (2048, 2048), dtype=torch.int8, device="cuda", generator=gen)
    for _ in range(2):  # the second launch finds the scratch the first left zero
        got = probes.blocksum(q, 8, bn, sub)
        torch.cuda.synchronize()
        assert torch.equal(got, probes.blocksum_plain(q, 8, bn, sub))


@pytest.mark.parametrize("tile,bf16", [(False, False), (True, False), (False, True)])
@pytest.mark.parametrize("r,c,w,g", [(8, 128, 256, 32), (64, 96, 3072, 32), (3, 16, 40, 4)])
def test_probe_expand_kernel_is_exact(cuda, tile, bf16, r, c, w, g):
    gen = torch.Generator(device="cuda").manual_seed(37)
    s = torch.randn(r, c, device="cuda", generator=gen)
    got = probes_i4.expand(s, g, w, tile, bf16)
    torch.cuda.synchronize()
    assert torch.equal(got, probes_i4.expand_plain(s, g, w, tile, bf16))


def _i4_operands(gen, m, k, n, mode):
    half = k // 2
    q = torch.randint(0, 256, (half, n), dtype=torch.uint8, device="cuda", generator=gen)
    s = torch.randn(probes_i4.SCALE_ROWS[mode], half // 32, n, device="cuda", generator=gen)
    x3 = torch.randn(m, 2, half, device="cuda", generator=gen).to(torch.bfloat16)
    return x3, q, s


@pytest.mark.parametrize("mode", probes_i4.MODES)
@pytest.mark.parametrize("rows,cols", [(256, 128), (1024, 384)])
def test_probe_nibble_kernel_is_exact(cuda, mode, rows, cols):
    gen = torch.Generator(device="cuda").manual_seed(38)
    _, q, s = _i4_operands(gen, 1, 2 * rows, cols, mode)
    got = probes_i4.nibble_tiles(q, s, mode)
    torch.cuda.synchronize()
    for a, b in zip(got, probes_i4.nibble_tiles_plain(q, s, mode)):
        assert torch.equal(a, b)


# (mode, unpack): every i4mm form the probe tools run
PROBE_I4_FORMS = [("current", u) for u in probes_i4.UNPACKS] + [("i8mask", "i32"),
                                                                 ("affine", "i32")]


@pytest.mark.parametrize("mode,unpack", PROBE_I4_FORMS)
@pytest.mark.parametrize("m,k,n", [(8, 512, 256), (64, 2048, 384), (100, 1024, 128)])
def test_probe_i4mm_kernel_matches_plain(cuda, mode, unpack, m, k, n):
    gen = torch.Generator(device="cuda").manual_seed(39)
    x3, q, s = _i4_operands(gen, m, k, n, mode)
    got = probes_i4.i4mm(x3, q, s, mode, unpack)
    want = probes_i4.i4mm_plain(x3, q, s, mode)
    torch.cuda.synchronize()
    limit = 2e-4 * want.abs().max()
    assert (got - want).abs().max() <= limit
    assert (got - probes_i4.i4mm_plain(x3, q, s.flip(0), mode)).abs().max() > 8 * limit
    # every unpack of one mode is the same numbers in the same order
    assert torch.equal(probes_i4.i4mm(x3, q, s, mode), got)


@pytest.mark.parametrize("fmt", probes_i4.FORMATS)
@pytest.mark.parametrize("n,k", [(1024, 512), (256, 4096), (384, 1536)])
def test_probe_groupdot_kernel_matches_plain(cuda, fmt, n, k):
    gen = torch.Generator(device="cuda").manual_seed(40)
    rows = k if fmt == "i8" else k // 2
    q = (torch.randint(-127, 128, (rows, n), dtype=torch.int8, device="cuda", generator=gen)
         if fmt == "i8" else
         torch.randint(0, 256, (rows, n), dtype=torch.uint8, device="cuda", generator=gen))
    s = torch.rand({"i4": 2, "i4m": 4, "i8": 1}[fmt], rows // 32, n, device="cuda",
                   generator=gen) * 0.02 + 0.01
    x = torch.randn(1, k, device="cuda", generator=gen).to(torch.bfloat16)
    if fmt != "i8":
        x = x.reshape(1, 2, k // 2)
    got = probes_i4.groupdot(x, q, s, fmt)
    want = probes_i4.groupdot_plain(x, q, s, fmt)
    torch.cuda.synchronize()
    limit = 2e-4 * want.abs().max()
    assert (got - want).abs().max() <= limit
    assert torch.equal(probes_i4.groupdot(x, q, s, fmt), got)  # the split sums repeat


@pytest.mark.parametrize("m", [1, 8])
def test_probe_qmm_i4t_counts_under_its_own_key(cuda, m):
    gen = torch.Generator(device="cuda").manual_seed(41)
    x3, q, s = _i4_operands(gen, m, 1024, 256, "current")
    s = s.abs() * 0.02 + 0.01
    w = probes_i4.i4t_weight(q, s)
    kernels.reset_counts()
    got = probes_i4.qmm_i4t(x3, w)
    want = probes_i4.qmm_i4t_plain(x3, w)
    torch.cuda.synchronize()
    assert (got - want).abs().max() <= 2e-4 * want.abs().max()
    key = "probe_qmm_i4t_gd" if m == 1 else "probe_qmm_i4t_dq"
    assert {k: v for k, v in kernels.launch_counts.items() if v} == {key: 1}
    assert [k for k, _ in kernels.shape_counts] == [key]


def test_probe_i4_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    gen = torch.Generator(device="cuda").manual_seed(42)
    x3, q, s = _i4_operands(gen, 8, 512, 256, "current")
    with pytest.raises(NotImplementedError):  # an unpack of a mode other than current
        probes_i4.i4mm(x3, q, s[:2], "i8mask", "xor88")
    with pytest.raises(NotImplementedError):  # N not a multiple of 128
        probes_i4.i4mm(x3, q[:, :192].contiguous(), s[:, :, :192].contiguous())
    with pytest.raises(ValueError):  # affine takes three scale rows
        probes_i4.i4mm(x3, q, s, "affine")
    with pytest.raises(NotImplementedError):  # N not a multiple of 128
        probes_i4.groupdot(x3[:1].contiguous(), q[:, :192].contiguous(),
                           s[:, :, :192].contiguous(), "i4")
    with pytest.raises(ValueError):  # the repeat reads past the scales
        probes_i4.expand(s[0], 32, 32 * s.shape[2] + 1)
    qi = torch.zeros(1024, 1024, dtype=torch.int8, device="cuda")
    with pytest.raises(NotImplementedError):  # K not a multiple of sub
        probes.blocksum(qi, 8, 1024, 384)
    x, qk = _probe_operands(gen, 8, 384, 256, False, False)
    with pytest.raises(NotImplementedError):  # tile scales need K a multiple of 512
        probes.i8mm(x, qk, s=_probe_scales(gen, "group", torch.float32, 384, 256, False),
                    scale="tile")



# -- the s8 probe kernel and the whole MLP's queue (mlp_i8t.cu) ------------------

@pytest.mark.parametrize("m,k,n", [(8, 2048, 17024), (100, 2048, 1152), (33, 512, 384),
                                   (3, 384, 256), (64, 2048, 11264)])
@pytest.mark.parametrize("out_i32", [True, False])
def test_probe_s8mm_kernel_is_exact(cuda, m, k, n, out_i32):
    """The s8 kernel (int8 x against an N-major weight) equals the plain
    version bit for bit at the tiles of 8 to 64 rows, ragged M and 133
    column tiles; a second launch repeats the bits; it counts as
    probe_s8mm and no other."""
    gen = torch.Generator(device="cuda").manual_seed(43)
    x, q = _probe_operands(gen, m, k, n, True, True)
    kernels.reset_counts()
    got = probes.i8mm(x, q, n_major=True, out_i32=out_i32)
    want = probes.i8mm_plain(x, q, n_major=True, out_i32=out_i32)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(probes.i8mm(x, q, n_major=True, out_i32=out_i32), got)
    assert {k: v for k, v in kernels.launch_counts.items() if v} == {"probe_s8mm": 2}


def test_probe_s8_shared_memory_fits_two_blocks_an_sm(cuda):
    """The s8 kernel's shared memory, as the library reports it for the tile
    rows of every tool shape (s8_rows of M = 8, 64, 100 and the 16 and 32 of
    the tests' shapes), fits one block (227 KB) and two blocks an SM with
    their 1 KB of reserved shared memory each (228 KB); other rows are
    refused."""
    lib = kernels.library("probe_i8", probes._SIGNATURES)
    props = torch.cuda.get_device_properties(0)
    per_block = getattr(props, "shared_memory_per_block_optin", 232448)
    per_sm = getattr(props, "shared_memory_per_multiprocessor", 233472)
    for m in (8, 16, 32, 64, 100):
        smem = lib.bt_probe_s8_smem(probes.s8_rows(m))
        assert 0 < smem <= min(per_block, 232448)
        assert 2 * (smem + 1024) <= min(per_sm, 233472)
    assert lib.bt_probe_s8_smem(128) == -1


def test_mlp_workspace_size_matches_its_mirror(cuda):
    lib = kernels.library("mlp_i8t", tm._SIGNATURES)
    for M, ff, C, bm in ((1, 14336, 4096, 16), (64, 14336, 4096, 64), (100, 5632, 2048, 128)):
        assert lib.bt_mlp_i8t_ws_ints(M, ff, C, bm) == tm.mlp_ws_ints(M, ff, C, bm)


@pytest.mark.parametrize("m", [1, 16, 64, 100])
def test_mlp_i8t_equal_on_any_block_count_and_in_parts(cuda, m):
    """The whole MLP gives the same bits on 1, 7, 132 and 396 blocks (three
    an SM) as on the library's two an SM; its gate-up items alone (ids [0,
    nA)) write the mid that the down items alone (ids [nA, nA + nD), no
    waits) turn into the same out; the workspace is zero after each
    launch."""
    gen = torch.Generator(device="cuda").manual_seed(44)
    wgu, wd = _w8(1, 512, 2048, gen).at(0), _w8(1, 1024, 384, gen).at(0)
    x = torch.randn(m, 512, device="cuda", generator=gen).to(torch.bfloat16)
    want = tm.qmm_mlp_i8t(x, wgu, wd)
    plan = tm.mlp_plan(m, 512, 1024, 384)
    for workers in (1, 7, 132, 396):
        out, _ = tm._run(x, wgu, wd, workers=workers)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        assert int(tq._tickets[x.device].abs().sum()) == 0
    nA, nD = plan["nA"], plan["nD"]
    _, mid = tm._run(x, wgu, wd, 0, nA)
    out, _ = tm._run(x, wgu, wd, nA, nD, mid=mid)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert int(tq._tickets[x.device].abs().sum()) == 0


# -- Q4_K: real four-plane weights (scales, then mins, zero 0) ------------------


@pytest.mark.parametrize("m", [1, 9, 600])
@pytest.mark.parametrize("k,n,gateup", [(4096, 6144, False), (4096, 2 * 14336, True)])
def test_q4k_i4t_kernels_on_real_planes(cuda, m, k, n, gateup):
    """qmm_i4t.cu on real Q4_K planes (testing.q4k_weight: the min term as
    large as the scaled term): the matmul at the 8B qkv shape and the fused
    gate-up at ff 14336, at M = 1 (csrc/i4mv.cuh), 9 and 600 (the tile):
    within the limit of the plain version (the gate-up: equal to the matmul
    kernel + silu·mul), and the mins dropped or taken with the wrong sign
    8x past it."""
    from booster_tpu_torch.testing import q4k_weight, qmm_mins_mutants

    w = q4k_weight(n, k, seed=m + n, device="cuda")
    assert tuple(w.scales.shape) == (4, k // 64, n) and w.zero == 0
    x = torch.randn(m, k, device="cuda", generator=torch.Generator(device="cuda").manual_seed(m))
    x = x.to(torch.bfloat16)
    got, want = tq.qmm_i4t(x, w), tq.qmm_plain(x, w)
    limit = 2e-4 * want.abs().max()
    assert (got - want).abs().max() <= limit
    for what, (xm, wm) in qmm_mins_mutants(x, w).items():
        assert (tq.qmm_plain(xm, wm) - want).abs().max() > 8 * limit, what
    if gateup:
        g = tq.qmm_i4t_gateup(x, w)
        gu = got.to(torch.bfloat16)
        assert torch.equal(g, tq.silu(gu[:, :n // 2]) * gu[:, n // 2:])


@pytest.mark.parametrize("m", [1, 5, 40, 600])
def test_q4k_lane_kernel_with_mins(cuda, m):
    """qmm_lane.cu's i4p form with mins (the expand-and-subtract rounding) at
    each row tile and a ragged last tile, on real Q4_K planes: within the
    limit of the plain version, each wrong kernel of
    testing.qmm_lane_mutants (the mins dropped and with the wrong sign among
    them) 8x past it, the same bits across graph replays."""
    from booster_tpu_torch.testing import q4k_weight, qmm_lane_mutants

    k, n = 1024, 384
    w = q4k_weight(n, k, seed=m, device="cuda", kmajor=False)
    assert tuple(w.scales.shape) == (n, 4, k // 64)
    gen = torch.Generator(device="cuda").manual_seed(40 + m)
    x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
    kernels.reset_counts()
    got = _replays_equal(lambda: tq.qmm_lane(x, w))
    assert kernels.launch_counts["qmm_i4p"] == 3
    want = tq.qmm_lane_plain(x, w)
    limit = 2e-4 * want.abs().max()
    assert (got - want).abs().max() <= limit
    bm, ks = tq.lane_plan(m, k, n)
    sk = tq.lane_stage(bm, "i4p")
    nst = k // sk
    seen = qmm_lane_mutants(x, w, ((ks - 1) * nst // ks, nst), sk)
    assert {"mins dropped", "mins with the wrong sign"} <= set(seen)
    for what, (xm, wm) in seen.items():
        assert (tq.qmm_lane_plain(xm, wm) - want).abs().max() > 8 * limit, what


@pytest.mark.parametrize("n_tok", [1, 3, 1024])
def test_q4k_grouped_kernel_with_mins(cuda, n_tok):
    """The grouped form over a Q4_K expert stack (4 experts): within the
    limit of its plain version, zero past rows_used, and a dropped-mins
    stack seen 8x past the limit."""
    from booster_tpu_torch.ops import moe
    from booster_tpu_torch.testing import q4k_weight, qmm_mins_mutants

    E, K, Ne = 4, 1024, 256
    w = q4k_weight(E * Ne, K, seed=n_tok, device="cuda", kmajor=False)
    gen = torch.Generator(device="cuda").manual_seed(50 + n_tok)
    x = torch.randn(n_tok, K, device="cuda", generator=gen).to(torch.bfloat16)
    topi = torch.topk(torch.randn(n_tok, E, device="cuda", generator=gen), 2).indices
    xp, pos, te, used = moe.route_pad(x, topi.to(torch.int32), E)
    got = _replays_equal(lambda: moe.grouped_qmm(xp, w, te, E, used))
    want = moe.grouped_qmm_plain(xp, w, te, E, used)
    limit = 2e-4 * want.abs().max()
    assert (got - want).abs().max() <= limit
    assert not got[int(used[0]):].any()
    for what, (_, wm) in qmm_mins_mutants(xp, w).items():
        assert (moe.grouped_qmm_plain(xp, wm, te, E, used) - want).abs().max() > 8 * limit, what


# -- Q5_K and Q5_1 (llama.cpp's Q5_K_S mix): int8 codes with a mins plane ------


@pytest.mark.parametrize("m", [2, 16, 17, 64, 100, 2048])
def test_q5k_i8t_tile_with_mins(cuda, m):
    """csrc/i8k_tile.cuh's mins form (qmm_i8t.cu's dq_kernel) on real Q5_K
    planes (testing.q5k_weight) at the 1.3B qkv shape (2048 → 6144) and
    the fused gate-up at its ff (2048 → 2·5504), at the path's M (16, 64,
    2048) and ragged M: within 2e-4 of the largest output of the plain
    version, the mins dropped and taken with the wrong sign 8x past that,
    the gate-up equal to the matmul kernel + silu·mul bit for bit."""
    from booster_tpu_torch.testing import q5k_weight, qmm_mins_mutants

    gen = torch.Generator(device="cuda").manual_seed(60 + m)
    for n, gateup in ((6144, False), (2 * 5504, True)):
        w = q5k_weight(n, 2048, seed=m + n, device="cuda")
        assert tuple(w.scales.shape) == (2, 2048 // 32, n)
        x = torch.randn(m, 2048, device="cuda", generator=gen).to(torch.bfloat16)
        got, want = tq.qmm_i8t(x, w), tq.qmm_plain(x, w)
        limit = 2e-4 * want.abs().max()
        assert (got - want).abs().max() <= limit
        for what, (xm, wm) in qmm_mins_mutants(x, w).items():
            assert (tq.qmm_plain(xm, wm) - want).abs().max() > 8 * limit, what
        if gateup:
            gu = got.to(torch.bfloat16)
            assert torch.equal(tq.qmm_i8t_gateup(x, w), tq.silu(gu[:, :5504]) * gu[:, 5504:])


@pytest.mark.parametrize("m", [1, 16, 64, 100])
def test_q5k_mlp_with_mins_equals_unfused(cuda, m):
    """csrc/mlp_i8t.cu with mins planes on both weights (real Q5_K at
    Llama-3-8B's width, ff 14336): equal bit for bit to the gate-up (its
    dequant form) + silu·mul + the dequant matmul, within the MLP's limit of
    its plain version, its workspace zero after the launch; the down's mins
    dropped seen 8x past that limit."""
    from booster_tpu_torch.testing import q5k_weight

    gu = q5k_weight(2 * 14336, 4096, seed=70, device="cuda")
    dn = q5k_weight(4096, 14336, seed=71, device="cuda")
    assert tm.mlp_supported(gu, dn, 4096, m) == (m <= 64)
    gen = torch.Generator(device="cuda").manual_seed(72 + m)
    x = torch.randn(m, 4096, device="cuda", generator=gen).to(torch.bfloat16)
    got = tm.qmm_mlp_i8t(x, gu, dn)
    g = tq.qmm_i8t(x, gu, dq=True).to(torch.bfloat16)
    mid = tq.silu(g[:, :14336]) * g[:, 14336:]
    if m > 1:
        assert torch.equal(mid, tq.qmm_i8t_gateup(x, gu))
    assert torch.equal(got, tq.qmm_i8t(mid, dn, dq=True).to(torch.bfloat16))
    torch.cuda.synchronize()
    assert not int(tq._tickets[x.device].abs().sum())
    want = tm.qmm_mlp_plain(x, gu, dn)
    assert (got.float() - want.float()).abs().max() <= 2 ** -7 * want.float().abs().max()
    no_mins = dataclasses.replace(dn, scales=dn.scales[:1].contiguous())
    wrong = tm.qmm_mlp_plain(x, gu, no_mins).float()
    assert (wrong - want.float()).abs().max() > 8 * 2 ** -7 * want.float().abs().max()


@pytest.mark.parametrize("m", [1, 5, 16, 40, 600, 2048])
def test_q5_1_lane_kernel_with_mins(cuda, m):
    """The int8 lane-major form with mins (csrc/qmm_lane_i8.cu, the plan's
    form at each M) on real Q5_1 planes (negative m, so mins of -m) at the
    1.3B down (5504 → 2048, lane-major: (5504/32) % 8 = 4): within the
    limit of the plain version (each value bf16(q·s) less its bf16 min,
    rounded again), each wrong kernel of testing.qmm_lane_i8_mutants (the
    mins dropped, with the wrong sign and from the next group among them)
    8x past it, the same bits across graph replays."""
    from booster_tpu_torch.testing import q5_1_weight, qmm_lane_i8_mutants

    k, n = 5504, 2048
    w = q5_1_weight(n, k, seed=m, device="cuda")
    assert w.kind == "i8" and tuple(w.scales.shape) == (n, 2, k // 32)
    assert not tq.transposable(w) and tq.lane_supported(w)
    gen = torch.Generator(device="cuda").manual_seed(80 + m)
    x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
    kernels.reset_counts()
    got = _replays_equal(lambda: tq.qmm_lane(x, w))
    plan = tq.lane_i8_plan(m, k, n)
    assert kernels.launch_counts[tq.lane_i8_count_name(plan)] == 3
    want = tq.qmm_lane_plain(x, w)
    limit = 2e-4 * want.abs().max()
    assert (got - want).abs().max() <= limit
    seen = qmm_lane_i8_mutants(x, w, plan)
    assert {"mins dropped", "mins with the wrong sign",
            "each group's min from the next group"} <= set(seen)
    for what, (xm, wm) in seen.items():
        assert (tq.qmm_lane_plain(xm, wm) - want).abs().max() > 8 * limit, what


@pytest.mark.parametrize("n_tok", [1, 3, 1024])
def test_q5k_grouped_kernel_with_mins(cuda, n_tok):
    """The grouped form (pallas_moe.py's i8 branch with has_mins) over a
    Q5_K expert stack (4 experts): within the limit of its plain version,
    zero past rows_used, the mins mutants 8x past the limit."""
    from booster_tpu_torch.ops import moe
    from booster_tpu_torch.testing import q5k_weight, qmm_mins_mutants

    E, K, Ne = 4, 1024, 256
    w = q5k_weight(E * Ne, K, seed=n_tok, device="cuda", kmajor=False)
    gen = torch.Generator(device="cuda").manual_seed(90 + n_tok)
    x = torch.randn(n_tok, K, device="cuda", generator=gen).to(torch.bfloat16)
    topi = torch.topk(torch.randn(n_tok, E, device="cuda", generator=gen), 2).indices
    xp, pos, te, used = moe.route_pad(x, topi.to(torch.int32), E)
    got = _replays_equal(lambda: moe.grouped_qmm(xp, w, te, E, used))
    want = moe.grouped_qmm_plain(xp, w, te, E, used)
    limit = 2e-4 * want.abs().max()
    assert (got - want).abs().max() <= limit
    assert not got[int(used[0]):].any()
    for what, (_, wm) in qmm_mins_mutants(xp, w).items():
        assert (moe.grouped_qmm_plain(xp, wm, te, E, used) - want).abs().max() > 8 * limit, what


@pytest.mark.parametrize("qt", ["Q5_K", "Q5_1"])
def test_q5_repack_on_card_equals_host(cuda, qt):
    """The Q5_K and Q5_1 repacks on the card (the loader's path for expert
    stacks) bit-equal to the same torch repack on the host."""
    import numpy as np

    from booster_tpu_torch.quant.qtensor import repack_gguf_tensor
    from booster_tpu_torch.testing import random_blocks

    n, k = 512, 2048
    raw = np.frombuffer(random_blocks(np.random.default_rng(5), n * k, GGMLType[qt], 0.05),
                        np.uint8)
    host = repack_gguf_tensor(raw, GGMLType[qt], (n, k))
    card = repack_gguf_tensor(torch.from_numpy(raw.copy()), GGMLType[qt], (n, k), device="cuda")
    assert card.qw.is_cuda and (card.kind, card.group) == (host.kind, host.group) == ("i8", 32)
    for f in ("qw", "scales", "mins"):
        assert np.array_equal(getattr(card, f).cpu().numpy(), getattr(host, f)), f


def test_janus_shortlist_on_cuda_equals_cpu(cuda):
    """janus_shortlist on CUDA tensors against the same call on the CPU:
    the same shortlist, the shaped logits within 1e-5 relative: CUDA's powf
    (up to 4 ulps), log1pf and its FMA-contracted 1 - (1 - s)·0.2 differ
    from the CPU's in the last bits, and pow(factor, count) carries the
    factor's error count times."""
    import numpy as np

    from booster_tpu_torch.sampling import SamplingParams
    from booster_tpu_torch.sampling.janus import janus_shortlist

    rng = np.random.default_rng(0)
    B, V, N = 4, 32000, 256
    logits = (8.0 + 0.2 * rng.standard_normal((B, V))).astype(np.float32)
    logits[1] -= 30.0
    ring = rng.integers(0, 64, (B, N)).astype(np.int32)
    prev_pos = np.int32([40, 300, 90, 260])
    prompt_len = np.int32([40, 20, 10, 100])
    types_ = rng.choice(np.int32([0, 2, 3, 4, 20, 30, 40]), V)
    pedantic = rng.random(V) < 0.1
    scales = (1.0 - 0.03 * rng.choice(np.float32([0.1, 0.3, 1.0]), V)).astype(np.float32)
    args = [logits, ring, prev_pos, prompt_len]
    tabs = [scales, types_, pedantic]
    out = {}
    for dev in ("cpu", "cuda"):
        t = [torch.from_numpy(a).to(dev) for a in args]
        tb = [torch.from_numpy(a).to(dev) for a in tabs]
        out[dev] = janus_shortlist(*t, 128, *tb, 2, SamplingParams(janus=1)).cpu()
    a, b = out["cpu"], out["cuda"]
    assert torch.equal(torch.isfinite(a), torch.isfinite(b))
    keep = torch.isfinite(a)
    rel = ((a[keep] - b[keep]).abs() / a[keep].abs()).max()
    assert rel <= 1e-5, rel


# -- Gemma: the GELU gate-up and the 256-lane attention and appends ------------


@pytest.mark.parametrize("m", [1, 2, 16, 64, 130])
@pytest.mark.parametrize("mins", [False, True], ids=["R2", "R4"])
def test_gateup_gelu_equals_qmm_then_gelu_mul(cuda, m, mins):
    """The i4t gate-up with the GELU epilogue (group 32: the M = 1 matvec
    pair of i4mv.cuh, the tile above) equals the matmul kernel on the fused
    weight + gelu·mul bit for bit, holds the gate-up limit against its
    plain version (or gives an output of one-ulp roundings of g and u:
    testing.gateup_flips), and is not its SiLU form."""
    from booster_tpu_torch.testing import gateup_flips

    gen = torch.Generator(device="cuda").manual_seed(60 + m)
    w = _w(2, 2048, 2 * 512, gen, mins).at(1)
    x = torch.randn(m, 2048, device="cuda", generator=gen).to(torch.bfloat16)
    got = tq.qmm_i4t_gateup(x, w, "gelu")
    gu = tq.qmm_i4t(x, w).to(torch.bfloat16)
    assert torch.equal(got, tq.gelu(gu[:, :512]) * gu[:, 512:])
    want = tq.qmm_gateup_plain(x, w, act="gelu").float()
    d = (got.float() - want).abs()
    gp = tq.qmm_plain(x, w).to(torch.bfloat16)
    flips = gateup_flips(got, gp[:, :512], gp[:, 512:], "gelu")
    assert ((d <= 2 ** -7 * want.abs() + 1e-5 * want.abs().max()) | flips).all()
    assert not torch.equal(got, tq.qmm_i4t_gateup(x, w, "silu"))


@pytest.mark.parametrize("m", [1, 16, 64, 2048])
@pytest.mark.parametrize("group,mins", [(32, False), (32, True), (16, False)],
                         ids=["g32", "g32-mins", "g16"])
def test_i8t_gateup_gelu_equals_qmm_then_gelu_mul(cuda, m, group, mins):
    """The int8 gate-up with the GELU epilogue (qmm_i8t_gelu.cu: the M = 1
    matvec pair of i8mv.cuh, kGateUpGelu; the tile above, dq_kernel with act
    1)
    equals qmm_i8t of its form on the fused weight + gelu·mul bit for bit,
    holds the gate-up limit against its plain version per element (or gives
    one-ulp roundings of g and u: testing.gateup_flips), launches its own
    count, and its SiLU epilogue is 8x past that limit."""
    from booster_tpu_torch.testing import gateup_flips

    gen = torch.Generator(device="cuda").manual_seed(70 + m + group)
    ff = 512
    w = _w8(2, 1024, 2 * ff, gen, group, mins).at(1)
    x = torch.randn(m, 1024, device="cuda", generator=gen).to(torch.bfloat16)
    name = "qmm_i8t_gateup_gelu_" + ("gd" if m == 1 else "dq")
    before = kernels.launch_counts[name]
    got = tq.qmm_i8t_gateup(x, w, "gelu")
    assert kernels.launch_counts[name] == before + 1
    gu = tq.qmm_i8t(x, w).to(torch.bfloat16)
    assert torch.equal(got, tq.gelu(gu[:, :ff]) * gu[:, ff:])
    want = tq.qmm_gateup_plain(x, w, act="gelu").float()
    limit = (2 ** -7 if m == 1 else 2 ** -5) * want.abs() + 1e-5 * want.abs().max()
    gp = tq.qmm_plain(x, w).to(torch.bfloat16)
    flips = gateup_flips(got, gp[:, :ff], gp[:, ff:], "gelu")
    assert (((got.float() - want).abs() <= limit) | flips).all()
    silu = (tq.silu(gp[:, :ff]) * gp[:, ff:]).float()
    assert float(((silu - want).abs() / limit).max()) >= 8


def test_gateup_acts_not_ported_raise(cuda):
    """ReLU on any kind and GELU on i4t at group 16 raise "not ported yet"
    on the card: nothing falls back; GELU on int8 weights runs its kernel
    (equal to qmm_i8t + gelu·mul)."""
    gen = torch.Generator(device="cuda").manual_seed(66)
    x = torch.randn(1, 1024, device="cuda", generator=gen).to(torch.bfloat16)
    w = _w(1, 1024, 512, gen).at(0)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tq.qmm_i4t_gateup(x, w, "relu")
    w16 = dataclasses.replace(w.resolved(), group=16,
                              scales=torch.zeros(2, 32, 512, device="cuda", dtype=torch.bfloat16))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tq.qmm_i4t_gateup(x, w16, "gelu")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tq.qmm_i8t_gateup(x, _w8(1, 1024, 512, gen).at(0), "relu")
    w8 = _w8(1, 1024, 512, gen).at(0)
    before = kernels.launch_counts["qmm_i8t_gateup_gelu_gd"]
    got = tq.qmm_i8t_gateup(x, w8, "gelu")
    assert kernels.launch_counts["qmm_i8t_gateup_gelu_gd"] == before + 1
    gu = tq.qmm_i8t(x, w8).to(torch.bfloat16)
    assert torch.equal(got, tq.gelu(gu[:, :256]) * gu[:, 256:])


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("B,lens", [(1, [150]), (1, [500]), (3, [300, 1, 1023])])
def test_decode_attn_256_lanes(cuda, quantized, B, lens):
    """Decode attention over a 256-lane cache (Gemma: one kv head of 8 query
    heads, head dim 256) within its limit, and each wrong kernel of
    testing.decode_attn_mutants (lanes 128-255 dropped among them) 8x past
    it; the launch counts under the 256-lane form's name."""
    from booster_tpu_torch.testing import decode_attn_mutants

    args = decode_attn_case(2, B, 1, 8, 1024, 256, 256, lens, "cuda", seed=sum(lens),
                            quantized=quantized)
    kernels.reset_counts()
    got, want = da.decode_attn(*args), da.decode_attn_plain(*args)
    name = "decode_attn_i8_d256" if quantized else "decode_attn_d256"
    assert kernels.launch_counts[name] == 1
    limit = decode_attn_limit(args)
    assert ((got - want).abs() <= limit).all()
    mutants = decode_attn_mutants(args)
    assert "lanes 128-255 dropped" in mutants
    for what, margs in mutants.items():
        if what == "column past the end read" and max(lens) == 1023:
            continue
        seen = float(((da.decode_attn_plain(*margs) - want).abs() / limit).max())
        assert seen >= 8, (what, seen)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("B,Hkv,G,S,lens", [(64, 1, 8, 512, [150, 500] * 32),
                                            (1, 16, 1, 2048, [2000])],
                         ids=["gemma2b-batch", "gemma7b"])
def test_decode_attn_256_lanes_multi_stage(cuda, quantized, B, Hkv, G, S, lens):
    """Decode attention over a 256-lane cache where a slice spans several
    stages (few slices against lens: Gemma-2B's 64 slots take 2, Gemma-7B's
    16 kv heads 8): within its limit of the plain version and of the CPU
    mirror testing.decode_attn_split, whose warps take no column past their
    stage (at 64 bf16 columns a stage, warps 4-7 none)."""
    from booster_tpu_torch.testing import decode_attn_split

    nsplit = da.decode_splits(B, Hkv, S, quantized, 256)
    per = -(-max(lens) // nsplit)
    assert per > da.stage_cols(256, quantized)  # some slice spans several stages
    args = decode_attn_case(2, B, Hkv, G, S, 256, 256, lens, "cuda", seed=B + Hkv,
                            quantized=quantized)
    got, want = da.decode_attn(*args), da.decode_attn_plain(*args)
    limit = decode_attn_limit(args)
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= limit).all()
    assert ((got - decode_attn_split(args, nsplit)).abs() <= limit).all()


@pytest.mark.parametrize("G,T,pos", [(2, 16, 0), (2, 32, 200), (8, 32, 0), (8, 32, 200)])
def test_prefill_attn_256_lanes(cuda, G, T, pos):
    """Chunked-prefill attention over a 256-lane int8 cache at G = 2 and
    Gemma's G = 8 (64 query rows a block) within its limit, each wrong
    kernel 8x past it."""
    from booster_tpu_torch.testing import prefill_attn_mutants

    n_valid = [T, max(1, T // 3), 1]
    args = prefill_attn_case(3, 1, G, T, 512, 256, 256, [pos] * 3, n_valid, "cuda", seed=G + T)
    kernels.reset_counts()
    got, want = pa.prefill_attn(*args), pa.prefill_attn_plain(*args)
    assert kernels.launch_counts["prefill_attn_i8_d256"] == 1
    limit = prefill_attn_limit(args)
    assert ((got - want).abs() <= limit).all()
    mutants = prefill_attn_mutants(args)
    assert "lanes 128-255 dropped" in mutants
    for what, margs in mutants.items():
        seen = float(((pa.prefill_attn_plain(*margs) - want).abs() / limit).max())
        assert seen >= 8, (what, seen)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("L,B", [(18, 1), (3, 64)])
def test_kv_append_all_layers_256_lanes(cuda, quantized, L, B):
    """The all-layer append into a 256-lane cache (a warp a row: 8 values a
    lane at int8) equals its plain version bit for bit, payloads and
    scales, a zero row and offsets at 0 and S - 1 among them."""
    gen = torch.Generator(device="cuda").manual_seed(70 + B)
    S, D = 64, 256
    base = torch.randn(L, B, 1, S, D, device="cuda", generator=gen)
    if quantized:
        k, ks = _quantize_kv(base)
        cache = [k, k.clone(), ks, ks.clone()]
    else:
        cache = [base.to(torch.bfloat16), (-base).to(torch.bfloat16), None, None]
    out = [cache, [None if t is None else t.clone() for t in cache]]
    new = (torch.randn(2, L, B, 1, D, device="cuda", generator=gen) * 3).to(torch.bfloat16)
    new[0, 0, 0] = 0
    off = torch.randint(0, S, (B,), dtype=torch.int32, device="cuda", generator=gen)
    off[0] = S - 1
    kernels.reset_counts()
    ka.kv_append(out[0][0], out[0][1], new[0], new[1], off, out[0][2], out[0][3])
    assert kernels.launch_counts["kv_append_i8_d256" if quantized else "kv_append_d256"] == 1
    ka.kv_append_plain(out[1][0], out[1][1], new[0], new[1], off, out[1][2], out[1][3])
    for got, want in zip(*out):
        assert got is None or torch.equal(got, want)


def test_paged_forms_refuse_256_lanes(cuda):
    """The paged decode attention and append take 256 lanes (counted under
    their _d256 names, the attention equal to its plain version within its
    limit); a 384-lane pool raises "not ported yet"."""
    args = paged_attn_case(1, 2, 1, 8, 128, 2, 256, 256, [100, 50], "cuda", seed=3)
    kernels.reset_counts()
    got = pga.paged_attn(*args)
    assert kernels.launch_counts["paged_attn_d256"] == 1
    assert ((got - pga.paged_attn_plain(*args)).abs() <= paged_attn_limit(args)).all()
    wide = paged_attn_case(1, 2, 1, 8, 128, 2, 384, 384, [100, 50], "cuda", seed=3)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        pga.paged_attn(*wide)
    table = torch.tensor([[1], [2]], dtype=torch.int32, device="cuda")
    off = torch.zeros(2, dtype=torch.int32, device="cuda")
    for D in (256, 384):
        pool = torch.zeros(1, 3, 1, 128, D, device="cuda", dtype=torch.bfloat16)
        row = torch.ones(1, 2, 1, D, device="cuda", dtype=torch.bfloat16)
        if D == 256:
            ka.kv_append_all_layers_paged(pool, pool.clone(), row, row, off, table)
            assert kernels.launch_counts["kv_append_paged_d256"] == 1
            assert bool((pool[0, 1:, 0, 0] == 1).all())
            continue
        with pytest.raises(NotImplementedError, match="not ported yet"):
            ka.kv_append_all_layers_paged(pool, pool.clone(), row, row, off, table)


# -- Gemma's int8 MLP with GELU (groups 32 and 16) and its 256-lane paged pool ----


@pytest.mark.parametrize("m", [1, 2, 16, 64, 100, 2048])
@pytest.mark.parametrize("group,mins", [(32, False), (32, True), (16, False)],
                         ids=["g32", "g32-mins", "g16"])
def test_mlp_gelu_equals_unfused(cuda, m, group, mins):
    """csrc/mlp_i8t_gelu.cu (the GELU epilogue) at Gemma-2B's widths (K 2048,
    ff 16384, C 2048; at M = 2048 tiles of 256 rows): equal bit for bit to
    the dequant matmul on the fused weight + gelu·mul + the dequant matmul
    on mid, its mid equal to gelu·mul of the gate-up sums, within the MLP's
    limit of its plain version, its workspace zero after the launch, and
    counted under its form's name; SiLU is another result."""
    gen = torch.Generator(device="cuda").manual_seed(90 + m + group)
    K, ff = 2048, 16384
    gu = _w8(1, K, 2 * ff, gen, group=group, mins=mins).at(0)
    dn = _w8(1, ff, K, gen, group=group, mins=mins).at(0)
    assert tm.mlp_supported(gu, dn, K, m)
    x = torch.randn(m, K, device="cuda", generator=gen).to(torch.bfloat16)
    kernels.reset_counts()
    got, mid_k = tm._run(x, gu, dn, act="gelu")
    assert kernels.launch_counts[tm.mlp_count_name(group, "gelu")] == 1
    g = tq.qmm_i8t(x, gu, dq=True).to(torch.bfloat16)
    mid = tq.gelu(g[:, :ff]) * g[:, ff:]
    assert torch.equal(mid_k, mid)
    assert torch.equal(got, tq.qmm_i8t(mid, dn, dq=True).to(torch.bfloat16))
    torch.cuda.synchronize()
    assert not int(tq._tickets[x.device].abs().sum())
    want = tm.qmm_mlp_plain(x, gu, dn, "gelu")
    assert (got.float() - want.float()).abs().max() <= 2 ** -7 * want.float().abs().max()
    assert not torch.equal(got, tm.qmm_mlp_i8t(x, gu, dn, "silu"))


@pytest.mark.parametrize("m", [1, 64])
def test_mlp_silu_group_16_equals_unfused(cuda, m):
    """The whole MLP's SiLU form at group 16 (a uniform Q6_K llama, ff a
    multiple of 256) equals the gate-up + silu·mul + the dequant matmul."""
    gen = torch.Generator(device="cuda").manual_seed(95 + m)
    gu, dn = _w8(1, 2048, 2 * 1024, gen, group=16).at(0), _w8(1, 1024, 2048, gen, group=16).at(0)
    x = torch.randn(m, 2048, device="cuda", generator=gen).to(torch.bfloat16)
    kernels.reset_counts()
    got = tm.qmm_mlp_i8t(x, gu, dn)
    assert kernels.launch_counts["mlp_i8t_g16"] == 1
    g = tq.qmm_i8t(x, gu, dq=True).to(torch.bfloat16)
    mid = tq.silu(g[:, :1024]) * g[:, 1024:]
    assert torch.equal(got, tq.qmm_i8t(mid, dn, dq=True).to(torch.bfloat16))


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("with_self", [False, True], ids=["no-self", "self"])
def test_paged_attn_256_lanes(cuda, quantized, with_self):
    """The paged decode attention over a 256-lane pool at Gemma-2B's layout
    (one kv head of 8 query heads, pages of 256 rows scattered, 16 slots
    sharing two, lengths mid-page, on a boundary, of one row and of the
    whole table) within its limit, each wrong kernel of
    testing.paged_attn_mutants (lanes 128-255 dropped among them) 8x past
    it, counted under its _d256 name."""
    from booster_tpu_torch.testing import paged_attn_mutants

    lens = [600 + 53 * i for i in range(16)] + [1, 256, 512, 4096, 300, 255, 257, 1000]
    args = paged_attn_case(3, len(lens), 1, 8, 256, 16, 256, 256, lens, "cuda", seed=17,
                           quantized=quantized, shared=16)
    if not with_self:
        args = (*args[:10], torch.zeros_like(args[10]), *args[11:])
    kernels.reset_counts()
    got, want = pga.paged_attn(*args), pga.paged_attn_plain(*args)
    assert kernels.launch_counts["paged_attn_i8_d256" if quantized else "paged_attn_d256"] == 1
    limit = paged_attn_limit(args)
    assert torch.isfinite(got).all() and ((got - want).abs() <= limit).all()
    for what, margs in paged_attn_mutants(args).items():
        seen = float(((pga.paged_attn_plain(*margs) - want).abs() / limit).max())
        assert seen >= 8, (what, seen)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_kv_append_paged_256_lanes_is_exact(cuda, quantized):
    """The paged all-layer append into a 256-lane pool (18 layers, one kv
    head; int8 two passes of 4 values a lane) equals its plain version (the
    scatter) bit for bit off the scratch page 0: offsets on a page
    boundary, mid-page, on a page's last row and past the table."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    L, B, H, P, MAXP, D = 18, 8, 1, 256, 4, 256
    Np = B * MAXP + 1
    table = (1 + torch.randperm(Np - 1, generator=torch.Generator().manual_seed(1))).reshape(
        B, MAXP).to("cuda", torch.int32)
    new = (torch.randn(2, L, B, H, D, device="cuda", generator=gen) * 3).to(torch.bfloat16)
    new[0, 0, 0, 0] = 0  # a zero row
    off = torch.tensor([0, P, 137, P - 1, 2 * P + 5, 3 * P + 255, 600, MAXP * P + 3],
                       dtype=torch.int32, device="cuda")
    k = torch.randn(L, Np, H, P, D, device="cuda", generator=gen)
    if quantized:
        k, ks = _quantize_kv(k)
        pool = [k, k.clone(), ks, ks.clone()]
    else:
        pool = [k.to(torch.bfloat16), k.to(torch.bfloat16), None, None]
    plain = [None if t is None else t.clone() for t in pool]
    kernels.reset_counts()
    ka.kv_append_all_layers_paged(*pool[:2], new[0], new[1], off, table, *pool[2:])
    assert kernels.launch_counts["kv_append_paged_i8_d256" if quantized
                                 else "kv_append_paged_d256"] == 1
    from booster_tpu_torch.ops.paged_kv import paged_append_all_layers

    paged_append_all_layers(*plain[:2], new[0], new[1], off, table, *plain[2:])
    for got, want in zip(pool, plain):
        if got is not None:
            assert torch.equal(got[:, 1:], want[:, 1:])


def test_tied_head_on_the_card(cuda):
    """The tied head at Gemma's width: one product of the bf16 x and the bf16
    table with an f32 output, within f32 summation order of the CPU's f32
    product of the same operands, and no f32 copy of the table."""
    from booster_tpu_torch.models.llama import tied_head

    gen = torch.Generator(device="cuda").manual_seed(80)
    emb = (torch.randn(4096, 2048, device="cuda", generator=gen) * 0.05).to(torch.bfloat16)
    x = torch.randn(3, 1, 2048, device="cuda", generator=gen).to(torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    got = tied_head(x, emb)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (3, 1, 4096)
    assert torch.cuda.max_memory_allocated() - before < emb.numel() * 4 // 4
    want = tied_head(x.cpu(), emb.cpu())
    assert (got.cpu() - want).abs().max() <= 1e-5 * want.abs().max()


# -- the min term of the M > 1 tiles on the tensor cores ---------------------

# (form, path shape K, N) of the redesigned mins forms: the i4t tile at
# groups 32 (Q4_K: config 2's qkv) and 16 (Q2_K: the Llama-3-8B q), the
# int8 wgmma tile at group 32 (Q5_K: the 1.3B qkv)
MIN_FORMS = {"q4k": (4096, 6144), "q2k": (4096, 4096), "q5k": (2048, 6144)}


def _mins_weight(fmt, N, K, seed):
    from booster_tpu_torch.testing import q2k_weight, q4k_weight, q5k_weight

    return {"q4k": q4k_weight, "q2k": q2k_weight, "q5k": q5k_weight}[fmt](N, K, seed, "cuda")


def _mins_qmm(fmt, x, w):
    return tq.qmm_i8t(x, w) if fmt == "q5k" else tq.qmm_i4t(x, w)


@pytest.mark.parametrize("fmt", sorted(MIN_FORMS))
@pytest.mark.parametrize("m", [17, 100, 600, 2051])
def test_min_term_alone_within_bound_and_mutants_past_it(cuda, fmt, m):
    """Each redesigned mins form at its path shape, ragged M (the tiles'
    32-256 rows a block, K split over blocks where the plan splits it): on
    the weight whose every nibble or byte sits at its zero point the kernel
    computes the min term alone, -sum_g xs·f32(bf16 m), within 2^-16 of
    sum_g |xs_g·m_g| of the f64 product at every output; the wrong kernels
    (testing.qmm_min_term_mutants: the one-part split, the next group's
    mins, the min term dropped) each land past it by the factor asserted;
    the kernel on the weight itself within 2e-4 of the largest output of
    its plain version."""
    from booster_tpu_torch.testing import (min_term_reference, min_term_weight,
                                           qmm_min_term_mutants)

    K, N = MIN_FORMS[fmt]
    w = _mins_weight(fmt, N, K, seed=90 + m)
    gen = torch.Generator(device="cuda").manual_seed(90 + m)
    x = torch.randn(m, K, device="cuda", generator=gen).to(torch.bfloat16)
    ref, bound = min_term_reference(x, w)
    got = _mins_qmm(fmt, x, min_term_weight(w)).double()
    assert float(((got - ref).abs() / bound).max()) <= 1
    for what, out in qmm_min_term_mutants(x, w).items():
        assert float(((out.double() - ref).abs() / bound).max()) > 4, what
    want = tq.qmm_plain(x, w)
    assert (_mins_qmm(fmt, x, w) - want).abs().max() <= 2e-4 * want.abs().max()


@pytest.mark.parametrize("fmt", sorted(MIN_FORMS))
@pytest.mark.parametrize("m", [64, 130, 2048])
def test_mins_gateups_equal_matmul_then_act_mul(cuda, fmt, m):
    """The fused gate-ups of the redesigned mins forms (SiLU; GELU where it
    is built: the i4t tile at group 32, the int8 tile) equal the matmul on
    their fused weight + act·mul bit for bit: the min term's steps run the
    same code per column in both."""
    K = MIN_FORMS[fmt][0]
    ff = 1024
    w = _mins_weight(fmt, 2 * ff, K, seed=95 + m)
    gen = torch.Generator(device="cuda").manual_seed(95 + m)
    x = torch.randn(m, K, device="cuda", generator=gen).to(torch.bfloat16)
    gu = _mins_qmm(fmt, x, w).to(torch.bfloat16)
    fused = tq.qmm_i8t_gateup if fmt == "q5k" else tq.qmm_i4t_gateup
    assert torch.equal(fused(x, w), tq.silu(gu[:, :ff]) * gu[:, ff:])
    if fmt != "q2k":
        assert torch.equal(fused(x, w, "gelu"), tq.gelu(gu[:, :ff]) * gu[:, ff:])
