"""The attention kernels' arithmetic, mirrored in plain torch on the CPU,
against the plain versions within the kernels' limits.

csrc/decode_attn.cu splits each (slot, kv head)'s live range over blocks
(slices of whole 128-column stages, each rounding its PV weights against its
own running max, merged in f32 by the block that arrives last, the self
term added once), and both it and csrc/prefill_attn.cu split a block's
128-column stages over warps of 16-column sub-blocks, whose running max
moves once a stage and whose sums are added in f32.  The kernels run only
on the card; ``booster_tpu_torch.testing.decode_attn_split`` and
``prefill_attn_split`` compute what they compute, so these tests hold that
arithmetic to ``decode_attn_limit`` / ``prefill_attn_limit`` (unchanged) and
check that every wrong kernel of ``*_mutants`` still exceeds the limit 8x
against it."""

import pytest
import torch

from booster_tpu_torch.ops.decode_attention import decode_attn_plain, decode_splits
from booster_tpu_torch.ops.prefill_attention import prefill_attn_plain
from booster_tpu_torch.testing import (decode_attn_case, decode_attn_limit, decode_attn_mutants,
                                       decode_attn_split, prefill_attn_case, prefill_attn_limit,
                                       prefill_attn_mutants, prefill_attn_split)
from booster_tpu_torch.testing import torch_threads

S = 512
# 0 and 1 column, each side of the 128- and 256-column slice boundaries, the
# full cache
LENS = [0, 1, 127, 128, 129, 255, 256, 257, S]
FORMS = {"self": (S + 1, 0.0, True), "no self": (S + 1, 0.0, False),
         "window 64 softcap 30": (64, 30.0, True), "window 300": (300, 0.0, True)}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


def _decode_args(quantized, G, form):
    win, softcap, with_self = FORMS[form]
    args = list(decode_attn_case(2, len(LENS), 2, G, S, 128, 128, LENS, "cpu", seed=G,
                                 quantized=quantized))
    args[5], args[6] = win, softcap
    if not with_self:
        args[9] = torch.zeros_like(args[9])
    return tuple(args)


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("nsplit", [1, 2, 7, 16])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_decode_split_within_limit(quantized, G, nsplit, form):
    args = _decode_args(quantized, G, form)
    got, want = decode_attn_split(args, nsplit), decode_attn_plain(*args)
    live = (args[4] > 0) | (args[9] > 0)  # a slot with neither attends to nothing
    assert ((got - want).abs() <= decode_attn_limit(args))[live].all()
    assert torch.all(got[~live] == 0)  # and the kernel writes 0 there


@pytest.mark.parametrize("nsplit", [1, 2, 7, 16])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_decode_mutants_exceed_limit_against_split(quantized, G, nsplit):
    args = _decode_args(quantized, G, "self")
    got, limit = decode_attn_split(args, nsplit), decode_attn_limit(args)
    for what, margs in decode_attn_mutants(args).items():
        assert float(((decode_attn_plain(*margs) - got).abs() / limit).max()) >= 8, what


def test_decode_split_slices_the_live_range():
    """The slices the mirror (and the kernel) take: whole 128-column stages
    of the live range, so a short range takes fewer slices than nsplit."""
    q, kc, vc, layer, lens, win, softcap, sk, sv, ok = _decode_args(False, 4, "self")
    one = decode_attn_split((q, kc, vc, layer, lens, win, softcap, sk, sv, ok), 1)
    # at 16 slices a range of 129 columns takes two (128 + 1), 512 four
    many = decode_attn_split((q, kc, vc, layer, lens, win, softcap, sk, sv, ok), 16)
    assert torch.equal(one[:4], many[:4])  # ranges of one stage: the same arithmetic
    assert not torch.equal(one[4], many[4])  # 129 columns: two slices merged


@pytest.mark.parametrize("B,Hkv,S_,quantized,want", [
    (1, 4, 1024, False, 8), (1, 8, 1024, False, 8), (1, 16, 1024, False, 8),
    (1, 8, 8192, False, 16), (1, 8, 8192, True, 33), (64, 4, 512, True, 1),
    (64, 8, 512, True, 1), (64, 16, 512, True, 1), (64, 8, 4096, True, 1),
    (64, 8, 4096, False, 1), (2, 4, 64, True, 1), (1, 1, 1 << 16, True, 128)])
def test_decode_splits_from_the_shapes(B, Hkv, S_, quantized, want):
    """As many blocks as the card holds at once at B = 1 (two an SM over an
    int8 cache, one over bf16), one slice at B = 64 (the batch and paged
    forms keep their grid), at most one per stage of the capacity."""
    assert decode_splits(B, Hkv, S_, quantized) == want


PREFILL = {"causal": (None, 0.0), "window 64 softcap 30": (64, 30.0)}


def _prefill_args(G, T, form):
    win, softcap = PREFILL[form]
    args = list(prefill_attn_case(4, 2, G, T, S, 128, 128, [0, 200, 37, 300], [T, 7, 1, T],
                                  "cpu", seed=G + T))
    if win is not None:
        args[7], args[8] = win, softcap
    return tuple(args)


@pytest.mark.parametrize("form", list(PREFILL))
@pytest.mark.parametrize("G,T", [(1, 16), (1, 32), (1, 20), (4, 32), (8, 32), (8, 16),
                                 (8, 20)])
def test_prefill_split_within_limit(G, T, form):
    """Warps splitting the stages' sub-blocks (8 on 1 m16 tile at G·T = 16,
    4 a tile at 32, 1 a tile at 128) and a last tile shorter than TQ (T 20
    at G 8: TQ 16)."""
    args = _prefill_args(G, T, form)
    got, want = prefill_attn_split(args), prefill_attn_plain(*args)
    assert ((got - want).abs() <= prefill_attn_limit(args)).all()


@pytest.mark.parametrize("G,T", [(1, 16), (1, 32), (4, 32), (8, 32)])
def test_prefill_mutants_exceed_limit_against_split(G, T):
    args = _prefill_args(G, T, "causal")
    got, limit = prefill_attn_split(args), prefill_attn_limit(args)
    for what, margs in prefill_attn_mutants(args).items():
        assert float(((prefill_attn_plain(*margs) - got).abs() / limit).max()) >= 8, what
