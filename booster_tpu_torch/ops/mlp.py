"""The whole gated MLP in one kernel, for K-major int8 weights (i8t).

Counterpart of ``qmm_mlp`` in ``booster_tpu/ops/pallas_qmm.py``:
``(act(x @ Wg^T) * (x @ Wu^T)) @ Wd^T`` from the fused [2ff, K] gate-up
QTensor and the [C, ff] down QTensor, returned as bf16 [.., C], with act
SiLU or the tanh-GELU of gated-GELU models (Gemma; ``ops.qmm.act_mul``),
at group 32 (Q8_0, Q5_K, and 4-bit weights widened by ``weights="i8"``) or
16 (Q6_K); with mins planes on both weights (Q5_K: ``has_mins`` and
``d_has_mins``; group 32) each product subtracts its min term, the f32
group sums of its bf16 input times f32(bf16 m).
``qmm_mlp_i8t`` runs the kernel of ``csrc/mlp_i8t.cuh`` (a library an act:
``mlp_i8t.cu``, ``mlp_i8t_gelu.cu``) on CUDA tensors and
``qmm_mlp_plain`` on CPU tensors: the unfused sequence (the dequantize
form of the matmul on the fused gate-up weight, act·mul in bf16, the
dequantize form of the down matmul) rounded to bf16, which the kernel
equals bit for bit.  The kernel's blocks take the
items of ``mlp_plan`` (the unfused kernels' tiles and splits) by their ids
in order, the order ``mlp_schedule`` spells out for the tests.

Which M takes the kernel is the reference's rule: ``mlp_fits`` is a copy of
``_pick_bf_mlp``'s arithmetic (``pallas_qmm.py:1281``), the reference's
dispatch between the whole-MLP kernel and gate-up + down, so the port runs
the same kernels at the same M (the 7B shape: the MLP kernel up to M = 64
and at M = 1; gate-up + down at the batch prefill's M = 2048; Gemma-2B's
widths, at groups 32 and 16: the MLP kernel at every M up to 4096).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from booster_tpu_torch.ops import kernels
from booster_tpu_torch.ops.qmm import (
    ACT_IDS,
    _SUB,
    _VMEM_LIMIT,
    _rows,
    _stack_ok,
    _ticket_buffer,
    check_i8t,
    i8k_plan,
    qmm_gateup_plain,
    qmm_plain,
)
from booster_tpu_torch.quant.qtensor import QTensor, kernel_scales

_SIGNATURES = {
    "bt_mlp_i8t": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 13 + [ctypes.c_void_p],
    "bt_mlp_i8t_ws_ints": [ctypes.c_int] * 4,
}
_MAX_SPLITS = 8  # ready counts an M tile (i8k::kMaxSplits)


def mlp_plan(M: int, K: int, ff: int, C: int, G: int = 32) -> dict:
    """The whole MLP's items at M rows of weights at group G: the tile rows
    ``bm`` and the splits ``ks1`` (gate-up, over K) and ``ks2`` (down, over
    ff) of the unfused kernels (``i8k_plan``), the M tiles, the gate/up
    column pairs of 64 (``nF``), the down's column tiles of 128 (``nC``),
    and the item counts: ``nA`` gate-up items (pair, split, M tile), ``nD``
    down items (split, column tile, M tile)."""
    (bm, ks1), (_, ks2) = i8k_plan(M, K, 2 * ff), i8k_plan(M, ff, C)
    mtiles, nF, nC = -(-M // bm), ff // 64, C // 128
    return {"M": M, "K": K, "ff": ff, "C": C, "G": G, "bm": bm, "ks1": ks1, "ks2": ks2,
            "mtiles": mtiles, "nF": nF, "nC": nC, "nA": mtiles * nF * ks1,
            "nD": mtiles * nC * ks2}


def mlp_ws_ints(M: int, ff: int, C: int, bm: int) -> int:
    """Ints of csrc/mlp_i8t.cuh's zeroed workspace (bt_mlp_i8t_ws_ints):
    counter, exits, then per M tile 8 ready counts (one a down split), a
    ticket per gate/up pair and a ticket per down column tile."""
    return 2 + -(-M // bm) * (_MAX_SPLITS + ff // 64 + C // 128)


def gateup_id(plan: dict, fj: int, s: int, mt: int) -> int:
    """Item id of pair fj's split s at M tile mt (csrc/mlp_i8t.cuh's decoding)."""
    return (fj * plan["ks1"] + s) * plan["mtiles"] + mt


def down_id(plan: dict, s: int, j: int, mt: int) -> int:
    """Item id of the down's split s of column tile j at M tile mt."""
    return plan["nA"] + (s * plan["nC"] + j) * plan["mtiles"] + mt


def split_of_pair(plan: dict, fj: int) -> int:
    """The down split whose stages [s·nF/ks2, (s+1)·nF/ks2) of 64 mid
    columns hold pair fj (csrc/mlp_i8t.cuh's ready count)."""
    return ((fj + 1) * plan["ks2"] - 1) // plan["nF"]


def pairs_of_split(plan: dict, s: int) -> range:
    nF, ks2 = plan["nF"], plan["ks2"]
    return range(s * nF // ks2, (s + 1) * nF // ks2)


def item_bytes(plan: dict, item: int) -> int:
    """Payload and scale bytes that an item streams (x and mid come from L2):
    128 payload columns a row of K, and a bf16 scale row of them a group."""
    if item < plan["nA"]:
        rows = plan["K"] // plan["ks1"]
    else:
        rows = plan["ff"] // plan["ks2"]
    return rows * 128 + rows // plan["G"] * 256


def mlp_schedule(plan: dict) -> list:
    """The order in which the kernel's blocks take the items, whatever their
    count: every gate-up item (pair-major, then split, then M tile), then
    the down items split by split, so that each down item comes after every
    gate-up item of the pairs it reads.  The ids are numbered in that order
    (``gateup_id``, ``down_id``), so the list is the ids in order, which is
    how the kernel hands them out; it is the model the tests hold the
    kernel's decoding to."""
    mt, nF, ks1, nC, ks2 = plan["mtiles"], plan["nF"], plan["ks1"], plan["nC"], plan["ks2"]
    gu = [gateup_id(plan, fj, s, m) for fj in range(nF) for s in range(ks1) for m in range(mt)]
    dn = [down_id(plan, s, j, m) for s in range(ks2) for j in range(nC) for m in range(mt)]
    return gu + dn


def mlp_fits(ff: int, kk: int, c: int, m: int, rows: int, d_rows: int, group: int,
             s_item: int) -> bool:
    """Whether the reference's whole-MLP kernel takes M = m: its ff tile
    picker ``_pick_bf_mlp`` (pallas_qmm.py:1281, the reference's dispatch
    rule between qmm_mlp and gate-up + down) finds a tile under its VMEM
    model.  The arithmetic is copied; the CUDA kernel's tiles are its own."""
    bm = m if m <= 256 else 256
    for bf in (512, 256):
        if ff % bf or bf % group:
            continue
        s_sub = 8 if s_item == 4 else 16
        pair = (bf // group) % s_sub != 0
        if pair and ((bf // group) * 2 % s_sub or (ff // bf) % 2):
            continue
        sub = min(_SUB, kk)
        sub2 = min(_SUB, bf)
        cc = min(512, c)
        blocks = 2 * (2 * bm * kk + 2 * kk * bf + bf * c
                      + 2 * rows * (kk // group) * s_item * bf
                      + d_rows * (bf // group) * (2 if pair else 1) * s_item * c
                      + 2 * bm * c)
        acc = 4 * bm * c + 2 * 4 * bm * bf
        temps = 2 * 9 * sub * bf + 2 * 9 * sub2 * cc
        if blocks + acc + temps <= _VMEM_LIMIT:
            return True
    return False


def mlp_supported(w_gu: QTensor, w_down: QTensor, K: int, M: int) -> bool:
    """The reference's gate of qmm_mlp (pallas_qmm.py:1319-1356)."""
    if w_gu.kind != "i8t" or w_down.kind != "i8t":
        return False
    if w_gu.scales is None or w_down.scales is None:
        return False
    if (w_gu.layer is None) != (w_down.layer is None):
        return False
    if not (_stack_ok(w_gu) and _stack_ok(w_down)):
        return False
    N2, Kg = w_gu.shape
    C, ffd = w_down.shape
    if N2 % 2 or Kg != K:
        return False
    ff = N2 // 2
    G = w_gu.group
    if ffd != ff or w_down.group != G:
        return False
    sgu, _ = kernel_scales(w_gu)
    sd, _ = kernel_scales(w_down)
    s_item = sgu.element_size()
    if sd.element_size() != s_item:
        return False
    s_sub = 8 if s_item == 4 else 16
    if K % 32 or (K // G) % s_sub or ff % 128 or C % 128 or K % (2 * G):
        return False
    return mlp_fits(ff, K, C, M, sgu.shape[-3], sd.shape[-3], G, s_item)


def mlp_count_name(G: int, act: str) -> str:
    """The launch count of a whole-MLP kernel form: mlp_i8t, then _g16 at
    group 16 and _gelu with the GELU epilogue (the group-32 SiLU forms,
    with or without mins, keep the one name)."""
    return "mlp_i8t" + ("_g16" if G == 16 else "") + ("_gelu" if act == "gelu" else "")


def qmm_mlp_plain(x: torch.Tensor, w_gu: QTensor, w_down: QTensor,
                  act: str = "silu") -> torch.Tensor:
    """x [M, K] → [M, C] bf16 in plain torch: the dequantize-form gate-up
    (act·mul in bf16), then the dequantize-form down matmul, rounded."""
    mid = qmm_gateup_plain(x, w_gu, dq=True, act=act)
    return qmm_plain(mid, w_down, dq=True).to(torch.bfloat16)


def _run(x: torch.Tensor, w_gu: QTensor, w_down: QTensor, first: int = 0,
         n: Optional[int] = None, workers: int = 0,
         mid: Optional[torch.Tensor] = None, act: str = "silu") -> tuple:
    """One launch of the kernel → (out, mid).  By default the whole MLP, its
    item ids [0, nA + nD) on the library's grid (two blocks an SM); the
    range [`first`, `first` + `n`), `workers` blocks and a `mid` computed
    before run parts of it (the schedule's ablations, ``tools/mlp_sched.py``:
    the gate-up items [0, nA), the down items [nA, nA + nD) without waits)."""
    w_gu, w_down = w_gu.resolved(), w_down.resolved()
    M, K = x.shape
    ff = w_gu.shape[0] // 2
    C = w_down.shape[0]
    G = w_gu.group
    if act not in ACT_IDS:
        raise NotImplementedError(f"mlp_i8t kernel with act {act!r}: not ported yet "
                                  f"({tuple(ACT_IDS)} are)")
    # groups 32 (Q8_0, Q5_K, widened 4-bit weights) and 16 (Q6_K); mins at 32
    sgu = check_i8t(x, w_gu, "mlp_i8t")
    if mid is None:
        mid = torch.empty(M, ff, device=x.device, dtype=torch.bfloat16)
    sd = check_i8t(mid, w_down, "mlp_i8t")
    if w_down.group != G:
        raise ValueError(f"mlp_i8t kernel: gate-up group {G}, down group {w_down.group}")
    if ff % 128:
        raise NotImplementedError(f"mlp_i8t kernel: ff = {ff}: not ported yet (a multiple of 128)")
    mins = sgu.shape[0] == 2
    if (sd.shape[0] == 2) != mins:
        raise NotImplementedError("mlp_i8t kernel: mins on one of its weights only: not ported "
                                  "yet (Q5_K_S gives both, Q8_0 neither)")
    # the unfused kernels' plans: one tile (a function of M), each product's splits
    plan = mlp_plan(M, K, ff, C, G)
    bm, ks1, ks2 = plan["bm"], plan["ks1"], plan["ks2"]
    if n is None:
        n = plan["nA"] + plan["nD"] - first
    dev = x.device
    f32 = torch.float32
    part1 = torch.empty(ks1 * M * 2 * ff, dtype=f32, device=dev) if ks1 > 1 else None
    part2 = torch.empty(ks2 * M * C, dtype=f32, device=dev) if ks2 > 1 else None
    out = torch.empty(M, C, device=dev, dtype=torch.bfloat16)
    # one library an epilogue (csrc/mlp_i8t.cu, mlp_i8t_gelu.cu: built at once)
    lib = kernels.library("mlp_i8t_gelu" if act == "gelu" else "mlp_i8t", _SIGNATURES)
    ws = _ticket_buffer(dev, lib.bt_mlp_i8t_ws_ints(M, ff, C, bm))
    rc = lib.bt_mlp_i8t(x.data_ptr(), w_gu.qw.data_ptr(), sgu.data_ptr(), w_down.qw.data_ptr(),
                        sd.data_ptr(), None if part1 is None else part1.data_ptr(),
                        mid.data_ptr(), None if part2 is None else part2.data_ptr(),
                        out.data_ptr(), ws.data_ptr(), M, K, ff, C, ks1, ks2, bm,
                        first, n, workers, int(mins), G, ACT_IDS[act],
                        torch.cuda.current_stream(dev).cuda_stream)
    name = mlp_count_name(G, act)
    kernels.check(rc, name)
    kernels.count(name, (K, C))
    return out, mid


def _launch(x: torch.Tensor, w_gu: QTensor, w_down: QTensor, act: str = "silu") -> torch.Tensor:
    return _run(x, w_gu, w_down, act=act)[0]


def qmm_mlp_i8t(x: torch.Tensor, w_gu: QTensor, w_down: QTensor,
                act: str = "silu") -> torch.Tensor:
    """Kernel-level entry: x [M, K] bf16 → [M, C] bf16 with act "silu" or
    "gelu" (the plain version for CPU tensors, the kernel for CUDA
    tensors)."""
    if x.device.type == "cpu":
        return qmm_mlp_plain(x, w_gu, w_down, act)
    return _launch(x, w_gu, w_down, act)


def qmm_mlp(x: torch.Tensor, w_gu: QTensor, w_down: QTensor,
            act: str = "silu") -> Optional[torch.Tensor]:
    """The whole gated MLP → [..., C] bf16, or None when the kinds or shapes
    are not taken (the caller then runs gate-up + down).  SiLU and GELU:
    where the reference would take its kernel with another act (ReLU), this
    raises."""
    K = x.shape[-1]
    M = _rows(x)
    if not mlp_supported(w_gu, w_down, K, M):
        return None
    if act not in ACT_IDS:
        raise NotImplementedError(f"the whole MLP with act {act!r}: not ported yet")
    y = qmm_mlp_i8t(x.reshape(M, K).to(torch.bfloat16).contiguous(), w_gu, w_down, act)
    return y.reshape(*x.shape[:-1], w_down.shape[0])
