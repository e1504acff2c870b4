"""The whole gated MLP in one kernel, for K-major int8 weights (i8t).

Counterpart of ``qmm_mlp`` in ``booster_tpu/ops/pallas_qmm.py``:
``(silu(x @ Wg^T) * (x @ Wu^T)) @ Wd^T`` from the fused [2ff, K] gate-up
QTensor and the [C, ff] down QTensor, returned as bf16 [.., C].
``qmm_mlp_i8t`` runs the kernel of ``csrc/mlp_i8t.cu`` on CUDA tensors and
``qmm_mlp_plain`` on CPU tensors: the unfused sequence (the dequantize
forms of the gate-up and of the down matmul, at M = 1 too) rounded to
bf16, which the kernel equals bit for bit.

Which M takes the kernel is the reference's rule: ``mlp_fits`` is a copy of
``_pick_bf_mlp``'s arithmetic (``pallas_qmm.py:1281``), the reference's
dispatch between the whole-MLP kernel and gate-up + down, so the port runs
the same kernels at the same M (the 7B shape: the MLP kernel up to M = 64
and at M = 1; gate-up + down at the batch prefill's M = 2048).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from booster_tpu_torch.ops import kernels
from booster_tpu_torch.ops.qmm import (
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
    "bt_mlp_i8t": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "bt_mlp_i8t_ws_ints": [ctypes.c_int] * 4,
}


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


def qmm_mlp_plain(x: torch.Tensor, w_gu: QTensor, w_down: QTensor) -> torch.Tensor:
    """x [M, K] → [M, C] bf16 in plain torch: the dequantize-form gate-up
    (silu·mul in bf16), then the dequantize-form down matmul, rounded."""
    mid = qmm_gateup_plain(x, w_gu, dq=True)
    return qmm_plain(mid, w_down, dq=True).to(torch.bfloat16)


def _launch(x: torch.Tensor, w_gu: QTensor, w_down: QTensor) -> torch.Tensor:
    w_gu, w_down = w_gu.resolved(), w_down.resolved()
    M, K = x.shape
    ff = w_gu.shape[0] // 2
    C = w_down.shape[0]
    # Q8_0's group only: a uniform Q6_K file (group 16) of a model whose ff
    # is a multiple of 256 would take the reference's MLP kernel at group 16
    sgu = check_i8t(x, w_gu, "mlp_i8t", groups=(32,))
    mid = torch.empty(M, ff, device=x.device, dtype=torch.bfloat16)
    sd = check_i8t(mid, w_down, "mlp_i8t", groups=(32,))
    if ff % 128:
        raise NotImplementedError(f"mlp_i8t kernel: ff = {ff}: not ported yet (a multiple of 128)")
    # the unfused kernels' plans: one tile (a function of M), each product's splits
    (bm, ks1), (_, ks2) = i8k_plan(M, K, 2 * ff), i8k_plan(M, ff, C)
    dev = x.device
    f32 = torch.float32
    part1 = torch.empty(ks1 * M * 2 * ff, dtype=f32, device=dev) if ks1 > 1 else None
    part2 = torch.empty(ks2 * M * C, dtype=f32, device=dev) if ks2 > 1 else None
    out = torch.empty(M, C, device=dev, dtype=torch.bfloat16)
    lib = kernels.library("mlp_i8t", _SIGNATURES)
    ws = _ticket_buffer(dev, lib.bt_mlp_i8t_ws_ints(M, ff, C, bm))
    rc = lib.bt_mlp_i8t(x.data_ptr(), w_gu.qw.data_ptr(), sgu.data_ptr(), w_down.qw.data_ptr(),
                        sd.data_ptr(), None if part1 is None else part1.data_ptr(),
                        mid.data_ptr(), None if part2 is None else part2.data_ptr(),
                        out.data_ptr(), ws.data_ptr(), M, K, ff, C, ks1, ks2, bm,
                        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(rc, "mlp_i8t")
    kernels.count("mlp_i8t", (K, C))
    return out


def qmm_mlp_i8t(x: torch.Tensor, w_gu: QTensor, w_down: QTensor) -> torch.Tensor:
    """Kernel-level entry: x [M, K] bf16 → [M, C] bf16 (the plain version
    for CPU tensors, the kernel for CUDA tensors)."""
    if x.device.type == "cpu":
        return qmm_mlp_plain(x, w_gu, w_down)
    return _launch(x, w_gu, w_down)


def qmm_mlp(x: torch.Tensor, w_gu: QTensor, w_down: QTensor) -> Optional[torch.Tensor]:
    """The whole gated MLP → [..., C] bf16, or None when the kinds or shapes
    are not taken (the caller then runs gate-up + down)."""
    K = x.shape[-1]
    M = _rows(x)
    if not mlp_supported(w_gu, w_down, K, M):
        return None
    y = qmm_mlp_i8t(x.reshape(M, K).to(torch.bfloat16).contiguous(), w_gu, w_down)
    return y.reshape(*x.shape[:-1], w_down.shape[0])
