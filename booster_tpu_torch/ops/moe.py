"""Routed experts (MoE): sort-based grouped dispatch over quantized expert
stacks.

Port of ``booster_tpu/ops/pallas_moe.py``.  Tokens are sorted by their
routed expert and group-padded so that every 32-row tile belongs to one
expert (``route_pad``); ``grouped_qmm`` then multiplies each tile by its
expert's rows of the stacked lane-major [E·Ne, K] weight, in the kernel of
``csrc/qmm_lane.cu`` (the port of the reference's two pallas_calls, with
the tile table and the count of real rows read on the card) or, for CPU
tensors, its plain version.  The expert weights stream at 4 or 8 bits and
are never expanded to a bf16 stack.

Nothing here reads a value back to the host: route_pad counts with
``index_add_`` and its padded size is static, so a decode step dispatches
without waiting for the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from booster_tpu_torch.ops.linear import qlinear
from booster_tpu_torch.ops.qmm import lane_dequant, lane_launch, silu
from booster_tpu_torch.quant.qtensor import QTensor, dequantize

BM = 32  # rows per tile: the group padding (the reference's BT_MOE_BM default)


def route_pad(x: torch.Tensor, top_idx: torch.Tensor, E: int):
    """Sort the expanded (token, choice) rows by expert and scatter them into
    a group-padded buffer where each BM-row tile belongs to one expert.

    Returns (xp [Mp, C], pos [N·k] int32 row positions, tile_expert [Mp/BM]
    int32, rows_used [1] int32): Mp = ⌈(N·k + E·BM)/BM⌉·BM is the static
    worst case; rows_used is the padded groups' total (start[E]), past which
    every row is zero; tiles past it name expert E - 1, as in the
    reference."""
    N, k = top_idx.shape
    Nk = N * k
    Mp = (Nk + E * BM + BM - 1) // BM * BM
    dev = x.device
    i32 = torch.int32
    flat_e = top_idx.reshape(-1).long()
    order = torch.sort(flat_e, stable=True).indices  # [Nk] sorted row → expanded row
    se = flat_e[order]
    counts = torch.zeros(E, dtype=i32, device=dev).index_add_(
        0, flat_e, torch.ones(Nk, dtype=i32, device=dev))
    padded = (counts + BM - 1) // BM * BM
    zero = torch.zeros(1, dtype=i32, device=dev)
    start = torch.cat([zero, torch.cumsum(padded, 0, dtype=i32)])
    excl = torch.cat([zero, torch.cumsum(counts, 0, dtype=i32)])[:-1]
    rank = torch.arange(Nk, dtype=i32, device=dev) - excl[se]
    pos_sorted = start[se] + rank  # position of sorted row s in the padded buffer
    xp = torch.zeros(Mp, x.shape[1], dtype=x.dtype, device=dev)
    xp[pos_sorted.long()] = x[order // k]
    pos = torch.empty(Nk, dtype=i32, device=dev).scatter_(0, order, pos_sorted)
    tile0 = torch.arange(Mp // BM, dtype=i32, device=dev) * BM
    tile_expert = torch.searchsorted(start[1:].contiguous(), tile0, right=True,
                                     out_int32=True).clamp_(0, E - 1)
    return xp, pos, tile_expert, start[E:]


def grouped_qmm_plain(xp: torch.Tensor, w: QTensor, tile_expert: torch.Tensor, E: int,
                      rows_used: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The grouped kernel's function in plain torch: per run of tiles of one
    expert, that expert dequantized once (``ops.qmm.lane_dequant``, the
    kernel's rounding) and its rows multiplied in f32; rows past
    `rows_used` are zero (all tiles when it is None)."""
    Mp, K = xp.shape
    Ne = w.shape[0] // E
    out = torch.zeros(Mp, Ne, dtype=torch.float32, device=xp.device)
    te = tile_expert.tolist()
    n_tiles = len(te) if rows_used is None else min(len(te), int(rows_used[0]) // BM)
    xb = xp.to(torch.bfloat16).float()
    t = 0
    while t < n_tiles:
        e, t1 = te[t], t + 1
        while t1 < n_tiles and te[t1] == e:
            t1 += 1
        rows = slice(t * BM, t1 * BM)
        out[rows] = xb[rows] @ lane_dequant(w, e * Ne, (e + 1) * Ne).t()
        t = t1
    return out


def grouped_qmm(xp: torch.Tensor, w: QTensor, tile_expert: torch.Tensor, E: int,
                rows_used: Optional[torch.Tensor] = None) -> torch.Tensor:
    """xp [Mp, K] @ W[e(row)]^T → [Mp, Ne] f32; each BM-row tile uses its
    expert's rows of the stacked [E·Ne, K] weight (layer view allowed).
    i4p and i8 stacks take the kernel on the card (the plain version for
    CPU tensors); other kinds the reference's per-tile gather of dequantized
    bf16 rows (pallas_moe.py:156-168)."""
    Mp, K = xp.shape
    Ne = w.shape[0] // E
    if w.kind in ("i4p", "i8"):
        if xp.device.type == "cpu":
            return grouped_qmm_plain(xp, w, tile_expert, E, rows_used)
        return lane_launch(xp.to(torch.bfloat16).contiguous(), w, Ne, f"moe_qmm_{w.kind}",
                           tile_expert, rows_used)
    wd = dequantize(w, torch.bfloat16).reshape(E, Ne, K)
    wt = wd[tile_expert.long()].float()  # [Mp/BM, Ne, K]
    x3 = xp.to(torch.bfloat16).float().reshape(-1, BM, K)
    return torch.bmm(x3, wt.transpose(1, 2)).reshape(Mp, Ne)


def moe_supported(lp: dict) -> bool:
    return all(isinstance(lp.get(n), QTensor) and lp[n].kind in ("i4p", "i8", "dense")
               for n in ("gate_exps", "up_exps", "down_exps"))


def moe_ffn_grouped(x: torch.Tensor, lp: dict, cfg) -> torch.Tensor:
    """Routed MoE FFN (softmax over all experts, top-k, renormalized over the
    selected; ``models.llama.moe_route``) with the sort-based grouped
    dispatch: three grouped matmuls, silu(g)·u in bf16 between them, and the
    combine sum_k y[pos]·topv in f32, rounded to x's dtype."""
    from booster_tpu_torch.models.llama import moe_route

    E, k = cfg.n_experts, cfg.n_experts_used
    B, T, C = x.shape
    N = B * T
    xf = x.reshape(N, C)
    topv, topi = moe_route(qlinear(xf, lp["router"]), cfg)  # [N, k]
    xp, pos, tile_expert, used = route_pad(xf, topi, E)
    g = grouped_qmm(xp, lp["gate_exps"], tile_expert, E, used)
    u = grouped_qmm(xp, lp["up_exps"], tile_expert, E, used)
    h = silu(g.to(torch.bfloat16)) * u.to(torch.bfloat16)
    y = grouped_qmm(h, lp["down_exps"], tile_expert, E, used)  # [Mp, C]
    rows = y[pos.long()].reshape(N, k, C)  # back to (token, choice) order
    out = (rows * topv[..., None]).sum(1)
    return out.reshape(B, T, C).to(x.dtype)
