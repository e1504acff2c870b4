"""Quantized matmul for K-major (i4t, i8t) and lane-major (i4p, i8) weights,
and fused gate+up.

Counterpart of ``booster_tpu/ops/pallas_qmm.py``.
``qmm`` runs, for i4t (Q4_0 and Q4_K at group 32, Q2_K and Q3_K at group
16), the kernel of ``csrc/qmm_i4t.cu`` (the port of
``_tqmm_i4_gd_kernel`` at M = 1 and ``_tqmm_i4_kernel`` at M > 1) and, for
i8t (Q8_0 at group 32, Q6_K at group 16, Q5_K and Q5_1 at group 32 with a
mins plane), those of ``csrc/qmm_i8t.cuh``
(``_tqmm_i8_gd_kernel`` at M = 1, ``_tqmm_i8_kernel`` at M > 1; a library
an epilogue: ``qmm_i8t.cu`` the matmuls and SiLU gate-ups,
``qmm_i8t_gelu.cu`` the GELU gate-ups).
``qmm_gateup`` runs their act·mul forms (``_gateup_i4_gd_kernel`` /
``_gateup_i4_kernel``, ``_gateup_i8_gd_kernel`` / ``_gateup_i8_kernel``):
SiLU on every kind, the tanh-GELU of gated-GELU models (Gemma) on i4t at
group 32 and on i8t at every group it takes; ReLU is not ported yet.  Int8
weights take the whole MLP (``ops.mlp``) where the reference's does; the
i8t gate-up with GELU where it declines (Gemma-7B's widths above 141 rows,
a down of another group than the gate-up).
The M > 1 tiles take their rows per block and K splits from ``i4t_plan``
(i4t), ``lane_plan`` (lane-major) and ``i8k_plan`` (i8t and i8c, whose tile
is ``csrc/i8k_tile.cuh``), the i8t and i8c matvecs at M = 1 (the
streaming block of ``csrc/i8mv.cuh``) their K splits from ``mv_plan``, and
the i4t matvec at M = 1 (the same block on the nibble layout,
``csrc/i4mv.cuh``) from ``i4t_mv_plan``: functions of the shapes only, so a CUDA graph replays the same sum order
and the fused gate-up splits as the matmul on its weight does.
``qmm_plain`` and ``qmm_gateup_plain`` are the same functions in plain
torch, with the same rounding points; a wrapper uses them only for tensors
on the CPU.  Lane-major weights that the reference's ``_supported`` takes
run ``csrc/qmm_lane.cu`` (the port of ``_qmm_i4_kernel``/``_qmm_i8_kernel``;
``qmm_lane``, plain version ``qmm_lane_plain``), whose grouped form
``ops.moe`` runs over the routed experts; an int8 one without a tile table
(the Q8_0 and Q5_1 downs) runs ``csrc/qmm_lane_i8.cu`` instead, a matvec at
few rows and a ``wgmma`` tile above (``lane_i8_plan``).  Per-channel int8
weights (i8c, ``weights="i8c"``) that the reference's ``_supported_i8c`` takes run
``csrc/qmm_i8c.cu`` (the port of ``_i8c_kernel``; ``qmm_i8c``, plain version
``qmm_i8c_plain``).  Shapes the kernels do not take go to the
dequantize-matmul path, as in the JAX package.

Numerics (see the sources' headers): i4t at M = 1, the group-dot form
``y = sum_g f32(bf16 s)·(sum bf16(x)·q - zero·xs) - f32(bf16 m)·xs``; at M > 1
``w = bf16(bf16(q - zero)·bf16(s))`` then ``y = bf16(x) @ w`` in f32 less the
min term.  i8t at M = 1 ``y = sum_g f32(bf16 s)·(sum bf16(x)·q) - f32(bf16
m)·xs`` (mins, with the f32 group sums xs of bf16(x)); at M > 1
``w = bf16(f32(q)·f32(bf16 s))``, ``y = bf16(x) @ w`` in f32, less the min
term ``xs @ f32(bf16 m)`` with mins (Q5_K, Q5_1; group 32).  Lane-major at
any M ``w = bf16(bf16(q - zero)·bf16(s))`` (less bf16(m), rounded again, with
mins), ``y = bf16(x) @ w`` in f32.  i8c at any
M ``y = (bf16(x) @ q)`` in f32, then ``· s[n]`` in f32.  The plain
versions use f32 matmuls (``torch.backends.cuda.matmul.allow_tf32`` must
stay False, its default, on the card).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import replace
from typing import Optional

import torch

from booster_tpu_torch.ops import kernels
from booster_tpu_torch.quant.qtensor import QTensor, dequantize, kernel_scales

_SIGNATURES = {
    "bt_qmm_i4t": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    "bt_qmm_i4t_mm": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p],
}
_I8_SIGNATURES = {
    "bt_qmm_i8t_gd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "bt_qmm_i8t_dq": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
}
_I8C_SIGNATURES = {
    "bt_qmm_i8c_mv": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "bt_qmm_i8c_mm": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
}
_MV_I8C_ROWS = 32  # rows of K of an i8c chunk of csrc/i8mv.cuh (kI8cRows; i8t: the group)
_MV_WARPS = 8  # warps of a block of csrc/i8mv.cuh (kWarps)
_LANE_SIGNATURES = {
    "bt_qmm_lane": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
}
_LANE_I8_SIGNATURES = {
    "bt_qmm_lane_i8_mv": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "bt_qmm_lane_i8_mm": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
}
LANE_MV_ROWS = 16  # payload rows a block of csrc/qmm_lane_i8.cu's matvec (kMvRows)
LANE_MV_WARPS = 8  # its warps, each 64-k chunks of all of K in turn
LANE_MV_MAX_K = 16384  # K up to which its block's scale planes fit (kMvMaxK)
LANE_BK = 64  # k of the matvec's chunk and of the tile's stage
_LANE_MV_MAX = 32  # rows up to which lane_i8_plan takes the matvec (PERF.md §6)
# past this K, at 17-64 rows, csrc/qmm_lane.cu's kernel measured faster than
# the matvec and the tile (the 7B down, 14336 → 4096, at M = 32 and 64 without
# mins; PERF.md §6): the plan keeps it there
_LANE_OLD_K = 8192
_TILE_N = 128  # output columns of a block of the M > 1 tiles (i4t, lane-major, i8k)
_I8K_BK = 64  # rows of K a stage of csrc/i8k_tile.cuh
_SMS = 132  # the H100's SMs
_TARGET_BLOCKS = 2 * _SMS
_MAX_SPLITS = 8  # a tile's K splits run as one thread-block cluster (portable size)

# per device: int32 zeros the kernels' blocks take tickets from (the last
# block of a column tile, or of a split decode attention's (slot, kv head),
# resets its ticket, so the buffer stays zero between launches on one stream)
_tickets: dict = {}


def _ticket_buffer(device: torch.device, n: int) -> torch.Tensor:
    t = _tickets.get(device)
    if t is None or t.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the kernels' ticket buffer is allocated by a first call, which "
                               "must not be captured in a CUDA graph")
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _tickets[device] = t
    return t


def i8k_plan(M: int, K: int, N: int, bm: Optional[int] = None) -> tuple[int, int]:
    """(BM, KS) of csrc/i8k_tile.cuh for y [M, N] = x [M, K] @ W (i8t or
    i8c, K-major; N = 2ff for a fused gate-up): rows of x a block (wgmma's
    N: the least of 16, 32, 64, 128 and 256 that holds M, 256 above) and K
    splits on whole stages of 64 rows: as many as keep the blocks within
    two an SM, each split at least 512 columns of K; where their f32 sums
    (4·KS·M bytes a column) would pass half the payload's K bytes, only as
    many as one block an SM needs; then the power of two at or below, at
    most 8 (a tile's splits run as one thread-block cluster).  The matmul,
    the fused gate-up and both products of the whole MLP take this function
    of the shapes alone, so they add their splits alike and agree bit for
    bit.  `bm` takes another tile height, its splits by the same rule
    (tools/mins_tiles.py)."""
    bm = bm or next((b for b in (16, 32, 64, 128) if M <= b), 256)
    tiles = -(-M // bm) * (N // _TILE_N)
    ks = _pow2_floor(max(1, min(_TARGET_BLOCKS // tiles, K // 512, _MAX_SPLITS)))
    if 8 * ks * M > K:  # no more splits than one block an SM needs
        ks = min(ks, 1 << (-(-_SMS // tiles) - 1).bit_length())
    return bm, ks


def mv_plan(K: int, N: int, G: int) -> int:
    """K splits of csrc/i8mv.cuh, the M = 1 matvec of i8t (group G, the
    group-dot form) and i8c (G = 0), for y [1, N] = x [1, K] @ W: a block of
    8 warps takes a 128-column tile over one split of K, each warp chunks of
    R rows (G, or 32 for i8c), and a tile's splits run as one thread-block
    cluster (at most 8).  As many splits as give the tiles about 1.5 blocks
    an SM (measured best on the path shapes, PERF.md §6), each split
    at least a chunk a warp.  The matvec and the fused gate-up on one [K,
    2ff] weight take this function of the shapes alone, so they add alike
    and agree bit for bit."""
    return _mv_splits(K // mv_chunk_rows(G), N)


def i4t_mv_plan(K: int, N: int, G: int) -> int:
    """K splits of csrc/i4mv.cuh, the M = 1 matvec of i4t (group G), for y
    [1, N] = x [1, K] @ W: one split where the 128-column tiles alone give
    0.7 of the SMs a block (MPT-7B's qkv and up, the lm heads: fastest
    there, tools/mv_splits.py), else ``mv_plan``'s rule over the K/(2G)
    groups of each half, a warp's chunk being one group (its G payload rows
    hold group g of both halves).  The matvec and the fused gate-up on one
    [K, 2ff] weight take this function of the shapes alone, so they add
    alike and agree bit for bit."""
    if N // _TILE_N >= 0.7 * _SMS:
        return 1
    return _mv_splits(K // (2 * G), N)


def _mv_splits(chunks: int, N: int) -> int:
    """Splits of a K of `chunks` chunks over N / 128 tiles: about 1.5 blocks
    an SM, at most 8 (one cluster), each split at least a chunk a warp."""
    tiles = N // _TILE_N
    return max(1, min(_MAX_SPLITS, int(1.5 * _SMS / tiles + 0.5), chunks // _MV_WARPS))


def mv_chunk_rows(G: int) -> int:
    """Rows of K of a warp's chunk in csrc/i8mv.cuh: the group G (i8t), or
    32 (i8c, G = 0)."""
    return G or _MV_I8C_ROWS


def _pow2_floor(n: int) -> int:
    return 1 << (n.bit_length() - 1)


def _tile_splits(tiles: int, K: int) -> int:
    """K splits for `tiles` output tiles: the nearest count to two blocks
    for each SM, each split at least 512 columns of K (its ring's stages
    must outlast the load of its first)."""
    return max(1, min(int(_TARGET_BLOCKS / tiles + 0.5), K // 512))


def _rows_tile(rows: int) -> int:
    """Rows of x per block (32, 64 or 128) for `rows` rows of one weight."""
    return 32 if rows <= 32 else 64 if rows < 512 else 128


def i4t_plan(M: int, K: int, N: int, bm: Optional[int] = None) -> tuple[int, int]:
    """(BM, KS) of csrc/qmm_i4t.cu's M > 1 tile for y [M, N] = x [M, K] @ W:
    rows of x per block and K splits on whole stages (64 columns of K a
    stage, 32 of each half: one group at G = 32, two at G = 16, so the
    plan needs no G).  N is the payload's width, 2ff for a fused gate-up, whose blocks
    hold 64 gate and 64 up columns: the gate-up and the matmul on one fused
    weight take one plan, so they add alike and agree bit for bit.  `bm`
    takes another tile height, its splits by the same rule
    (tools/mins_tiles.py)."""
    bm = bm or _rows_tile(M)
    return bm, _tile_splits(-(-M // bm) * -(-N // _TILE_N), K)


def i4t_launch_plan(M: int, K: int, N: int, gateup: bool) -> tuple[int, int, int]:
    """(BM, KS, tickets) of a launch of the M > 1 tile on a weight of N
    payload columns: ``i4t_plan(M, K, N)`` for the matmul and the fused
    gate-up alike, and one ticket a block of a K range (128 columns, or 64
    gate and 64 up columns, by BM rows)."""
    bm, ks = i4t_plan(M, K, N)
    tn = _TILE_N // 2 if gateup else _TILE_N
    return bm, ks, -(-M // bm) * -(-(N // 2 if gateup else N) // tn)


def lane_stage(bm: int, kind: str) -> int:
    """Columns of K a stage of csrc/qmm_lane.cu for a `kind` weight at `bm`
    rows a block (its kSK)."""
    return 128 if bm == 32 and kind == "i4p" else 64


def lane_plan(M: int, K: int, N: int, E: int = 0) -> tuple[int, int]:
    """(BM, KS) of csrc/qmm_lane.cu for y [M, N] = x [M, K] @ W^T (the i4p
    forms and the grouped int8 form; the int8 form without a tile table
    takes ``lane_i8_plan``): rows of x
    per block and K splits on whole stages (``lane_stage``).  The grouped
    form (E experts, M = route_pad's padded rows) plans from the shapes
    alone, as its sum order must: route_pad reserves a tile of padding per
    expert, so at most M - 32E rows are real, spread over E experts; each
    expert they reach adds a partly filled tile."""
    if not E:
        bm = _rows_tile(M)
        return bm, _tile_splits(-(-M // bm) * (N // _TILE_N), K)
    rows = max(1, M - 32 * E)
    bm = _rows_tile(rows // E)
    live = rows + 32 * min(E, -(-rows // 32))  # rows of the tiles that hold real rows
    return bm, _tile_splits(-(-live // bm) * (N // _TILE_N), K)


def lane_i8_plan(M: int, K: int, N: int, bm: Optional[int] = None) -> tuple:
    """The form of csrc/qmm_lane_i8.cu for y [M, N] = x [M, K] @ W^T on an
    int8 lane-major weight without a tile table: ``("mv", mt)``, the matvec
    with mt m8 tiles of x (1 up to 8 rows, 2 up to 16, 4 up to 32), up to
    ``_LANE_MV_MAX`` rows where K is at most ``LANE_MV_MAX_K`` (the matvec
    was faster than the tile at every M up to 32 on the card);
    above, ``("mm", bm, ks)``, the wgmma tile with bm rows of x a block (the
    least of 64 and 128 that holds M, else 256) and K split ks ways on
    whole 64-k stages, as ``i8k_plan`` splits (as many splits as keep the
    blocks within two an SM, one at 256 rows, each split at least 512 k, a
    power of two, at most 8: a tile's splits are one cluster); at 17-64
    rows where K passes ``_LANE_OLD_K``, ``("lane",)``: csrc/qmm_lane.cu's
    kernel, which measured faster there.  A function of the shapes only.
    `bm` takes the tile at another height, its splits by the same rule
    (tools/lane_forms.py)."""
    if bm is None and K > _LANE_OLD_K and 16 < M <= 64:
        return ("lane",)
    if bm is None and M <= _LANE_MV_MAX and K <= LANE_MV_MAX_K:
        return ("mv", 1 if M <= 8 else 2 if M <= 16 else 4)
    bm = bm or next((b for b in (64, 128) if M <= b), 256)
    tiles = -(-M // bm) * (N // _TILE_N)
    target = _SMS if bm == 256 else _TARGET_BLOCKS  # 256 rows a block: one block an SM
    return ("mm", bm, _pow2_floor(max(1, min(target // tiles, K // 512, _MAX_SPLITS))))


def lane_i8_count_name(plan: tuple) -> str:
    """The launch count of a form of ``lane_i8_plan``: ``qmm_i8_mv`` (the
    matvec), ``qmm_i8_mm`` (the wgmma tile), ``qmm_i8`` (``("lane",)``:
    csrc/qmm_lane.cu's kernel, where the plan keeps it or a tool asks)."""
    return "qmm_i8" if plan[0] == "lane" else f"qmm_i8_{plan[0]}"


def silu(x: torch.Tensor) -> torch.Tensor:
    """The llama MLP activation in x's dtype, with the sigmoid computed in
    f32 and rounded to x's dtype before the product (the kernels' epilogue
    and the JAX package's ``_act``)."""
    return x * torch.sigmoid(x.float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximate GELU in f32 as ``jax.nn.gelu`` writes it, rounded to
    x's dtype: z = c·(x + 0.044715·x·x·x), x·0.5·(1 + tanh z), each op in
    f32 (csrc/bf16_ops.cuh gelu_mul repeats them one by one)."""
    xf = x.float()
    z = math.sqrt(2.0 / math.pi) * (xf + 0.044715 * (xf * xf * xf))
    cdf = 0.5 * (1.0 + torch.tanh(z))
    return (xf * cdf).to(x.dtype)


ACT_IDS = {"silu": 0, "gelu": 1}  # the gate-up epilogues ported, by their kernel codes


def act_mul(g: torch.Tensor, u: torch.Tensor, act: str) -> torch.Tensor:
    """act(g)·u in g's dtype: the fused gate-ups' epilogue, the unfused
    sequence of the JAX package's ``_act`` then the product."""
    if act not in ACT_IDS:
        raise NotImplementedError(f"gate-up with act {act!r}: not ported yet")
    return (gelu(g) if act == "gelu" else silu(g)) * u


# -- shape gates (copied from pallas_qmm.py) ---------------------------------

# pallas_qmm.py's tile candidates and per-block budget (its defaults), for
# the copy of its gate-up tile picker
_BK_CANDS = (8192, 5632, 4096, 2816, 2048, 1408, 1024, 512, 256, 128)
_BN_CANDS = (3200, 2560, 2048, 1792, 1536, 1280, 1024, 768, 640, 512, 384, 256, 128)
_BUDGET = 2 * 1024 * 1024
_SUB = 256
_VMEM_LIMIT = 13 * 2 ** 20 + 2 ** 19


def _stack_ok(w: QTensor) -> bool:
    """Stacked ([L, ...]) payloads need a layer view; 2-D need none."""
    return (w.layer is None) == (w.qw.ndim == 2)


def _supported_t(w: QTensor, K: int, M: int) -> bool:
    if w.kind not in ("i4t", "i8t") or w.scales is None:
        return False
    N = w.shape[0]
    G = w.group
    if K != w.shape[1] or K % (2 * G) != 0:
        return False
    pk = K // 2 if w.kind == "i4t" else K
    if pk % 32 != 0 or N % 128 != 0 or (pk // G) % 8 != 0:
        return False
    return True


def _supported_i8c(w: QTensor, K: int) -> bool:
    """The reference's gate of the i8c kernel (pallas_qmm.py:1552-1557)."""
    if w.kind != "i8c" or w.scales is None:
        return False
    return K == w.shape[1] and K % 256 == 0 and w.shape[0] % 128 == 0


def _supported(w: QTensor, K: int, M: int) -> bool:
    """The reference's gate of the lane-major kernels (pallas_qmm.py:1583)."""
    if w.kind not in ("i4p", "i8"):
        return False
    N = w.shape[0]
    G = w.group
    if K != w.shape[1] or K % (2 * G) != 0:
        return False
    half = K // 2 if w.kind == "i4p" else K
    return half % 128 == 0 and N % 128 == 0


def lane_supported(w: QTensor) -> bool:
    """True when a lane-major (i4p, i8) weight that stays lane-major goes to
    the lane-major kernel: the loader stores its scale planes in bf16 then."""
    return _supported(w, w.shape[1], 1)


def transposable(w: QTensor) -> bool:
    """True when the K-major kernel takes this tensor's shape — the loader
    transposes only then."""
    if w.kind not in ("i4p", "i8") or w.scales is None:
        return False
    return _supported_t(replace(w, kind=w.kind[:2] + "t"), w.shape[1], 1)


def _gateup_fits(ff: int, pk: int, m: int, srows: int, group: int, s_item: int,
                 x_mult: int, deq_bytes: int) -> bool:
    """Whether ``pallas_qmm._pick_tiles_gateup`` finds a tile (it returns
    BN = 0, and the reference's qmm_gateup None, when none fits its VMEM
    model); its arithmetic, copied."""
    bm = m if m <= 256 else 256
    s_sub = 8 if s_item == 4 else 16
    for bk in _BK_CANDS:
        if bk > pk or pk % bk:
            continue
        if bk != pk and (bk % group or (bk // group) % s_sub or bk % 32):
            continue
        for bn in _BN_CANDS:
            if bn > ff or ff % bn or 2 * bn * bk > _BUDGET * 2:
                continue
            sub = min(_SUB, bk)
            depth = min(-(-bk // sub), 2)
            blocks = 2 * (x_mult * bm * bk + 2 * bn * bk + 2 * bm * bn
                          + 2 * srows * (bk // group) * s_item * bn)
            if blocks + 2 * 4 * bm * bn + depth * 2 * deq_bytes * sub * bn <= _VMEM_LIMIT:
                return True
    return False


def _gateup_supported(w: QTensor, K: int, M: int) -> bool:
    """The reference's gate of qmm_gateup (pallas_qmm.py:1039-1060)."""
    if w.kind not in ("i4t", "i8t") or w.scales is None:
        return False
    N2 = w.shape[0]
    if N2 % 2 or K != w.shape[1]:
        return False
    ff = N2 // 2
    G = w.group
    is4 = w.kind == "i4t"
    pk = K // 2 if is4 else K
    s3, _ = kernel_scales(w)
    s_item = s3.element_size()
    s_sub = 8 if s_item == 4 else 16
    if K % (2 * G) or pk % 32 or (pk // G) % s_sub or ff % 128:
        return False
    return _gateup_fits(ff, pk, M, s3.shape[-3], G, s_item, 4 if is4 else 2, 16 if is4 else 9)


# -- plain versions ----------------------------------------------------------


def _qmm_i8t_plain(x: torch.Tensor, w: QTensor, dq: bool) -> torch.Tensor:
    M, K = x.shape
    G = w.group
    ng = K // G
    N = w.shape[0]
    s3, has_mins = kernel_scales(w)
    sf = s3.to(torch.bfloat16).float()  # [R, K/G, N] consumed at bf16
    xb = x.to(torch.bfloat16).float()
    if M == 1 and not dq:
        # the group-dot form (_gd_parts, _tqmm_i8_gd_kernel and
        # _gateup_i8_gd_kernel): each group's exact dot p, its f32 sum xs
        # of bf16(x), c = s·p - m·xs, summed over the groups
        xg = xb.reshape(ng, 1, G)
        p = torch.bmm(xg, w.qw.float().reshape(ng, G, N)).reshape(ng, N)
        c = sf[0] * p
        if has_mins:
            c = c - sf[1] * xg.sum(-1)
        return c.sum(0).reshape(1, N)
    # bf16(q·s): q is exact in bf16 and torch rounds a bf16 product of the
    # exact f32 one, so the product is formed in bf16 with s broadcast
    wd = (w.qw.reshape(ng, G, N).to(torch.bfloat16) * sf[0].to(torch.bfloat16)[:, None, :])
    y = xb @ wd.reshape(K, N).float()
    if has_mins:  # the reference's _MIN_DOT form: f32 group sums of bf16(x), never rounded
        y = y - xb.reshape(M, ng, G).sum(-1) @ sf[1]
    return y


def qmm_plain(x: torch.Tensor, w: QTensor, dq: bool = False) -> torch.Tensor:
    """x [M, K] @ W^T → [M, N] f32 for an i4t or i8t QTensor (layer view
    allowed), in plain torch with the kernels' rounding points.  `dq` takes
    the dequantize form at M = 1 too (the whole-MLP kernel's form)."""
    w = w.resolved()
    if w.kind == "i8t":
        return _qmm_i8t_plain(x, w, dq)
    M, K = x.shape
    half = K // 2
    G = w.group
    ngh = half // G
    N = w.shape[0]
    s3, has_mins = kernel_scales(w)
    sf = s3.to(torch.bfloat16).float()  # [R, ngh, N] consumed at bf16
    xb = x.to(torch.bfloat16).float()
    q = w.qw  # [half, N] u8
    if M == 1:
        planes = torch.stack([q & 0x0F, q >> 4]).float()  # [2, half, N]
        xh = xb.reshape(2 * ngh, 1, G)
        p = torch.bmm(xh, planes.reshape(2 * ngh, G, N)).reshape(2, ngh, N)
        xs = xh.reshape(2, ngh, G).sum(-1, keepdim=True)  # [2, ngh, 1]
        if w.zero:
            p = p - float(w.zero) * xs
        contrib = sf[:2] * p
        if has_mins:
            contrib = contrib - sf[2:4] * xs
        return contrib.sum(dim=(0, 1)).reshape(1, N)
    # bf16(bf16(q - zero)·bf16(s)) as one bf16 product (the rounding of the
    # exact f32 product), s broadcast over each group's G rows
    planes = (torch.stack([q & 0x0F, q >> 4]).to(torch.int16) - w.zero).to(torch.bfloat16)
    wd = planes.reshape(2, ngh, G, N) * sf[:2].to(torch.bfloat16)[:, :, None, :]
    y = xb @ wd.reshape(K, N).float()
    if has_mins:
        xs = xb.reshape(M, 2 * ngh, G).sum(-1)  # [M, 2·ngh] f32 group sums
        y = y - xs @ sf[2:4].reshape(2 * ngh, N)
    return y


def min_split(xs: torch.Tensor, parts: int = 3) -> list[torch.Tensor]:
    """The bf16 parts into which the M > 1 tiles split an f32 group sum xs
    (csrc/bf16_ops.cuh split3): hi = bf16(xs), mid = bf16(xs - hi), lo =
    bf16(xs - hi - mid), each difference exact in f32; the first `parts` of
    them, as f32 tensors of bf16 values.  With all three, hi + mid + lo ==
    xs exactly for every normal xs (8 bits of its 24 each), and a part times
    a bf16 min is exact in f32."""
    out, r = [], xs.float()
    for _ in range(parts):
        p = r.to(torch.bfloat16).float()
        out.append(p)
        r = r - p
    return out


def min_term(xs: torch.Tensor, mf: torch.Tensor, parts: int = 3) -> torch.Tensor:
    """sum_g xs[m, g]·mf[g, n] as the M > 1 tiles run the min term: extra
    rows of K, [hi | mid | lo] of the f32 group sums xs [M, ng] against
    [mf; mf; mf] (mf [ng, N], the f32 of the bf16 mins), one f32 product.
    parts = 1 is the rounding the reference warns of (xs rounded to bf16,
    pallas_qmm.py:66-73); 3 is the tiles'."""
    return torch.cat(min_split(xs, parts), -1) @ mf.float().repeat(parts, 1)


def qmm_i8c_plain(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """x [M, K] @ W^T → [M, N] f32 for an i8c QTensor (layer view allowed),
    in plain torch with the kernel's rounding points: the f32 sum of
    bf16(x)·q, then times the f32 channel scale."""
    w = w.resolved()
    return (x.to(torch.bfloat16).float() @ w.qw.float()) * w.scales.float()


def lane_dequant(w: QTensor, r0: int = 0, r1: Optional[int] = None) -> torch.Tensor:
    """Rows [r0, r1) of a lane-major i4p or i8 QTensor (layer view allowed)
    as the lane-major kernel forms them, f32 [r1 - r0, K]: w =
    bf16(bf16(q - zero)·bf16(s)), less bf16(m) (rounded again) when affine."""
    w = w.resolved()
    s3, has_mins = kernel_scales(w)  # [R, rows(+rows), SG]
    rows, G, K = w.scale_rows, w.group, w.shape[1]
    p = w.qw[r0:r1]
    q = torch.cat([p & 0x0F, p >> 4], dim=-1) if w.kind == "i4p" else p
    q = q.to(torch.bfloat16) - w.zero  # small integers: exact in bf16
    s = s3[r0:r1].to(torch.bfloat16)
    n = s.shape[0]
    # bf16 · bf16: the exact product, rounded once (torch computes it in f32)
    v = q.reshape(n, K // G, G) * s[:, :rows].reshape(n, K // G, 1)
    if has_mins:
        v = v - s[:, rows:].reshape(n, K // G, 1)
    return v.reshape(n, K).float()


def qmm_lane_plain(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """x [M, K] @ W^T → [M, N] f32 for a lane-major i4p or i8 QTensor, in
    plain torch with the lane-major kernel's rounding points."""
    return x.to(torch.bfloat16).float() @ lane_dequant(w).t()


def qmm_gateup_plain(x: torch.Tensor, w: QTensor, dq: bool = False,
                     act: str = "silu") -> torch.Tensor:
    """act(x @ Wg^T) * (x @ Wu^T) → [M, ff] bf16 from a fused [2ff, K]
    QTensor: the unfused sequence, qmm then act·mul in bf16."""
    gu = qmm_plain(x, w, dq).to(torch.bfloat16)
    ff = gu.shape[-1] // 2
    return act_mul(gu[:, :ff], gu[:, ff:], act)


# -- kernel wrappers ---------------------------------------------------------


def _launch(x: torch.Tensor, w: QTensor, gateup: bool, act: str = "silu") -> torch.Tensor:
    w = w.resolved()
    M, K = x.shape
    N = w.shape[0]
    s3, _ = kernel_scales(w)
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("qmm_i4t kernel: x must be contiguous bf16")
    if w.qw.dtype != torch.uint8 or tuple(w.qw.shape) != (K // 2, N) or not w.qw.is_contiguous():
        raise ValueError(f"qmm_i4t kernel: payload must be contiguous u8 [{K // 2}, {N}]")
    if s3.dtype != torch.bfloat16 or s3.shape[-2:] != (K // 2 // w.group, N) \
            or s3.shape[0] not in (2, 4) or not s3.is_contiguous():
        raise ValueError("qmm_i4t kernel: scale planes must be contiguous bf16 "
                         "[2|4, K/(2G), N] (compact_scales)")
    if w.group not in (16, 32):
        raise NotImplementedError(f"qmm_i4t kernel: group {w.group}: not ported yet "
                                  "(groups 16 and 32 are)")
    if not (x.device == w.qw.device == s3.device):
        raise ValueError("qmm_i4t kernel: all operands must be on one device")
    if act not in ACT_IDS or (act == "gelu" and w.group != 32):
        raise NotImplementedError(f"qmm_i4t gate-up with act {act!r} at group {w.group}: not "
                                  "ported yet (SiLU at groups 16 and 32, GELU at 32)")
    ncols = N // 2 if gateup else N
    if M > 1 and ncols % 16:
        raise NotImplementedError(f"qmm_i4t kernel at M > 1: {ncols} output columns: not "
                                  "ported yet (a multiple of 16)")
    if M == 1 and ncols % _TILE_N:
        raise NotImplementedError(f"qmm_i4t kernel at M = 1: {ncols} output columns: not "
                                  "ported yet (a multiple of 128)")
    if M == 1 and (x.data_ptr() % 4 or w.qw.data_ptr() % 16 or s3.data_ptr() % 16):
        raise ValueError("qmm_i4t kernel at M = 1: payload and scales must lie on 16 bytes, "
                         "x on 4")
    if M > 1 and (x.data_ptr() % 16 or w.qw.data_ptr() % 16 or s3.data_ptr() % 16):
        raise ValueError("qmm_i4t kernel at M > 1: x, payload and scales must lie on 16 bytes")
    out = torch.empty(M, ncols, device=x.device,
                      dtype=torch.bfloat16 if gateup else torch.float32)
    lib = kernels.library("qmm_i4t", _SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if M == 1:
        rc = lib.bt_qmm_i4t(x.data_ptr(), w.qw.data_ptr(), s3.data_ptr(), out.data_ptr(),
                            K, N, s3.shape[0], w.zero, w.group, int(gateup), ACT_IDS[act],
                            i4t_mv_plan(K, N, w.group), stream)
    else:
        bm, ks, n_tickets = i4t_launch_plan(M, K, N, gateup)
        part = torch.empty(ks * M * N, dtype=torch.float32, device=x.device) if ks > 1 else None
        tickets = _ticket_buffer(x.device, n_tickets)
        rc = lib.bt_qmm_i4t_mm(x.data_ptr(), w.qw.data_ptr(), s3.data_ptr(), out.data_ptr(),
                               None if part is None else part.data_ptr(), tickets.data_ptr(),
                               M, K, N, s3.shape[0], w.zero, w.group, int(gateup),
                               ACT_IDS[act], bm, ks, stream)
    kernels.check(rc, "qmm_i4t")
    kernels.count(i4t_count_name(gateup, M, w.group, s3.shape[0] == 4, act), (K, N))
    return out


def i4t_count_name(gateup: bool, M: int, G: int, mins: bool, act: str = "silu") -> str:
    """The launch count of an i4t kernel form: qmm_i4t[_gateup] then, at
    group 16, _g16m (with mins: Q2_K) or _g16 (without: Q3_K), a gate-up's
    _gelu epilogue, then _gd (M = 1) or _dq (M > 1).  The group-32 forms
    (Q4_0, Q4_K) keep one name each, their paths apart."""
    g16 = ("_g16m" if mins else "_g16") if G == 16 else ""
    epi = "_gelu" if gateup and act == "gelu" else ""
    return ("qmm_i4t_gateup" if gateup else "qmm_i4t") + g16 + epi + ("_gd" if M == 1 else "_dq")


def check_i8t(x: torch.Tensor, w: QTensor, what: str, groups=(16, 32),
              mins=(32,)) -> torch.Tensor:
    """Raise unless the i8t kernels take x [M, K] and the 2-D QTensor w
    (contiguous bf16 x on 16 bytes, int8 payload [K, N], bf16 scale planes
    [R, K/G, N] with R = 1, or 2 at a group in `mins` (a mins plane), a
    group in `groups`, N a multiple of 128, K of 64); returns the scale
    planes."""
    M, K = x.shape
    N = w.shape[0]
    G = w.group
    s3, has_mins = kernel_scales(w)
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what} kernel: x must be contiguous bf16 on 16 bytes")
    if w.qw.dtype != torch.int8 or tuple(w.qw.shape) != (K, N) or not w.qw.is_contiguous():
        raise ValueError(f"{what} kernel: payload must be contiguous int8 [{K}, {N}]")
    if G not in groups:
        raise NotImplementedError(f"{what} kernel: group {G}: not ported yet "
                                  f"(groups {groups} are)")
    if has_mins and G not in mins:
        raise NotImplementedError(f"{what} kernel: i8t weights with mins at group {G}: not "
                                  "ported yet (no format gives them)")
    R = 2 if has_mins else 1
    if s3.dtype != torch.bfloat16 or tuple(s3.shape) != (R, K // G, N) or not s3.is_contiguous():
        raise ValueError(f"{what} kernel: scales must be contiguous bf16 [{R}, K/G, N] "
                         "(compact_scales)")
    if N % 128 or K % 64:
        raise NotImplementedError(f"{what} kernel: N = {N}, K = {K}: not ported yet "
                                  "(N a multiple of 128, K of 64)")
    if not (x.device == w.qw.device == s3.device):
        raise ValueError(f"{what} kernel: all operands must be on one device")
    return s3


def i8t_count_name(gateup: bool, gd: bool, act: str = "silu") -> str:
    """The launch count of an i8t kernel form: qmm_i8t[_gateup], a gate-up's
    _gelu epilogue, then _gd (the M = 1 group-dot form) or _dq."""
    epi = "_gelu" if gateup and act == "gelu" else ""
    return ("qmm_i8t_gateup" if gateup else "qmm_i8t") + epi + ("_gd" if gd else "_dq")


def _launch_i8t(x: torch.Tensor, w: QTensor, gateup: bool, dq: bool,
                act: str = "silu") -> torch.Tensor:
    if act not in ACT_IDS:
        raise NotImplementedError(f"qmm_i8t gate-up with act {act!r}: not ported yet "
                                  "(silu and gelu are)")
    w = w.resolved()
    M, K = x.shape
    N = w.shape[0]
    gd = M == 1 and not dq
    s3 = check_i8t(x, w, "qmm_i8t", mins=(16, 32) if gd else (32,))
    G = w.group
    dev = x.device
    # one library an epilogue (csrc/qmm_i8t.cu, qmm_i8t_gelu.cu: built at once)
    lib = kernels.library("qmm_i8t_gelu" if gateup and act == "gelu" else "qmm_i8t",
                          _I8_SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if gateup and N % 256:
        raise NotImplementedError(f"qmm_i8t gate-up kernel: ff = {N // 2}: not ported yet "
                                  "(a multiple of 128)")
    if gd:
        if w.qw.data_ptr() % 16 or s3.data_ptr() % 16:
            raise ValueError("qmm_i8t kernel at M = 1: payload and scales must lie on 16 bytes")
        out = torch.empty(1, N // 2 if gateup else N, device=dev,
                          dtype=torch.bfloat16 if gateup else torch.float32)
        rc = lib.bt_qmm_i8t_gd(x.data_ptr(), w.qw.data_ptr(), s3.data_ptr(), out.data_ptr(),
                               K, N, G, int(s3.shape[0] == 2), int(gateup), mv_plan(K, N, G),
                               ACT_IDS[act], stream)
        name = i8t_count_name(gateup, True, act)
        kernels.check(rc, name)
        kernels.count(name, (K, N))
        return out
    bm, ks = i8k_plan(M, K, N)
    if gateup:
        out = torch.empty(M, N // 2, device=dev, dtype=torch.bfloat16)
    else:
        out = torch.empty(M, N, device=dev, dtype=torch.float32)
    rc = lib.bt_qmm_i8t_dq(x.data_ptr(), w.qw.data_ptr(), s3.data_ptr(), out.data_ptr(),
                           M, K, N, ks, int(gateup), G, bm, int(s3.shape[0] == 2),
                           ACT_IDS[act], stream)
    name = i8t_count_name(gateup, False, act)
    kernels.check(rc, name)
    kernels.count(name, (K, N))
    return out


def _launch_i8c(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    w = w.resolved()
    M, K = x.shape
    N = w.shape[0]
    s = w.scales
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("qmm_i8c kernel: x must be contiguous bf16 on 16 bytes")
    if w.qw.dtype != torch.int8 or tuple(w.qw.shape) != (K, N) or not w.qw.is_contiguous():
        raise ValueError(f"qmm_i8c kernel: payload must be contiguous int8 [{K}, {N}]")
    if s.dtype != torch.float32 or tuple(s.shape) != (1, N) or not s.is_contiguous():
        raise ValueError(f"qmm_i8c kernel: scales must be contiguous f32 [1, {N}]")
    if K % 256 or N % 128:
        raise NotImplementedError(f"qmm_i8c kernel: N = {N}, K = {K}: not ported yet "
                                  "(K a multiple of 256, N of 128)")
    dev = x.device
    if not (dev == w.qw.device == s.device):
        raise ValueError("qmm_i8c kernel: all operands must be on one device")
    lib = kernels.library("qmm_i8c", _I8C_SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty(M, N, device=dev, dtype=torch.float32)
    if M == 1:
        if w.qw.data_ptr() % 16:
            raise ValueError("qmm_i8c kernel at M = 1: the payload must lie on 16 bytes")
        rc = lib.bt_qmm_i8c_mv(x.data_ptr(), w.qw.data_ptr(), s.data_ptr(), out.data_ptr(),
                               K, N, mv_plan(K, N, 0), stream)
        name = "qmm_i8c_mv"
    else:
        bm, ks = i8k_plan(M, K, N)
        rc = lib.bt_qmm_i8c_mm(x.data_ptr(), w.qw.data_ptr(), s.data_ptr(), out.data_ptr(),
                               M, K, N, ks, bm, stream)
        name = "qmm_i8c_mm"
    kernels.check(rc, name)
    kernels.count(name, (K, N))
    return out


def _lane_operands(x: torch.Tensor, w: QTensor, N: int, name: str,
                   tabs: tuple = ()) -> tuple:
    """(M, K, R, s3, has_mins) of a lane-major launch; raises unless the
    kernels take the operands (``lane_launch``'s list)."""
    M, K = x.shape
    i4 = w.kind == "i4p"
    s3, has_mins = kernel_scales(w)
    R = w.qw.shape[0]
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} kernel: x must be contiguous bf16 on 16 bytes")
    want = (torch.uint8, (R, K // 2)) if i4 else (torch.int8, (R, K))
    if w.kind not in ("i4p", "i8") or w.qw.dtype != want[0] \
            or tuple(w.qw.shape) != want[1] or not w.qw.is_contiguous():
        raise ValueError(f"{name} kernel: payload must be contiguous i4p u8 [R, K/2] "
                         f"or i8 int8 [R, K], K = {K}")
    if s3.dtype != torch.bfloat16 or not s3.is_contiguous() or tuple(s3.shape) != (
            R, w.scale_rows * (2 if has_mins else 1), K // (w.scale_rows * w.group)):
        raise ValueError(f"{name} kernel: scales must be contiguous bf16 prepared planes "
                         "(prepare_kernel_scales, compact_scales)")
    if N % 128 or K % 128 or K % (2 * w.group) or w.group % 16:
        raise NotImplementedError(f"{name} kernel: N = {N}, K = {K}, G = {w.group}: "
                                  "not ported yet (N, K multiples of 128, G of 16)")
    if any(t.device != x.device for t in (w.qw, s3, *tabs)):
        raise ValueError(f"{name} kernel: all operands must be on one device")
    if w.qw.data_ptr() % 16:
        raise ValueError(f"{name} kernel: the payload must lie on 16 bytes")
    return M, K, R, s3, has_mins


def lane_launch(x: torch.Tensor, w: QTensor, N: int, name: str,
                tile_expert: Optional[torch.Tensor] = None,
                rows_used: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch csrc/qmm_lane.cu: y [M, N] f32 = x [M, K] @ W^T over rows
    [0, N) of a lane-major weight, or, with a tile table, over the rows of
    each 32-row tile's expert (ops.moe.grouped_qmm): the i4p forms, the
    grouped i8 form, and the int8 form without a table where a caller asks
    for it by name (``qmm_lane`` runs that one on csrc/qmm_lane_i8.cu).
    Raises unless the kernel takes the operands: contiguous bf16 x on 16
    bytes; an i4p (u8 [R, K/2]) payload with bf16 prepared planes (the
    halves' scales, then their mins when affine: Q4_K) or an i8 (int8 [R,
    K]) one with bf16 prepared planes (the scales, then the mins when
    affine: Q5_K, Q5_1); N a multiple of 128; K of 128 and of 2G; G of 16.
    Rows per block and K splits: ``lane_plan`` (with the experts E = rows /
    N of the stacked payload for a tile table)."""
    w = w.resolved()
    tabs = tuple(t for t in (tile_expert, rows_used) if t is not None)
    M, K, R, s3, has_mins = _lane_operands(x, w, N, name, tabs)
    if any(t.dtype != torch.int32 or not t.is_contiguous() for t in tabs):
        raise ValueError(f"{name} kernel: tile table and row count must be contiguous int32")
    if tile_expert is not None and (tile_expert.numel() != -(-M // 32) or R % N):
        raise ValueError(f"{name} kernel: a tile table needs one expert per 32 rows "
                         "and a payload of whole experts")
    if tile_expert is None and R < N:
        raise ValueError(f"{name} kernel: the payload has {R} rows, not {N}")
    bm, ks = lane_plan(M, K, N, 0 if tile_expert is None else R // N)
    out = torch.empty(M, N, device=x.device, dtype=torch.float32)
    part = torch.empty(ks * M * N, dtype=torch.float32, device=x.device) if ks > 1 else None
    tickets = _ticket_buffer(x.device, -(-M // bm) * (N // _TILE_N))
    lib = kernels.library("qmm_lane", _LANE_SIGNATURES)
    rc = lib.bt_qmm_lane(x.data_ptr(), w.qw.data_ptr(), s3.data_ptr(), out.data_ptr(),
                         None if part is None else part.data_ptr(), tickets.data_ptr(),
                         None if tile_expert is None else tile_expert.data_ptr(),
                         None if rows_used is None else rows_used.data_ptr(),
                         M, K, N, w.group, w.zero, int(w.kind == "i4p"), int(has_mins), bm, ks,
                         torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(rc, name)
    kernels.count(name, (K, N))
    return out


def lane_i8_launch(x: torch.Tensor, w: QTensor, plan: Optional[tuple] = None) -> torch.Tensor:
    """Launch csrc/qmm_lane_i8.cu: y [M, N] f32 = x [M, K] @ W^T for an int8
    lane-major weight [N, K] without a tile table (the Q8_0 and Q5_1 downs),
    in the form of `plan` (``lane_i8_plan`` by default; a tool may name
    another), counted under ``lane_i8_count_name``.  Raises where
    ``lane_launch`` would, and for a weight of another kind."""
    w = w.resolved()
    N = w.shape[0]
    plan = plan or lane_i8_plan(x.shape[0], x.shape[1], N)
    name = lane_i8_count_name(plan)
    if w.kind != "i8" or w.qw.shape[0] != N:
        raise ValueError(f"{name} kernel: an int8 lane-major weight of {N} rows, not "
                         f"{w.kind} {tuple(w.qw.shape)}")
    if plan[0] == "lane":
        return lane_launch(x, w, N, name)
    M, K, _, s3, has_mins = _lane_operands(x, w, N, name)
    if plan[0] == "mv" and not (plan[1] in (1, 2, 4) and M <= 8 * plan[1]
                                and K <= LANE_MV_MAX_K):
        raise ValueError(f"{name} kernel: {M} rows do not fit {plan[1]} m8 tiles, or K "
                         f"= {K} is past {LANE_MV_MAX_K}")
    out = torch.empty(M, N, device=x.device, dtype=torch.float32)
    lib = kernels.library("qmm_lane_i8", _LANE_I8_SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if plan[0] == "mv":
        rc = lib.bt_qmm_lane_i8_mv(x.data_ptr(), w.qw.data_ptr(), s3.data_ptr(), out.data_ptr(),
                                   M, K, N, w.group, int(has_mins), plan[1], stream)
    else:
        rc = lib.bt_qmm_lane_i8_mm(x.data_ptr(), w.qw.data_ptr(), s3.data_ptr(), out.data_ptr(),
                                   M, K, N, w.group, int(has_mins), plan[1], plan[2], stream)
    kernels.check(rc, name)
    kernels.count(name, (K, N))
    return out


def qmm_lane(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """Kernel-level entry for a lane-major i4p or i8 weight: x [M, K] bf16 @
    W^T → [M, N] f32 (the plain version for CPU tensors, the kernel for
    CUDA tensors)."""
    if x.device.type == "cpu":
        return qmm_lane_plain(x, w)
    if w.kind == "i8":
        return lane_i8_launch(x, w)
    return lane_launch(x, w, w.shape[0], "qmm_i4p")


def qmm_i4t(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """Kernel-level entry: x [M, K] bf16 @ W^T → [M, N] f32 (the plain
    version for CPU tensors, the kernel for CUDA tensors)."""
    if x.device.type == "cpu":
        return qmm_plain(x, w)
    return _launch(x, w, gateup=False)


def qmm_i4t_gateup(x: torch.Tensor, w: QTensor, act: str = "silu") -> torch.Tensor:
    """Kernel-level entry of the fused gate+up: → [M, ff] bf16, act(gate)·up
    with act "silu" or (group 32) "gelu"."""
    if x.device.type == "cpu":
        return qmm_gateup_plain(x, w, act=act)
    return _launch(x, w, gateup=True, act=act)


def qmm_i8t(x: torch.Tensor, w: QTensor, dq: bool = False) -> torch.Tensor:
    """Kernel-level entry for i8t: x [M, K] bf16 @ W^T → [M, N] f32, the
    group-dot kernel at M = 1 and the dequant (tensor-core) kernel at M > 1,
    or at M = 1 too with `dq` (the whole-MLP kernel's form)."""
    if x.device.type == "cpu":
        return qmm_plain(x, w, dq)
    return _launch_i8t(x, w, gateup=False, dq=dq)


def qmm_i8t_gateup(x: torch.Tensor, w: QTensor, act: str = "silu") -> torch.Tensor:
    """Kernel-level entry of the i8t fused gate+up → [M, ff] bf16, act(gate)·up
    with act "silu" or "gelu": at M = 1 the group-dot form
    (``_gateup_i8_gd_kernel``; equal to qmm_i8t's M = 1 kernel + act·mul
    bit for bit), above the dequant form (``_gateup_i8_kernel``; equal to
    qmm_i8t's M > 1 kernel + act·mul)."""
    if act not in ACT_IDS:
        raise NotImplementedError(f"qmm_i8t gate-up with act {act!r}: not ported yet "
                                  "(silu and gelu are)")
    if x.device.type == "cpu":
        return qmm_gateup_plain(x, w, act=act)
    return _launch_i8t(x, w, gateup=True, dq=x.shape[0] > 1, act=act)


def qmm_i8c(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """Kernel-level entry for i8c: x [M, K] bf16 @ W^T → [M, N] f32, the
    streaming matvec at M = 1 and the tensor-core tile above (the plain
    version for CPU tensors, the kernel for CUDA tensors)."""
    if x.device.type == "cpu":
        return qmm_i8c_plain(x, w)
    return _launch_i8c(x, w)


# -- public ops --------------------------------------------------------------


def _rows(x: torch.Tensor) -> int:
    M = 1
    for d in x.shape[:-1]:
        M *= d
    return M


def qmm(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """x [..., K] @ W[N, K]^T → [..., N] float32."""
    K = x.shape[-1]
    lead = x.shape[:-1]
    M = _rows(x)
    if _supported_i8c(w, K) and _stack_ok(w):
        kern = qmm_i8c
    elif w.transposed and _supported_t(w, K, M) and _stack_ok(w):
        kern = qmm_i4t if w.kind == "i4t" else qmm_i8t
    elif not w.transposed and _supported(w, K, M) and _stack_ok(w):
        # M needs no padding: the kernel masks the rows of its last tile
        kern = qmm_lane
    else:
        kern = None
    if kern is not None:
        y = kern(x.reshape(M, K).to(torch.bfloat16).contiguous(), w)
        return y.reshape(*lead, w.shape[0])
    wd = dequantize(w, torch.bfloat16)
    return (x.to(torch.bfloat16).float() @ wd.float().t()).reshape(*lead, w.shape[0])


def qmm_gateup(x: torch.Tensor, w: QTensor, act: str = "silu") -> Optional[torch.Tensor]:
    """act(x @ Wg^T) * (x @ Wu^T) → [..., ff] bf16 from a fused [2ff, K]
    QTensor (the reference's ``qmm_gateup(x, w, act)``), or None when the
    kind/shape is not taken (the caller then runs the unfused qlinear +
    act·mul path).  An act whose kernel form is not ported raises where the
    reference would take its kernel."""
    K = x.shape[-1]
    M = _rows(x)
    if not _gateup_supported(w, K, M) or not _stack_ok(w):
        return None
    kern = qmm_i4t_gateup if w.kind == "i4t" else qmm_i8t_gateup
    y = kern(x.reshape(M, K).to(torch.bfloat16).contiguous(), w, act)
    return y.reshape(*x.shape[:-1], w.shape[0] // 2)
