"""The scale-expansion and i4 probes' kernels: the scale expansion, the
dequantized nibble tiles, the split-half i4 tensor-core dequant matmul and
the M = 1 group-dot with f32 scales.

Counterpart of the Pallas kernels of the JAX package's measurement tools
``tools/expander_probe.py`` (part 1), ``tqmm_probe.py`` (the i4 rung),
``nibble_probe.py`` and ``groupdot_probe.py`` (the port's tools are
``booster_tpu_torch.tools``; their int8 rungs are ``ops.probes``).  Each
function below is a kernel of ``csrc/probe_i4.cu``:

- ``expand`` (kernel E): s [R, C] f32 → [R, width]: column c takes
  s[:, c // g] (repeat) or s[:, c % C] (``tile``), rounded to bf16 first
  with ``bf16``.  Exact.
- ``nibble_tiles`` (kernel F): the dequantized tiles (w_lo, w_hi) f32 of a
  split-half u8 payload [rows, cols] under f32 scale rows [R, rows/32,
  cols], by ``mode`` (below).  Exact.
- ``i4mm`` (kernel G): y [M, N] f32 = x3[:, 0] @ w_lo + x3[:, 1] @ w_hi for
  x3 [M, 2, K/2] bf16 and the payload [K/2, N] u8 (byte row r holds k = r
  in its low nibble and r + K/2 in its high one), scale rows f32 [R,
  K/2/32, N] rounded to bf16.  ``mode`` ``"current"`` (rows [s0, s1]):
  w_h = bf16((nib_h - 8) · bf16(s_h)); ``"i8mask"`` (rows [s0, s1/16]): the
  byte ^ 0x80, w_lo = bf16((lo - 8) · bf16(r0)), w_hi = bf16(16(hi - 8) ·
  bf16(r1)), the same numbers as "current" on rows [s0, s1];
  ``"affine"`` (rows [s0, s1/16, 8·s0]): w_lo = bf16(bf16(lo · bf16(r0)) -
  bf16(r2)), lo unsigned.  ``unpack`` (``UNPACKS``) picks the instructions
  of "current"'s unpack, each the same numbers.
- ``groupdot`` (kernel H): M = 1, unrounded f32 scales, ``fmt`` ``"i4"``:
  out_n = sum_{h,g} s[h,g,n]·(p_hgn - 8·xs_hg) with p the f32 dot of bf16 x
  and the raw nibbles over group g of half h and xs the f32 sum of bf16 x
  over it; ``"i4m"``: s[h]·p - s[2+h]·xs; ``"i8"``: sum_g s[g,n]·p_gn over
  an int8 [K, N] and x [1, K].

``qmm_i4t`` runs the serving path's own kernel (``csrc/qmm_i4t.cu``) on a
probe's payload with its scale rows rounded to bf16 planes (``i4t_weight``,
built once, outside the timed call), counted under keys of its own
(``probe_qmm_i4t_gd`` and ``_dq``): at M > 1 it computes ``i4mm``'s
"current" function on its tensor-core tile, at M = 1 the group-dot with bf16 scales.

Each wrapper runs its plain version for CPU tensors and launches the
kernel for CUDA tensors (or raises).  The plain versions of the matmuls
use f32 matmuls (``torch.backends.cuda.matmul.allow_tf32`` must stay False
on the card) and differ from the kernels by f32 summation order.
"""

from __future__ import annotations

import ctypes

import torch

from booster_tpu_torch.gguf import GGMLType
from booster_tpu_torch.ops import kernels, qmm
from booster_tpu_torch.ops.probes import stream, zero_buffer
from booster_tpu_torch.quant.qtensor import QTensor

_SIGNATURES = {
    "bt_probe_expand": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "bt_probe_nibble": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "bt_probe_i4mm": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "bt_probe_gd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}
G = 32  # rows of a group: Q4_0's, and every probe's
MODES = ("current", "i8mask", "affine")
SCALE_ROWS = {"current": 2, "i8mask": 2, "affine": 3}
UNPACKS = ("i32", "xor88", "magic_f32", "magic_bf16")
FORMATS = ("i4", "i4m", "i8")
_BM, _BN = 64, 128  # the i4mm tile (csrc/probe_i4.cu, i8t_tile.cuh)
_GD_COLS, _GD_ROWS = 128, 256  # a group-dot block's columns and payload rows
_TARGET_BLOCKS = 264  # two blocks for each of the H100's 132 SMs


def i4mm_splits(M: int, K: int, N: int) -> int:
    """K splits of the i4mm tile (whole groups of 32 payload rows): about
    two blocks per SM, at least 2 groups per split.  A function of the shape
    alone, so every mode and unpack at one shape runs one grid."""
    tiles = -(-M // _BM) * (N // _BN)
    return max(1, min(-(-_TARGET_BLOCKS // tiles), (K // 2 // G) // 2))


# -- plain versions ----------------------------------------------------------


def expand_plain(s: torch.Tensor, g: int, width: int, tile: bool = False,
                 bf16: bool = False) -> torch.Tensor:
    """s [R, C] f32 → [R, width] f32: column c takes s[:, c // g], or
    s[:, c % C] with `tile`; rounded to bf16 first with `bf16`."""
    C = s.shape[1]
    c = torch.arange(width, device=s.device)
    v = s[:, c % C if tile else c // g]
    return v.to(torch.bfloat16).float() if bf16 else v.clone()


def expand_bytes(R: int, C: int, g: int, width: int, tile: bool = False) -> int:
    """The bytes the expansion of s [R, C] f32 to [R, width] must move: the
    columns of s it reads (the first ceil(width / g) for a repeat, the first
    min(C, width) for a tile), each once, and the output."""
    cols = min(C, width) if tile else min(C, -(-width // g))
    return 4 * R * (cols + width)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _dequant(q: torch.Tensor, s: torch.Tensor, mode: str) -> tuple:
    """The payload q [rows, cols] u8 under scale rows s [R, rows/32, cols]
    → (w_lo, w_hi) f32 holding bf16 values, with `mode`'s rounding points.
    Every product is exact in f32 before its rounding."""
    sx = _bf16(s).repeat_interleave(G, dim=1)  # [R, rows, cols]
    lo = (q & 0x0F).to(torch.int32)
    if mode == "current":
        hi = (q >> 4).to(torch.int32) - 8
        return _bf16((lo - 8).float() * sx[0]), _bf16(hi.float() * sx[1])
    if mode not in ("i8mask", "affine"):
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    hi16 = (q ^ 0x80).view(torch.int8).to(torch.int32) & ~0x0F  # 16·(hi - 8)
    w_hi = _bf16(hi16.float() * sx[1])
    if mode == "i8mask":
        return _bf16((lo - 8).float() * sx[0]), w_hi
    return _bf16(_bf16(lo.float() * sx[0]) - sx[2]), w_hi


def nibble_tiles_plain(q: torch.Tensor, s: torch.Tensor, mode: str) -> tuple:
    """(w_lo, w_hi) f32 [rows, cols] of the payload q under scale rows s."""
    return _dequant(q, s, mode)


def i4mm_plain(x3: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
               mode: str = "current") -> torch.Tensor:
    """x3 [M, 2, K/2] bf16 @ the split-half payload q [K/2, N] under scale
    rows s [R, K/2/32, N] → [M, N] f32 (see the module doc)."""
    w_lo, w_hi = _dequant(q, s, mode)
    M = x3.shape[0]
    return x3.reshape(M, -1).float() @ torch.cat([w_lo, w_hi])


def groupdot_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, fmt: str) -> torch.Tensor:
    """The M = 1 group-dot → [1, N] f32: x [1, 2, K/2] (i4, i4m) or [1, K]
    (i8) bf16, q [K/2, N] u8 or [K, N] int8, s f32 [2 | 4 | 1, groups, N]."""
    N = q.shape[1]
    xf = x.float().reshape(-1)
    if fmt == "i8":
        ng = q.shape[0] // G
        p = torch.bmm(xf.reshape(ng, 1, G), q.float().reshape(ng, G, N)).reshape(ng, N)
        return (s[0] * p).sum(0, keepdim=True)
    if fmt not in ("i4", "i4m"):
        raise ValueError(f"fmt {fmt!r}: one of {FORMATS}")
    half = q.shape[0]
    ng = half // G
    planes = torch.stack([q & 0x0F, q >> 4]).float()  # [2, half, N]
    xh = xf.reshape(2 * ng, 1, G)
    p = torch.bmm(xh, planes.reshape(2 * ng, G, N)).reshape(2, ng, N)
    xs = xh.reshape(2, ng, G).sum(-1, keepdim=True)  # [2, ng, 1]
    c = s[:2] * (p - 8.0 * xs) if fmt == "i4" else s[:2] * p - s[2:4] * xs
    return c.sum((0, 1)).reshape(1, N)


def i4t_weight(q: torch.Tensor, s: torch.Tensor, zero: int = 8) -> QTensor:
    """The probe's payload q [K/2, N] with its f32 scale rows s [R, K/2/32,
    N] rounded to the i4t kernel's bf16 planes, `zero` subtracted from each
    nibble and rows 2-3 as mins (at M = 1)."""
    half, N = q.shape
    return QTensor("i4t", q, s.to(torch.bfloat16).contiguous(), None, G, (N, 2 * half),
                   GGMLType.Q4_0, zero=zero)


def qmm_i4t_plain(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """The serving path's i4t matmul of x [M, K] (or x3) by an i4t_weight."""
    return qmm.qmm_plain(x.reshape(x.shape[0], -1), w)


# -- kernels -----------------------------------------------------------------


def _lib():
    return kernels.library("probe_i4", _SIGNATURES)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def expand(s: torch.Tensor, g: int, width: int, tile: bool = False,
           bf16: bool = False) -> torch.Tensor:
    """Kernel-level entry of the scale expansion (expand_plain's arguments):
    the plain version for CPU tensors, csrc/probe_i4.cu's expand_kernel for
    CUDA tensors."""
    if s.device.type == "cpu":
        return expand_plain(s, g, width, tile, bf16)
    _check(s.dtype == torch.float32 and s.dim() == 2 and s.is_contiguous(),
           "expand kernel: s must be contiguous f32 [R, C]")
    R, C = s.shape
    if not tile and width > C * g:
        raise ValueError(f"expand kernel: width {width} reads past the {C} columns of s")
    out = torch.empty(R, width, dtype=torch.float32, device=s.device)
    rc = _lib().bt_probe_expand(s.data_ptr(), out.data_ptr(), R, C, width, g, int(tile),
                                int(bf16), stream(s))
    kernels.check(rc, "probe_expand")
    kernels.count("probe_expand", (f"{'tile' if tile else 'repeat'}{'.bf16' if bf16 else ''}",
                                   R, width))
    return out


def nibble_tiles(q: torch.Tensor, s: torch.Tensor, mode: str) -> tuple:
    """Kernel-level entry of the dequantized tiles: the plain version for
    CPU tensors, csrc/probe_i4.cu's nibble_kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return nibble_tiles_plain(q, s, mode)
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    _check(q.dtype == torch.uint8 and q.dim() == 2 and q.is_contiguous(),
           "nibble kernel: q must be contiguous u8 [rows, cols]")
    rows, cols = q.shape
    want = (SCALE_ROWS[mode], rows // G, cols)
    _check(rows % G == 0 and s.dtype == torch.float32 and tuple(s.shape) == want
           and s.is_contiguous() and s.device == q.device,
           f"nibble kernel: rows a multiple of {G}, scales contiguous f32 {list(want)}")
    lo = torch.empty(rows, cols, dtype=torch.float32, device=q.device)
    hi = torch.empty_like(lo)
    rc = _lib().bt_probe_nibble(q.data_ptr(), s.data_ptr(), lo.data_ptr(), hi.data_ptr(), rows,
                                cols, MODES.index(mode), stream(q))
    kernels.check(rc, "probe_nibble")
    kernels.count("probe_nibble", (mode, rows, cols))
    return lo, hi


def i4mm(x3: torch.Tensor, q: torch.Tensor, s: torch.Tensor, mode: str = "current",
         unpack: str = "i32") -> torch.Tensor:
    """Kernel-level entry of the split-half i4 dequant matmul (i4mm_plain's
    arguments, `unpack` one of UNPACKS for mode "current"): the plain
    version for CPU tensors, csrc/probe_i4.cu's i4mm_kernel (mma.sync) for
    CUDA tensors."""
    if x3.device.type == "cpu":
        return i4mm_plain(x3, q, s, mode)
    if mode not in MODES or unpack not in UNPACKS or mode != "current" and unpack != "i32":
        raise NotImplementedError(f"i4mm kernel: mode {mode!r}, unpack {unpack!r}: not "
                                  f"ported yet (modes {MODES}; unpacks {UNPACKS} of "
                                  "'current')")
    M = x3.shape[0]
    _check(x3.dtype == torch.bfloat16 and x3.dim() == 3 and x3.shape[1] == 2
           and x3.is_contiguous() and x3.data_ptr() % 16 == 0,
           "i4mm kernel: x3 must be contiguous bf16 [M, 2, K/2] on 16 bytes")
    half, N = q.shape
    K = 2 * half
    _check(q.dtype == torch.uint8 and q.is_contiguous() and q.data_ptr() % 16 == 0
           and x3.shape[2] == half, f"i4mm kernel: payload must be contiguous u8 [{K // 2}, N]")
    want = (SCALE_ROWS[mode], half // G, N)
    _check(s.dtype == torch.float32 and tuple(s.shape) == want and s.is_contiguous(),
           f"i4mm kernel: scale rows must be contiguous f32 {list(want)}")
    _check(q.device == x3.device == s.device, "i4mm kernel: all operands must be on one device")
    if N % _BN or half % G:
        raise NotImplementedError(f"i4mm kernel: N = {N}, K = {K}: not ported yet (N a "
                                  "multiple of 128, K of 64)")
    ks = i4mm_splits(M, K, N)
    out = torch.empty(M, N, dtype=torch.float32, device=x3.device)
    part = torch.empty(ks * M * N, dtype=torch.float32, device=x3.device) if ks > 1 else None
    tickets = zero_buffer(x3.device, "tickets", -(-M // _BM) * (N // _BN))
    rc = _lib().bt_probe_i4mm(x3.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                              None if part is None else part.data_ptr(), tickets.data_ptr(),
                              M, K, N, ks, MODES.index(mode), UNPACKS.index(unpack),
                              stream(x3))
    kernels.check(rc, "probe_i4mm")
    kernels.count("probe_i4mm", (f"{mode}.{unpack}", K, N))
    return out


def groupdot(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, fmt: str) -> torch.Tensor:
    """Kernel-level entry of the M = 1 group-dot (groupdot_plain's
    arguments): the plain version for CPU tensors, csrc/probe_i4.cu's
    gd_kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return groupdot_plain(x, q, s, fmt)
    if fmt not in FORMATS:
        raise ValueError(f"fmt {fmt!r}: one of {FORMATS}")
    i4 = fmt != "i8"
    rows, N = q.shape
    K = 2 * rows if i4 else rows
    _check(x.dtype == torch.bfloat16 and x.is_contiguous() and x.numel() == K
           and x.shape[0] == 1, f"groupdot kernel: x must be contiguous bf16 with 1 row of {K}")
    _check(q.dtype == (torch.uint8 if i4 else torch.int8) and q.is_contiguous()
           and q.data_ptr() % 16 == 0,
           f"groupdot kernel: the payload must be contiguous {'u8' if i4 else 'int8'} [rows, N]")
    want = ({"i4": 2, "i4m": 4, "i8": 1}[fmt], rows // G, N)
    _check(s.dtype == torch.float32 and tuple(s.shape) == want and s.is_contiguous(),
           f"groupdot kernel: scales must be contiguous f32 {list(want)}")
    _check(q.device == x.device == s.device, "groupdot kernel: all operands must be on one "
           "device")
    if N % _GD_COLS or rows % G:
        raise NotImplementedError(f"groupdot kernel: N = {N}, {rows} payload rows: not ported "
                                  "yet (N a multiple of 128, rows of 32)")
    ks = -(-rows // _GD_ROWS)
    out = torch.empty(1, N, dtype=torch.float32, device=x.device)
    part = torch.empty(ks * N, dtype=torch.float32, device=x.device) if ks > 1 else None
    tickets = zero_buffer(x.device, "tickets", N // _GD_COLS)
    rc = _lib().bt_probe_gd(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                            None if part is None else part.data_ptr(), tickets.data_ptr(), K, N,
                            FORMATS.index(fmt), stream(x))
    kernels.check(rc, "probe_gd")
    kernels.count("probe_gd", (fmt, K, N))
    return out


def qmm_i4t(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """The serving path's i4t kernel (csrc/qmm_i4t.cu, unchanged) on an
    i4t_weight (qmm_i4t_plain's arguments), its launch counted as
    probe_qmm_i4t_gd (M = 1) or probe_qmm_i4t_dq: the plain version for CPU
    tensors."""
    x2 = x.reshape(x.shape[0], -1)
    if x.device.type == "cpu":
        return qmm.qmm_plain(x2, w)
    out = qmm.qmm_i4t(x2, w)
    form = "_gd" if x2.shape[0] == 1 else "_dq"
    kernels.recount("qmm_i4t" + form, "probe_qmm_i4t" + form, (x2.shape[1], w.shape[0]))
    return out
