"""The i8 stream probes' kernels: the column-sum read, the int8-weight
tensor-core dot and its per-group rescale form.

Counterpart of the Pallas kernels of the JAX package's measurement tools
``tools/kernel_micro.py``, ``cast_probe.py``, ``mmq_probe.py``,
``qmm_gap.py`` and ``qmm_probe.py`` (the port's tools are
``booster_tpu_torch.tools``).  Their 21 Pallas functions compute three
functions of the data, each a kernel of ``csrc/probe_i8.cu``:

- ``colsum`` (kernel A): column sums of a u8 or i8 [R, C] array into f32
  [1, C], by mode: ``"i32"`` (each block of ``block_rows`` rows summed in
  i32, the blocks added in f32), ``"f32"``, ``"bf16"`` (each block's sum
  rounded to bf16, the block sums added in f32).  Exact: the kernel equals
  ``colsum_plain`` bit for bit.
- ``i8mm`` (kernel B): x [M, K] (bf16 or int8) against an int8 weight stored
  K-major [K, N] or N-major [N, K] (``n_major``).  bf16 x: y = x @ w in f32
  with w = bf16(q), or under a scale w = bf16(q · s) rounded once (``scale``
  ``"plane"``: a bf16 [K, N] plane; ``"group"``: bf16 [K/32, N] rows, row k
  taking s[k // 32], or over an N-major weight f32 or bf16 [N, K/32] rounded
  to bf16 first; ``"reorder"``: row r of K block b of ``bk`` rows takes
  scale row b·bk/32 + r % (bk/32)).  int8 x: the exact integer product, in
  i32 (``out_i32``) or converted to f32.
- ``i8mm_group`` (kernel C): per-group partial products over ``group`` (32
  or 128) rows of K, each (i32 for int8 x, f32 for bf16 x) times its group's
  scale (the row of its first 32 rows of a [K/32, N] plane, or [N, K/32]
  over an N-major weight) and summed in f32.

Each wrapper runs its plain version for CPU tensors and launches the
kernel for CUDA tensors (or raises).  The plain versions of the int8 dots
multiply in float64, which is exact here (sums below 2^53), and cast to
i32: the card has no integer matmul.  The bf16 forms' plain versions use f32
matmuls (``torch.backends.cuda.matmul.allow_tf32`` must stay False, its
default, on the card); they differ from the kernel by f32 summation order.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from booster_tpu_torch.ops import kernels

_SIGNATURES = {
    "bt_probe_colsum": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "bt_probe_i8mm": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "bt_probe_i8mm_group": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
}
BLOCK_ROWS = 1024  # rows per block of the column sums (the tools' BN)
SUM_MODES = ("i32", "f32", "bf16")
SCALES = ("none", "plane", "group", "reorder")
SCALE_ROWS = 32  # rows of K per scale row (Q8_0's group)
_CS_COLS, _CS_ROWS = 1024, 32  # a colsum block's columns and batch of rows (csrc/probe_i8.cu)
_BM, _BN, _UNIT = 64, 128, 128  # the i8mm tile and its split unit of K rows
_TARGET_BLOCKS = 264  # two blocks for each of the H100's 132 SMs

# the kernels' forms (bt_probe_i8mm / _group's `form`): x_i8 | n_major << 1 |
# scale << 2 | s_f32 << 4 | out_i32 << 5, and for the group form G 128 << 6
_MM_FORMS = {0 | 2, 1 | 2, 1 | 2 | 32, 1 | 32, 0, 1 << 2, 2 << 2, 3 << 2, 2 | (2 << 2) | 16}
_GROUP_FORMS = {1, 1 | 2 | 16, 0, 64}

# per device: zeros the kernels' last blocks reset after use ("tickets":
# int32 arrival counters; "acc": the column sums' per-block totals)
_zeros: dict = {}


def _zero_buffer(device: torch.device, what: str, n: int) -> torch.Tensor:
    t = _zeros.get((device, what))
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _zeros[(device, what)] = t
    return t


def splits(M: int, K: int, N: int) -> int:
    """K splits of the i8mm tile for y [M, N] = x [M, K] @ W: enough blocks
    for two per SM, at least 2 units of 128 rows of K per split.  A function
    of the shape alone, so every form at one shape runs one grid."""
    tiles = -(-M // _BM) * (N // _BN)
    return max(1, min(-(-_TARGET_BLOCKS // tiles), (K // _UNIT) // 2))


# -- plain versions ----------------------------------------------------------


def colsum_plain(q: torch.Tensor, mode: str, block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """q [R, C] u8 or i8 → [1, C] f32: each block of `block_rows` rows summed
    (i32, f32, or f32 rounded to bf16 by `mode`), the blocks added in f32."""
    R, C = q.shape
    b = q.reshape(R // block_rows, block_rows, C)
    if mode == "i32":
        s = b.to(torch.int32).sum(1, dtype=torch.int32).float()
    elif mode == "f32":
        s = b.float().sum(1)
    elif mode == "bf16":
        s = b.float().sum(1).to(torch.bfloat16).float()
    else:
        raise ValueError(f"colsum mode {mode!r}: one of {SUM_MODES}")
    return s.sum(0, keepdim=True)


def _kn(q: torch.Tensor, n_major: bool) -> torch.Tensor:
    """The weight as a [K, N] view."""
    return q.t() if n_major else q


def _group_rows(s: torch.Tensor, n_major: bool) -> torch.Tensor:
    """Group scales as f32 [K/32, N] (exact for bf16; f32 as given)."""
    return s.float().t() if n_major else s.float()


def _scale_plane(s: torch.Tensor, scale: str, K: int, n_major: bool = False,
                bk: int = 0) -> torch.Tensor:
    """The bf16 scale each weight [K, N] takes under `scale`, in f32."""
    if scale == "plane":
        return s.float()
    if n_major:  # f32 group scales are rounded to bf16 before the product
        sg = s.to(torch.bfloat16).float().t()
    else:
        sg = s.float()
    k = torch.arange(K, device=s.device)
    if scale == "group":
        rows = k // SCALE_ROWS
    elif scale == "reorder":
        rows = (k // bk) * (bk // SCALE_ROWS) + (k % bk) % (bk // SCALE_ROWS)
    else:
        raise ValueError(f"scale {scale!r}: one of {SCALES}")
    return sg[rows]


def _int_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact i32 product of int8 operands (batched or not)."""
    return torch.matmul(x.double(), w.double()).to(torch.int32)


def i8mm_plain(x: torch.Tensor, q: torch.Tensor, n_major: bool = False,
               s: Optional[torch.Tensor] = None, scale: str = "none", bk: int = 0,
               out_i32: bool = False) -> torch.Tensor:
    """x [M, K] @ the int8 weight (see the module doc) → [M, N] f32, or i32
    for int8 x with `out_i32`."""
    w = _kn(q, n_major)
    if x.dtype == torch.int8:
        y = _int_dot(x, w)
        return y if out_i32 else y.float()
    wf = w.float()
    if scale != "none":
        wf = (wf * _scale_plane(s, scale, w.shape[0], n_major, bk)).to(torch.bfloat16).float()
    return x.float() @ wf


def i8mm_group_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, n_major: bool = False,
                     group: int = 32) -> torch.Tensor:
    """sum over groups g of `group` rows of K: (x @ W)_g · s_g → [M, N] f32,
    the partial in i32 (int8 x, exact) or f32 (bf16 x) before the scale."""
    M, K = x.shape
    w = _kn(q, n_major)
    ng = K // group
    xg = x.reshape(M, ng, group).transpose(0, 1)  # [ng, M, G]
    wg = w.reshape(ng, group, -1)  # [ng, G, N]
    if x.dtype == torch.int8:
        d = _int_dot(xg, wg).float()
    else:
        d = torch.matmul(xg.float(), wg.float())
    sg = _group_rows(s, n_major)[::group // SCALE_ROWS]  # the row of each group's first 32
    return (d * sg[:, None, :]).sum(0)


# -- kernels -----------------------------------------------------------------


def _check_x(x: torch.Tensor, what: str) -> None:
    if x.dtype not in (torch.bfloat16, torch.int8) or x.dim() != 2 or not x.is_contiguous() \
            or x.data_ptr() % 16:
        raise ValueError(f"{what} kernel: x must be contiguous [M, K] bf16 or int8 on 16 bytes")


def _check_q(q: torch.Tensor, K: int, n_major: bool, what: str) -> int:
    if q.dtype != torch.int8 or q.dim() != 2 or not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError(f"{what} kernel: the weight must be contiguous int8 on 16 bytes")
    if (q.shape[1] if n_major else q.shape[0]) != K:
        raise ValueError(f"{what} kernel: weight {tuple(q.shape)} does not take K = {K} "
                         f"({'N' if n_major else 'K'}-major)")
    return q.shape[0] if n_major else q.shape[1]


def _scratch(x: torch.Tensor, M: int, N: int, ks: int, dtype) -> tuple:
    part = torch.empty(ks * M * N, dtype=dtype, device=x.device) if ks > 1 else None
    tickets = _zero_buffer(x.device, "tickets", -(-M // _BM) * (N // _BN))
    return part, tickets


def colsum(q: torch.Tensor, mode: str, block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """Kernel-level entry of the column sums: the plain version for CPU
    tensors, csrc/probe_i8.cu's colsum_kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return colsum_plain(q, mode, block_rows)
    if mode not in SUM_MODES:
        raise ValueError(f"colsum mode {mode!r}: one of {SUM_MODES}")
    if q.dtype not in (torch.uint8, torch.int8) or q.dim() != 2 or not q.is_contiguous() \
            or q.data_ptr() % 16:
        raise ValueError("colsum kernel: q must be contiguous [R, C] u8 or int8 on 16 bytes")
    R, C = q.shape
    if C % _CS_COLS or block_rows % _CS_ROWS or R % block_rows:
        raise NotImplementedError(f"colsum kernel: R = {R}, C = {C}, blocks of {block_rows} "
                                  "rows: not ported yet (C a multiple of 1024, R of the "
                                  "block, the block of 32)")
    out = torch.empty(1, C, dtype=torch.float32, device=q.device)
    acc = _zero_buffer(q.device, "acc", R // block_rows * C)
    tickets = _zero_buffer(q.device, "tickets", C // _CS_COLS)
    lib = kernels.library("probe_i8", _SIGNATURES)
    rc = lib.bt_probe_colsum(q.data_ptr(), out.data_ptr(), acc.data_ptr(), tickets.data_ptr(),
                             R, C, block_rows, SUM_MODES.index(mode), int(q.dtype == torch.int8),
                             torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(rc, "probe_colsum")
    kernels.count("probe_colsum", (f"{mode}.{'i8' if q.dtype == torch.int8 else 'u8'}", R, C))
    return out


def i8mm(x: torch.Tensor, q: torch.Tensor, n_major: bool = False,
         s: Optional[torch.Tensor] = None, scale: str = "none", bk: int = 0,
         out_i32: bool = False) -> torch.Tensor:
    """Kernel-level entry of the int8-weight dot (i8mm_plain's arguments):
    the plain version for CPU tensors, csrc/probe_i8.cu's i8mm_kernel for
    CUDA tensors."""
    if x.device.type == "cpu":
        return i8mm_plain(x, q, n_major, s, scale, bk, out_i32)
    _check_x(x, "i8mm")
    M, K = x.shape
    N = _check_q(q, K, n_major, "i8mm")
    x_i8 = x.dtype == torch.int8
    if scale not in SCALES:
        raise ValueError(f"scale {scale!r}: one of {SCALES}")
    s_f32 = s is not None and s.dtype == torch.float32
    form = (int(x_i8) | int(n_major) << 1 | SCALES.index(scale) << 2 | int(s_f32) << 4
            | int(out_i32) << 5)
    if form not in _MM_FORMS or out_i32 and not x_i8:
        raise NotImplementedError(f"i8mm kernel: x {x.dtype}, {'N' if n_major else 'K'}-major, "
                                  f"scale {scale} ({s.dtype if s is not None else None}), "
                                  f"{'i32' if out_i32 else 'f32'} out: not ported yet")
    if N % _BN or K % _UNIT or scale == "reorder" and (bk % SCALE_ROWS or K % bk):
        raise NotImplementedError(f"i8mm kernel: N = {N}, K = {K}, bk = {bk}: not ported yet "
                                  "(N, K multiples of 128; K of bk, bk of 32)")
    if scale != "none":
        want = {"plane": (K, N), "group": (N, K // SCALE_ROWS) if n_major
                else (K // SCALE_ROWS, N), "reorder": (K // SCALE_ROWS, N)}[scale]
        if s is None or tuple(s.shape) != want or not s.is_contiguous() \
                or s.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"i8mm kernel: {scale} scales must be contiguous {list(want)}")
    if any(t is not None and t.device != x.device for t in (q, s)):
        raise ValueError("i8mm kernel: all operands must be on one device")
    ks = splits(M, K, N)
    out = torch.empty(M, N, dtype=torch.int32 if out_i32 else torch.float32, device=x.device)
    part, tickets = _scratch(x, M, N, ks, torch.int32 if x_i8 else torch.float32)
    lib = kernels.library("probe_i8", _SIGNATURES)
    rc = lib.bt_probe_i8mm(x.data_ptr(), q.data_ptr(), None if s is None else s.data_ptr(),
                           out.data_ptr(), None if part is None else part.data_ptr(),
                           tickets.data_ptr(), M, K, N, ks, bk, form,
                           torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(rc, "probe_i8mm")
    kernels.count("probe_i8mm", (f"{'i8' if x_i8 else 'bf16'}.{'n' if n_major else 'k'}.{scale}"
                                 f"{'.i32' if out_i32 else ''}", K, N))
    return out


def i8mm_group(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, n_major: bool = False,
               group: int = 32) -> torch.Tensor:
    """Kernel-level entry of the per-group rescale form (i8mm_group_plain's
    arguments): the plain version for CPU tensors, csrc/probe_i8.cu's
    i8mm_group_kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return i8mm_group_plain(x, q, s, n_major, group)
    _check_x(x, "i8mm_group")
    M, K = x.shape
    N = _check_q(q, K, n_major, "i8mm_group")
    x_i8 = x.dtype == torch.int8
    s_f32 = s.dtype == torch.float32
    form = int(x_i8) | int(n_major) << 1 | int(s_f32) << 4 | int(group == 128) << 6
    if group not in (32, 128) or form not in _GROUP_FORMS:
        raise NotImplementedError(f"i8mm_group kernel: x {x.dtype}, "
                                  f"{'N' if n_major else 'K'}-major, {s.dtype} scales, "
                                  f"group {group}: not ported yet")
    if N % _BN or K % _UNIT:
        raise NotImplementedError(f"i8mm_group kernel: N = {N}, K = {K}: not ported yet "
                                  "(multiples of 128)")
    want = (N, K // SCALE_ROWS) if n_major else (K // SCALE_ROWS, N)
    if tuple(s.shape) != want or not s.is_contiguous():
        raise ValueError(f"i8mm_group kernel: scales must be contiguous {list(want)}")
    if q.device != x.device or s.device != x.device:
        raise ValueError("i8mm_group kernel: all operands must be on one device")
    ks = splits(M, K, N)
    out = torch.empty(M, N, dtype=torch.float32, device=x.device)
    part, tickets = _scratch(x, M, N, ks, torch.float32)
    lib = kernels.library("probe_i8", _SIGNATURES)
    rc = lib.bt_probe_i8mm_group(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                                 None if part is None else part.data_ptr(), tickets.data_ptr(),
                                 M, K, N, ks, form,
                                 torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(rc, "probe_i8mm_group")
    kernels.count("probe_i8mm_group", (f"{'i8' if x_i8 else 'bf16'}.{'n' if n_major else 'k'}"
                                       f".g{group}", K, N))
    return out
