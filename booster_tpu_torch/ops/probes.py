"""The i8 stream probes' kernels: the column-sum read, the int8-weight
tensor-core dot, its per-group rescale form and a block sum.

Counterpart of the Pallas kernels of the JAX package's measurement tools
``tools/kernel_micro.py``, ``cast_probe.py``, ``mmq_probe.py``,
``qmm_gap.py`` and ``qmm_probe.py``, and of the int8 rungs of
``tools/expander_probe.py`` and ``tqmm_probe.py`` (the port's tools are
``booster_tpu_torch.tools``; the 4-bit and scale-expansion rungs are
``ops.probes_i4``).  They compute four functions of the data, each a kernel
of ``csrc/probe_i8.cu``:

- ``colsum`` (kernel A): column sums of a u8 or i8 [R, C] array into f32
  [1, C], by mode: ``"i32"`` (each block of ``block_rows`` rows summed in
  i32, the blocks added in f32), ``"f32"``, ``"bf16"`` (each block's sum
  rounded to bf16, the block sums added in f32).  Exact: the kernel equals
  ``colsum_plain`` bit for bit.
- ``i8mm`` (kernel B): x [M, K] (bf16 or int8) against an int8 weight stored
  K-major [K, N] or N-major [N, K] (``n_major``).  bf16 x: y = x @ w in f32
  with w = bf16(q), or under a scale w = bf16(q · bf16(s)) rounded once
  (``scale`` ``"plane"``: a bf16 [K, N] plane; ``"group"``: [K/32, N] rows,
  or [N, K/32] over an N-major weight, row k taking s[k // 32];
  ``"reorder"``: row r of K block b of ``bk`` rows takes scale row
  b·bk/32 + r % (bk/32); ``"tile"``: row k takes s[k % (K/32)]).  Group and
  tile scales may be f32, rounded to bf16 first.  int8 x: the exact integer
  product, in i32 (``out_i32``) or converted to f32; against an N-major
  weight it runs kernel E, ``s8mm_kernel`` (``wgmma``, one block a whole
  tile of ``s8_rows`` rows), counted as ``probe_s8mm``.
- ``i8mm_group`` (kernel C): per-group partial products over ``group`` (32
  or 128) rows of K, each (i32 for int8 x, f32 for bf16 x) times its group's
  scale (the row of its first 32 rows of a [K/32, N] plane, or [N, K/32]
  over an N-major weight, or the transpose of either: the kernel reads the
  scales through their strides) and summed in f32.
- ``blocksum`` (kernel D): expander_probe's castonly, every output of N
  tile t (``bn`` rows of an N-major weight) the f32 sum over K pieces j
  (``sub`` columns) of f32(S_tj) · f32(1e-9), S_tj the tile's exact integer
  sum over the piece.

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
    "bt_probe_i8mm_group": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "bt_probe_blocksum": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "bt_probe_s8mm": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "bt_probe_s8_smem": [ctypes.c_int],
}
BLOCK_ROWS = 1024  # rows per block of the column sums (the tools' BN)
SUM_MODES = ("i32", "f32", "bf16")
SCALES = ("none", "plane", "group", "reorder", "tile")
SCALE_ROWS = 32  # rows of K per scale row (Q8_0's group)
_CS_COLS, _CS_ROWS = 1024, 32  # a colsum block's columns and batch of rows (csrc/probe_i8.cu)
_BM, _BN, _UNIT = 64, 128, 128  # the i8mm tile and its split unit of K rows
_TARGET_BLOCKS = 264  # two blocks for each of the H100's 132 SMs
_S8_ROWS = 128  # weight rows of the s8 kernel's tile (csrc/probe_i8.cu E)


def _mm_form(x_i8: bool, n_major: bool, scale: str, s_f32: bool, out_i32: bool) -> int:
    """bt_probe_i8mm's `form` (csrc/probe_i8.cu mm_form)."""
    return (int(x_i8) | int(n_major) << 1 | int(s_f32) << 2 | int(out_i32) << 3
            | SCALES.index(scale) << 4)


def _group_form(x_i8: bool, n_major: bool, s_f32: bool, group: int) -> int:
    """bt_probe_i8mm_group's `form` (csrc/probe_i8.cu group_form)."""
    return int(x_i8) | int(n_major) << 1 | int(s_f32) << 2 | int(group == 128) << 3


# the forms the kernels are built for: (x_i8, n_major, scale, s_f32, out_i32)
# and (x_i8, n_major, s_f32, group); int8 x against an N-major weight is the
# s8 kernel's (_s8mm)
_MM_FORMS = {_mm_form(*f) for f in (
    (False, True, "none", False, False), (True, False, "none", False, True),
    (False, False, "none", False, False), (False, False, "plane", False, False),
    (False, False, "group", False, False), (False, False, "reorder", False, False),
    (False, True, "group", True, False), (False, True, "tile", True, False),
    (False, False, "group", True, False), (False, False, "tile", True, False))}
_GROUP_FORMS = {_group_form(*f) for f in (
    (True, False, False, 32), (True, True, True, 32), (False, False, False, 32),
    (False, False, False, 128), (False, True, True, 32))}

# per device: zeros the kernels' last blocks reset after use ("tickets":
# int32 arrival counters; "acc": the column sums' per-block totals; "part":
# the block sums' per-piece totals)
_zeros: dict = {}


def zero_buffer(device: torch.device, what: str, n: int) -> torch.Tensor:
    """At least `n` int32 zeros on `device` for the kernels' `what` (shared
    with ops.probes_i4's kernels, which reset them as these do)."""
    t = _zeros.get((device, what))
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _zeros[(device, what)] = t
    return t


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of `t`'s device, as the kernels take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def splits(M: int, K: int, N: int) -> int:
    """K splits of the i8mm tile for y [M, N] = x [M, K] @ W: enough blocks
    for two per SM, at least 2 units of 128 rows of K per split.  A function
    of the shape alone, so every form at one shape runs one grid."""
    tiles = -(-M // _BM) * (N // _BN)
    return max(1, min(-(-_TARGET_BLOCKS // tiles), (K // _UNIT) // 2))


def s8_rows(M: int) -> int:
    """Rows of x a tile of the s8 kernel (int8 x against an N-major weight):
    the least of 8, 16, 32 and 64 that holds M, 64 above.  The kernel runs
    one block a tile over all of K (on the H100 every split of K measured
    slower than whole tiles); its ring and shared memory follow from these
    rows in csrc/probe_i8.cu (S8Cfg, ``bt_probe_s8_smem``)."""
    return next((b for b in (8, 16, 32) if M <= b), 64)


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
    """The bf16 scale each weight [K, N] takes under `scale`, in f32 (f32
    scales rounded to bf16 before the product)."""
    sg = s.to(torch.bfloat16).float()
    if scale == "plane":
        return sg
    if n_major:
        sg = sg.t()
    k = torch.arange(K, device=s.device)
    if scale == "group":
        rows = k // SCALE_ROWS
    elif scale == "reorder":
        rows = (k // bk) * (bk // SCALE_ROWS) + (k % bk) % (bk // SCALE_ROWS)
    elif scale == "tile":
        rows = k % (K // SCALE_ROWS)
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


def blocksum_plain(q: torch.Tensor, m: int, bn: int, sub: int) -> torch.Tensor:
    """expander_probe's castonly over the N-major int8 q [N, K] → [m, N] f32:
    every output of N tile t is the f32 sum over pieces j, in order, of
    f32(S_tj) · f32(1e-9), S_tj the exact sum of q over rows t·bn + [0, bn)
    and columns j·sub + [0, sub)."""
    N, K = q.shape
    S = q.reshape(N // bn, bn, K // sub, sub).to(torch.int64).sum((1, 3)).to(torch.int32)
    acc = torch.zeros(N // bn, dtype=torch.float32, device=q.device)
    scale = torch.full((), 1e-9, dtype=torch.float32, device=q.device)  # castonly's f32(1e-9)
    for j in range(K // sub):
        acc = acc + S[:, j].float() * scale
    return acc.repeat_interleave(bn).expand(m, N).contiguous()


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
    tickets = zero_buffer(x.device, "tickets", -(-M // _BM) * (N // _BN))
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
    acc = zero_buffer(q.device, "acc", R // block_rows * C)
    tickets = zero_buffer(q.device, "tickets", C // _CS_COLS)
    lib = kernels.library("probe_i8", _SIGNATURES)
    rc = lib.bt_probe_colsum(q.data_ptr(), out.data_ptr(), acc.data_ptr(), tickets.data_ptr(),
                             R, C, block_rows, SUM_MODES.index(mode), int(q.dtype == torch.int8),
                             stream(q))
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
    if x_i8 and n_major and scale == "none":
        return _s8mm(x, q, M, K, N, out_i32)
    if scale not in SCALES:
        raise ValueError(f"scale {scale!r}: one of {SCALES}")
    s_f32 = s is not None and s.dtype == torch.float32
    form = _mm_form(x_i8, n_major, scale, s_f32, out_i32)
    if form not in _MM_FORMS or out_i32 and not x_i8:
        raise NotImplementedError(f"i8mm kernel: x {x.dtype}, {'N' if n_major else 'K'}-major, "
                                  f"scale {scale} ({s.dtype if s is not None else None}), "
                                  f"{'i32' if out_i32 else 'f32'} out: not ported yet")
    if N % _BN or K % _UNIT or scale == "reorder" and (bk % SCALE_ROWS or K % bk) \
            or scale == "tile" and K % (16 * SCALE_ROWS):
        raise NotImplementedError(f"i8mm kernel: N = {N}, K = {K}, bk = {bk}: not ported yet "
                                  "(N, K multiples of 128; K of bk, bk of 32; K of 512 for "
                                  "tile scales)")
    if scale != "none":
        rows = (N, K // SCALE_ROWS) if n_major else (K // SCALE_ROWS, N)
        want = {"plane": (K, N), "group": rows, "reorder": rows, "tile": rows}[scale]
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
                           tickets.data_ptr(), M, K, N, ks, bk, form, stream(x))
    kernels.check(rc, "probe_i8mm")
    kernels.count("probe_i8mm", (f"{'i8' if x_i8 else 'bf16'}.{'n' if n_major else 'k'}.{scale}"
                                 f"{'.f32' if s_f32 else ''}{'.i32' if out_i32 else ''}", K, N))
    return out


def _s8mm(x: torch.Tensor, q: torch.Tensor, M: int, K: int, N: int,
          out_i32: bool) -> torch.Tensor:
    """int8 x @ the N-major int8 q^T on csrc/probe_i8.cu's s8mm_kernel."""
    if N % _S8_ROWS or K % 128:
        raise NotImplementedError(f"i8mm kernel: N = {N}, K = {K}: not ported yet "
                                  "(multiples of 128)")
    if q.device != x.device:
        raise ValueError("i8mm kernel: all operands must be on one device")
    out = torch.empty(M, N, dtype=torch.int32 if out_i32 else torch.float32, device=x.device)
    lib = kernels.library("probe_i8", _SIGNATURES)
    rc = lib.bt_probe_s8mm(x.data_ptr(), q.data_ptr(), out.data_ptr(), M, K, N, s8_rows(M),
                           int(out_i32), stream(x))
    kernels.check(rc, "probe_s8mm")
    kernels.count("probe_s8mm", (f"i8.n.none{'.i32' if out_i32 else ''}", K, N))
    return out


def i8mm_group(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, n_major: bool = False,
               group: int = 32) -> torch.Tensor:
    """Kernel-level entry of the per-group rescale form (i8mm_group_plain's
    arguments; `s` may be the transpose of a contiguous plane): the plain
    version for CPU tensors, csrc/probe_i8.cu's i8mm_group_kernel for CUDA
    tensors."""
    if x.device.type == "cpu":
        return i8mm_group_plain(x, q, s, n_major, group)
    _check_x(x, "i8mm_group")
    M, K = x.shape
    N = _check_q(q, K, n_major, "i8mm_group")
    x_i8 = x.dtype == torch.int8
    s_f32 = s.dtype == torch.float32
    form = _group_form(x_i8, n_major, s_f32, group)
    if group not in (32, 128) or form not in _GROUP_FORMS:
        raise NotImplementedError(f"i8mm_group kernel: x {x.dtype}, "
                                  f"{'N' if n_major else 'K'}-major, {s.dtype} scales, "
                                  f"group {group}: not ported yet")
    if N % _BN or K % _UNIT:
        raise NotImplementedError(f"i8mm_group kernel: N = {N}, K = {K}: not ported yet "
                                  "(multiples of 128)")
    want = (N, K // SCALE_ROWS) if n_major else (K // SCALE_ROWS, N)
    if tuple(s.shape) != want or not (s.is_contiguous() or s.t().is_contiguous()):
        raise ValueError(f"i8mm_group kernel: scales must be {list(want)}, contiguous or "
                         "the transpose of a contiguous plane")
    if q.device != x.device or s.device != x.device:
        raise ValueError("i8mm_group kernel: all operands must be on one device")
    sn, sg = (s.stride(0), s.stride(1)) if n_major else (s.stride(1), s.stride(0))
    ks = splits(M, K, N)
    out = torch.empty(M, N, dtype=torch.float32, device=x.device)
    part, tickets = _scratch(x, M, N, ks, torch.float32)
    lib = kernels.library("probe_i8", _SIGNATURES)
    rc = lib.bt_probe_i8mm_group(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                                 None if part is None else part.data_ptr(), tickets.data_ptr(),
                                 M, K, N, ks, sn, sg, form, stream(x))
    kernels.check(rc, "probe_i8mm_group")
    kernels.count("probe_i8mm_group", (f"{'i8' if x_i8 else 'bf16'}.{'n' if n_major else 'k'}"
                                       f".g{group}{'' if s.is_contiguous() else '.sT'}", K, N))
    return out


def blocksum(q: torch.Tensor, m: int, bn: int, sub: int) -> torch.Tensor:
    """Kernel-level entry of castonly's block sum (blocksum_plain's
    arguments): the plain version for CPU tensors, csrc/probe_i8.cu's
    blocksum_kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return blocksum_plain(q, m, bn, sub)
    if q.dtype != torch.int8 or q.dim() != 2 or not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("blocksum kernel: q must be contiguous [N, K] int8 on 16 bytes")
    N, K = q.shape
    if N % bn or K % sub or sub % 16 or bn * sub * 128 >= 2 ** 31:
        raise NotImplementedError(f"blocksum kernel: N = {N}, K = {K}, bn = {bn}, sub = {sub}: "
                                  "not ported yet (N a multiple of bn, K of sub, sub of 16, "
                                  "bn·sub·128 below 2^31)")
    out = torch.empty(m, N, dtype=torch.float32, device=q.device)
    part = zero_buffer(q.device, "part", (N // bn) * (K // sub))
    tickets = zero_buffer(q.device, "tickets", N // bn)
    lib = kernels.library("probe_i8", _SIGNATURES)
    rc = lib.bt_probe_blocksum(q.data_ptr(), out.data_ptr(), part.data_ptr(), tickets.data_ptr(),
                               m, N, K, bn, sub, stream(q))
    kernels.check(rc, "probe_blocksum")
    kernels.count("probe_blocksum", (f"bn{bn}.sub{sub}", K, N))
    return out
