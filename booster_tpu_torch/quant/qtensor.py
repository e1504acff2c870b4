"""QTensor: quantized weights in the kernels' layout, over torch tensors.

Port of ``booster_tpu/quant/qtensor.py`` for the Q4_0, Q5_1, Q8_0, Q2_K,
Q3_K, Q4_K, Q5_K and Q6_K llama paths.  At load time a GGUF tensor of one of those
types is *losslessly* repacked
(torch bit operations, on the host or on the card) into

    value[r, c] = (q[r, c] - zero) * scales[r, c // group]  -  mins[r, c // group]

with payload ``qw``:

    kind="i4p"  uint8 [out, in // 2]  split-half packing: byte b holds element
                b (low nibble) and element b + in/2 (high nibble) (Q4_0:
                group 32, zero 8; Q4_K: group 32 with mins; Q2_K: the
                2-bit codes at group 16 with mins; Q3_K: the 3-bit codes
                at group 16, zero 4, signed scales); prepared
                scale planes [out, 2, in/(2G)] (the halves' scales, then
                their mins when affine), bf16 where a lane-major kernel
                reads them (the expert stacks of a MoE model)
    kind="i4t"  the same payload stored K-major, [in // 2, out]
                (transpose_qtensor), with scale planes [R, in/(2G), out]:
                rows 0-1 the scales of the two halves, rows 2-3 their mins
                when the format is affine
    kind="i8"   int8 [out, in] (Q8_0: symmetric, group 32, no zero point;
                Q6_K: symmetric, group 16, the codes q - 32 and the f32
                scales d·sc of the super-block's 16 groups; Q5_K and Q5_1:
                the codes 0..31 at group 32 with f32 scales and mins,
                Q5_K's d·sc and dmin·mn, Q5_1's d and -m); prepared
                scale planes [out, 1(+1), in/G], the mins after the scales
    kind="i8t"  the same payload stored K-major, [in, out], with scale
                planes [R, in/G, out]: row 0 the scales, row 1 the mins
                when affine
    kind="i8c"  per-channel symmetric int8 (``channel_quantize``, lossy):
                K-major int8 [in, out], f32 scales [1, out], group = in
    kind="dense" bf16 [out, in]   (no scales; ``repack_weights(qt, "bf16")``;
                while loading, numpy f32 or the bf16 bits as uint16)

The K-major forms are what ops/qmm.py's kernels (csrc/qmm_i4t.cu,
csrc/qmm_i8t.cu, csrc/qmm_i8c.cu) and ops/mlp.py's (csrc/mlp_i8t.cu) read:
consecutive output columns are consecutive bytes, so a warp's loads of one
payload row coalesce.  ``compact_scales`` stores the K-major scale planes as
bfloat16 — the kernel rounds scales to bf16 anyway, so this is exact through
the kernel and halves the scale bytes.

``layer`` selects one layer of a stacked [L, ...] QTensor without copying:
the kernel wrappers offset the data pointers (the counterpart of the JAX
package's scalar-prefetch layer index).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field, replace
from typing import Any, Optional

import numpy as np
import torch

from booster_tpu_torch.gguf.constants import GGMLType, TYPE_TRAITS
from booster_tpu_torch.quant import formats as F


@dataclass
class QTensor:
    """Quantized 2-D weight [out_features, in_features] (optionally stacked
    on a leading layer axis).  Arrays are numpy while loading, torch after
    ``to_torch``."""

    kind: str  # "i4p" | "i4t" | "i8" | "i8t" | "i8c" | "dense"
    qw: Any
    scales: Optional[Any]
    mins: Optional[Any]
    group: int
    shape: tuple[int, int]  # logical (out, in)
    source_type: GGMLType
    zero: int = 0
    layer: Optional[int] = None  # layer of a stacked payload (a view, no copy)

    # per-layer views and the resolved 2-D form, built once: the decode loop
    # asks for them for every layer of every token
    _views: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    @property
    def prepared(self) -> bool:
        """True when `scales` holds the kernel-block form (prepare_kernel_scales)."""
        return self.scales is not None and self.scales.ndim == self.qw.ndim + 1

    @property
    def transposed(self) -> bool:
        return self.kind in ("i4t", "i8t", "i8c")

    @property
    def scale_rows(self) -> int:
        return 2 if self.kind in ("i4p", "i4t") else 1

    def at(self, layer: int) -> "QTensor":
        """View of one layer of a stacked QTensor (no copy)."""
        v = self._views.get(layer)
        if v is None:
            v = self._views[layer] = replace(self, layer=layer)
        return v

    def resolved(self) -> "QTensor":
        """The selected layer as a 2-D QTensor (tensor views, no copy)."""
        if self.layer is None:
            return self
        r = self._views.get("resolved")
        if r is None:

            def pick(a):
                return None if a is None else a[self.layer]

            r = self._views["resolved"] = replace(
                self, qw=pick(self.qw), scales=pick(self.scales), mins=pick(self.mins),
                layer=None)
        return r


def to_torch(qt: QTensor, device) -> QTensor:
    """numpy (or CPU torch) fields → torch tensors on `device`; dense
    payloads become bf16 (a uint16 payload holds bf16 bit patterns)."""

    def conv(a, dense=False):
        if a is None:
            return None
        if torch.is_tensor(a):
            t = a
        elif dense and a.dtype == np.uint16:
            t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(a))
        if dense and t.dtype != torch.bfloat16:
            t = t.to(torch.bfloat16)
        return t.to(device).contiguous()

    return replace(qt, qw=conv(qt.qw, dense=qt.kind == "dense"),
                   scales=conv(qt.scales), mins=conv(qt.mins))


# --------------------------------------------------------------------------
# Repacking: GGUF raw bytes -> QTensor (host-side numpy, done once at load)
# --------------------------------------------------------------------------


def _pack_nibbles_planar(q: torch.Tensor) -> torch.Tensor:
    """[rows, K] uint8 (values 0..15) → [rows, K//2] split-half packing:
    byte j = elem j (low nibble) | elem j + K/2 (high nibble)."""
    if q.shape[-1] % 2:
        raise ValueError("split-half packing needs an even row length")
    half = q.shape[-1] // 2
    return q[..., :half] | (q[..., half:] << 4)


def _repack_q4_0(b: torch.Tensor, out_f: int, in_f: int) -> QTensor:
    b = b.reshape(-1, TYPE_TRAITS[GGMLType.Q4_0].type_size)
    d = b[:, 0:2].contiguous().view(torch.float16).float().reshape(out_f, in_f // 32)
    qs = b[:, 2:18]
    q = torch.cat([qs & 0x0F, qs >> 4], dim=1).reshape(out_f, in_f)  # block order 0..31
    return QTensor("i4p", _pack_nibbles_planar(q), d, None, 32, (out_f, in_f),
                   GGMLType.Q4_0, zero=8)


def _repack_q8_0(b: torch.Tensor, out_f: int, in_f: int) -> QTensor:
    b = b.reshape(-1, TYPE_TRAITS[GGMLType.Q8_0].type_size)
    d = b[:, 0:2].contiguous().view(torch.float16).float().reshape(out_f, in_f // 32)
    q = b[:, 2:34].contiguous().view(torch.int8).reshape(out_f, in_f)
    return QTensor("i8", q, d, None, 32, (out_f, in_f), GGMLType.Q8_0)


def _repack_q6_k(b: torch.Tensor, out_f: int, in_f: int) -> QTensor:
    """Q6_K → i8 at group 16 (``_repack_q6_k`` of the JAX package): the 6-bit
    codes less 32, and the f32 scale d·sc of each 16-element group."""
    b = b.reshape(-1, TYPE_TRAITS[GGMLType.Q6_K].type_size)
    ql = b[:, 0:128].reshape(-1, 2, 64)
    qh = b[:, 128:192].reshape(-1, 2, 32)
    sc = b[:, 192:208].contiguous().view(torch.int8).float()  # [n, 16]
    d = b[:, 208:210].contiguous().view(torch.float16).float()  # [n, 1]
    lo, hi = ql[:, :, :32], ql[:, :, 32:]
    q = torch.cat([(lo & 0x0F) | ((qh & 3) << 4), (hi & 0x0F) | (((qh >> 2) & 3) << 4),
                   (lo >> 4) | (((qh >> 4) & 3) << 4), (hi >> 4) | (((qh >> 6) & 3) << 4)],
                  dim=2)  # [n, 2, 128], values 0..63
    q = (q.to(torch.int16) - 32).to(torch.int8).reshape(out_f, in_f)
    return QTensor("i8", q, (d * sc).reshape(out_f, in_f // 16), None, 16, (out_f, in_f),
                   GGMLType.Q6_K)


def _scale_min_k4(s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """get_scale_min_k4's packing of Q4_K's and Q5_K's 8 six-bit scales and
    mins: [n, 12] bytes → (sc, mn), each [n, 8]."""
    sc = torch.cat([s[:, 0:4] & 63, (s[:, 8:12] & 0x0F) | ((s[:, 0:4] >> 6) << 4)], dim=1)
    mn = torch.cat([s[:, 4:8] & 63, (s[:, 8:12] >> 4) | ((s[:, 4:8] >> 6) << 4)], dim=1)
    return sc, mn


def _repack_q4_k(b: torch.Tensor, out_f: int, in_f: int) -> QTensor:
    """Q4_K → i4p at group 32, zero 0 (``_repack_q4_k`` of the JAX package):
    the split-half nibbles of each row in element order, the f32 scales
    d·sc and mins dmin·mn of its 32-element groups (w = q·scale - min)."""
    b = b.reshape(-1, TYPE_TRAITS[GGMLType.Q4_K].type_size)
    d = b[:, 0:2].contiguous().view(torch.float16).float()  # [n, 1]
    dmin = b[:, 2:4].contiguous().view(torch.float16).float()
    sc, mn = _scale_min_k4(b[:, 4:16])
    qs = b[:, 16:144].reshape(-1, 4, 32)  # chunk j: groups 2j (low nibbles), 2j + 1 (high)
    q = torch.stack([qs & 0x0F, qs >> 4], dim=2).reshape(out_f, in_f)
    return QTensor("i4p", _pack_nibbles_planar(q), (d * sc.float()).reshape(out_f, in_f // 32),
                   (dmin * mn.float()).reshape(out_f, in_f // 32), 32, (out_f, in_f),
                   GGMLType.Q4_K)


def _repack_q5_k(b: torch.Tensor, out_f: int, in_f: int) -> QTensor:
    """Q5_K → i8 at group 32 (``_repack_q5_k`` of the JAX package): the
    5-bit codes 0..31 of each row in element order, the f32 scales d·sc and
    mins dmin·mn of its 32-element groups (w = q·scale - min)."""
    b = b.reshape(-1, TYPE_TRAITS[GGMLType.Q5_K].type_size)
    d = b[:, 0:2].contiguous().view(torch.float16).float()  # [n, 1]
    dmin = b[:, 2:4].contiguous().view(torch.float16).float()
    sc, mn = _scale_min_k4(b[:, 4:16])
    qh = b[:, None, 16:48]  # bit 2j: the fifth bit of chunk j's low nibbles, 2j + 1 its high
    qs = b[:, 48:176].reshape(-1, 4, 32)  # chunk j: groups 2j (low nibbles), 2j + 1 (high)
    j = torch.arange(4, device=b.device, dtype=torch.uint8)[None, :, None]
    lo = (qs & 0x0F) | (((qh >> (2 * j)) & 1) << 4)
    hi = (qs >> 4) | (((qh >> (2 * j + 1)) & 1) << 4)
    q = torch.stack([lo, hi], dim=2).reshape(out_f, in_f).to(torch.int8)
    return QTensor("i8", q, (d * sc.float()).reshape(out_f, in_f // 32),
                   (dmin * mn.float()).reshape(out_f, in_f // 32), 32, (out_f, in_f),
                   GGMLType.Q5_K)


def _repack_q5_1(b: torch.Tensor, out_f: int, in_f: int) -> QTensor:
    """Q5_1 → i8 at group 32 (``_repack_q5_1`` of the JAX package): the
    5-bit codes 0..31, the f32 scales d and, as mins, -m (w = q·d + m)."""
    b = b.reshape(-1, TYPE_TRAITS[GGMLType.Q5_1].type_size)
    d = b[:, 0:2].contiguous().view(torch.float16).float()
    m = b[:, 2:4].contiguous().view(torch.float16).float()
    qh = b[:, 4:8].contiguous().view(torch.int32)  # [n, 1]: bit e the fifth bit of element e
    bits = (qh >> torch.arange(32, device=b.device, dtype=torch.int32)) & 1
    qs = b[:, 8:24]
    lo = (qs & 0x0F) | (bits[:, :16].to(torch.uint8) << 4)
    hi = (qs >> 4) | (bits[:, 16:].to(torch.uint8) << 4)
    q = torch.cat([lo, hi], dim=1).reshape(out_f, in_f).to(torch.int8)
    return QTensor("i8", q, d.reshape(out_f, in_f // 32), (-m).reshape(out_f, in_f // 32), 32,
                   (out_f, in_f), GGMLType.Q5_1)


def _repack_q2_k(b: torch.Tensor, out_f: int, in_f: int) -> QTensor:
    """Q2_K → i4p at group 16, zero 0 (``_repack_q2_k`` of the JAX package):
    the 2-bit codes 0..3 of each row in element order, the f32 scales
    d·(sc & 15) and mins dmin·(sc >> 4) of its 16-element groups (w =
    q·scale - min)."""
    b = b.reshape(-1, TYPE_TRAITS[GGMLType.Q2_K].type_size)
    sc = b[:, 0:16]  # one byte a 16-element group: the scale low, the min high
    qs = b[:, 16:80].reshape(-1, 2, 32)  # half h: shift 2j holds elements 128h + 32j + l
    d = b[:, 80:82].contiguous().view(torch.float16).float()  # [n, 1]
    dmin = b[:, 82:84].contiguous().view(torch.float16).float()
    q = torch.stack([(qs >> (2 * j)) & 3 for j in range(4)], dim=2).reshape(out_f, in_f)
    return QTensor("i4p", _pack_nibbles_planar(q),
                   (d * (sc & 0x0F).float()).reshape(out_f, in_f // 16),
                   (dmin * (sc >> 4).float()).reshape(out_f, in_f // 16), 16, (out_f, in_f),
                   GGMLType.Q2_K)


def _repack_q3_k(b: torch.Tensor, out_f: int, in_f: int) -> QTensor:
    """Q3_K → i4p at group 16, zero 4 (``_repack_q3_k`` of the JAX package):
    the 3-bit codes q2 + 4·hbit in 0..7 of each row in element order and
    the f32 scales d·(sc6 - 32) of its 16-element groups, which may be
    negative (w = (q - 4)·scale).  The 12 packed scale bytes are unpacked
    byte by byte: the reference's kmask unpack on three little-endian u32
    words moves no bits across bytes, so scale j takes the low 4 bits
    from nibble j of bytes 0-7 (low nibbles first) and the high 2 from
    bits 2(j // 4) of byte 8 + j % 4."""
    b = b.reshape(-1, TYPE_TRAITS[GGMLType.Q3_K].type_size)
    hmask = b[:, None, 0:32]  # bit 4h + j: the third bit of shift j of half h
    qs = b[:, 32:96].reshape(-1, 2, 32)
    p = b[:, 96:108]
    d = b[:, 108:110].contiguous().view(torch.float16).float()  # [n, 1]
    low = torch.cat([p[:, 0:8] & 0x0F, p[:, 0:8] >> 4], dim=1)  # [n, 16]
    high = torch.cat([(p[:, 8:12] >> (2 * g)) & 3 for g in range(4)], dim=1)
    sc6 = (low | (high << 4)).float() - 32
    code = [((qs >> (2 * j)) & 3) | (((hmask >> (4 * torch.arange(2, device=b.device,
                                                                   dtype=torch.uint8)[:, None]
                                                   + j)) & 1) << 2) for j in range(4)]
    q = torch.stack(code, dim=2).reshape(out_f, in_f)
    return QTensor("i4p", _pack_nibbles_planar(q), (d * sc6).reshape(out_f, in_f // 16), None,
                   16, (out_f, in_f), GGMLType.Q3_K, zero=4)


_REPACK = {GGMLType.Q4_0: _repack_q4_0, GGMLType.Q5_1: _repack_q5_1,
           GGMLType.Q8_0: _repack_q8_0, GGMLType.Q2_K: _repack_q2_k,
           GGMLType.Q3_K: _repack_q3_k, GGMLType.Q4_K: _repack_q4_k,
           GGMLType.Q5_K: _repack_q5_k, GGMLType.Q6_K: _repack_q6_k}
_DENSE_TYPES = (GGMLType.F32, GGMLType.F16, GGMLType.BF16)


def repack_gguf_tensor(raw, ggml_type: GGMLType, shape: tuple[int, ...],
                       device=None) -> QTensor:
    """Raw GGUF tensor bytes (bytes, a numpy view or a uint8 torch tensor)
    → QTensor.  Tensors with more than 2 dims are flattened to
    [prod(leading), last].  Without `device` the fields are
    host numpy arrays; with it, a quantized tensor's bytes go to that
    torch device and are repacked there (the loader repacks the expert
    stacks of a MoE model on the card: a host repack of 26 GB takes
    minutes).  One torch implementation serves both, so the two agree bit
    for bit."""
    if len(shape) == 1:
        out_f, in_f = 1, shape[0]
    else:
        in_f = shape[-1]
        out_f = int(np.prod(shape[:-1]))
    fn = _REPACK.get(ggml_type)
    if fn is None:
        if ggml_type not in _DENSE_TYPES:
            raise NotImplementedError(f"{ggml_type.name} weights: not ported yet")
        w = F.dequantize(raw, ggml_type, shape=(out_f, in_f))
        return QTensor("dense", w, None, None, 1, (out_f, in_f), ggml_type)
    if torch.is_tensor(raw):
        b = raw.view(torch.uint8).reshape(-1)
    else:
        raw = np.frombuffer(raw, dtype=np.uint8) if isinstance(raw, (bytes, bytearray)) else raw
        with warnings.catch_warnings():  # a read-only mmap view: the repack never writes it
            warnings.simplefilter("ignore", UserWarning)
            b = torch.from_numpy(raw.view(np.uint8).ravel())
    qt = fn(b if device is None else b.to(device), out_f, in_f)
    if device is not None:
        return qt
    return replace(qt, qw=qt.qw.numpy(), scales=qt.scales.numpy(),
                   mins=None if qt.mins is None else qt.mins.numpy())


def repack_weights(qt: QTensor, mode: str) -> QTensor:
    """Load-time weight format (``booster_tpu/quant/qtensor.py::repack_weights``):
    "native" keeps the file's quantization; "bf16" dequantizes exactly (f32
    values from the stored scales, rounded once) to a ``dense`` QTensor whose
    payload holds the bf16 bit patterns as numpy uint16 [out, in] (numpy has
    no bf16; ``to_torch`` reads them back); "i8" widens i4p nibbles to int8
    ``q - zero`` with the same scales and mins (exact; other kinds are kept).
    The loader applies "i8c" (``channel_quantize``) at stack time."""
    if mode == "native" or qt.kind == "dense":
        return qt
    if mode == "i8":
        if qt.kind != "i4p":
            return qt
        p = np.asarray(qt.qw)
        q = np.concatenate([p & 0x0F, p >> 4], axis=-1).astype(np.int16) - int(qt.zero)
        return replace(qt, kind="i8", qw=q.astype(np.int8), zero=0)
    if mode != "bf16":
        raise ValueError(f"unknown weights mode {mode!r}")

    def t(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a))

    w = dequantize(replace(qt, qw=t(qt.qw), scales=t(qt.scales), mins=t(qt.mins)))
    bits = w.view(torch.int16).numpy().view(np.uint16)
    return QTensor("dense", bits, None, None, 1, qt.shape, qt.source_type)


def channel_quantize(qt: QTensor) -> QTensor:
    """Per-output-row symmetric int8, K-major (``channel_quantize`` of the
    JAX package, lossy): w = the f32 values from the file's f32 scales,
    s = max(max|w[n, :]| / 127, 1e-12), q = rint(w / s); → kind "i8c" with
    qw int8 [K, N], scales f32 [1, N], group K.  On numpy arrays (computed
    on the host) or torch tensors (computed where they lie: the loader
    quantizes on the card).  Both divisions are IEEE f32 divisions by a
    tensor, as numpy's are, so the result is bit-equal to the JAX
    package's on either device (CUDA divides by a CPU scalar as a multiply
    by its reciprocal, which differs in the last bit)."""
    if qt.kind == "dense":
        return qt
    if qt.kind not in ("i4p", "i8") or qt.prepared:
        raise ValueError(f"channel_quantize takes i4p or i8 with flat scales, not {qt.kind!r}")

    def t(a):
        return None if a is None else (a if torch.is_tensor(a) else torch.from_numpy(
            np.ascontiguousarray(a)))

    qt = replace(qt, qw=t(qt.qw), scales=t(qt.scales), mins=t(qt.mins))
    if qt.scales.dtype != torch.float32 or (qt.mins is not None
                                            and qt.mins.dtype != torch.float32):
        raise ValueError("channel_quantize needs the file's f32 scales (before compact_scales)")
    N, K = qt.shape
    w = dequantize(qt, torch.float32)  # [N, K]
    amax = w.abs().amax(dim=1, keepdim=True)
    s = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-12)
    q = torch.round(w / s).to(torch.int8)  # round half to even, as np.rint
    return QTensor("i8c", q.t().contiguous(), s.reshape(1, N).contiguous(), None, K, qt.shape,
                   qt.source_type)


def prepare_kernel_scales(qt: QTensor) -> QTensor:
    """Pre-shape `scales` (and fold `mins`) into the kernels' operand layout:
    i4p → [..., N, 2(+2), K/(2G)], i8 → [..., N, 1(+1), K/G] (the extra
    rows hold mins when affine).  On numpy arrays or torch tensors."""
    if qt.kind not in ("i4p", "i8") or qt.scales is None or qt.prepared:
        return qt
    s = qt.scales
    rows = qt.scale_rows
    sg = s.shape[-1] // rows
    s3 = s.reshape(*s.shape[:-1], rows, sg)
    if qt.mins is not None:
        m3 = qt.mins.reshape(*s.shape[:-1], rows, sg)
        s3 = (torch.cat([s3, m3], dim=-2) if torch.is_tensor(s3)
              else np.concatenate([s3, m3], axis=-2))
    s3 = s3.contiguous() if torch.is_tensor(s3) else np.ascontiguousarray(s3)
    return replace(qt, scales=s3, mins=None)


def transpose_qtensor(qt: QTensor) -> QTensor:
    """Lane-major → K-major storage (i4p→i4t, i8→i8t), exact: qw [..., N, Kp]
    → [..., Kp, N]; prepared scales [..., N, R, SG] → [..., R, SG, N].  On
    numpy arrays on the host, or on torch tensors where they lie (the loader
    transposes on the card: a host transpose of a 7B model takes a minute)."""
    if qt.kind in ("dense", "i4t", "i8t", "i8c"):
        return qt
    if qt.kind not in ("i4p", "i8"):
        raise ValueError(f"cannot transpose kind {qt.kind!r}")
    if qt.scales is not None and not qt.prepared:
        qt = prepare_kernel_scales(qt)
    s = qt.scales
    if torch.is_tensor(qt.qw):
        qw = qt.qw.transpose(-1, -2).contiguous()
        if s is not None:
            s = s.movedim(-3, -1).contiguous()
    else:
        qw = np.ascontiguousarray(np.swapaxes(np.asarray(qt.qw), -1, -2))
        if s is not None:
            s = np.ascontiguousarray(np.moveaxis(np.asarray(s), -3, -1))
    return replace(qt, kind=qt.kind[:2] + "t", qw=qw, scales=s)


def compact_scales(qt: QTensor) -> QTensor:
    """Prepared scale (+folded-min) planes → bfloat16 storage
    (round-to-nearest-even, as the kernels round them anyway): the K-major
    planes, and the lane-major ones of a weight that a lane-major kernel
    reads (the expert stacks).  numpy planes become a CPU torch tensor."""
    if qt.scales is None or not (qt.transposed or qt.prepared):
        return qt
    if torch.is_tensor(qt.scales) and qt.scales.dtype == torch.bfloat16:
        return qt
    s = qt.scales if torch.is_tensor(qt.scales) else torch.from_numpy(
        np.ascontiguousarray(qt.scales, dtype=np.float32))
    return replace(qt, scales=s.to(torch.bfloat16))


def kernel_scales(qt: QTensor):
    """(s3, has_mins) in the kernels' operand layout: [(L,) R, SG, N] for a
    transposed, prepared QTensor; [(L,) N, R, SG] for a lane-major one,
    built from the flat planes when it was not prepared at load."""
    rows = qt.scale_rows
    s3 = qt.scales
    if qt.transposed:
        return s3, s3.shape[-3] == 2 * rows
    if qt.prepared:
        return s3, s3.shape[-2] == 2 * rows
    return prepare_kernel_scales(qt).scales, qt.mins is not None


# --------------------------------------------------------------------------
# Dequantization (torch; the plain path and the fallback matmul)
# --------------------------------------------------------------------------


def _flat_scales(qt: QTensor):
    """(scales [N, K/G], mins [N, K/G] | None) of a 2-D QTensor in either
    storage form."""
    s = qt.scales
    if qt.transposed:
        s = s.movedim(-1, -3)  # [R, SG, N] → [N, R, SG]
    elif not qt.prepared:
        return s, qt.mins
    rows = qt.scale_rows
    sc = s[:, :rows, :].reshape(s.shape[0], -1)
    mn = s[:, rows:, :].reshape(s.shape[0], -1) if s.shape[1] > rows else None
    return sc, mn


def dequantize(qt: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """QTensor (torch fields) → dense [out, in] in `dtype`: values formed in
    f32 from the stored scales, then cast once."""
    qt = qt.resolved()
    if qt.kind == "dense":
        return qt.qw.to(dtype)
    if qt.kind == "i8c":  # [K, N] · [1, N] → [N, K]
        return (qt.qw.float() * qt.scales.float()).t().to(dtype)
    if qt.kind not in ("i4p", "i4t", "i8", "i8t"):
        raise NotImplementedError(f"kind {qt.kind!r}: not ported yet")
    p = qt.qw.t() if qt.transposed else qt.qw  # [N, K/2] u8 or [N, K] i8
    out_f, in_f = qt.shape
    if qt.kind in ("i4p", "i4t"):
        q = torch.cat([p & 0x0F, p >> 4], dim=-1).to(torch.float32)
    else:
        q = p.to(torch.float32)
    if qt.zero:
        q = q - float(qt.zero)
    sc, mn = _flat_scales(qt)
    g = qt.group
    v = q.reshape(out_f, in_f // g, g) * sc.to(torch.float32)[:, :, None]
    if mn is not None:
        v = v - mn.to(torch.float32)[:, :, None]
    return v.reshape(out_f, in_f).to(dtype)
