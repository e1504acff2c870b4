"""Bit-exact (de)quantization of the ggml block formats the port loads, in numpy.

A copy of the Q4_0, Q5_1, Q8_0, Q2_K, Q3_K, Q4_K, Q5_K, Q6_K and float
parts of ``booster_tpu/quant/formats.py`` (decode semantics:
llama.cpp/ggml/src/ggml-quants.c dequantize_row_q4_0/q5_1/q8_0/q2_K/q3_K/
q4_K/q5_K/q6_K; the Q4_0 and Q8_0 encoders are quantize_row_q4_0_ref/
q8_0_ref, the Q5_1 encoder the JAX package's min/max affine one, the Q2_K,
Q3_K, Q4_K, Q5_K and Q6_K encoders its per-group affine and amax seeds
without llama.cpp's scale search).  The other block formats are not ported yet.
"""

from __future__ import annotations

import numpy as np

from booster_tpu_torch.gguf.constants import K_SCALE_SIZE, QK_K, GGMLType, TYPE_TRAITS

F16 = np.dtype("<f2")
F32 = np.dtype("<f4")
U8 = np.uint8


def _blocks(data: np.ndarray, type_size: int) -> np.ndarray:
    """View raw bytes as [n_blocks, type_size] uint8."""
    data = np.frombuffer(data, dtype=U8) if not isinstance(data, np.ndarray) else data
    if data.dtype != U8:
        data = data.view(U8)
    if data.size % type_size != 0:
        raise ValueError(f"data size {data.size} not multiple of block size {type_size}")
    return data.reshape(-1, type_size)


def _f16(b: np.ndarray) -> np.ndarray:
    """Interpret uint8 column pairs as little-endian float16 → float32."""
    return np.ascontiguousarray(b).view(F16).astype(np.float32)


def _dequant_q4_0(b: np.ndarray) -> np.ndarray:
    d = _f16(b[:, 0:2])  # [n, 1]
    qs = b[:, 2:18]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)  # elem j and j+16
    return q * d


def _q5_high_bits(qh_bytes: np.ndarray) -> np.ndarray:
    """[n, 4] uint8 → [n, 32] the per-element 5th bit (0/1)."""
    qh = np.ascontiguousarray(qh_bytes).view("<u4").astype(np.uint32)  # [n, 1]
    shifts = np.arange(32, dtype=np.uint32)
    return ((qh >> shifts) & 1).astype(np.uint8)


def _dequant_q5_1(b: np.ndarray) -> np.ndarray:
    d = _f16(b[:, 0:2])
    m = _f16(b[:, 2:4])
    h = _q5_high_bits(b[:, 4:8])
    qs = b[:, 8:24]
    lo = (qs & 0x0F) | (h[:, :16] << 4)
    hi = (qs >> 4) | (h[:, 16:] << 4)
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)
    return q * d + m


def _dequant_q8_0(b: np.ndarray) -> np.ndarray:
    d = _f16(b[:, 0:2])
    q = b[:, 2:34].view(np.int8).astype(np.float32)
    return q * d


def _kscales_6bit(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unpack the 12-byte packed 6-bit scales and mins of Q4_K: (sc, m),
    each [n, 8] uint8, one per 32-element group (get_scale_min_k4)."""
    s = scales.astype(np.uint8)
    sc = np.empty(s.shape[:-1] + (8,), dtype=np.uint8)
    mn = np.empty_like(sc)
    sc[..., :4] = s[..., 0:4] & 63
    mn[..., :4] = s[..., 4:8] & 63
    sc[..., 4:] = (s[..., 8:12] & 0x0F) | ((s[..., 0:4] >> 6) << 4)
    mn[..., 4:] = (s[..., 8:12] >> 4) | ((s[..., 4:8] >> 6) << 4)
    return sc, mn


def _dequant_q4_k(b: np.ndarray) -> np.ndarray:
    d = _f16(b[:, 0:2])  # [n,1]
    dmin = _f16(b[:, 2:4])
    sc, mn = _kscales_6bit(b[:, 4:16])  # [n,8]
    qs = b[:, 16:144].reshape(-1, 4, 32)  # 4 chunks of 64 elems (32 bytes)
    lo = (qs & 0x0F).astype(np.float32)  # group 2j
    hi = (qs >> 4).astype(np.float32)  # group 2j+1
    q = np.stack([lo, hi], axis=2).reshape(-1, 8, 32)  # [n, group, 32]
    dl = (d * sc.astype(np.float32))[:, :, None]
    ml = (dmin * mn.astype(np.float32))[:, :, None]
    return (q * dl - ml).reshape(-1, QK_K)


def _dequant_q5_k(b: np.ndarray) -> np.ndarray:
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    sc, mn = _kscales_6bit(b[:, 4:16])
    qh = b[:, 16:48]  # [n, 32]: bit 2j the fifth bit of group 2j's element, 2j + 1 of 2j + 1's
    qs = b[:, 48:176].reshape(-1, 4, 32)
    j = np.arange(4)
    u1 = (1 << (2 * j)).astype(np.uint8)[None, :, None]
    u2 = (1 << (2 * j + 1)).astype(np.uint8)[None, :, None]
    qh4 = qh[:, None, :]  # the same 32 bytes for all 4 chunks
    lo = (qs & 0x0F) + np.where((qh4 & u1) != 0, 16, 0).astype(np.uint8)
    hi = (qs >> 4) + np.where((qh4 & u2) != 0, 16, 0).astype(np.uint8)
    q = np.stack([lo, hi], axis=2).reshape(-1, 8, 32).astype(np.float32)
    dl = (d * sc.astype(np.float32))[:, :, None]
    ml = (dmin * mn.astype(np.float32))[:, :, None]
    return (q * dl - ml).reshape(-1, QK_K)


def _dequant_q6_k(b: np.ndarray) -> np.ndarray:
    ql = b[:, 0:128].reshape(-1, 2, 64)  # two 128-element halves
    qh = b[:, 128:192].reshape(-1, 2, 32)
    sc = b[:, 192:208].view(np.int8).reshape(-1, 2, 8).astype(np.float32)
    d = _f16(b[:, 208:210])  # [n,1]
    l = np.arange(32)
    q1 = (ql[:, :, l] & 0x0F) | (((qh[:, :, l] >> 0) & 3) << 4)
    q2 = (ql[:, :, l + 32] & 0x0F) | (((qh[:, :, l] >> 2) & 3) << 4)
    q3 = (ql[:, :, l] >> 4) | (((qh[:, :, l] >> 4) & 3) << 4)
    q4 = (ql[:, :, l + 32] >> 4) | (((qh[:, :, l] >> 6) & 3) << 4)
    q = np.concatenate([q1, q2, q3, q4], axis=2).astype(np.int16) - 32  # [n,2,128]
    # scale index: within a half, element e uses sc[e // 16]
    sidx = (np.arange(128) // 16)[None, None, :]
    scale = np.take_along_axis(sc, np.broadcast_to(sidx, q.shape), axis=2)
    return (d[:, :, None] * scale * q.astype(np.float32)).reshape(-1, QK_K)


def _dequant_q2_k(b: np.ndarray) -> np.ndarray:
    scales = b[:, 0:16]  # [n, 16]: low nibble the scale, high the min, one per 16 elements
    qs = b[:, 16:80].reshape(-1, 2, 32)  # two halves of 128
    d = _f16(b[:, 80:82])
    dmin = _f16(b[:, 82:84])
    shift = (2 * np.arange(4))[None, None, :, None]
    q = ((qs[:, :, None, :] >> shift) & 3).astype(np.float32)  # [n, 2, 4, 32]
    dl = (d * (scales & 0x0F).astype(np.float32)).reshape(-1, 16)
    ml = (dmin * (scales >> 4).astype(np.float32)).reshape(-1, 16)
    q = q.reshape(-1, 16, 16)  # [n, 16 groups of 16, 16]
    return (q * dl[:, :, None] - ml[:, :, None]).reshape(-1, QK_K)


def _q3k_scales(packed: np.ndarray) -> np.ndarray:
    """The 12 packed bytes of Q3_K → its 16 signed 6-bit scales, f32 [n, 16]
    (ggml-quants.c dequantize_row_q3_K's kmask unpack, on three
    little-endian u32 words)."""
    a = np.ascontiguousarray(packed).view("<u4").astype(np.uint32)  # [n, 3]
    tmp = a[:, 2]
    out = np.empty((packed.shape[0], 4), dtype=np.uint32)
    out[:, 0] = (a[:, 0] & 0x0F0F0F0F) | (((tmp >> 0) & 0x03030303) << 4)
    out[:, 1] = (a[:, 1] & 0x0F0F0F0F) | (((tmp >> 2) & 0x03030303) << 4)
    out[:, 2] = ((a[:, 0] >> 4) & 0x0F0F0F0F) | (((tmp >> 4) & 0x03030303) << 4)
    out[:, 3] = ((a[:, 1] >> 4) & 0x0F0F0F0F) | (((tmp >> 6) & 0x03030303) << 4)
    return out.view(np.int8).reshape(-1, 16).astype(np.float32) - 32


def _q3k_codes(hmask: np.ndarray, qs: np.ndarray) -> np.ndarray:
    """Q3_K's 3-bit codes q2 + 4·hbit in 0..7, uint8 [n, 2, 4, 32] (half,
    shift, element): the value is scale·(code - 4)."""
    shift = (2 * np.arange(4))[None, None, :, None]
    q2 = ((qs[:, :, None, :] >> shift) & 3).astype(np.uint8)
    bit = (4 * np.arange(2))[None, :, None, None] + np.arange(4)[None, None, :, None]
    hb = ((hmask[:, None, None, :] >> bit) & 1).astype(np.uint8)
    return q2 + (hb << 2)


def _dequant_q3_k(b: np.ndarray) -> np.ndarray:
    scales = _q3k_scales(b[:, 96:108])
    d = _f16(b[:, 108:110])
    code = _q3k_codes(b[:, 0:32], b[:, 32:96].reshape(-1, 2, 32))
    q = (code.astype(np.int16) - 4).astype(np.float32).reshape(-1, 16, 16)
    return (q * (d[:, :] * scales)[:, :, None]).reshape(-1, QK_K)


_DEQUANT = {GGMLType.Q4_0: _dequant_q4_0, GGMLType.Q5_1: _dequant_q5_1,
            GGMLType.Q8_0: _dequant_q8_0, GGMLType.Q2_K: _dequant_q2_k,
            GGMLType.Q3_K: _dequant_q3_k, GGMLType.Q4_K: _dequant_q4_k,
            GGMLType.Q5_K: _dequant_q5_k, GGMLType.Q6_K: _dequant_q6_k}


def dequantize(data: np.ndarray | bytes, ggml_type: GGMLType, shape=None) -> np.ndarray:
    """Raw tensor bytes → float32 array (reshaped to `shape` if given)."""
    raw = np.frombuffer(data, dtype=U8) if isinstance(data, (bytes, bytearray)) else data.view(U8).ravel()
    if ggml_type == GGMLType.F32:
        out = np.ascontiguousarray(raw).view(F32).astype(np.float32)
    elif ggml_type == GGMLType.F16:
        out = np.ascontiguousarray(raw).view(F16).astype(np.float32)
    elif ggml_type == GGMLType.BF16:
        u32 = np.ascontiguousarray(raw).view("<u2").astype(np.uint32) << 16
        out = u32.view(np.float32)
    else:
        fn = _DEQUANT.get(ggml_type)
        if fn is None:
            raise NotImplementedError(f"dequantization of {ggml_type.name}: not ported yet")
        out = fn(_blocks(raw, TYPE_TRAITS[ggml_type].type_size)).reshape(-1)
    return out.reshape(shape) if shape is not None else out


def _f16_bytes(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.astype(F16)).view(U8).reshape(x.shape[0], 2)


def _quant_q4_0(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 32)
    imax = np.argmax(np.abs(x), axis=1)
    maxv = x[np.arange(x.shape[0]), imax]  # signed amax (reference keeps sign)
    d = maxv / -8.0
    inv_d = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    # reference: (int8_t)(x*id + 8.5f) truncates toward zero; values >= 0 so floor
    q = np.clip(np.floor(x * inv_d[:, None] + 8.5), 0, 15).astype(np.uint8)
    out = np.empty((x.shape[0], 18), dtype=U8)
    out[:, 0:2] = _f16_bytes(d)
    out[:, 2:18] = q[:, :16] | (q[:, 16:] << 4)
    return out


def _quant_q8_0(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 32)
    amax = np.max(np.abs(x), axis=1)
    d = amax / 127.0
    inv_d = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.clip(np.round(x * inv_d[:, None]), -128, 127).astype(np.int8)
    out = np.empty((x.shape[0], 34), dtype=U8)
    out[:, 0:2] = _f16_bytes(d)
    out[:, 2:34] = q.view(U8)
    return out


def _pack_q5_high(q: np.ndarray) -> np.ndarray:
    """[n, 32] 5-bit values → [n, 4] qh bytes (bit j = high bit of element j)."""
    bits = (q >> 4) & 1
    shifts = np.arange(32, dtype=np.uint32)
    qh = (bits.astype(np.uint32) << shifts).sum(axis=1, dtype=np.uint64).astype(np.uint32)
    return qh[:, None].astype("<u4").view(U8).reshape(-1, 4)


def _quant_q5_1(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 32)
    mn = x.min(axis=1)
    mx = x.max(axis=1)
    d = (mx - mn) / 31.0
    inv_d = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = np.clip(np.round((x - mn[:, None]) * inv_d[:, None]), 0, 31).astype(np.uint8)
    out = np.empty((x.shape[0], 24), dtype=U8)
    out[:, 0:2] = _f16_bytes(d)
    out[:, 2:4] = _f16_bytes(mn)
    out[:, 4:8] = _pack_q5_high(q)
    out[:, 8:24] = (q[:, :16] & 0x0F) | ((q[:, 16:] & 0x0F) << 4)
    return out


def _pack_kscales_6bit(sc: np.ndarray, mn: np.ndarray) -> np.ndarray:
    """Inverse of _kscales_6bit: [n,8]+[n,8] 6-bit values → [n,12] bytes."""
    out = np.zeros((sc.shape[0], K_SCALE_SIZE), dtype=U8)
    out[:, 0:4] = (sc[:, :4] & 63) | ((sc[:, 4:] >> 4) << 6)
    out[:, 4:8] = (mn[:, :4] & 63) | ((mn[:, 4:] >> 4) << 6)
    out[:, 8:12] = (sc[:, 4:] & 0x0F) | ((mn[:, 4:] & 0x0F) << 4)
    return out


def _affine_group_quant(x: np.ndarray, nbits: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-group affine quantization: q in [0, 2^nbits-1], x ≈ q*scale - min."""
    qmax = (1 << nbits) - 1
    mn = np.minimum(x.min(axis=-1), 0.0)
    mx = np.maximum(x.max(axis=-1), 0.0)
    scale = (mx - mn) / qmax
    inv = np.where(scale > 0, 1.0 / np.where(scale == 0, 1, scale), 0.0)
    q = np.clip(np.round((x - mn[..., None]) * inv[..., None]), 0, qmax).astype(np.uint8)
    return q, scale, -mn


def _quant_q4_k(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 8, 32)  # 8 groups of 32
    q, scale, minv = _affine_group_quant(x, 4)
    smax = scale.max(axis=1)
    mmax = minv.max(axis=1)
    d = smax / 63.0
    dmin = mmax / 63.0
    sc = np.clip(np.round(scale / np.where(d == 0, 1, d)[:, None]), 0, 63).astype(U8)
    mn = np.clip(np.round(minv / np.where(dmin == 0, 1, dmin)[:, None]), 0, 63).astype(U8)
    n = x.shape[0]
    out = np.empty((n, TYPE_TRAITS[GGMLType.Q4_K].type_size), dtype=U8)
    out[:, 0:2] = _f16_bytes(d)
    out[:, 2:4] = _f16_bytes(dmin)
    out[:, 4:16] = _pack_kscales_6bit(sc, mn)
    qq = q.reshape(n, 4, 2, 32)  # chunk j: groups 2j (lo nibble), 2j+1 (hi)
    out[:, 16:144] = (qq[:, :, 0, :] | (qq[:, :, 1, :] << 4)).reshape(n, 128)
    return out


def _quant_q5_k(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 8, 32)
    q, scale, minv = _affine_group_quant(x, 5)
    d = scale.max(axis=1) / 63.0
    dmin = minv.max(axis=1) / 63.0
    sc = np.clip(np.round(scale / np.where(d == 0, 1, d)[:, None]), 0, 63).astype(U8)
    mn = np.clip(np.round(minv / np.where(dmin == 0, 1, dmin)[:, None]), 0, 63).astype(U8)
    n = x.shape[0]
    out = np.empty((n, TYPE_TRAITS[GGMLType.Q5_K].type_size), dtype=U8)
    out[:, 0:2] = _f16_bytes(d)
    out[:, 2:4] = _f16_bytes(dmin)
    out[:, 4:16] = _pack_kscales_6bit(sc, mn)
    qq = q.reshape(n, 4, 2, 32)
    qh = np.zeros((n, 32), dtype=U8)
    for j in range(4):
        qh |= ((qq[:, j, 0, :] >> 4) & 1) << (2 * j)
        qh |= ((qq[:, j, 1, :] >> 4) & 1) << (2 * j + 1)
    out[:, 16:48] = qh
    out[:, 48:176] = ((qq[:, :, 0, :] & 0x0F) | ((qq[:, :, 1, :] & 0x0F) << 4)).reshape(n, 128)
    return out


def _quant_q6_k(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 16, 16)  # 16 groups of 16
    amax = np.abs(x).max(axis=-1)
    # symmetric: q in [-32,31], x ≈ d * sc * q with int8 sc
    gscale = amax / 31.0  # per-group float scale
    d = gscale.max(axis=1) / 127.0
    d_safe = np.where(d == 0, 1, d)
    sc = np.clip(np.round(gscale / d_safe[:, None]), -128, 127).astype(np.int8)
    eff = d[:, None] * sc.astype(np.float32)
    inv = np.where(eff != 0, 1.0 / np.where(eff == 0, 1, eff), 0.0)
    q = np.clip(np.round(x * inv[..., None]), -32, 31).astype(np.int16) + 32  # [n,16,16] in 0..63
    n = x.shape[0]
    q = q.reshape(n, 2, 128).astype(np.uint8)  # two halves
    q1, q2, q3, q4 = q[:, :, 0:32], q[:, :, 32:64], q[:, :, 64:96], q[:, :, 96:128]
    ql = np.empty((n, 2, 64), dtype=U8)
    ql[:, :, 0:32] = (q1 & 0x0F) | ((q3 & 0x0F) << 4)
    ql[:, :, 32:64] = (q2 & 0x0F) | ((q4 & 0x0F) << 4)
    qh = ((q1 >> 4) << 0) | ((q2 >> 4) << 2) | ((q3 >> 4) << 4) | ((q4 >> 4) << 6)
    out = np.empty((n, TYPE_TRAITS[GGMLType.Q6_K].type_size), dtype=U8)
    out[:, 0:128] = ql.reshape(n, 128)
    out[:, 128:192] = qh.reshape(n, 64)
    out[:, 192:208] = sc.view(U8)
    out[:, 208:210] = _f16_bytes(d)
    return out


def _quant_q2_k(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 16, 16)
    q, scale, minv = _affine_group_quant(x, 2)
    d = scale.max(axis=1) / 15.0
    dmin = minv.max(axis=1) / 15.0
    sc = np.clip(np.round(scale / np.where(d == 0, 1, d)[:, None]), 0, 15).astype(U8)
    mn = np.clip(np.round(minv / np.where(dmin == 0, 1, dmin)[:, None]), 0, 15).astype(U8)
    n = x.shape[0]
    out = np.empty((n, TYPE_TRAITS[GGMLType.Q2_K].type_size), dtype=U8)
    out[:, 0:16] = sc | (mn << 4)
    qv = q.reshape(n, 2, 4, 32)  # [n, half, shift, 32]
    packed = np.zeros((n, 2, 32), dtype=U8)
    for j in range(4):
        packed |= qv[:, :, j, :] << (2 * j)
    out[:, 16:80] = packed.reshape(n, 64)
    out[:, 80:82] = _f16_bytes(d)
    out[:, 82:84] = _f16_bytes(dmin)
    return out


def _quant_q3_k(x: np.ndarray) -> np.ndarray:
    x = x.reshape(-1, 16, 16)
    amax = np.abs(x).max(axis=-1)
    gscale = amax / 4.0  # q in [-4, 3]
    d = gscale.max(axis=1) / 31.0
    d_safe = np.where(d == 0, 1, d)
    sc6 = np.clip(np.round(gscale / d_safe[:, None]) + 32, 0, 63).astype(np.int16)  # biased 6-bit
    eff = d[:, None] * (sc6.astype(np.float32) - 32)
    inv = np.where(eff != 0, 1.0 / np.where(eff == 0, 1, eff), 0.0)
    q = np.clip(np.round(x * inv[..., None]), -4, 3).astype(np.int16) + 4  # 0..7
    n = x.shape[0]
    q = q.reshape(n, 2, 4, 32).astype(np.uint8)  # [n, half, shift, 32]
    low = q & 3
    hb = (q >> 2) & 1
    qs = np.zeros((n, 2, 32), dtype=U8)
    hmask = np.zeros((n, 32), dtype=U8)
    for h in range(2):
        for j in range(4):
            qs[:, h, :] |= low[:, h, j, :] << (2 * j)
            hmask |= hb[:, h, j, :] << (4 * h + j)
    # the 16 6-bit scales in 12 bytes (the inverse of _q3k_scales)
    s = sc6.astype(np.uint8)
    out12 = np.zeros((n, 12), dtype=U8)
    lo4 = s & 0x0F
    hi2 = (s >> 4) & 3
    out12[:, 0:8] = lo4[:, 0:8] | (lo4[:, 8:16] << 4)
    for g in range(4):  # byte 8 + i holds the 2-bit highs of scales i, i + 4, i + 8, i + 12
        out12[:, 8:12] |= hi2[:, 4 * g:4 * g + 4] << (2 * g)
    out = np.empty((n, TYPE_TRAITS[GGMLType.Q3_K].type_size), dtype=U8)
    out[:, 0:32] = hmask
    out[:, 32:96] = qs.reshape(n, 64)
    out[:, 96:108] = out12
    out[:, 108:110] = _f16_bytes(d)
    return out


_QUANT = {GGMLType.Q4_0: _quant_q4_0, GGMLType.Q5_1: _quant_q5_1, GGMLType.Q8_0: _quant_q8_0,
          GGMLType.Q2_K: _quant_q2_k, GGMLType.Q3_K: _quant_q3_k, GGMLType.Q4_K: _quant_q4_k,
          GGMLType.Q5_K: _quant_q5_k, GGMLType.Q6_K: _quant_q6_k}


def quantize(x: np.ndarray, ggml_type: GGMLType) -> bytes:
    """float array → raw GGUF tensor bytes of the given type."""
    x = np.asarray(x, dtype=np.float32)
    if ggml_type == GGMLType.F32:
        return np.ascontiguousarray(x.astype(F32)).tobytes()
    if ggml_type == GGMLType.F16:
        return np.ascontiguousarray(x.astype(F16)).tobytes()
    if ggml_type == GGMLType.BF16:
        u32 = x.astype(np.float32).view(np.uint32)
        # round-to-nearest-even bf16
        rounded = ((u32 + 0x7FFF + ((u32 >> 16) & 1)) >> 16).astype(np.uint16)
        return np.ascontiguousarray(rounded).tobytes()
    fn = _QUANT.get(ggml_type)
    if fn is None:
        raise NotImplementedError(f"quantization to {ggml_type.name}: not ported yet")
    bs = TYPE_TRAITS[ggml_type].block_size
    if x.size % bs != 0:
        raise ValueError(f"size {x.size} not a multiple of {ggml_type.name} block {bs}")
    return fn(x.reshape(-1)).tobytes()
