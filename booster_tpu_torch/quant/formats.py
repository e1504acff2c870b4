"""Bit-exact (de)quantization of the ggml block formats the port loads, in numpy.

A copy of the Q4_0, Q8_0 and float parts of ``booster_tpu/quant/formats.py``
(decode semantics: llama.cpp/ggml/src/ggml-quants.c dequantize_row_q4_0/q8_0,
quantize_row_q4_0_ref/q8_0_ref).  The other block formats are not ported yet.
"""

from __future__ import annotations

import numpy as np

from booster_tpu_torch.gguf.constants import GGMLType, TYPE_TRAITS

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


def _dequant_q8_0(b: np.ndarray) -> np.ndarray:
    d = _f16(b[:, 0:2])
    q = b[:, 2:34].view(np.int8).astype(np.float32)
    return q * d


_DEQUANT = {GGMLType.Q4_0: _dequant_q4_0, GGMLType.Q8_0: _dequant_q8_0}


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


_QUANT = {GGMLType.Q4_0: _quant_q4_0, GGMLType.Q8_0: _quant_q8_0}


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
