"""GGUF v3 writer.

Used by tests (build tiny synthetic models), by tools/convert (HF -> GGUF) and
by tools/quantize.  Counterpart of the reference's gguf write path
(llama.cpp/ggml/src/ggml.c:20996 gguf_write_to_file semantics).
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, Callable

import numpy as np

from booster_tpu_torch.gguf.constants import (
    GGMLType,
    GGUFValueType,
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    tensor_nbytes,
)

_SCALAR_PACK = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}

_NUMPY_TO_VTYPE = {
    np.dtype(np.uint8): GGUFValueType.UINT8,
    np.dtype(np.int8): GGUFValueType.INT8,
    np.dtype(np.uint16): GGUFValueType.UINT16,
    np.dtype(np.int16): GGUFValueType.INT16,
    np.dtype(np.uint32): GGUFValueType.UINT32,
    np.dtype(np.int32): GGUFValueType.INT32,
    np.dtype(np.float32): GGUFValueType.FLOAT32,
    np.dtype(np.uint64): GGUFValueType.UINT64,
    np.dtype(np.int64): GGUFValueType.INT64,
    np.dtype(np.float64): GGUFValueType.FLOAT64,
}


def _infer_vtype(value: Any) -> GGUFValueType:
    if isinstance(value, bool):
        return GGUFValueType.BOOL
    if isinstance(value, int):
        if value < 0:
            return GGUFValueType.INT64 if abs(value) > 1 << 31 else GGUFValueType.INT32
        return GGUFValueType.UINT64 if value >= 1 << 32 else GGUFValueType.UINT32
    if isinstance(value, float):
        return GGUFValueType.FLOAT32
    if isinstance(value, str):
        return GGUFValueType.STRING
    if isinstance(value, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot infer GGUF value type for {type(value)}")


class GGUFWriter:
    """Accumulate metadata + tensors, then serialize a single GGUF v3 file."""

    def __init__(self, alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.alignment = alignment
        self._kv: list[tuple[str, GGUFValueType, Any]] = []
        # (name, gguf-order dims (ne[0] fastest), type, raw bytes)
        self._tensors: list[tuple[str, list[int], GGMLType, bytes]] = []
        if alignment != GGUF_DEFAULT_ALIGNMENT:
            self.add("general.alignment", alignment, GGUFValueType.UINT32)

    def add(self, key: str, value: Any, vtype: GGUFValueType | None = None) -> None:
        self._kv.append((key, vtype or _infer_vtype(value), value))

    def add_tensor(
        self,
        name: str,
        data: bytes | np.ndarray | Callable[[], bytes],
        shape: tuple[int, ...],
        ggml_type: GGMLType,
    ) -> None:
        """`shape` uses numpy convention (last dim contiguous); raw quantized
        bytes for quant types, or a float/int array for F32/F16/etc.  A
        callable is called for the bytes while the file is written, in the
        order the tensors were added, so that a large file never holds more
        than one tensor in memory."""
        if isinstance(data, np.ndarray):
            data = np.ascontiguousarray(data).tobytes()
        ne = list(reversed(shape))
        self._tensors.append((name, ne, ggml_type, data))
        if not callable(data):
            self._check(name, data, ne, ggml_type)

    @staticmethod
    def _check(name: str, data: bytes, ne: list[int], ggml_type: GGMLType) -> None:
        n_elem = int(np.prod(ne)) if ne else 1
        expect = tensor_nbytes(ggml_type, n_elem)
        if len(data) != expect:
            raise ValueError(
                f"tensor {name}: got {len(data)} bytes, expected {expect} "
                f"for shape {tuple(reversed(ne))} type {ggml_type.name}"
            )

    # -- serialization ------------------------------------------------------

    def _write_str(self, f: BinaryIO, s: str) -> None:
        b = s.encode("utf-8")
        f.write(struct.pack("<Q", len(b)))
        f.write(b)

    def _write_value(self, f: BinaryIO, vtype: GGUFValueType, value: Any) -> None:
        if vtype == GGUFValueType.STRING:
            self._write_str(f, value)
        elif vtype == GGUFValueType.BOOL:
            f.write(struct.pack("<B", 1 if value else 0))
        elif vtype == GGUFValueType.ARRAY:
            if isinstance(value, np.ndarray) and value.dtype in _NUMPY_TO_VTYPE:
                et = _NUMPY_TO_VTYPE[value.dtype]
                f.write(struct.pack("<IQ", int(et), value.size))
                f.write(np.ascontiguousarray(value).tobytes())
            else:
                seq = list(value)
                if seq and isinstance(seq[0], str):
                    et = GGUFValueType.STRING
                elif seq and isinstance(seq[0], float):
                    et = GGUFValueType.FLOAT32
                else:
                    et = GGUFValueType.INT32
                f.write(struct.pack("<IQ", int(et), len(seq)))
                for v in seq:
                    self._write_value(f, et, v)
        else:
            f.write(struct.pack(_SCALAR_PACK[vtype], value))

    def write(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(struct.pack("<IIQQ", GGUF_MAGIC, 3, len(self._tensors), len(self._kv)))
            for key, vtype, value in self._kv:
                self._write_str(f, key)
                f.write(struct.pack("<I", int(vtype)))
                self._write_value(f, vtype, value)

            offset = 0
            for name, ne, gt, _ in self._tensors:
                self._write_str(f, name)
                f.write(struct.pack("<I", len(ne)))
                for d in ne:
                    f.write(struct.pack("<Q", d))
                f.write(struct.pack("<I", int(gt)))
                f.write(struct.pack("<Q", offset))
                offset += tensor_nbytes(gt, int(np.prod(ne)) if ne else 1)
                offset = (offset + self.alignment - 1) // self.alignment * self.alignment

            pos = f.tell()
            pad = (pos + self.alignment - 1) // self.alignment * self.alignment - pos
            f.write(b"\x00" * pad)
            for name, ne, gt, data in self._tensors:
                if callable(data):
                    data = data()
                    self._check(name, data, ne, gt)
                f.write(data)
                f.write(b"\x00" * ((-len(data)) % self.alignment))
