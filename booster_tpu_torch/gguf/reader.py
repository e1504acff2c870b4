"""GGUF v2/v3 reader: mmap the file, parse metadata + tensor infos.

Behavioral parity target: llama_model_loader in
llama.cpp/src/llama.cpp:3582 (mmap load, typed KV metadata,
per-tensor bounds checks).  Differences by design: we return numpy views over
the mmap (zero-copy) and leave dequantization to booster_tpu_torch.quant, which
repacks into TPU-friendly layouts instead of ggml's CPU-SIMD block order.

Multi-file splits (`model-00001-of-0000N.gguf`) are supported via
``GGUFReader.open_split``, mirroring the reference's split handling
(llama.cpp:3630-3700) without the `split.no`/`split.count` KV being required.
"""

from __future__ import annotations

import mmap
import os
import re
import struct
from dataclasses import dataclass, field
from typing import Any, BinaryIO, Iterator

import numpy as np

from booster_tpu_torch.gguf.constants import (
    GGMLType,
    GGUFValueType,
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_SUPPORTED_VERSIONS,
    TYPE_TRAITS,
    tensor_nbytes,
)


class GGUFError(ValueError):
    pass


@dataclass
class GGUFTensorInfo:
    name: str
    # logical shape, row-major numpy convention (shape[-1] = contiguous dim).
    # GGUF stores dims fastest-varying first (ggml ne[0..3]); we reverse them.
    shape: tuple[int, ...]
    ggml_type: GGMLType
    offset: int  # absolute byte offset of tensor data within the file
    nbytes: int
    file_index: int = 0  # which split file holds the data

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n


_SCALAR_FORMATS = {
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

_SCALAR_DTYPES = {
    GGUFValueType.UINT8: np.uint8,
    GGUFValueType.INT8: np.int8,
    GGUFValueType.UINT16: np.uint16,
    GGUFValueType.INT16: np.int16,
    GGUFValueType.UINT32: np.uint32,
    GGUFValueType.INT32: np.int32,
    GGUFValueType.FLOAT32: np.float32,
    GGUFValueType.UINT64: np.uint64,
    GGUFValueType.INT64: np.int64,
    GGUFValueType.FLOAT64: np.float64,
}


class _Cursor:
    """Sequential binary parser over a memoryview."""

    def __init__(self, buf: memoryview, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def read(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise GGUFError(
                f"truncated GGUF: need {n} bytes at offset {self.pos}, "
                f"file has {len(self.buf)}"
            )
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        (val,) = struct.unpack(fmt, self.read(struct.calcsize(fmt)))
        return val

    def read_string(self) -> str:
        n = self.unpack("<Q")
        if n > 1 << 31:
            raise GGUFError(f"unreasonable string length {n}")
        return bytes(self.read(n)).decode("utf-8", errors="replace")

    def read_value(self, vtype: GGUFValueType) -> Any:
        if vtype == GGUFValueType.STRING:
            return self.read_string()
        if vtype == GGUFValueType.BOOL:
            return bool(self.unpack("<B"))
        if vtype == GGUFValueType.ARRAY:
            elem_type = GGUFValueType(self.unpack("<I"))
            count = self.unpack("<Q")
            if elem_type in _SCALAR_DTYPES:
                dt = np.dtype(_SCALAR_DTYPES[elem_type]).newbyteorder("<")
                raw = self.read(count * dt.itemsize)
                # copy: metadata arrays must not pin the mmap open
                return np.frombuffer(raw, dtype=dt, count=count).copy()
            return [self.read_value(elem_type) for _ in range(count)]
        fmt = _SCALAR_FORMATS.get(vtype)
        if fmt is None:
            raise GGUFError(f"unknown metadata value type {vtype}")
        return self.unpack(fmt)


@dataclass
class _MappedFile:
    path: str
    file: BinaryIO
    mm: mmap.mmap
    view: memoryview


class GGUFReader:
    """Parsed GGUF file (or split set): metadata dict + tensor catalog.

    Usage::

        with GGUFReader("model.gguf") as r:
            arch = r.metadata["general.architecture"]
            info = r.tensors["token_embd.weight"]
            raw = r.tensor_bytes(info)   # zero-copy uint8 view
    """

    def __init__(self, path: str | os.PathLike):
        self._files: list[_MappedFile] = []
        self.metadata: dict[str, Any] = {}
        self.tensors: dict[str, GGUFTensorInfo] = {}
        self.tensor_order: list[str] = []
        self.version: int = 0
        self.alignment: int = GGUF_DEFAULT_ALIGNMENT

        paths = self._resolve_splits(os.fspath(path))
        for i, p in enumerate(paths):
            self._map_and_parse(p, file_index=i, is_first=(i == 0))

    # -- construction -------------------------------------------------------

    @staticmethod
    def _resolve_splits(path: str) -> list[str]:
        m = re.match(r"^(.*)-(\d{5})-of-(\d{5})\.gguf$", path)
        if not m:
            return [path]
        base, _, total = m.group(1), m.group(2), m.group(3)
        n = int(total)
        paths = [f"{base}-{i:05d}-of-{total}.gguf" for i in range(1, n + 1)]
        for p in paths:
            if not os.path.exists(p):
                raise GGUFError(f"missing split file {p}")
        return paths

    def _map_and_parse(self, path: str, file_index: int, is_first: bool) -> None:
        f = open(path, "rb")
        try:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except Exception:
            f.close()
            raise
        view = memoryview(mm)
        self._files.append(_MappedFile(path, f, mm, view))

        cur = _Cursor(view)
        magic = cur.unpack("<I")
        if magic != GGUF_MAGIC:
            raise GGUFError(f"{path}: bad magic {magic:#x} (not GGUF)")
        version = cur.unpack("<I")
        if version not in GGUF_SUPPORTED_VERSIONS:
            raise GGUFError(f"{path}: unsupported GGUF version {version}")
        self.version = version
        n_tensors = cur.unpack("<Q")
        n_kv = cur.unpack("<Q")

        metadata: dict[str, Any] = {}
        for _ in range(n_kv):
            key = cur.read_string()
            vtype = GGUFValueType(cur.unpack("<I"))
            metadata[key] = cur.read_value(vtype)
        if is_first:
            self.metadata = metadata
            self.alignment = int(
                metadata.get("general.alignment", GGUF_DEFAULT_ALIGNMENT)
            )
        alignment = int(metadata.get("general.alignment", self.alignment))

        infos: list[tuple[str, tuple[int, ...], GGMLType, int]] = []
        for _ in range(n_tensors):
            name = cur.read_string()
            n_dims = cur.unpack("<I")
            if n_dims > 4:
                raise GGUFError(f"{path}: tensor {name} has {n_dims} dims (>4)")
            ne = [cur.unpack("<Q") for _ in range(n_dims)]
            ttype = cur.unpack("<I")
            try:
                gt = GGMLType(ttype)
            except ValueError as e:
                raise GGUFError(f"{path}: tensor {name} unknown type {ttype}") from e
            rel_offset = cur.unpack("<Q")
            # GGUF dims are ne[0]=fastest-varying; numpy shape is the reverse
            shape = tuple(reversed(ne)) if ne else (1,)
            infos.append((name, shape, gt, rel_offset))

        data_start = (cur.pos + alignment - 1) // alignment * alignment
        file_size = len(view)
        for name, shape, gt, rel_offset in infos:
            if gt not in TYPE_TRAITS:
                raise GGUFError(f"tensor {name}: unsupported ggml type {gt.name}")
            n_elem = 1
            for d in shape:
                n_elem *= d
            nbytes = tensor_nbytes(gt, n_elem)
            abs_off = data_start + rel_offset
            if abs_off + nbytes > file_size:
                raise GGUFError(
                    f"tensor {name}: data [{abs_off}, {abs_off + nbytes}) "
                    f"out of bounds (file size {file_size})"
                )
            if name in self.tensors:
                raise GGUFError(f"duplicate tensor name {name}")
            info = GGUFTensorInfo(
                name=name,
                shape=shape,
                ggml_type=gt,
                offset=abs_off,
                nbytes=nbytes,
                file_index=file_index,
            )
            self.tensors[name] = info
            self.tensor_order.append(name)

    # -- access -------------------------------------------------------------

    def tensor_bytes(self, info: GGUFTensorInfo | str) -> np.ndarray:
        """Zero-copy uint8 view of a tensor's raw (possibly quantized) bytes."""
        if isinstance(info, str):
            info = self.tensors[info]
        view = self._files[info.file_index].view
        return np.frombuffer(view, dtype=np.uint8, count=info.nbytes, offset=info.offset)

    def read_into(self, info: GGUFTensorInfo | str, out) -> None:
        """Read a tensor's raw bytes into `out` (a writable buffer of at
        least ``info.nbytes`` bytes) with file reads, not through the map:
        the loader stages the large expert stacks in one reused buffer so
        that their pages never count in the process's resident memory."""
        if isinstance(info, str):
            info = self.tensors[info]
        f = self._files[info.file_index].file
        dst = memoryview(out).cast("B")[:info.nbytes]
        f.seek(info.offset)
        done = 0
        while done < info.nbytes:
            n = f.readinto(dst[done:])
            if not n:
                raise GGUFError(f"tensor {info.name}: file ends before its data")
            done += n

    def __iter__(self) -> Iterator[GGUFTensorInfo]:
        for name in self.tensor_order:
            yield self.tensors[name]

    def get(self, key: str, default: Any = None) -> Any:
        return self.metadata.get(key, default)

    @property
    def architecture(self) -> str:
        return str(self.metadata.get("general.architecture", "unknown"))

    def field(self, key: str, default: Any = None) -> Any:
        """Metadata lookup with `{arch}` substitution, e.g. ``{arch}.block_count``."""
        return self.metadata.get(key.replace("{arch}", self.architecture), default)

    def close(self) -> None:
        for mf in self._files:
            try:
                mf.view.release()
                mf.mm.close()
            except BufferError:
                pass  # outstanding numpy tensor views keep the mmap alive
            mf.file.close()
        self._files = []

    def __enter__(self) -> "GGUFReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
