"""Minimal safetensors reader and writer (numpy only): the port's own copy of
the file format the JAX package reads and writes.

Format: 8-byte little-endian header length, a JSON header
``{name: {dtype, shape, data_offsets}}`` (an optional ``__metadata__`` dict of
strings first), then the raw little-endian tensor bytes.  bf16 tensors are
kept as raw ``uint16`` bits.  Reads are lazy, through a memory map.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Optional, Tuple

import numpy as np

_DTYPES = {
    "F64": np.dtype("<f8"),
    "F32": np.dtype("<f4"),
    "F16": np.dtype("<f2"),
    "BF16": np.dtype("<u2"),   # raw bits
    "I64": np.dtype("<i8"),
    "I32": np.dtype("<i4"),
    "I16": np.dtype("<i2"),
    "I8": np.dtype("<i1"),
    "U8": np.dtype("<u1"),
    "BOOL": np.dtype("<u1"),
}

_NP_TO_ST = {
    np.dtype("float64"): "F64",
    np.dtype("float32"): "F32",
    np.dtype("float16"): "F16",
    np.dtype("int64"): "I64",
    np.dtype("int32"): "I32",
    np.dtype("int16"): "I16",
    np.dtype("int8"): "I8",
    np.dtype("uint8"): "U8",
    np.dtype("bool"): "BOOL",
}


class SafetensorsFile:
    """Lazy reader over a memory-mapped safetensors file."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            (header_len,) = struct.unpack("<Q", f.read(8))
            self.header = json.loads(f.read(header_len))
        self.metadata = self.header.pop("__metadata__", {})
        self._data_offset = 8 + header_len
        self._mm = np.memmap(path, mode="r", dtype=np.uint8)

    def keys(self):
        return self.header.keys()

    def info(self, name: str) -> Tuple[str, Tuple[int, ...]]:
        """(safetensors dtype, shape) of a tensor, read from the header."""
        e = self.header[name]
        return e["dtype"], tuple(e["shape"])

    def tensor(self, name: str, as_f32: bool = False) -> np.ndarray:
        """The tensor's array (bf16 as raw bits); ``as_f32`` converts any
        floating dtype, bf16 included, to float32."""
        e = self.header[name]
        start = self._data_offset + e["data_offsets"][0]
        end = self._data_offset + e["data_offsets"][1]
        arr = np.frombuffer(self._mm[start:end], dtype=_DTYPES[e["dtype"]]).reshape(e["shape"])
        if not as_f32:
            return arr
        if e["dtype"] == "BF16":
            return (arr.astype(np.uint32) << 16).view(np.float32)
        return arr.astype(np.float32)


def save_safetensors(path: str, tensors: Dict[str, np.ndarray],
                     metadata: Optional[Dict[str, str]] = None,
                     dtype_map: Optional[Dict[str, str]] = None) -> None:
    """``metadata`` becomes the header's ``__metadata__``; ``dtype_map``
    overrides the declared dtype per tensor name (raw-bits uint16 arrays that
    are really BF16)."""
    dtype_map = dtype_map or {}
    header: Dict[str, dict] = {}
    if metadata:
        header["__metadata__"] = metadata
    offset = 0
    blobs = []
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        if name in dtype_map:
            st_dtype = dtype_map[name]
        elif arr.dtype in _NP_TO_ST:
            st_dtype = _NP_TO_ST[arr.dtype]
        else:
            raise ValueError(f"unsupported dtype {arr.dtype} for {name}")
        raw = arr.tobytes()
        header[name] = {"dtype": st_dtype, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        offset += len(raw)
        blobs.append(raw)
    hjson = json.dumps(header).encode()
    hjson += b" " * ((-len(hjson)) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for b in blobs:
            f.write(b)
