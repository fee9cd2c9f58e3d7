"""In-tree reader and writer of the safetensors file format.

The card's machine has no ``safetensors`` package, and the port must not
need one. The format is small: an 8-byte little-endian header length N,
N bytes of JSON (``{name: {"dtype", "shape", "data_offsets": [begin,
end]}, "__metadata__": {str: str}}``), then the raw little-endian tensor
bytes, each tensor's range relative to the start of that buffer.

The writer lays a file out as the ``safetensors`` package does, byte for
byte: tensors ordered by dtype (widest type first, in the package's order)
and then by name, compact JSON, the header padded with spaces to a
multiple of 8 bytes. Files from either side read on the other.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Mapping, Optional

import numpy as np
import torch

_DTYPES = {
    "BOOL": torch.bool,
    "U8": torch.uint8,
    "I8": torch.int8,
    "I16": torch.int16,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I32": torch.int32,
    "F32": torch.float32,
    "F64": torch.float64,
    "I64": torch.int64,
}
_NAMES = {v: k for k, v in _DTYPES.items()}
# the package's dtype order (it writes the highest first)
_ORDER = ["BOOL", "U8", "I8", "I16", "U16", "F16", "BF16", "I32", "U32",
          "F32", "F64", "I64", "U64"]


def _as_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().contiguous()
    return torch.from_numpy(np.ascontiguousarray(value))


def _raw_bytes(t: torch.Tensor) -> bytes:
    if t.numel() == 0:
        return b""
    flat = t.reshape(-1)
    if t.dtype == torch.bfloat16:
        flat = flat.view(torch.int16)  # numpy has no bfloat16
    arr = flat.numpy()
    return arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()


def save_file(tensors: Mapping[str, object], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write {name: tensor or array} to ``path``."""
    items = []
    for name, value in tensors.items():
        t = _as_tensor(value)
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors code")
        items.append((name, _NAMES[t.dtype], t))
    items.sort(key=lambda it: (-_ORDER.index(it[1]), it[0]))

    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    chunks = []
    offset = 0
    for name, code, t in items:
        raw = _raw_bytes(t)
        header[name] = {
            "dtype": code,
            "shape": list(t.shape),
            "data_offsets": [offset, offset + len(raw)],
        }
        chunks.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in chunks:
            f.write(raw)


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Read every tensor of ``path`` as a CPU tensor that owns its memory."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8:
        raise ValueError(f"{path}: not a safetensors file (too short)")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise ValueError(f"{path}: header length {n} exceeds the file")
    header = json.loads(data[8:8 + n])
    header.pop("__metadata__", None)
    buf = memoryview(data)[8 + n:]
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        code = info["dtype"]
        if code not in _DTYPES:
            raise ValueError(f"{path}: {name} has unsupported dtype {code}")
        dtype = _DTYPES[code]
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if not 0 <= begin <= end <= len(buf):
            raise ValueError(f"{path}: {name} lies outside the data buffer")
        raw = bytearray(buf[begin:end])
        if dtype == torch.bfloat16:
            t = torch.frombuffer(raw, dtype=torch.int16).view(torch.bfloat16) \
                if raw else torch.empty(0, dtype=dtype)
        else:
            t = torch.frombuffer(raw, dtype=dtype) if raw else torch.empty(
                0, dtype=dtype)
        if t.numel() != int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{path}: {name} has {t.numel()} values for "
                             f"shape {shape}")
        out[name] = t.reshape(shape)
    return out
