"""The safetensors file format, read and written without the safetensors
package.

A file is an 8-byte little-endian header length n, n bytes of JSON header
padded with spaces to a multiple of 8, then the tensors' raw little-endian
bytes, back to back. The header maps each name to {"dtype", "shape",
"data_offsets": [begin, end]} (offsets into the bytes after the header)
and may hold string metadata under "__metadata__".

``save_file`` writes the bytes ``safetensors.torch.save_file`` writes for
the same tensors: tensors ordered by dtype, widest first in the package's
own dtype order, then by name; compact JSON with "__metadata__" first.
The package emits its metadata keys in hash order, which changes from
process to process; this writer sorts them, so with one key or none the
two files are byte-identical, and with more they differ only in that
order.
"""

from __future__ import annotations

import json
import struct
import sys
from typing import Dict, Optional, Tuple

import torch

# the package's dtype names, in the order of its Dtype enum (it sorts
# tensors by this order, descending)
_DTYPES = (
    ("BOOL", torch.bool), ("U8", torch.uint8), ("I8", torch.int8),
    ("F8_E5M2", torch.float8_e5m2), ("F8_E4M3", torch.float8_e4m3fn),
    ("I16", torch.int16), ("U16", torch.uint16), ("F16", torch.float16),
    ("BF16", torch.bfloat16), ("I32", torch.int32), ("U32", torch.uint32),
    ("F32", torch.float32), ("F64", torch.float64), ("I64", torch.int64),
    ("U64", torch.uint64),
)
_NAME = {dt: name for name, dt in _DTYPES}
_DTYPE = dict(_DTYPES)
_RANK = {dt: i for i, (_, dt) in enumerate(_DTYPES)}


def _check_byteorder() -> None:
    if sys.byteorder != "little":
        raise RuntimeError("safetensors data is little-endian; this host "
                           "is not")


def _raw(t: torch.Tensor) -> bytes:
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (name → tensor, copied to contiguous CPU memory)
    and the string ``metadata`` to ``path``."""
    _check_byteorder()
    items = []
    for name, t in tensors.items():
        if not isinstance(name, str):
            raise TypeError(f"tensor names are strings, got {name!r}")
        if t.dtype not in _NAME:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors "
                             f"name")
        items.append((name, t.detach().cpu().contiguous()))
    items.sort(key=lambda kv: (-_RANK[kv[1].dtype], kv[0]))
    header: dict = {}
    if metadata is not None:
        for k, v in metadata.items():
            if not isinstance(k, str) or not isinstance(v, str):
                raise TypeError(f"metadata is str → str, got {k!r}: {v!r}")
        header["__metadata__"] = dict(sorted(metadata.items()))
    offset = 0
    for name, t in items:
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAME[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    text = json.dumps(header, separators=(",", ":"),
                      ensure_ascii=False).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for _, t in items:
            f.write(_raw(t))


def load_file(path: str) -> Tuple[Dict[str, torch.Tensor],
                                  Optional[Dict[str, str]]]:
    """(tensors, metadata) of a safetensors file: CPU tensors by name, in
    the file's order, and its metadata (None when it has none). A header
    whose offsets do not tile the data exactly raises ValueError."""
    _check_byteorder()
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    (n,) = struct.unpack("<Q", raw[:8])
    if 8 + n > len(raw):
        raise ValueError(f"{path}: header length {n} beyond the file")
    try:
        header = json.loads(raw[8:8 + n])
    except ValueError as e:
        raise ValueError(f"{path}: unreadable header ({e})") from None
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is not a JSON object")
    data = memoryview(raw)[8 + n:]
    metadata = header.pop("__metadata__", None)
    spans = []
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        try:
            dt = _DTYPE[info["dtype"]]
            shape = [int(d) for d in info["shape"]]
            begin, end = (int(o) for o in info["data_offsets"])
        except (KeyError, TypeError, ValueError):
            raise ValueError(f"{path}: bad header entry {name!r}: "
                             f"{info!r}") from None
        numel = 1
        for d in shape:
            numel *= d
        itemsize = torch.empty((), dtype=dt).element_size()
        if end - begin != numel * itemsize or not 0 <= begin <= end:
            raise ValueError(f"{path}: {name} spans bytes [{begin}, {end}) "
                             f"but holds {numel} x {itemsize} bytes")
        spans.append((begin, end, name))
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dt)
        else:
            out[name] = torch.frombuffer(bytearray(data[begin:end]),
                                         dtype=dt).reshape(shape)
    at = 0
    for begin, end, name in sorted(spans):
        if begin != at:
            raise ValueError(f"{path}: {name} starts at byte {begin}, "
                             f"expected {at}")
        at = end
    if at != len(data):
        raise ValueError(f"{path}: {len(data) - at} bytes after the last "
                         f"tensor")
    return out, metadata
