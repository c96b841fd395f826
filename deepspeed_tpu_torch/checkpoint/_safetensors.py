"""A reader of the safetensors format of the port's own (no ``safetensors``
package, no ``ml_dtypes``).

The format: an 8-byte little-endian header length N, then N bytes of JSON
(``name -> {"dtype", "shape", "data_offsets": [start, end]}`` plus an
optional ``"__metadata__"`` of strings), then the tensors' raw bytes, each
tensor's offsets counted from the end of the header. The file is
memory-mapped (copy-on-write, so a returned tensor is writable without
touching the file) and a tensor comes back as a view of its bytes: no copy
until the caller makes one. bf16 becomes torch bf16 directly."""

from __future__ import annotations

import json
import mmap
import struct
from typing import Dict, List

import torch

DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


class SafetensorsFile:
    """One safetensors file, memory-mapped: ``keys()``, ``get(name)``,
    ``metadata``. Use as a context manager, or call :meth:`close`."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{path}: not a safetensors file (no header length)")
            (n,) = struct.unpack("<Q", head)
            size = f.seek(0, 2)
            if 8 + n > size:
                raise ValueError(f"{path}: header length {n} runs past the file's {size} bytes")
            f.seek(8)
            header = json.loads(f.read(n))
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        self.metadata: Dict[str, str] = header.pop("__metadata__", None) or {}
        self._base = 8 + n
        self._entries = header
        for name, e in header.items():
            start, end = e["data_offsets"]
            if not 0 <= start <= end <= size - self._base:
                raise ValueError(f"{path}: tensor {name!r} offsets {e['data_offsets']} "
                                 f"run outside the data of {size - self._base} bytes")

    def keys(self) -> List[str]:
        return list(self._entries)

    def get(self, name: str) -> torch.Tensor:
        """The tensor ``name``: a CPU view of the mapped bytes."""
        e = self._entries[name]
        dtype = DTYPES.get(e["dtype"])
        if dtype is None:
            raise ValueError(f"{self.path}: tensor {name!r} has safetensors dtype "
                             f"{e['dtype']!r}; the reader takes {sorted(DTYPES)}")
        shape = tuple(e["shape"])
        start, end = e["data_offsets"]
        numel = 1
        for s in shape:
            numel *= s
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - start != numel * itemsize:
            raise ValueError(f"{self.path}: tensor {name!r} holds {end - start} bytes, "
                             f"its shape {list(shape)} of {e['dtype']} needs {numel * itemsize}")
        if numel == 0:
            return torch.empty(shape, dtype=dtype)
        return torch.frombuffer(self._mm, dtype=dtype, count=numel,
                                offset=self._base + start).reshape(shape)

    def close(self) -> None:
        """Unmap the file. A view still held keeps the mapping alive: it is
        then unmapped when the last view goes."""
        try:
            self._mm.close()
        except BufferError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the file, each a view of the mapped bytes (the
    mapping lives as long as one of them does)."""
    f = SafetensorsFile(path)
    return {name: f.get(name) for name in f.keys()}
