"""Memory-mapped indexed dataset (counterpart of
``deepspeed_tpu/runtime/data_pipeline/data_sampling/indexed_dataset.py``,
its own copy; reference
``runtime/data_pipeline/data_sampling/indexed_dataset.py`` — the
Megatron-derived ``MMapIndexedDataset``).

Two on-disk formats behind one reader:

- ``DSTPUIDX`` — the JAX package's native layout, which the port writes too
  (int64 sizes + byte offsets).
- ``MMIDIDX``  — the Megatron binary layout the reference reads/writes
  (``indexed_dataset.py:370`` ``_HDR_MAGIC = b'MMIDIDX\\x00\\x00'``, version
  ``<Q``, dtype code ``<B``, sequence count ``<Q``, document count ``<Q``,
  int32 sizes, int64 byte pointers, int64 doc_idx), so corpora preprocessed
  with Megatron/reference tooling load here unchanged.

``.bin`` is identical in both: concatenated sample payloads, zero-copy
``np.memmap`` reads — the host-side data path that feeds the training
input pipeline without materialising the dataset in RAM.
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Sequence

import numpy as np

_MAGIC = b"DSTPUIDX"
_VERSION = 2  # v2 appends doc_idx; v1 (no document boundaries) still reads
_MEGATRON_MAGIC = b"MMIDIDX\x00\x00"

_DTYPES = {1: np.uint8, 2: np.int8, 3: np.int16, 4: np.int32, 5: np.int64,
           6: np.float32, 7: np.float64, 8: np.uint16}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

# the reference's table (indexed_dataset.py:98-110) differs from ours in the
# float rows — 6 and 7 are BOTH float64 upstream — and extends to uint32/64
_MEGATRON_DTYPES = {1: np.uint8, 2: np.int8, 3: np.int16, 4: np.int32,
                    5: np.int64, 6: np.float64, 7: np.float64, 8: np.uint16,
                    9: np.uint32, 10: np.uint64}
_MEGATRON_CODES = {np.dtype(v): k for k, v in _MEGATRON_DTYPES.items()
                   if k != 7}  # float64 has two codes upstream; write 6


def data_file_path(prefix: str) -> str:
    return prefix + ".bin"


def index_file_path(prefix: str) -> str:
    return prefix + ".idx"


class MMapIndexedDatasetBuilder:
    """Streaming writer: ``add_item`` per sample, ``end_document`` at doc
    boundaries (preserved by both formats), then ``finalize``.

    ``fmt="dstpu"`` (default) writes the native index; ``fmt="megatron"``
    writes a reference-compatible ``MMIDIDX`` index that Megatron/DeepSpeed
    tooling can read back.
    """

    def __init__(self, out_prefix: str, dtype=np.int32, fmt: str = "dstpu"):
        if fmt not in ("dstpu", "megatron"):
            raise ValueError(f"unknown indexed-dataset format {fmt!r}")
        self._prefix = out_prefix
        self._dtype = np.dtype(dtype)
        self._fmt = fmt
        if fmt == "megatron" and self._dtype not in _MEGATRON_CODES:
            raise ValueError(f"dtype {self._dtype} has no megatron code")
        self._data_file = open(data_file_path(out_prefix), "wb")
        self._sizes: List[int] = []
        self._doc_idx: List[int] = [0]

    def add_item(self, tokens: Sequence[int]) -> None:
        arr = np.asarray(tokens, dtype=self._dtype)
        self._data_file.write(arr.tobytes(order="C"))
        self._sizes.append(arr.size)

    def end_document(self) -> None:
        """Mark a document boundary after the last added sample."""
        self._doc_idx.append(len(self._sizes))

    def merge_file_(self, another_prefix: str) -> None:
        """Append another dataset's samples, preserving its document
        boundaries (megatron doc_idx semantics; v1 native datasets carry no
        boundaries and read back as one-doc-per-sample)."""
        other = MMapIndexedDataset(another_prefix)
        bounds = set(int(b) for b in other.doc_idx[1:])
        for i in range(len(other)):
            self.add_item(other[i])
            if i + 1 in bounds:
                self.end_document()

    def finalize(self) -> None:
        self._data_file.close()
        sizes = np.asarray(self._sizes, dtype=np.int64)
        offsets = np.concatenate([[0], np.cumsum(sizes)])[:-1] * self._dtype.itemsize
        if self._doc_idx[-1] != len(self._sizes):  # trailing partial document
            self._doc_idx.append(len(self._sizes))
        with open(index_file_path(self._prefix), "wb") as f:
            if self._fmt == "megatron":
                f.write(_MEGATRON_MAGIC)
                f.write(struct.pack("<QB", 1, _MEGATRON_CODES[self._dtype]))
                f.write(struct.pack("<QQ", len(sizes), len(self._doc_idx)))
                f.write(sizes.astype(np.int32).tobytes())
                f.write(offsets.astype(np.int64).tobytes())
                f.write(np.asarray(self._doc_idx, np.int64).tobytes())
            else:
                f.write(_MAGIC)
                f.write(struct.pack("<QBQ", _VERSION, _DTYPE_CODES[self._dtype], len(sizes)))
                f.write(sizes.tobytes())
                f.write(offsets.astype(np.int64).tobytes())
                f.write(struct.pack("<Q", len(self._doc_idx)))
                f.write(np.asarray(self._doc_idx, np.int64).tobytes())


class MMapIndexedDataset:
    """Zero-copy random access over a built dataset; reads both the native
    ``DSTPUIDX`` and the reference's ``MMIDIDX`` index layouts (format is
    auto-detected from the magic)."""

    def __init__(self, prefix: str):
        self._prefix = prefix
        with open(index_file_path(prefix), "rb") as f:
            magic = f.read(len(_MEGATRON_MAGIC))  # longest magic: 9 bytes
            if magic.startswith(_MEGATRON_MAGIC):
                version, dtype_code = struct.unpack("<QB", f.read(9))
                if version != 1:
                    raise ValueError(f"unsupported MMIDIDX version {version}")
                count, doc_count = struct.unpack("<QQ", f.read(16))
                if dtype_code not in _MEGATRON_DTYPES:
                    raise ValueError(f"{index_file_path(prefix)}: unknown "
                                     f"MMIDIDX dtype code {dtype_code}")
                self._dtype = np.dtype(_MEGATRON_DTYPES[dtype_code])
                self._sizes = np.frombuffer(f.read(4 * count),
                                            dtype=np.int32).astype(np.int64)
                self._offsets = np.frombuffer(f.read(8 * count), dtype=np.int64)
                self._doc_idx = np.frombuffer(f.read(8 * doc_count), dtype=np.int64)
            elif magic.startswith(_MAGIC):
                f.seek(len(_MAGIC))
                version, dtype_code, count = struct.unpack("<QBQ", f.read(17))
                if version not in (1, 2):
                    raise ValueError(f"unsupported index version {version}")
                if dtype_code not in _DTYPES:
                    raise ValueError(f"{index_file_path(prefix)}: unknown "
                                     f"DSTPUIDX dtype code {dtype_code}")
                self._dtype = np.dtype(_DTYPES[dtype_code])
                self._sizes = np.frombuffer(f.read(8 * count), dtype=np.int64)
                self._offsets = np.frombuffer(f.read(8 * count), dtype=np.int64)
                if version >= 2:
                    doc_count, = struct.unpack("<Q", f.read(8))
                    self._doc_idx = np.frombuffer(f.read(8 * doc_count),
                                                  dtype=np.int64)
                else:  # v1 carried no boundaries: one document per sample
                    self._doc_idx = np.arange(count + 1, dtype=np.int64)
            else:
                raise ValueError(f"{index_file_path(prefix)}: bad magic {magic!r}")
        self._data = np.memmap(data_file_path(prefix), dtype=self._dtype, mode="r")

    def __len__(self) -> int:
        return len(self._sizes)

    @property
    def sizes(self) -> np.ndarray:
        return self._sizes

    @property
    def doc_idx(self) -> np.ndarray:
        """Document boundaries as sample indices (megatron semantics: entry d
        is the first sample of document d; final entry == len(self)). Native
        datasets default to one document per sample."""
        return self._doc_idx

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return [self[i] for i in range(*idx.indices(len(self)))]
        size = self._sizes[idx]
        start = self._offsets[idx] // self._dtype.itemsize
        return self._data[start:start + size]

    def get(self, idx: int, offset: int = 0, length: Optional[int] = None) -> np.ndarray:
        sample = self[idx]
        if length is None:
            length = len(sample) - offset
        return sample[offset:offset + length]

    @staticmethod
    def exists(prefix: str) -> bool:
        return os.path.exists(index_file_path(prefix)) and os.path.exists(data_file_path(prefix))
