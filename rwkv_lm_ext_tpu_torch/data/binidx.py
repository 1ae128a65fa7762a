"""Memory-mapped indexed dataset (Megatron-style MMIDIDX format).

A jax-free copy of rwkv_lm_ext_tpu/data/binidx.py:40-129 (IndexedDataset,
the numpy memmap reader, and IndexedDatasetWriter): the JAX package's
modules cannot be imported without JAX. The layout is the reference's
(src/binidx.py): magic b"MMIDIDX\\x00\\x00", version u64, dtype-code u8,
count u64, doc_count u64, sizes i32[count], pointers i64[count],
doc_idx i64[doc_count]; tokens raw in the .bin file. Files are byte for
byte the JAX writer's, and each package reads the other's.
"""
from __future__ import annotations

import struct
from typing import Optional, Sequence

import numpy as np

_MAGIC = b"MMIDIDX\x00\x00"
_VERSION = 1

DTYPES = {
    1: np.uint8,
    2: np.int8,
    3: np.int16,
    4: np.int32,
    5: np.int64,
    6: np.float32,
    7: np.float64,
    8: np.uint16,
}
_CODES = {np.dtype(v): k for k, v in DTYPES.items()}


def _idx_path(prefix: str) -> str:
    return prefix + ".idx"


def _bin_path(prefix: str) -> str:
    return prefix + ".bin"


class IndexedDataset:
    """Read-only mmap view over a binidx pair (`prefix.idx` + `prefix.bin`)."""

    def __init__(self, prefix: str):
        with open(_idx_path(prefix), "rb") as f:
            magic = f.read(9)
            if magic != _MAGIC:
                raise ValueError(f"{prefix}.idx: bad magic {magic!r}")
            (version,) = struct.unpack("<Q", f.read(8))
            if version != _VERSION:
                raise ValueError(f"unsupported binidx version {version}")
            (code,) = struct.unpack("<B", f.read(1))
            self.dtype = np.dtype(DTYPES[code])
            (count,) = struct.unpack("<Q", f.read(8))
            (doc_count,) = struct.unpack("<Q", f.read(8))
            offset = f.tell()
        idx_map = np.memmap(_idx_path(prefix), mode="r", dtype=np.uint8)
        self.sizes = idx_map[offset : offset + 4 * count].view(np.int32)
        offset += 4 * count
        self.pointers = idx_map[offset : offset + 8 * count].view(np.int64)
        offset += 8 * count
        self.doc_idx = idx_map[offset : offset + 8 * doc_count].view(np.int64)
        self._data = np.memmap(_bin_path(prefix), mode="r", dtype=self.dtype)
        self._item = self.dtype.itemsize

    def __len__(self) -> int:
        return len(self.sizes)

    def __getitem__(self, i: int) -> np.ndarray:
        start = self.pointers[i] // self._item
        return self._data[start : start + self.sizes[i]]

    def get(
        self, i: int, offset: int = 0, length: Optional[int] = None
    ) -> np.ndarray:
        """Sub-range of document i (the reference's .get accessor)."""
        start = self.pointers[i] // self._item + offset
        if length is None:
            length = self.sizes[i] - offset
        return self._data[start : start + length]

    def slice_tokens(self, start: int, length: int) -> np.ndarray:
        """Flat token-stream view (pretraining sampling ignores doc
        boundaries, src/dataset.py:140-160)."""
        return self._data[start : start + length]

    @property
    def total_tokens(self) -> int:
        return len(self._data)


class IndexedDatasetWriter:
    """Stream documents to a binidx pair."""

    def __init__(self, prefix: str, dtype=np.uint16):
        self.prefix = prefix
        self.dtype = np.dtype(dtype)
        self._bin = open(_bin_path(prefix), "wb")
        self.sizes = []
        self.doc_idx = [0]

    def add_document(self, tokens: Sequence[int]) -> None:
        arr = np.asarray(tokens, dtype=self.dtype)
        self._bin.write(arr.tobytes(order="C"))
        self.sizes.append(len(arr))
        self.doc_idx.append(len(self.sizes))

    def finalize(self) -> None:
        self._bin.close()
        item = self.dtype.itemsize
        pointers = np.zeros(len(self.sizes), dtype=np.int64)
        acc = 0
        for i, s in enumerate(self.sizes):
            pointers[i] = acc
            acc += s * item
        with open(_idx_path(self.prefix), "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<Q", _VERSION))
            f.write(struct.pack("<B", _CODES[self.dtype]))
            f.write(struct.pack("<Q", len(self.sizes)))
            f.write(struct.pack("<Q", len(self.doc_idx)))
            f.write(np.asarray(self.sizes, np.int32).tobytes(order="C"))
            f.write(pointers.tobytes(order="C"))
            f.write(np.asarray(self.doc_idx, np.int64).tobytes(order="C"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finalize()
