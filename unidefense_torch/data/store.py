"""FrameStore — a memory-mapped key-value blob store for encoded frames
(unidefense_tpu/data/store.py:33-124; the same ``.udb`` format, byte for
byte).

The reference keeps face-anti-spoofing frames in LMDB (read with py-lmdb,
dataset/abstract_dataset.py:28-31). This module provides the same
read-by-key-bytes capability with:

* a dependency-free packed single-file format (``.udb``): all blobs
  concatenated, plus a JSON index of key -> (offset, length). Readers mmap
  the file; `get` is a zero-copy slice until decode. Random reads hit the
  page cache exactly like LMDB, without the C library dependency;
* optional pass-through to real LMDB environments when py-lmdb is installed
  (so existing reference LMDB datasets work unmodified).

Layout of a .udb file:
    [8-byte magic 'UDBSTOR1'][8-byte LE index_offset]
    [blob bytes ...]
    [JSON index at index_offset]
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Iterable, Optional

MAGIC = b"UDBSTOR1"


class FrameStoreWriter:
    """Streaming writer: add(key, blob) then close()."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self._f.write(struct.pack("<Q", 0))  # index offset placeholder
        self._index: dict[str, tuple[int, int]] = {}
        self._pos = 16

    def add(self, key: str, blob: bytes):
        self._f.write(blob)
        self._index[key] = (self._pos, len(blob))
        self._pos += len(blob)

    def close(self):
        index_offset = self._pos
        self._f.write(json.dumps(self._index).encode())
        self._f.seek(8)
        self._f.write(struct.pack("<Q", index_offset))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FrameStore:
    """mmap-backed reader. get(key) -> bytes (memoryview slice copy)."""

    def __init__(self, path: str):
        self.path = path
        self._file = open(path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        if self._mm[:8] != MAGIC:
            raise ValueError(f"{path} is not a FrameStore file")
        (index_offset,) = struct.unpack("<Q", self._mm[8:16])
        self._index = json.loads(self._mm[index_offset:].decode())

    def get(self, key: str) -> Optional[bytes]:
        ent = self._index.get(key)
        if ent is None:
            return None
        off, length = ent
        return bytes(self._mm[off : off + length])

    def get_view(self, key: str):
        """(offset, length) for zero-copy native decode."""
        return self._index.get(key)

    def keys(self) -> Iterable[str]:
        return self._index.keys()

    def __len__(self):
        return len(self._index)

    def close(self):
        self._mm.close()
        self._file.close()


def open_blob_source(root: str, name: str):
    """Open an LMDB environment if py-lmdb + the LMDB dir exist (reference
    data layout, dataset/abstract_dataset.py:28), else a FrameStore .udb.

    Returns an object with .get(key: str) -> bytes | None.
    """
    lmdb_dir = os.path.join(root, "lmdb", name)
    udb_path = lmdb_dir + ".udb"
    if os.path.exists(udb_path):
        return FrameStore(udb_path)
    try:
        import lmdb  # type: ignore

        if os.path.exists(lmdb_dir):
            env = lmdb.open(lmdb_dir, readonly=True, max_readers=512)
            txn = env.begin(write=False)

            class _LmdbSource:
                def get(self, key: str):
                    return txn.get(key.encode())

            return _LmdbSource()
    except ImportError:
        pass
    raise FileNotFoundError(
        f"No blob source found for root={root!r} name={name!r}: looked for "
        f"{udb_path} (FrameStore) and {lmdb_dir} (LMDB; py-lmdb required)."
    )
