"""On-disk block store: the spill tier under the device blocks.

The port's own copy of vega_tpu/store/disk.py's DiskStore: one file per
key under a per-Context directory, written to a .tmp file and replaced into
place (a reader never sees half a block), each file a VGBK header (magic,
version, crc32, payload length) and the payload. A read checks the header
and the checksum: a corrupt, truncated or missing file is a miss, counted
in read_errors (missing: dropped silently), and its file is removed, so the
caller recomputes; a read never returns wrong bytes.

Beside put / get go the raw-block counters the dense tier uses from the
reference's TieredCache (vega_tpu/store/tiered.py: spill_raw, read_raw,
contains_raw, remove_raw, status). The port has no memory tier and no
event bus, so there is nothing else to it.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import struct
import threading
import zlib
from typing import Dict, Optional, Tuple

log = logging.getLogger(__name__)

_MAGIC = b"VGBK"
# magic(4s) version(u16) reserved(u16) crc32(u32) payload_len(u64)
_HEADER = struct.Struct("<4sHHIQ")
_VERSION = 1

_SAFE = re.compile(r"[^A-Za-z0-9._-]")


def _filename(key: str) -> str:
    """Filesystem-safe, collision-safe name for a key: the sanitized key
    keeps files attributable, the crc of the raw key tells apart keys that
    sanitize alike."""
    return f"{_SAFE.sub('_', key)[:120]}.{zlib.crc32(key.encode()):08x}.blk"


class DiskStore:
    """One file per block, checksummed, byte-accounted. The index (key ->
    (path, payload bytes)) lives in memory: the directory belongs to one
    Context and dies with it. spill_raw / read_raw are put / get counted
    as the dense tier's demotions and promotions."""

    def __init__(self, root: str):
        self._root = root
        self._index: Dict[str, Tuple[str, int]] = {}
        self._used = 0
        self._lock = threading.Lock()
        self.read_errors = 0  # checksum / format failures read as misses
        self.spill_count = 0
        self.spilled_bytes = 0
        self.promote_count = 0
        self.promoted_bytes = 0

    @property
    def root(self) -> str:
        return self._root

    def put(self, key: str, data) -> int:
        """Write one block (bytes or a buffer); returns the payload bytes
        written. Overwriting a key replaces its file."""
        os.makedirs(self._root, exist_ok=True)
        path = os.path.join(self._root, _filename(key))
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        size = memoryview(data).nbytes
        header = _HEADER.pack(_MAGIC, _VERSION, 0, zlib.crc32(data), size)
        try:
            with open(tmp, "wb") as f:
                f.write(header)
                f.write(data)
            os.replace(tmp, path)
        except OSError:
            # a failed write (ENOSPC mid-block) must not leave its partial
            # .tmp on the disk that just ran out
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        with self._lock:
            old = self._index.get(key)
            if old is not None:
                self._used -= old[1]
            self._index[key] = (path, size)
            self._used += size
        return size

    def get(self, key: str) -> Optional[memoryview]:
        """Checksummed read of the payload (a view of the file's bytes); a
        corrupt, truncated or missing file is a miss (None) and its entry
        is dropped."""
        with self._lock:
            entry = self._index.get(key)
        if entry is None:
            return None
        path, _ = entry
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            self._drop(key)
            return None
        if len(raw) < _HEADER.size:
            return self._corrupt(key, path, "truncated header")
        magic, version, _, crc, length = _HEADER.unpack_from(raw)
        payload = memoryview(raw)[_HEADER.size:]
        if magic != _MAGIC or version != _VERSION:
            return self._corrupt(key, path, "bad magic/version")
        if payload.nbytes != length or zlib.crc32(payload) != crc:
            return self._corrupt(key, path, "checksum mismatch")
        return payload

    def contains(self, key: str) -> bool:
        with self._lock:
            return key in self._index

    def path_of(self, key: str) -> Optional[str]:
        """On-disk path of a block (fault injection and diagnostics only:
        readers go through get() for the checksum)."""
        with self._lock:
            entry = self._index.get(key)
        return entry[0] if entry is not None else None

    def remove(self, key: str) -> int:
        """Delete one block; returns the payload bytes freed (0 if
        absent)."""
        with self._lock:
            entry = self._index.pop(key, None)
            if entry is None:
                return 0
            self._used -= entry[1]
        try:
            os.unlink(entry[0])
        except OSError:
            pass
        return entry[1]

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return self._used

    def __len__(self) -> int:
        with self._lock:
            return len(self._index)

    def spill_raw(self, key: str, data) -> int:
        """put(), counted as a demotion."""
        n = self.put(key, data)
        with self._lock:
            self.spill_count += 1
            self.spilled_bytes += n
        return n

    def read_raw(self, key: str) -> Optional[memoryview]:
        """get(), counted as a promotion when it hits."""
        data = self.get(key)
        if data is not None:
            with self._lock:
                self.promote_count += 1
                self.promoted_bytes += data.nbytes
        return data

    contains_raw = contains
    remove_raw = remove

    def status(self) -> Dict[str, int]:
        """The reference's TieredCache.status() keys for the disk tier."""
        with self._lock:
            return {
                "disk_bytes": self._used,
                "disk_entries": len(self._index),
                "spill_count": self.spill_count,
                "spilled_bytes": self.spilled_bytes,
                "promote_count": self.promote_count,
                "promoted_bytes": self.promoted_bytes,
                "disk_read_errors": self.read_errors,
            }

    def close(self) -> None:
        """Drop every block and remove the directory, then its parent (the
        Context's session directory) when that is left empty. The store
        stays usable: a later put re-creates the directory."""
        with self._lock:
            self._index.clear()
            self._used = 0
        shutil.rmtree(self._root, ignore_errors=True)
        try:
            os.rmdir(os.path.dirname(self._root))
        except OSError:
            pass

    def _drop(self, key: str) -> None:
        with self._lock:
            entry = self._index.pop(key, None)
            if entry is not None:
                self._used -= entry[1]

    def _corrupt(self, key: str, path: str, why: str) -> None:
        self.read_errors += 1
        log.warning("disk store: dropping corrupt block %s (%s)", key, why)
        self._drop(key)
        try:
            os.unlink(path)
        except OSError:
            pass
        return None
