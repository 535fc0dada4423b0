"""Shuffle bucket store, RAM first and disk under pressure: the port's
copy of vega_tpu/shuffle/store.py.

Buckets are keyed (shuffle_id, map_id, reduce_id) and hold the rows a
map task wrote for one reduce partition (pickled, or the native
runtime's VN01 / VG01 frames); the coded shuffle's parity frames live
under reserved negative map ids (fold_parity). A bucket larger than
spill_threshold goes straight to disk; past memory_budget in-RAM bytes
the oldest buckets spill (each written before it leaves memory, so a
reader always finds it in one tier). Disk reads go through the disk
store's checksummed read (store/disk.py): a corrupt spilled bucket reads
as missing, the reduce task's fetch fails (shuffle/fetcher.py) and the
scheduler recomputes the map output; wrong bytes are never served.
"""

from __future__ import annotations

import logging
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

from vega_tpu_torch import faults
from vega_tpu_torch.lint.sync_witness import named_lock
from vega_tpu_torch.store.disk import DiskStore

log = logging.getLogger(__name__)

Key = Tuple[int, int, int]  # (shuffle_id, map_id, reduce_id)

SPILL_THRESHOLD = 64 * 1024 * 1024
MEMORY_BUDGET = 1 << 30


def _disk_key(shuffle_id: int, map_id: int, reduce_id: int) -> str:
    return f"shuffle-{shuffle_id}-{map_id}-{reduce_id}"


class ShuffleStore:
    def __init__(self, spill_dir: Optional[str] = None,
                 spill_threshold: int = SPILL_THRESHOLD,
                 memory_budget: int = MEMORY_BUDGET):
        self._mem: "OrderedDict[Key, bytes]" = OrderedDict()
        self._mem_bytes = 0
        self._lock = named_lock("shuffle.store.ShuffleStore._lock")
        self._disk = DiskStore(spill_dir) if spill_dir else None
        self._spill_threshold = spill_threshold
        self._memory_budget = memory_budget
        self.spill_count = 0
        self.spilled_bytes = 0
        # the coded shuffle's parity frames folded here, and their bytes
        self.parity_folds = 0
        self.parity_bytes = 0
        # serializes fold_parity's read-modify-write; taken before _lock
        # (through get / put), never after
        self._parity_lock = named_lock("shuffle.store.parity_fold")
        # set by the Context to its bus's post (BlockSpilled)
        self.event_sink = None

    def put(self, shuffle_id: int, map_id: int, reduce_id: int,
            data: bytes) -> None:
        key = (shuffle_id, map_id, reduce_id)
        if self._disk is not None and len(data) > self._spill_threshold:
            if self._spill(key, data):
                with self._lock:
                    old = self._mem.pop(key, None)
                    if old is not None:
                        self._mem_bytes -= len(old)
                return
            # the disk refused: hold the bucket in RAM
        if self._disk is not None:
            # a rewrite (a retried map task) makes an earlier disk copy
            # stale; removed before the insert, after which a concurrent
            # spill may already have demoted the fresh bucket
            self._disk.remove(_disk_key(*key))
        with self._lock:
            old = self._mem.pop(key, None)
            if old is not None:
                self._mem_bytes -= len(old)
            self._mem[key] = data
            self._mem_bytes += len(data)
        if self._disk is not None:
            self._enforce_budget()

    def get(self, shuffle_id: int, map_id: int,
            reduce_id: int) -> Optional[bytes]:
        key = (shuffle_id, map_id, reduce_id)
        with self._lock:
            data = self._mem.get(key)
        if data is not None:
            return data
        if self._disk is not None:
            return self._disk.get(_disk_key(*key))
        return None

    def iter_buckets(self, shuffle_id: int, map_ids, reduce_id: int):
        """(map_id, bucket or None) for each map id in order, each read
        when the caller asks for it (a shuffle server streams them)."""
        for map_id in map_ids:
            yield map_id, self.get(shuffle_id, map_id, reduce_id)

    def fold_parity(self, shuffle_id: int, group_id: int, unit: int,
                    reduce_id: int, map_id: int, idx: int, scheme: str,
                    k: int, raw: bytes) -> None:
        """One member bucket folded into the (group, unit, reduce) parity
        frame under its reserved map id (coding.parity_map_id). ValueError
        when the stored frame fails its checks: the server then refuses
        the push."""
        from vega_tpu_torch.shuffle import coding

        pkey = coding.parity_map_id(group_id, unit)
        with self._parity_lock:
            old = self.get(shuffle_id, pkey, reduce_id)
            frame = coding.fold_frame(old, scheme, k, unit, map_id, idx, raw)
            self.put(shuffle_id, pkey, reduce_id, frame)
            with self._lock:
                self.parity_folds += 1
                self.parity_bytes += len(frame) - (len(old) if old else 0)

    def contains(self, shuffle_id: int, map_id: int, reduce_id: int) -> bool:
        key = (shuffle_id, map_id, reduce_id)
        with self._lock:
            if key in self._mem:
                return True
        return self._disk is not None and self._disk.contains(
            _disk_key(*key))

    def remove_shuffle(self, shuffle_id: int) -> None:
        """Drop every bucket of a shuffle."""
        with self._lock:
            for key in [k for k in self._mem if k[0] == shuffle_id]:
                self._mem_bytes -= len(self._mem.pop(key))
        if self._disk is not None:
            self._disk.remove_prefix(f"shuffle-{shuffle_id}-")

    def spill_all(self) -> int:
        """Every in-RAM bucket to disk; returns how many spilled."""
        if self._disk is None:
            return 0
        n = 0
        while self._spill_oldest():
            n += 1
        return n

    def clear(self) -> None:
        with self._lock:
            self._mem.clear()
            self._mem_bytes = 0
        if self._disk is not None:
            self._disk.clear()

    def close(self) -> None:
        """Drop everything and remove the spill directory."""
        self.clear()
        if self._disk is not None:
            self._disk.close()

    def status(self) -> Dict[str, Any]:
        with self._lock:
            mem_entries = len(self._mem)
            mem_bytes = self._mem_bytes
        disk = self._disk
        return {
            "entries": mem_entries + (len(disk) if disk else 0),
            "mem_entries": mem_entries,
            "mem_bytes": mem_bytes,
            "disk_entries": len(disk) if disk else 0,
            "disk_bytes": disk.used_bytes if disk else 0,
            "spill_count": self.spill_count,
            "spilled_bytes": self.spilled_bytes,
            "parity_folds": self.parity_folds,
            "parity_bytes": self.parity_bytes,
            # checksum failures read as misses: corruption caught, not
            # served
            "read_errors": disk.read_errors if disk else 0,
        }

    def __len__(self):
        with self._lock:
            n = len(self._mem)
        return n + (len(self._disk) if self._disk else 0)

    # --- internal -----------------------------------------------------------
    def _enforce_budget(self) -> None:
        """Oldest first until the RAM bytes fit; one bucket always stays."""
        while True:
            with self._lock:
                if self._mem_bytes <= self._memory_budget \
                        or len(self._mem) <= 1:
                    return
            if not self._spill_oldest():
                return

    def _spill_oldest(self) -> bool:
        with self._lock:
            if not self._mem:
                return False
            key = next(iter(self._mem))
            data = self._mem[key]
        if not self._spill(key, data):
            return False
        with self._lock:
            if self._mem.get(key) is data:  # unchanged since the write
                del self._mem[key]
                self._mem_bytes -= len(data)
        return True

    def _spill(self, key: Key, data: bytes) -> bool:
        """Best-effort disk write; False keeps the bucket in RAM."""
        dkey = _disk_key(*key)
        try:
            self._disk.put(dkey, data)
        except OSError:
            log.warning("shuffle spill of %s failed; bucket stays in RAM",
                        dkey, exc_info=True)
            return False
        faults.get().corrupt_spilled(self._disk, dkey)
        with self._lock:
            self.spill_count += 1
            self.spilled_bytes += len(data)
        sink = self.event_sink
        if sink is not None:
            from vega_tpu_torch.scheduler.events import BlockSpilled

            sink(BlockSpilled(store="shuffle", key=dkey, nbytes=len(data)))
        return True
