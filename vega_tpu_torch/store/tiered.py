"""Tiered partition cache: the bounded memory cache backed by the disk
store, the port's copy of vega_tpu/store/tiered.py.

A datum's StorageLevel (registered by persist through put) says which
tiers it may hold: eviction from memory demotes a MEMORY_AND_DISK
partition to the disk store instead of dropping it, a get that misses
memory reads the disk and promotes the partition back, and DISK_ONLY
partitions live on disk alone (pickled row lists). Each demotion and
promotion is counted in the disk store's counters (spill_raw /
read_raw) and posted as BlockSpilled / BlockPromoted once the Context
wires event_sink to its bus.
"""

from __future__ import annotations

import logging
import pickle
from typing import Any, Dict, Optional, Tuple

from vega_tpu_torch.cache import BoundedMemoryCache, KeySpace
from vega_tpu_torch.lint.sync_witness import named_lock
from vega_tpu_torch.store.disk import DiskStore
from vega_tpu_torch.store.level import StorageLevel

log = logging.getLogger(__name__)


def _disk_key(space: KeySpace, datum_id: int, partition: int) -> str:
    return f"cache-{space.name.lower()}-{datum_id}-{partition}"


class TieredCache:
    def __init__(self, memory: BoundedMemoryCache, disk: DiskStore):
        self.memory = memory
        self.disk = disk
        memory.on_evict = self._on_memory_evict
        self._levels: Dict[Tuple[KeySpace, int], StorageLevel] = {}
        self._lock = named_lock("store.tiered.TieredCache._lock")
        self.event_sink = None
        self._oversize_logged = False

    # --- levels -------------------------------------------------------------
    def set_level(self, space: KeySpace, datum_id: int, level) -> None:
        level = StorageLevel.coerce(level)
        with self._lock:
            self._levels[(space, datum_id)] = level

    def level_for(self, space: KeySpace, datum_id: int) -> StorageLevel:
        with self._lock:
            return self._levels.get((space, datum_id),
                                    StorageLevel.MEMORY_ONLY)

    # --- the cache ----------------------------------------------------------
    def put(self, space: KeySpace, datum_id: int, partition: int, value: Any,
            level=None) -> bool:
        """Insert under the datum's level; a value larger than the memory
        tier goes to disk (DISK_ONLY for that block)."""
        if level is not None:
            self.set_level(space, datum_id, level)
        lvl = self.level_for(space, datum_id)
        if not lvl.use_memory:
            self.memory.remove(space, datum_id, partition)
            return self._spill_value(space, datum_id, partition, value)
        # a stale disk copy of an earlier demotion must not resurface;
        # removed before the insert, after which a concurrent eviction may
        # already have demoted this very value
        self.disk.remove(_disk_key(space, datum_id, partition))
        if self.memory.put(space, datum_id, partition, value):
            return True
        if not self._oversize_logged:
            self._oversize_logged = True
            log.warning("cache: value larger than the memory capacity: "
                        "stored to disk (DISK_ONLY for this block); later "
                        "oversize values spill silently")
        self.memory.remove(space, datum_id, partition)
        return self._spill_value(space, datum_id, partition, value)

    def get(self, space: KeySpace, datum_id: int,
            partition: int) -> Optional[Any]:
        value = self.memory.get(space, datum_id, partition)
        if value is not None:
            return value
        key = _disk_key(space, datum_id, partition)
        data = self.disk.read_raw(key)
        if data is None:
            return None
        value = pickle.loads(data)
        if self.level_for(space, datum_id).use_memory:
            self.memory.put(space, datum_id, partition, value)
        self._emit("BlockPromoted", key, data.nbytes)
        return value

    def remove_datum(self, space: KeySpace, datum_id: int) -> None:
        self.memory.remove_datum(space, datum_id)
        self.disk.remove_prefix(f"cache-{space.name.lower()}-{datum_id}-")
        with self._lock:
            self._levels.pop((space, datum_id), None)

    @property
    def used_bytes(self) -> int:
        return self.memory.used_bytes

    @property
    def disk_used_bytes(self) -> int:
        return self.disk.used_bytes

    @property
    def evictions(self) -> int:
        return self.memory.evictions

    # the demotion and promotion counters, kept by the disk store
    @property
    def spill_count(self) -> int:
        return self.disk.spill_count

    @property
    def spilled_bytes(self) -> int:
        return self.disk.spilled_bytes

    @property
    def promote_count(self) -> int:
        return self.disk.promote_count

    @property
    def promoted_bytes(self) -> int:
        return self.disk.promoted_bytes

    def close(self) -> None:
        """Clear both tiers and remove the disk store's directory."""
        self.memory.clear()
        with self._lock:
            self._levels.clear()
        self.disk.close()

    def status(self) -> Dict[str, Any]:
        """The reference's status keys: the memory tier's bytes and
        evictions, then the disk store's counters."""
        return {"mem_bytes": self.memory.used_bytes,
                "evictions": self.memory.evictions, **self.disk.status()}

    # --- internal -----------------------------------------------------------
    def _on_memory_evict(self, key, value, size) -> None:
        space, datum_id, partition = key
        if not self.level_for(space, datum_id).use_disk:
            return
        if self.disk.contains(_disk_key(space, datum_id, partition)):
            return  # already demoted once (partitions never change)
        self._spill_value(space, datum_id, partition, value)

    def _spill_value(self, space, datum_id, partition, value) -> bool:
        """Best effort: a failed disk write leaves the block uncached, and
        the next miss recomputes it."""
        key = _disk_key(space, datum_id, partition)
        try:
            n = self.disk.spill_raw(key, pickle.dumps(value, protocol=5))
        except Exception:  # noqa: BLE001 — uncached, not a failed task
            log.warning("cache spill of %s failed; block not cached", key,
                        exc_info=True)
            return False
        self._emit("BlockSpilled", key, n)
        return True

    def _emit(self, kind: str, key: str, nbytes: int) -> None:
        sink = self.event_sink
        if sink is None:
            return
        from vega_tpu_torch.scheduler import events

        sink(getattr(events, kind)(store="cache", key=key, nbytes=nbytes))
