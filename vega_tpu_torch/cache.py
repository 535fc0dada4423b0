"""Bounded in-memory partition cache with LRU eviction: the port's copy
of vega_tpu/cache.py.

Entries are keyed (KeySpace, datum id, partition) and sized by _sizeof
(a sample of up to 16 elements of a row list, extrapolated); a put past
the capacity evicts the least recently used entries, each handed to the
on_evict hook first (TieredCache demotes it to disk there) and removed
only after the hook returns, so a concurrent get finds it in one tier."""

from __future__ import annotations

import enum
import logging
import sys
from collections import OrderedDict
from typing import Any, Callable, List, Optional, Tuple
from vega_tpu_torch.lint.sync_witness import named_lock

log = logging.getLogger(__name__)


class KeySpace(enum.Enum):
    RDD = 0
    BROADCAST = 1
    STREAM = 2


Key = Tuple[KeySpace, int, int]  # (space, datum_id, partition)


def _elem_sizeof(elem: Any) -> int:
    import numpy as np

    if isinstance(elem, np.ndarray):
        return elem.nbytes
    if isinstance(elem, (list, tuple, dict)):
        return _sizeof(elem)
    return max(sys.getsizeof(elem), 16)


def _sizeof(value: Any) -> int:
    """Approximate bytes of a cached partition: a list or tuple from an
    evenly spaced sample of min(len, 16) elements (arrays summed
    exactly), a dict from its first 100 items."""
    try:
        import numpy as np

        if isinstance(value, np.ndarray):
            return value.nbytes
        if isinstance(value, (list, tuple)):
            n = len(value)
            if n == 0:
                return 64
            k = min(n, 16)
            sample = [value[(i * n) // k] for i in range(k)]
            if all(isinstance(s, np.ndarray) for s in sample):
                try:
                    return sum(a.nbytes for a in value)
                except AttributeError:
                    pass  # a heterogeneous tail: sample it
            per = sum(_elem_sizeof(s) for s in sample) / k
            return 64 + int(n * per)
        if isinstance(value, dict):
            return 64 + sum(
                _sizeof(k) + _sizeof(v) for k, v in list(value.items())[:100]
            ) * max(1, len(value) // max(1, min(len(value), 100)))
    except Exception:  # noqa: BLE001 — an unsizable value takes the floor
        pass
    return max(sys.getsizeof(value), 64)


class BoundedMemoryCache:
    def __init__(self, capacity_bytes: int):
        self._capacity = capacity_bytes
        self._entries: "OrderedDict[Key, Tuple[Any, int]]" = OrderedDict()
        self._used = 0
        self._lock = named_lock("cache.BoundedMemoryCache._lock")
        self.evictions = 0
        # (key, value, size) of each victim, called outside the lock while
        # the victim is still readable (TieredCache demotes it)
        self.on_evict: Optional[Callable[[Key, Any, int], None]] = None

    def put(self, space: KeySpace, datum_id: int, partition: int,
            value: Any) -> bool:
        """Insert; False when the one value is larger than the capacity."""
        size = _sizeof(value)
        if size > self._capacity:
            return False
        key = (space, datum_id, partition)
        with self._lock:
            if key in self._entries:
                _, old = self._entries.pop(key)
                self._used -= old
            self._entries[key] = (value, size)
            self._used += size
            victims = self._peek_victims(exclude=key)
        self._evict(victims)
        return True

    def _peek_victims(self, exclude: Optional[Key] = None
                      ) -> List[Tuple[Key, Any, int]]:
        over = self._used - self._capacity
        victims: List[Tuple[Key, Any, int]] = []
        if over <= 0:
            return victims
        for ekey, (evalue, esize) in self._entries.items():
            if ekey == exclude:
                continue
            victims.append((ekey, evalue, esize))
            over -= esize
            if over <= 0:
                break
        return victims

    def _evict(self, victims: List[Tuple[Key, Any, int]]) -> None:
        """Hook, then remove each victim, unless a put replaced it
        meanwhile."""
        hook = self.on_evict
        for ekey, evalue, esize in victims:
            if hook is not None:
                try:
                    hook(ekey, evalue, esize)
                except Exception:  # noqa: BLE001 — a failed demotion drops
                    log.exception("cache eviction hook failed; entry "
                                  "dropped")
            with self._lock:
                entry = self._entries.get(ekey)
                if entry is not None and entry[0] is evalue:
                    del self._entries[ekey]
                    self._used -= entry[1]
                    self.evictions += 1

    def get(self, space: KeySpace, datum_id: int,
            partition: int) -> Optional[Any]:
        key = (space, datum_id, partition)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return None
            self._entries.move_to_end(key)
            return entry[0]

    def contains(self, space: KeySpace, datum_id: int,
                 partition: int) -> bool:
        with self._lock:
            return (space, datum_id, partition) in self._entries

    def remove(self, space: KeySpace, datum_id: int, partition: int) -> None:
        """Drop one entry (no hook: a removal is not a demotion)."""
        with self._lock:
            entry = self._entries.pop((space, datum_id, partition), None)
            if entry is not None:
                self._used -= entry[1]

    def remove_datum(self, space: KeySpace, datum_id: int) -> None:
        """Drop every partition of one datum (unpersist)."""
        with self._lock:
            doomed = [k for k in self._entries
                      if k[0] is space and k[1] == datum_id]
            for k in doomed:
                _, size = self._entries.pop(k)
                self._used -= size

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return self._used

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._used = 0
