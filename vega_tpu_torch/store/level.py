"""Storage levels for persisted dense nodes: the port's own copy of
vega_tpu/store/level.py's StorageLevel (same names, values and coercion)."""

from __future__ import annotations

import enum


class StorageLevel(enum.Enum):
    """Where a persisted block may live.

    - MEMORY_ONLY: on the device; eviction drops it and the next access
      recomputes it from lineage (the default).
    - MEMORY_AND_DISK: on the device first; eviction demotes it to the
      Context's disk store and the next access promotes it back.
    - DISK_ONLY: the reference's third level; a dense block must be on
      the device to compute, so for dense nodes it behaves like
      MEMORY_AND_DISK.
    """

    MEMORY_ONLY = "memory_only"
    MEMORY_AND_DISK = "memory_and_disk"
    DISK_ONLY = "disk_only"

    @property
    def use_memory(self) -> bool:
        return self is not StorageLevel.DISK_ONLY

    @property
    def use_disk(self) -> bool:
        return self is not StorageLevel.MEMORY_ONLY

    @classmethod
    def coerce(cls, value) -> "StorageLevel":
        """Accept a StorageLevel, its name ('MEMORY_AND_DISK', any case),
        or its value ('memory_and_disk'); None means MEMORY_ONLY. Anything
        else raises ValueError."""
        if value is None:
            return cls.MEMORY_ONLY
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            try:
                return cls(value.lower())
            except ValueError:
                pass
            try:
                return cls[value.upper()]
            except KeyError:
                pass
        raise ValueError(f"not a StorageLevel: {value!r}")
