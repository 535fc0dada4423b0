"""Partitioners (key -> partition) and the scalar key hash: the port's copy
of vega_tpu/partitioner.py.

hash_key is the reference's hash of a Python key: splitmix64 of an int's
64-bit word (a bool as 0 / 1), of an integral float's int (so 2.0 and 2
hash alike, and -0.0 like 0) or else of the float's bits, of a string's
FNV-1a over its UTF-8 bytes, and a tuple folded item by item; anything
else through Python's hash(). hll.py computes the same hash over whole
device columns. Partitioner equality is what lets co-partitioned parents
skip a shuffle (cogroup, combine_by_key)."""

from __future__ import annotations

import bisect
import struct
from typing import Any

import numpy as np

MASK = 0xFFFFFFFFFFFFFFFF
_M1 = 0xBF58476D1CE4E5B9
_M2 = 0x94D049BB133111EB


def splitmix64(x: int) -> int:
    """splitmix64's finalizer of one 64-bit word (a Python int)."""
    x = (x + 0x9E3779B97F4A7C15) & MASK
    x = ((x ^ (x >> 30)) * _M1) & MASK
    x = ((x ^ (x >> 27)) * _M2) & MASK
    return x ^ (x >> 31)


def splitmix64_np(x: np.ndarray) -> np.ndarray:
    """splitmix64 over a uint64 array (wrapping as the masked form)."""
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(_M1)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(_M2)
    return x ^ (x >> np.uint64(31))


def fnv1a64(data: bytes) -> int:
    """64-bit FNV-1a of a byte string."""
    h = 0xCBF29CE484222325
    for b in data:
        h = ((h ^ b) * 0x100000001B3) & MASK
    return h


def hash_key(key: Any) -> int:
    """The reference's stable uint64 hash of a Python key."""
    if isinstance(key, (bool, np.bool_)):
        return splitmix64(int(key))
    if isinstance(key, (int, np.integer)):
        return splitmix64(int(key) & MASK)
    if isinstance(key, (float, np.floating)):
        f = float(key)
        if f.is_integer() and -2.0 ** 63 <= f < 2.0 ** 63:
            return splitmix64(int(f) & MASK)
        return splitmix64(struct.unpack("<Q", struct.pack("<d", f))[0])
    if isinstance(key, str):
        key = key.encode("utf-8")
    if isinstance(key, bytes):
        return splitmix64(fnv1a64(key))
    if isinstance(key, tuple):
        h = 0x345678
        for item in key:
            h = splitmix64((h * 1000003) ^ hash_key(item))
        return h & MASK
    return splitmix64(hash(key) & MASK)


class Partitioner:
    """Key -> partition. Equal partitioners place keys alike."""

    @property
    def num_partitions(self) -> int:
        raise NotImplementedError

    def get_partition(self, key: Any) -> int:
        raise NotImplementedError

    def get_partitions(self, keys: list) -> list:
        """get_partition of each key of a list."""
        return [self.get_partition(k) for k in keys]

    def __eq__(self, other) -> bool:
        raise NotImplementedError

    def __ne__(self, other) -> bool:
        return not self.__eq__(other)


class HashPartitioner(Partitioner):
    """hash_key(key) % partitions."""

    def __init__(self, partitions: int):
        if partitions <= 0:
            raise ValueError("partitions must be positive")
        self._partitions = int(partitions)

    @property
    def num_partitions(self) -> int:
        return self._partitions

    def get_partition(self, key: Any) -> int:
        return hash_key(key) % self._partitions

    def get_partitions(self, keys: list) -> list:
        """get_partition of each key; a list of plain ints that fit int64
        hashes as one numpy pass (the same splitmix64 words)."""
        if keys and all(type(k) is int for k in keys):
            try:
                words = np.array(keys, dtype=np.int64).view(np.uint64)
            except OverflowError:
                pass
            else:
                return (splitmix64_np(words)
                        % np.uint64(self._partitions)).tolist()
        return [hash_key(k) % self._partitions for k in keys]

    def __eq__(self, other) -> bool:
        return (isinstance(other, HashPartitioner)
                and other._partitions == self._partitions)

    def __hash__(self):
        return hash(("HashPartitioner", self._partitions))

    def __repr__(self):
        return f"HashPartitioner({self._partitions})"


class RangePartitioner(Partitioner):
    """Ordered placement by sorted split points (sort_by_key): a key goes
    to bisect_left(bounds, key), mirrored when descending."""

    def __init__(self, bounds, ascending: bool = True):
        self._bounds = list(bounds)
        self._ascending = ascending

    @property
    def num_partitions(self) -> int:
        return len(self._bounds) + 1

    @property
    def bounds(self):
        return list(self._bounds)

    def get_partition(self, key: Any) -> int:
        idx = bisect.bisect_left(self._bounds, key)
        if not self._ascending:
            idx = len(self._bounds) - idx
        return idx

    def get_partitions(self, keys: list) -> list:
        return [self.get_partition(k) for k in keys]

    def __eq__(self, other) -> bool:
        return (isinstance(other, RangePartitioner)
                and other._bounds == self._bounds
                and other._ascending == self._ascending)

    def __hash__(self):
        return hash(("RangePartitioner", tuple(self._bounds),
                     self._ascending))

    def __repr__(self):
        return f"RangePartitioner(n={self.num_partitions})"
