"""Top-K bounded heap for take_ordered / top: the port's copy of
vega_tpu/utils/bounded_priority_queue.py."""

from __future__ import annotations

import heapq
from typing import Callable, Iterable, List, Optional


class BoundedPriorityQueue:
    """Keeps the `capacity` smallest items by `key` (a negating key keeps
    the largest); merge() folds in another queue's items, as an action
    merges the partitions' queues."""

    def __init__(self, capacity: int, key: Optional[Callable] = None):
        self.capacity = capacity
        self.key = key or (lambda x: x)
        # a max-heap by key: entries (_NegKey(key), seq, item)
        self._heap: List = []
        self._seq = 0

    def push(self, item) -> None:
        k = self.key(item)
        entry = (_NegKey(k), self._seq, item)
        self._seq += 1
        if len(self._heap) < self.capacity:
            heapq.heappush(self._heap, entry)
        elif k < self._heap[0][0].value:
            # the root is the largest of the kept items
            heapq.heapreplace(self._heap, entry)

    def extend(self, items: Iterable) -> "BoundedPriorityQueue":
        for item in items:
            self.push(item)
        return self

    def merge(self, other: "BoundedPriorityQueue") -> "BoundedPriorityQueue":
        for _, _, item in other._heap:
            self.push(item)
        return self

    def items_sorted(self) -> list:
        return [item for _, _, item in
                sorted(self._heap, key=lambda e: e[0].value)]

    def __len__(self):
        return len(self._heap)


class _NegKey:
    """Inverts comparison, so heapq's min-heap keeps the largest on top."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value

    def __lt__(self, other):
        return other.value < self.value

    def __eq__(self, other):
        return other.value == self.value
