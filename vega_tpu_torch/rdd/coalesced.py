"""Fewer partitions without a shuffle: the port's copy of
vega_tpu/rdd/coalesced.py.

The reference packs parent partitions by their preferred hosts when any
has one; with none it cuts them into n contiguous groups in order. No
partition of the port has a preferred location (one process holds every
partition, as the reference's device nodes give none), so only that
branch is kept."""

from __future__ import annotations

import itertools
from typing import Iterator, List

from vega_tpu_torch.dependency import ManyToOneDependency
from vega_tpu_torch.rdd.base import RDD
from vega_tpu_torch.split import Split


class CoalescedRDD(RDD):
    def __init__(self, prev: RDD, num_partitions: int):
        if num_partitions <= 0:
            raise ValueError("num_partitions must be positive")
        groups = self._pack(prev, num_partitions)
        super().__init__(prev.context,
                         deps=[ManyToOneDependency(prev, groups)])
        self.prev = prev
        self.groups = groups

    @staticmethod
    def _pack(prev: RDD, n: int) -> List[List[int]]:
        """min(n, parent partitions) contiguous groups, the first
        (parents % n) one partition longer."""
        n_parent = prev.num_partitions
        n = min(n, max(n_parent, 1))
        if n_parent == 0:
            return []
        base, extra = divmod(n_parent, n)
        out, lo = [], 0
        for gi in range(n):
            size = base + (1 if gi < extra else 0)
            out.append(list(range(lo, lo + size)))
            lo += size
        return out

    @property
    def num_partitions(self) -> int:
        return len(self.groups)

    def splits(self) -> List[Split]:
        return [Split(i, payload=g) for i, g in enumerate(self.groups)]

    def compute(self, split: Split, task_context=None) -> Iterator:
        parent_splits = self.prev.cached_splits()
        return itertools.chain.from_iterable(
            self.prev.iterator(parent_splits[pi], task_context)
            for pi in self.groups[split.index])
