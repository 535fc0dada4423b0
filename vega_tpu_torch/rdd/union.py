"""Union of RDDs: the port's copy of vega_tpu/rdd/union.py.

When every parent has one (equal) partitioner the union zips co-indexed
partitions and keeps it; otherwise it concatenates the parents'
partitions in order (RangeDependency edges)."""

from __future__ import annotations

import itertools
from collections import Counter
from typing import Iterator, List

from vega_tpu_torch.dependency import OneToOneDependency, RangeDependency
from vega_tpu_torch.rdd.base import RDD
from vega_tpu_torch.split import Split


class UnionRDD(RDD):
    def __init__(self, ctx, rdds: List[RDD]):
        if not rdds:
            raise ValueError("union of zero RDDs")
        first_part = rdds[0].partitioner
        self.partitioner_aware = first_part is not None and all(
            r.partitioner == first_part for r in rdds)
        if self.partitioner_aware:
            deps = [OneToOneDependency(r) for r in rdds]
            partitioner = first_part
        else:
            deps = []
            pos = 0
            for r in rdds:
                deps.append(RangeDependency(r, 0, pos, r.num_partitions))
                pos += r.num_partitions
            partitioner = None
        super().__init__(ctx, deps=deps, partitioner=partitioner)
        self.rdds = rdds

    @property
    def num_partitions(self) -> int:
        if self.partitioner_aware:
            return self.rdds[0].num_partitions
        return sum(r.num_partitions for r in self.rdds)

    def splits(self) -> List[Split]:
        if self.partitioner_aware:
            return [Split(i) for i in range(self.num_partitions)]
        out = []
        for ri, r in enumerate(self.rdds):
            for pi in range(r.num_partitions):
                out.append(Split(len(out), payload=(ri, pi)))
        return out

    def preferred_locations(self, split: Split) -> List[str]:
        if self.partitioner_aware:
            votes = Counter()
            for r in self.rdds:
                for loc in r.preferred_locations(Split(split.index)):
                    votes[loc] += 1
            return [loc for loc, _ in votes.most_common()]
        ri, pi = split.payload
        return self.rdds[ri].preferred_locations(
            self.rdds[ri].cached_splits()[pi])

    def compute(self, split: Split, task_context=None) -> Iterator:
        if self.partitioner_aware:
            return itertools.chain.from_iterable(
                r.iterator(r.cached_splits()[split.index], task_context)
                for r in self.rdds)
        ri, pi = split.payload
        parent = self.rdds[ri]
        return parent.iterator(parent.cached_splits()[pi], task_context)
