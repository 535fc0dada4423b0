"""Cross product: the port's copy of vega_tpu/rdd/cartesian.py. Split i
pairs partition i // n2 of the first parent with partition i % n2 of the
second; the second's partition is read into a list once per output
partition."""

from __future__ import annotations

from typing import Iterator, List

from vega_tpu_torch.dependency import ManyToOneDependency
from vega_tpu_torch.rdd.base import RDD
from vega_tpu_torch.split import Split


class CartesianRDD(RDD):
    def __init__(self, ctx, rdd1: RDD, rdd2: RDD):
        n1, n2 = rdd1.num_partitions, rdd2.num_partitions
        deps = [ManyToOneDependency(rdd1, [[i // n2] for i in range(n1 * n2)]),
                ManyToOneDependency(rdd2, [[i % n2] for i in range(n1 * n2)])]
        super().__init__(ctx, deps=deps)
        self.rdd1 = rdd1
        self.rdd2 = rdd2
        self._n2 = n2

    @property
    def num_partitions(self) -> int:
        return self.rdd1.num_partitions * self._n2

    def splits(self) -> List[Split]:
        return [Split(i, payload=(i // self._n2, i % self._n2))
                for i in range(self.num_partitions)]

    def compute(self, split: Split, task_context=None) -> Iterator:
        i, j = split.payload if split.payload else (
            split.index // self._n2, split.index % self._n2)
        s1 = self.rdd1.cached_splits()[i]
        s2 = self.rdd2.cached_splits()[j]
        right = list(self.rdd2.iterator(s2, task_context))
        for x in self.rdd1.iterator(s1, task_context):
            for y in right:
                yield (x, y)
