"""Narrow host RDDs and the in-memory source: the port's copy of
vega_tpu/rdd/narrow.py (ParallelCollectionRDD, MapperRDD, FlatMapperRDD,
MapPartitionsRDD, PartitionwiseSampledRDD, ZippedPartitionsRDD)."""

from __future__ import annotations

import itertools
from typing import Callable, Iterator, List, Sequence

from vega_tpu_torch.dependency import OneToOneDependency
from vega_tpu_torch.rdd.base import RDD
from vega_tpu_torch.split import Split


class ParallelCollectionRDD(RDD):
    """A source over an in-memory sequence cut into num_slices contiguous
    slices (slice i is data[i * n // k:(i + 1) * n // k]; no more slices
    than rows, and at least one). A range slices into ranges, so
    ctx.range(n) holds no rows until computed."""

    def __init__(self, ctx, data: Sequence, num_slices: int):
        super().__init__(ctx)
        if num_slices <= 0:
            raise ValueError("num_slices must be positive")
        self._slices = self._slice(data, num_slices)

    @staticmethod
    def _slice(data: Sequence, num_slices: int) -> List[Sequence]:
        n = len(data)
        num_slices = max(1, min(num_slices, max(n, 1)))
        bounds = [(i * n // num_slices, (i + 1) * n // num_slices)
                  for i in range(num_slices)]
        return [data[lo:hi] for lo, hi in bounds]

    @property
    def num_partitions(self) -> int:
        return len(self._slices)

    def splits(self) -> List[Split]:
        return [Split(i, payload=s) for i, s in enumerate(self._slices)]

    def compute(self, split: Split, task_context=None) -> Iterator:
        data = (split.payload if split.payload is not None
                else self._slices[split.index])
        return iter(data)


class _OneParent(RDD):
    """A narrow node over one parent: its partitions, splits and
    locations, and (unless it says otherwise) its pin."""

    def __init__(self, prev: RDD, partitioner=None):
        super().__init__(prev.context, deps=[OneToOneDependency(prev)],
                         partitioner=partitioner)
        self.prev = prev

    @property
    def num_partitions(self) -> int:
        return self.prev.num_partitions

    def splits(self) -> List[Split]:
        return self.prev.splits()

    def preferred_locations(self, split: Split) -> List[str]:
        return self.prev.preferred_locations(split)


class MapperRDD(_OneParent):
    def __init__(self, prev: RDD, f: Callable):
        super().__init__(prev)
        self.f = f
        self._pinned = prev.is_pinned

    def compute(self, split: Split, task_context=None) -> Iterator:
        return map(self.f, self.prev.iterator(split, task_context))


class FlatMapperRDD(_OneParent):
    def __init__(self, prev: RDD, f: Callable):
        super().__init__(prev)
        self.f = f
        self._pinned = prev.is_pinned

    def compute(self, split: Split, task_context=None) -> Iterator:
        return itertools.chain.from_iterable(
            map(self.f, self.prev.iterator(split, task_context)))


class MapPartitionsRDD(_OneParent):
    """f(index, iterator) -> iterator: the node under filter, glom,
    map_values, flat_map_values and the joins' emits."""

    def __init__(self, prev: RDD, f: Callable,
                 preserves_partitioning: bool = False):
        super().__init__(prev, prev.partitioner if preserves_partitioning
                         else None)
        self.f = f
        self._pinned = prev.is_pinned

    def compute(self, split: Split, task_context=None) -> Iterator:
        return self.f(split.index, self.prev.iterator(split, task_context))


class PartitionwiseSampledRDD(_OneParent):
    """Each partition through a sampler (random.py) seeded by its
    index."""

    def __init__(self, prev: RDD, sampler,
                 preserves_partitioning: bool = True):
        super().__init__(prev, prev.partitioner if preserves_partitioning
                         else None)
        self.sampler = sampler

    def compute(self, split: Split, task_context=None) -> Iterator:
        return self.sampler.sample(self.prev.iterator(split, task_context),
                                   split.index)


class ZippedPartitionsRDD(RDD):
    """Rows of co-indexed partitions paired; equal partition counts, each
    pair stops at the shorter partition."""

    def __init__(self, ctx, first: RDD, second: RDD):
        if first.num_partitions != second.num_partitions:
            raise ValueError("zip requires equal partition counts: "
                             f"{first.num_partitions} != "
                             f"{second.num_partitions}")
        super().__init__(ctx, deps=[OneToOneDependency(first),
                                    OneToOneDependency(second)])
        self.first = first
        self.second = second

    @property
    def num_partitions(self) -> int:
        return self.first.num_partitions

    def preferred_locations(self, split: Split) -> List[str]:
        return self.first.preferred_locations(split)

    def compute(self, split: Split, task_context=None) -> Iterator:
        return zip(self.first.iterator(split, task_context),
                   self.second.iterator(split, task_context))
