"""Lineage edges: the port's copy of the dependency objects of
vega_tpu/dependency.py.

A narrow dependency names the parent partitions one child partition reads
(OneToOne, Range for union, ManyToOne for coalesce and cartesian); a
ShuffleDependency is a stage boundary holding the parent, the aggregator
of the map-side combine and the output partitioner. The reference's
map-side writers (its native encodings, shuffle store, push and parity
planes) are not copied: the port's shuffle runs in process
(rdd/shuffled.py, shuffle_buckets)."""

from __future__ import annotations

from typing import TYPE_CHECKING, List

from vega_tpu_torch.aggregator import Aggregator
from vega_tpu_torch.partitioner import Partitioner

if TYPE_CHECKING:
    from vega_tpu_torch.rdd.base import RDD


class Dependency:
    __slots__ = ("rdd",)

    def __init__(self, rdd: "RDD"):
        self.rdd = rdd


class NarrowDependency(Dependency):
    """Each parent partition is read by at most one child partition."""

    def get_parents(self, partition_id: int) -> List[int]:
        raise NotImplementedError


class OneToOneDependency(NarrowDependency):
    def get_parents(self, partition_id: int) -> List[int]:
        return [partition_id]


class RangeDependency(NarrowDependency):
    """Child partitions [out_start, out_start + length) read parent
    partitions [in_start, in_start + length), one to one (union)."""

    __slots__ = ("in_start", "out_start", "length")

    def __init__(self, rdd: "RDD", in_start: int, out_start: int,
                 length: int):
        super().__init__(rdd)
        self.in_start = in_start
        self.out_start = out_start
        self.length = length

    def get_parents(self, partition_id: int) -> List[int]:
        if self.out_start <= partition_id < self.out_start + self.length:
            return [partition_id - self.out_start + self.in_start]
        return []


class ManyToOneDependency(NarrowDependency):
    """Child partition i reads the parent partitions groups[i] (coalesce,
    cartesian)."""

    __slots__ = ("groups",)

    def __init__(self, rdd: "RDD", groups: List[List[int]]):
        super().__init__(rdd)
        self.groups = groups

    def get_parents(self, partition_id: int) -> List[int]:
        return list(self.groups[partition_id])


class ShuffleDependency(Dependency):
    """A stage boundary: the parent, its map-side aggregator and the
    output partitioner, under a shuffle id the Context allocates."""

    __slots__ = ("shuffle_id", "aggregator", "partitioner", "is_cogroup")

    def __init__(self, shuffle_id: int, rdd: "RDD", aggregator: Aggregator,
                 partitioner: Partitioner, is_cogroup: bool = False):
        super().__init__(rdd)
        self.shuffle_id = shuffle_id
        self.aggregator = aggregator
        self.partitioner = partitioner
        self.is_cogroup = is_cogroup
