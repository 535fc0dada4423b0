"""Lineage edges: the port's copy of the dependency objects of
vega_tpu/dependency.py.

A narrow dependency names the parent partitions one child partition reads
(OneToOne, Range for union, ManyToOne for coalesce and cartesian); a
ShuffleDependency is a stage boundary holding the parent, the aggregator
of the map-side combine and the output partitioner; its do_shuffle_task
is a map task's body (scheduler/task.py ShuffleMapTask): the parent
partition bucketed by the partitioner, combined per bucket, each bucket
pickled into the Context's shuffle store (shuffle/store.py). This is the
reference's pure-Python path, the one it takes without its native
library; its native encodings and its push, replica and parity planes
belong to its distributed backend."""

from __future__ import annotations

from typing import TYPE_CHECKING, List

from vega_tpu_torch import serialization
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

    def do_shuffle_task(self, split, task_context=None) -> tuple:
        """Map-side combine of one parent partition: bucket its rows by
        the partitioner (hashed in one numpy pass for int keys,
        partitioner.get_partitions), combine each bucket (first-seen key
        order), pickle each bucket into the shuffle store under
        (shuffle_id, map id, reduce id). Returns the map task's result:
        ("local", per-reduce bucket bytes)."""
        env = self.rdd.context.env
        rows = list(self.rdd.iterator(split, task_context))
        buckets = [dict() for _ in range(self.partitioner.num_partitions)]
        _bucket(self, rows, buckets)
        row = [serialization.dumps(list(bucket.items()))
               for bucket in buckets]
        store = env.shuffle_store
        for reduce_id, blob in enumerate(row):
            store.put(self.shuffle_id, split.index, reduce_id, blob)
        return self._publish(env, split.index, row)

    def _publish(self, env, map_id: int, row: list) -> tuple:
        """The stored bucket row as the map task's result: its location
        (this process's store) and each bucket's bytes."""
        return ("local", [len(b) for b in row])


def _bucket(dep: ShuffleDependency, rows: list, buckets: List[dict]) -> None:
    """One map partition's rows into its buckets, combined."""
    parts = dep.partitioner.get_partitions([kv[0] for kv in rows])
    if dep.aggregator.is_group:
        # the list-collecting aggregator's create / merge, inlined
        for (k, v), p in zip(rows, parts):
            bucket = buckets[p]
            got = bucket.get(k)
            if got is None:
                bucket[k] = [v]
            else:
                got.append(v)
        return
    create = dep.aggregator.create_combiner
    merge = dep.aggregator.merge_value
    for (k, v), p in zip(rows, parts):
        bucket = buckets[p]
        if k in bucket:
            bucket[k] = merge(bucket[k], v)
        else:
            bucket[k] = create(v)
