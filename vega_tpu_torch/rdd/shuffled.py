"""The reduce side of a shuffle, over the port's in-process shuffle: the
port's copy of vega_tpu/rdd/shuffled.py.

The map side of a ShuffleDependency (map_outputs) runs once per shuffle,
when a reduce partition first needs it: each parent partition, in order,
is bucketed by the partitioner and combined by the aggregator into one
dict a bucket (first-seen key order), and the buckets are kept in the
Context under the shuffle id until the node that owns the shuffle is
collected or the Context stops (there is no budget and no spill: the
reference's ShuffleStore moves buckets past 1 GiB to disk). A reduce
partition merges its buckets in map-partition order with
merge_combiners, exactly (Python ints never overflow). The reference merges the same buckets; where it
takes its native C++ merge (a named monoid or a group over int keys and
int / float values under a HashPartitioner) the order of the keys within
a reduce partition is that hash map's, otherwise it is this one."""

from __future__ import annotations

import copy
import weakref
from typing import Iterator, List

import numpy as np

from vega_tpu_torch.aggregator import Aggregator
from vega_tpu_torch.dependency import ShuffleDependency
from vega_tpu_torch.partitioner import Partitioner
from vega_tpu_torch.rdd.base import RDD
from vega_tpu_torch.split import Split


def release_on_drop(owner: RDD, dep: ShuffleDependency) -> None:
    """Drop dep's map outputs from the Context once owner, the one node
    that reads them, is collected."""
    weakref.finalize(owner, owner.context._shuffle_outputs.pop,
                     dep.shuffle_id, None)


def map_outputs(dep: ShuffleDependency) -> List[List[list]]:
    """[reduce partition][map partition] -> the map partition's combined
    (k, c) rows for that reduce partition, computed once per shuffle."""
    ctx = dep.rdd.context
    outputs = ctx._shuffle_outputs.get(dep.shuffle_id)
    if outputs is not None:
        return outputs
    n_out = dep.partitioner.num_partitions
    parent = dep.rdd
    outputs = [[] for _ in range(n_out)]
    for split in parent.cached_splits():
        buckets = [dict() for _ in range(n_out)]
        _bucket(dep, list(parent.iterator(split)), buckets)
        for reduce_id, bucket in enumerate(buckets):
            outputs[reduce_id].append(list(bucket.items()))
    ctx._shuffle_outputs[dep.shuffle_id] = outputs
    return outputs


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


class ShuffledRDD(RDD):
    """(k, combiner) rows, one partition per partition of the
    partitioner."""

    def __init__(self, parent: RDD, aggregator: Aggregator,
                 partitioner: Partitioner):
        shuffle_id = parent.context.new_shuffle_id()
        dep = ShuffleDependency(shuffle_id, parent, aggregator, partitioner)
        super().__init__(parent.context, deps=[dep], partitioner=partitioner)
        self.parent = parent
        self.aggregator = aggregator
        self.shuffle_dep = dep
        self.shuffle_id = shuffle_id
        release_on_drop(self, dep)

    @property
    def num_partitions(self) -> int:
        return self.partitioner.num_partitions

    def compute(self, split: Split, task_context=None) -> Iterator:
        """The partition's buckets merged in map-partition order. Each
        read merges copies of the stored combiners (the reference reads
        unpickled copies), so a merge_combiners that extends its first
        argument, or a caller that mutates a row, leaves the map outputs
        as they were for the next read."""
        merge_combiners = self.aggregator.merge_combiners
        fresh = list if self.aggregator.is_group else _fresh
        combiners: dict = {}
        buckets = map_outputs(self.shuffle_dep)[split.index]
        for rows in buckets:
            for k, c in rows:
                if k in combiners:
                    combiners[k] = merge_combiners(combiners[k], fresh(c))
                else:
                    combiners[k] = fresh(c)
        return iter(combiners.items())


_ATOMS = (int, float, complex, str, bytes, bool, type(None), np.generic)


def _fresh(c):
    """A stored combiner as a new object: immutable values as they are,
    anything else deep-copied."""
    return c if isinstance(c, _ATOMS) else copy.deepcopy(c)
