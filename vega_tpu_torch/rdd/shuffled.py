"""The reduce side of a shuffle: the port's copy of
vega_tpu/rdd/shuffled.py.

A ShuffledRDD's ShuffleDependency is a stage boundary: the DAG scheduler
runs its map stage first (dependency.py do_shuffle_task writes each map
partition's combined buckets into the Context's shuffle store), and a
reduce partition reads its buckets through the fetcher
(shuffle/fetcher.py), in map-partition order, merging the unpickled
combiners with merge_combiners, exactly (Python ints never overflow).
The map outputs stay in the store until this node is collected or the
Context stops (Env.track_shuffle). The reference merges the same buckets in the same order
on its pickled path; where it takes its native C++ merge (a named monoid
or a group over int keys and int / float values under a
HashPartitioner) the order of the keys within a reduce partition is that
hash map's, otherwise it is this one."""

from __future__ import annotations

from typing import Iterator

from vega_tpu_torch.aggregator import Aggregator
from vega_tpu_torch.dependency import ShuffleDependency
from vega_tpu_torch.partitioner import Partitioner
from vega_tpu_torch.rdd.base import RDD
from vega_tpu_torch.shuffle.fetcher import ShuffleFetcher
from vega_tpu_torch.split import Split


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
        parent.context.env.track_shuffle(self, shuffle_id)

    @property
    def num_partitions(self) -> int:
        return self.partitioner.num_partitions

    def compute(self, split: Split, task_context=None) -> Iterator:
        """The partition's buckets merged in map-partition order."""
        merge_combiners = self.aggregator.merge_combiners
        combiners: dict = {}
        for k, c in ShuffleFetcher.fetch(self.context.env, self.shuffle_id,
                                         split.index):
            if k in combiners:
                combiners[k] = merge_combiners(combiners[k], c)
            else:
                combiners[k] = c
        return iter(combiners.items())
