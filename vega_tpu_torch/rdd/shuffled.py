"""The reduce side of a shuffle: the port's copy of
vega_tpu/rdd/shuffled.py.

A ShuffledRDD's ShuffleDependency is a stage boundary: the DAG scheduler
runs its map stage first (dependency.py do_shuffle_task writes each map
partition's combined buckets into the shuffle store), and a reduce
partition reads its buckets through the fetcher (shuffle/fetcher.py) as
they arrive. VN01 buckets (a named monoid's, from the native runtime)
feed a native.StreamingMerge, VG01 buckets (a group's raw rows) are
collected into lists, and pickled buckets merge with merge_combiners,
then the two are merged. When the native accumulator overflows int64
the partition's VN01 buckets are fetched again and merged exactly in
Python. Under shuffle_plan="push" the stream's first bucket is usually
the owning server's pre-merged VN01 frame (shuffle/premerge.py), merged
like any other. Keys come in the native hash map's order, then the
pickled path's first-seen order, as the reference's. The map outputs
stay in the store until this node is collected or the Context stops
(Env.track_shuffle)."""

from __future__ import annotations

import logging
from typing import Iterator

from vega_tpu_torch import serialization
from vega_tpu_torch.aggregator import Aggregator
from vega_tpu_torch.dependency import ShuffleDependency
from vega_tpu_torch.partitioner import Partitioner
from vega_tpu_torch.rdd.base import RDD
from vega_tpu_torch.shuffle.fetcher import ShuffleFetcher
from vega_tpu_torch.split import Split

log = logging.getLogger(__name__)


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
        """The partition's buckets merged as they arrive."""
        from vega_tpu_torch import native
        from vega_tpu_torch.dependency import (NATIVE_GROUP_MAGIC,
                                               NATIVE_MAGIC, is_mergeable)

        env = self.context.env
        merge_combiners = self.aggregator.merge_combiners
        merger = None  # made at the first VN01 bucket
        combiners: dict = {}
        py_combined: dict = {}
        mergeable = is_mergeable(self.aggregator)
        for blob in ShuffleFetcher.fetch_stream(env, self.shuffle_id,
                                                split.index,
                                                mergeable=mergeable):
            magic = blob[:4]
            if magic == NATIVE_MAGIC:
                if merger is None:
                    merger = native.StreamingMerge(self.aggregator.op_name)
                merger.feed(memoryview(blob)[5:], blob[4] == 1)
            elif magic == NATIVE_GROUP_MAGIC:
                for k, val in native.decode(blob[5:], blob[4] == 1):
                    bucket = combiners.get(k)
                    if bucket is None:
                        combiners[k] = [val]
                    else:
                        bucket.append(val)
            else:
                for k, c in serialization.loads(blob):
                    if k in py_combined:
                        py_combined[k] = merge_combiners(py_combined[k], c)
                    else:
                        py_combined[k] = c
        if merger is not None:
            merged = merger.finish()
            if merged is None:
                # int64 overflow in the native accumulator: the buckets
                # are fetched again and merged exactly in Python
                log.info("native streaming merge overflowed int64; "
                         "fetching shuffle %d reduce %d again for the exact "
                         "Python merge", self.shuffle_id, split.index)
                flagged = [
                    (b[5:], 1 if b[4] == 1 else 0)
                    for b in ShuffleFetcher.fetch_blobs(
                        env, self.shuffle_id, split.index,
                        mergeable=mergeable)
                    if b[:4] == NATIVE_MAGIC]
                merged = native.merge_encoded_py(flagged,
                                                 self.aggregator.op_name)
            combiners = dict(merged)
        for k, c in py_combined.items():
            if k in combiners:
                combiners[k] = merge_combiners(combiners[k], c)
            else:
                combiners[k] = c
        return iter(combiners.items())
