"""N-ary cogroup: the port's copy of vega_tpu/rdd/cogrouped.py.

A parent placed by the output partitioner is read narrow, partition by
partition; any other parent shuffles with the list-collecting aggregator
and is read through the fetcher (shuffle/fetcher.py). Rows are
(k, (list_0, ..., list_n-1)), keys in first-seen order over the parents
in order."""

from __future__ import annotations

from typing import Iterator, List

from vega_tpu_torch.aggregator import Aggregator
from vega_tpu_torch.dependency import (Dependency, OneToOneDependency,
                                       ShuffleDependency)
from vega_tpu_torch.partitioner import Partitioner
from vega_tpu_torch.rdd.base import RDD
from vega_tpu_torch.shuffle.fetcher import ShuffleFetcher
from vega_tpu_torch.split import Split


class CoGroupedRDD(RDD):
    def __init__(self, parents: List[RDD], partitioner: Partitioner):
        ctx = parents[0].context
        deps: List[Dependency] = []
        for parent in parents:
            if parent.partitioner is not None \
                    and parent.partitioner == partitioner:
                deps.append(OneToOneDependency(parent))
            else:
                deps.append(ShuffleDependency(
                    ctx.new_shuffle_id(), parent, Aggregator.default(),
                    partitioner, is_cogroup=True))
        super().__init__(ctx, deps=deps, partitioner=partitioner)
        self.parents = parents
        self._edges = list(deps)
        for dep in deps:
            if isinstance(dep, ShuffleDependency):
                ctx.env.track_shuffle(self, dep.shuffle_id)

    @property
    def num_partitions(self) -> int:
        return self.partitioner.num_partitions

    def compute(self, split: Split, task_context=None) -> Iterator:
        sides = range(len(self.parents))
        groups: dict = {}
        get = groups.get
        for i, (parent, dep) in enumerate(zip(self.parents, self._edges)):
            if isinstance(dep, ShuffleDependency):
                for k, vs in ShuffleFetcher.fetch(
                        self.context.env, dep.shuffle_id, split.index):
                    entry = get(k)
                    if entry is None:
                        entry = groups[k] = tuple([[] for _ in sides])
                    entry[i].extend(vs)
            else:
                for k, v in parent.iterator(split, task_context):
                    entry = get(k)
                    if entry is None:
                        entry = groups[k] = tuple([[] for _ in sides])
                    entry[i].append(v)
        return iter(groups.items())
