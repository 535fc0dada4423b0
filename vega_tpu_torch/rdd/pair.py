"""(K, V) pair operations of every host RDD whose rows are 2-tuples: the
port's copy of vega_tpu/rdd/pair.py.

combine_by_key and its forms (reduce_by_key, fold_by_key,
aggregate_by_key, group_by_key, partition_by_key) shuffle through
ShuffledRDD, or combine within each partition when the parent is already
placed by an equal partitioner; the joins are cogroup then
flat_map_values; sort_by_key samples range bounds and sorts each range
partition."""

from __future__ import annotations

import copy
from typing import Any, Callable, List, Optional

from vega_tpu_torch.aggregator import Aggregator, identity
from vega_tpu_torch.partitioner import (HashPartitioner, Partitioner,
                                        RangePartitioner)


class PairOpsMixin:
    """Mixed into RDD (rdd/base.py)."""

    # --- shuffle-backed combiners ------------------------------------------
    def combine_by_key(self, create_combiner: Callable,
                       merge_value: Callable, merge_combiners: Callable,
                       partitioner_or_num: Any = None):
        """A shuffle to the partitioner with a map-side combine; over a
        parent already placed by an equal partitioner, a combine within
        each partition instead."""
        from vega_tpu_torch.rdd.narrow import MapPartitionsRDD
        from vega_tpu_torch.rdd.shuffled import ShuffledRDD

        partitioner = _resolve_partitioner(self, partitioner_or_num)
        if self.partitioner is not None and self.partitioner == partitioner:
            def combine_locally(_idx, it):
                combiners: dict = {}
                for k, value in it:
                    if k in combiners:
                        combiners[k] = merge_value(combiners[k], value)
                    else:
                        combiners[k] = create_combiner(value)
                return iter(combiners.items())

            return MapPartitionsRDD(self, combine_locally,
                                    preserves_partitioning=True)
        agg = Aggregator(create_combiner, merge_value, merge_combiners)
        return ShuffledRDD(self, agg, partitioner)

    def reduce_by_key(self, func: Callable, partitioner_or_num: Any = None):
        from vega_tpu_torch.rdd.shuffled import ShuffledRDD

        partitioner = _resolve_partitioner(self, partitioner_or_num)
        if not (self.partitioner is not None
                and self.partitioner == partitioner):
            op_name = infer_named_op(func)
            if op_name is not None:
                agg = Aggregator(identity, func, func, op_name=op_name)
                return ShuffledRDD(self, agg, partitioner)
        return self.combine_by_key(identity, func, func, partitioner)

    def fold_by_key(self, zero, func: Callable,
                    partitioner_or_num: Any = None):
        return self.combine_by_key(
            lambda v: func(copy.deepcopy(zero), v), func, func,
            partitioner_or_num)

    def aggregate_by_key(self, zero, seq_func: Callable, comb_func: Callable,
                         partitioner_or_num: Any = None):
        return self.combine_by_key(
            lambda v: seq_func(copy.deepcopy(zero), v), seq_func, comb_func,
            partitioner_or_num)

    def group_by_key(self, partitioner_or_num: Any = None):
        from vega_tpu_torch.rdd.shuffled import ShuffledRDD

        partitioner = _resolve_partitioner(self, partitioner_or_num)
        return ShuffledRDD(self, Aggregator.default(), partitioner)

    def partition_by_key(self, partitioner_or_num: Any = None):
        """The rows placed by key, with no combine."""
        return self.group_by_key(partitioner_or_num).flat_map_values(
            lambda vs: vs)

    partition_by = partition_by_key

    def count_by_key(self) -> dict:
        return dict(self.map_values(lambda _: 1).reduce_by_key(
            lambda a, b: a + b).collect())

    # --- value-side narrow ops ---------------------------------------------
    def map_values(self, f: Callable):
        from vega_tpu_torch.rdd.narrow import MapPartitionsRDD

        def apply(_idx, it):
            for k, v in it:
                yield (k, f(v))

        return MapPartitionsRDD(self, apply, preserves_partitioning=True)

    def flat_map_values(self, f: Callable):
        from vega_tpu_torch.rdd.narrow import MapPartitionsRDD

        def apply(_idx, it):
            for k, v in it:
                for out in f(v):
                    yield (k, out)

        return MapPartitionsRDD(self, apply, preserves_partitioning=True)

    def keys(self):
        return self.map(lambda kv: kv[0])

    def values(self):
        return self.map(lambda kv: kv[1])

    def mask_keys(self, pred: Callable):
        return self.filter(lambda kv: pred(kv[0]))

    # --- joins and cogroup -------------------------------------------------
    def cogroup(self, *others, partitioner_or_num: Any = None):
        """(k, ([values of self], [values of each other])) per key."""
        from vega_tpu_torch.rdd.cogrouped import CoGroupedRDD

        partitioner = _resolve_partitioner(self, partitioner_or_num, others)
        return CoGroupedRDD([self, *others], partitioner)

    group_with = cogroup

    def join(self, other, partitioner_or_num: Any = None):
        return self.cogroup(other, partitioner_or_num=partitioner_or_num
                            ).flat_map_values(emit_inner)

    def left_outer_join(self, other, partitioner_or_num: Any = None):
        return self.cogroup(other, partitioner_or_num=partitioner_or_num
                            ).flat_map_values(emit_left_outer)

    def right_outer_join(self, other, partitioner_or_num: Any = None):
        return self.cogroup(other, partitioner_or_num=partitioner_or_num
                            ).flat_map_values(emit_right_outer)

    def full_outer_join(self, other, partitioner_or_num: Any = None):
        return self.cogroup(other, partitioner_or_num=partitioner_or_num
                            ).flat_map_values(emit_full_outer)

    def subtract_by_key(self, other, partitioner_or_num: Any = None):
        def emit(groups):
            left, right = groups
            return list(left) if not right else []

        return self.cogroup(other, partitioner_or_num=partitioner_or_num
                            ).flat_map_values(emit)

    # --- ordering ----------------------------------------------------------
    def sort_by_key(self, ascending: bool = True,
                    num_partitions: Optional[int] = None,
                    sample_size_hint: int = 1000):
        """A total sort: range bounds from a sample of the keys (seed 17),
        a shuffle to a RangePartitioner, then a sort of each partition."""
        from vega_tpu_torch.rdd.narrow import MapPartitionsRDD
        from vega_tpu_torch.rdd.shuffled import ShuffledRDD

        n_out = num_partitions or self.num_partitions
        if n_out <= 1:
            bounds: List = []
        else:
            frac = min(1.0, (sample_size_hint * n_out) / max(1, self.count()))
            keys = self.keys().sample(False, frac, seed=17).collect()
            if not keys:
                bounds = []
            else:
                keys.sort()
                step = len(keys) / n_out
                bounds = sorted(set(keys[min(len(keys) - 1, int(step * i))]
                                    for i in range(1, n_out)))
        partitioner = RangePartitioner(bounds, ascending)
        shuffled = ShuffledRDD(self, Aggregator.default(), partitioner)

        def sort_partition(_idx, it):
            rows = []
            for k, vs in it:
                for v in vs:
                    rows.append((k, v))
            rows.sort(key=lambda kv: kv[0], reverse=not ascending)
            return iter(rows)

        return MapPartitionsRDD(shuffled, sort_partition,
                                preserves_partitioning=True)

    # --- helpers that return host values ------------------------------------
    def collect_as_map(self) -> dict:
        return dict(self.collect())

    def lookup(self, key) -> list:
        """The values of key: one partition's job when the rows are
        placed by a partitioner, else a filter over all of them."""
        part = self.partitioner
        if part is not None:
            return self.context.run_job(
                self, lambda _tc, it: [v for k, v in it if k == key],
                partitions=[part.get_partition(key)])[0]
        return self.filter(lambda kv: kv[0] == key).values().collect()


def emit_inner(groups):
    left, right = groups
    return [(l, r) for l in left for r in right]


def emit_left_outer(groups):
    left, right = groups
    if not right:
        return [(l, None) for l in left]
    return [(l, r) for l in left for r in right]


def emit_right_outer(groups):
    left, right = groups
    if not left:
        return [(None, r) for r in right]
    return [(l, r) for l in left for r in right]


def emit_full_outer(groups):
    left, right = groups
    if not left:
        return [(None, r) for r in right]
    if not right:
        return [(l, None) for l in left]
    return [(l, r) for l in left for r in right]


def _canonical_monoid_codes():
    return {(lambda a, b: a + b).__code__.co_code: "add",
            (lambda a, b: a * b).__code__.co_code: "prod"}


_MONOID_CODES = _canonical_monoid_codes()


def infer_named_op(func: Callable) -> Optional[str]:
    """The monoid a binop is, only where that is certain: operator.add /
    mul, builtin min / max, or a lambda whose bytecode is the canonical
    `a + b` / `a * b` with no names, constants or closure."""
    import operator

    if func is operator.add:
        return "add"
    if func is operator.mul:
        return "prod"
    if func is min:
        return "min"
    if func is max:
        return "max"
    code = getattr(func, "__code__", None)
    if (code is not None and code.co_argcount == 2
            and not code.co_freevars and not code.co_names
            and code.co_consts in ((), (None,))
            and getattr(func, "__closure__", None) is None):
        return _MONOID_CODES.get(code.co_code)
    return None


def _resolve_partitioner(rdd, partitioner_or_num, others=()) -> Partitioner:
    """A partition count or a Partitioner as a Partitioner; None is the
    first parent's partitioner, else a HashPartitioner over the most
    partitions of any parent."""
    if isinstance(partitioner_or_num, Partitioner):
        return partitioner_or_num
    if partitioner_or_num is None:
        for r in (rdd, *others):
            if r.partitioner is not None:
                return r.partitioner
        return HashPartitioner(max(r.num_partitions for r in (rdd, *others)))
    return HashPartitioner(int(partitioner_or_num))
