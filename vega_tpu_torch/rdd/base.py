"""The host RDD: a lazy, partitioned lineage of Python rows, the port's copy
of vega_tpu/rdd/base.py.

Every transformation and action of the reference's RDD is here, with the
reference's results. A partition is a list of Python rows computed on
demand from its parents; actions run through Context.run_job, a job of
the local runtime: the DAG scheduler (scheduler/dag.py) cuts the lineage
into stages at its shuffles and runs each stage's tasks on the local
backend's threads (scheduler/local_backend.py). A DenseRDD
(dense_rdd.py) is an RDD too, one partition per shard, whose rows come
off its block shard by shard; this class gives it the names it has no
device form for, and dense() lifts host rows back onto the device.

Persistence: persist(level) keeps computed partitions in the Context's
tiered cache (store/tiered.py) through cache_tracker.get_or_compute:
MEMORY_ONLY in the bounded memory tier, MEMORY_AND_DISK demoted to the
disk store when evicted, DISK_ONLY in the disk store alone, as pickled
row lists. checkpoint(dir) marks the node: the next job writes its
partitions under dir (checkpoint.py) and reads them back from there with
no lineage. Rows are pickled with the standard library's pickle, which
the reference's cloudpickle reads too; closures are pickled only under
serialize_tasks_locally (serialization.py).
"""

from __future__ import annotations

import copy
import itertools
import logging
import math
import os
from typing import Callable, Iterator, List, Optional

from vega_tpu_torch.bounded_priority_queue import BoundedPriorityQueue
from vega_tpu_torch.dependency import Dependency, ShuffleDependency
from vega_tpu_torch.errors import VegaError
from vega_tpu_torch.lint.sync_witness import named_lock
from vega_tpu_torch.partitioner import Partitioner
from vega_tpu_torch.rdd.pair import PairOpsMixin
from vega_tpu_torch.split import Split

log = logging.getLogger(__name__)

# Claims a node's checkpoint write: held only across the check and the
# flag flip, never across the write job itself (that job re-enters
# _do_checkpoint on its own driver thread — holding a lock across it
# would deadlock the nested submission).
_checkpoint_claim_lock = named_lock("rdd.base._checkpoint_claim_lock")


def _collect_partition(_tc, it) -> list:
    return list(it)


def _count_partition(_tc, it) -> int:
    return sum(1 for _ in it)


class _Missing:
    pass


def _reduce_plan(f: Callable):
    """(per-partition fold, merge of the partials) of reduce(): empty
    partitions are skipped, an empty RDD raises."""

    def reduce_partition(_tc, it):
        acc = _Missing
        for x in it:
            acc = x if acc is _Missing else f(acc, x)
        return acc

    def merge(partials: list):
        parts = [r for r in partials if r is not _Missing]
        if not parts:
            raise VegaError("reduce() of empty RDD")
        acc = parts[0]
        for x in parts[1:]:
            acc = f(acc, x)
        return acc

    return reduce_partition, merge


class RDD(PairOpsMixin):
    """A node of the lineage. Subclasses give num_partitions and
    compute(split); splits() defaults to one Split per partition."""

    # the class name to_debug_string() prints (a port node standing for a
    # reference node of another name sets it)
    _debug_name: Optional[str] = None

    def __init__(self, ctx, deps: Optional[List[Dependency]] = None,
                 partitioner: Optional[Partitioner] = None):
        self.context = ctx
        self.rdd_id: int = ctx.new_rdd_id()
        self._init_host_state(deps, partitioner)

    def _init_host_state(self, deps, partitioner) -> None:
        self._deps: List[Dependency] = deps or []
        self._partitioner = partitioner
        self.should_cache = False
        self.storage_level = None
        self._pinned = False
        self._checkpoint_dir: Optional[str] = None
        self._checkpointed_rdd = None

    # ------------------------------------------------------------------ core
    def get_dependencies(self) -> List[Dependency]:
        if self._checkpointed_rdd is not None:
            return self._checkpointed_rdd.get_dependencies()
        return self._deps

    def splits(self) -> List[Split]:
        return [Split(i) for i in range(self.num_partitions)]

    def cached_splits(self) -> List[Split]:
        """splits(), built once per node."""
        cache = self.__dict__.get("_splits_cache")
        if cache is None:
            cache = self.splits()
            self._splits_cache = cache
        return cache

    @property
    def num_partitions(self) -> int:
        raise NotImplementedError

    @property
    def partitioner(self) -> Optional[Partitioner]:
        return self._partitioner

    def compute(self, split: Split, task_context=None) -> Iterator:
        """One partition's rows."""
        raise NotImplementedError

    def iterator(self, split: Split, task_context=None) -> Iterator:
        """compute(), read from the checkpoint once written and through
        the cache tracker when persisted."""
        if self._checkpointed_rdd is not None:
            return self._checkpointed_rdd.iterator(split, task_context)
        if self.should_cache:
            from vega_tpu_torch.cache_tracker import get_or_compute

            return get_or_compute(self, split, task_context)
        return self.compute(split, task_context)

    def preferred_locations(self, split: Split) -> List[str]:
        return []

    @property
    def is_pinned(self) -> bool:
        """Whether the node must run on its preferred host (a pin passes
        to the narrow nodes over it)."""
        return self._pinned

    def pin(self):
        self._pinned = True
        return self

    # ------------------------------------------------------------- persistence
    def cache(self):
        return self.persist()

    def persist(self, level=None):
        """Keep this node's partitions once computed, at a StorageLevel
        (its enum, name or value; None is MEMORY_ONLY)."""
        from vega_tpu_torch.store import StorageLevel

        self.should_cache = True
        self.storage_level = StorageLevel.coerce(level)
        return self

    def unpersist(self):
        from vega_tpu_torch.cache import KeySpace

        self.should_cache = False
        env = self.context.env
        env.cache.remove_datum(KeySpace.RDD, self.rdd_id)
        env.cache_tracker.unregister_rdd(self.rdd_id)
        return self

    def checkpoint(self, directory: Optional[str] = None):
        """Mark the node: the next job over it writes its partitions under
        directory (default: a folder of the Context's session directory)
        and cuts its lineage. Across processes the directory must be given:
        process 0 writes the files and every process reads them, and a
        session directory is each process's own."""
        if directory is None:
            if self.context.mesh.collective:
                raise VegaError("checkpoint() across processes needs a "
                                "directory every process sees; a Context's "
                                "session directory is its process's own")
            directory = os.path.join(self.context._work_dir(),
                                     f"checkpoint-rdd-{self.rdd_id}")
        self._checkpoint_dir = directory
        return self

    def _do_checkpoint(self):
        """Write every checkpoint-marked node of this lineage, parents
        first (run_job walks it before a job)."""
        for dep in self.get_dependencies():
            dep.rdd._do_checkpoint()
        with _checkpoint_claim_lock:
            if self._checkpoint_dir is None \
                    or self._checkpointed_rdd is not None \
                    or self.__dict__.get("_checkpointing"):
                return
            self._checkpointing = True
        from vega_tpu_torch.rdd.checkpoint import CheckpointRDD

        try:
            self._checkpointed_rdd = CheckpointRDD.write(
                self, self._checkpoint_dir)
        finally:
            self._checkpointing = False

    # --------------------------------------------------------- transformations
    def map(self, f: Callable):
        from vega_tpu_torch.rdd.narrow import MapperRDD

        return MapperRDD(self, f)

    def flat_map(self, f: Callable):
        from vega_tpu_torch.rdd.narrow import FlatMapperRDD

        return FlatMapperRDD(self, f)

    def filter(self, predicate: Callable):
        from vega_tpu_torch.rdd.narrow import MapPartitionsRDD

        def apply(_idx, it):
            return (x for x in it if predicate(x))

        return MapPartitionsRDD(self, apply, preserves_partitioning=True)

    def map_partitions(self, f: Callable, preserves_partitioning: bool = False):
        """f(iterator) -> iterator."""
        from vega_tpu_torch.rdd.narrow import MapPartitionsRDD

        return MapPartitionsRDD(self, lambda _idx, it: f(it),
                                preserves_partitioning)

    def map_partitions_with_index(self, f: Callable,
                                  preserves_partitioning: bool = False):
        """f(index, iterator) -> iterator."""
        from vega_tpu_torch.rdd.narrow import MapPartitionsRDD

        return MapPartitionsRDD(self, f, preserves_partitioning)

    def glom(self):
        """Each partition becomes one row, the list of its rows."""
        from vega_tpu_torch.rdd.narrow import MapPartitionsRDD

        return MapPartitionsRDD(self, lambda _idx, it: iter([list(it)]))

    def coalesce(self, num_partitions: int, shuffle: bool = False):
        """Fewer partitions without a shuffle (CoalescedRDD: contiguous
        groups of parent partitions); with shuffle=True each row is keyed
        round robin from its partition's index and shuffled by
        partition_by_key."""
        if shuffle:
            def key_by_round_robin(idx, it):
                counter = itertools.count(idx)
                return ((next(counter), x) for x in it)

            keyed = self.map_partitions_with_index(key_by_round_robin)
            return keyed.partition_by_key(num_partitions).values()
        from vega_tpu_torch.rdd.coalesced import CoalescedRDD

        return CoalescedRDD(self, num_partitions)

    def repartition(self, num_partitions: int):
        return self.coalesce(num_partitions, shuffle=True)

    def sample(self, with_replacement: bool, fraction: float,
               seed: Optional[int] = None):
        from vega_tpu_torch import random as vrandom
        from vega_tpu_torch.rdd.narrow import PartitionwiseSampledRDD

        sampler = (vrandom.PoissonSampler(fraction, seed) if with_replacement
                   else vrandom.BernoulliSampler(fraction, seed))
        return PartitionwiseSampledRDD(self, sampler)

    def random_split(self, weights: List[float], seed: Optional[int] = None):
        """One RDD per weight, each keeping the rows whose draw falls in
        its band of one stream."""
        from vega_tpu_torch import random as vrandom
        from vega_tpu_torch.rdd.narrow import PartitionwiseSampledRDD

        total = sum(weights)
        bounds = [0.0]
        for w in weights:
            bounds.append(bounds[-1] + w / total)
        return [PartitionwiseSampledRDD(
                    self, vrandom.BernoulliCellSampler(lb, ub, seed=seed))
                for lb, ub in zip(bounds, bounds[1:])]

    def key_by(self, f: Callable):
        return self.map(lambda x: (f(x), x))

    def group_by(self, f: Callable, partitioner_or_num=None):
        return self.key_by(f).group_by_key(partitioner_or_num)

    def union(self, other: "RDD"):
        from vega_tpu_torch.rdd.union import UnionRDD

        return UnionRDD(self.context, [self, other])

    __add__ = union

    def zip(self, other: "RDD"):
        """Rows of co-indexed partitions paired (equal partition counts;
        each pair stops at the shorter partition)."""
        from vega_tpu_torch.rdd.narrow import ZippedPartitionsRDD

        return ZippedPartitionsRDD(self.context, self, other)

    def zip_with_index(self):
        """(row, global index): one job counts the partitions first."""
        counts = self.map_partitions(
            lambda it: iter([sum(1 for _ in it)])).collect()
        offsets = [0]
        for c in counts[:-1]:
            offsets.append(offsets[-1] + c)

        def index_partition(idx, it):
            return ((x, i) for i, x in enumerate(it, start=offsets[idx]))

        return self.map_partitions_with_index(index_partition)

    def cartesian(self, other: "RDD"):
        from vega_tpu_torch.rdd.cartesian import CartesianRDD

        return CartesianRDD(self.context, self, other)

    def distinct(self, num_partitions: Optional[int] = None):
        n = num_partitions or self.num_partitions
        return self.map(lambda x: (x, 0)).reduce_by_key(min, n).keys()

    def intersection(self, other: "RDD",
                     num_partitions: Optional[int] = None):
        n = num_partitions or max(self.num_partitions, other.num_partitions)
        left = self.map(lambda x: (x, 0))
        right = other.map(lambda x: (x, 0))

        def emit(groups):
            l, r = groups
            return [0] if l and r else []

        return left.cogroup(right, partitioner_or_num=n).flat_map_values(
            emit).keys()

    def subtract(self, other: "RDD", num_partitions: Optional[int] = None):
        n = num_partitions or max(self.num_partitions, other.num_partitions)
        left = self.map(lambda x: (x, 0))
        right = other.map(lambda x: (x, 0))
        return left.subtract_by_key(right, partitioner_or_num=n).keys()

    def sort_by(self, key_func: Callable, ascending: bool = True,
                num_partitions: Optional[int] = None):
        return self.key_by(key_func).sort_by_key(
            ascending, num_partitions).values()

    def dense(self):
        """Lift the rows onto the device tier (one job collects them):
        2-tuples become a (key, value) pair block and anything else one
        value column, through dense_from_numpy (an int64 past int32 the
        wide pair, strings dictionary-encoded). Rows no column holds
        (mixed objects, ints past int64) leave this RDD as it is, the
        reference's "degrade, never error". Across processes every rank
        lifts the columns process 0 collected (mesh.agree_objects): two
        executor fleets may return a shuffle's rows in different orders,
        and float sums in different low bits, where from_numpy needs the
        same columns on every rank."""
        import numpy as np

        from vega_tpu_torch import dense_rdd
        from vega_tpu_torch import mesh as mesh_lib

        rows = self.collect()
        if rows and all(isinstance(r, tuple) and len(r) == 2 for r in rows):
            cols = (np.asarray([k for k, _v in rows]),
                    np.asarray([v for _k, v in rows]))
        else:
            cols = (np.asarray(rows),)
        cols = mesh_lib.agree_objects(self.context.mesh, cols)
        try:
            lifted = dense_rdd.dense_from_numpy(self.context, cols)
        except VegaError as e:
            log.info("dense() stays on the host tier: %s", e)
            return self
        # rows no block holds come back parallelized: this RDD stays
        return lifted if isinstance(lifted, dense_rdd.DenseRDD) else self

    def pipe(self, command):
        """Each partition through an external command (argv list, or a
        string split like a shell's), one str(row) a line in, one line a
        row out."""
        import shlex
        import subprocess

        argv = shlex.split(command) if isinstance(command, str) else command

        def run(it):
            proc = subprocess.Popen(argv, stdin=subprocess.PIPE,
                                    stdout=subprocess.PIPE, text=True)
            out, _ = proc.communicate("\n".join(str(x) for x in it) + "\n")
            return iter(out.splitlines())

        return self.map_partitions(run)

    # ----------------------------------------------------------------- actions
    def collect(self) -> list:
        results = self.context.run_job(self, _collect_partition)
        return list(itertools.chain.from_iterable(results))

    def count(self) -> int:
        return sum(self.context.run_job(self, _count_partition))

    def collect_async(self):
        """collect() as a job of the job server
        (scheduler/jobserver.py): a JobFuture whose result() is
        collect()'s."""
        return self.context.submit_job(
            self, _collect_partition,
            transform=lambda parts: list(itertools.chain.from_iterable(
                parts)))

    def count_async(self):
        return self.context.submit_job(self, _count_partition, transform=sum)

    def reduce(self, f: Callable):
        reduce_partition, merge = _reduce_plan(f)
        return merge(self.context.run_job(self, reduce_partition))

    def reduce_async(self, f: Callable):
        """reduce() as a job of the job server; an empty RDD raises
        VegaError through the future."""
        reduce_partition, merge = _reduce_plan(f)
        return self.context.submit_job(self, reduce_partition,
                                       transform=merge)

    def fold(self, zero, f: Callable):
        def fold_partition(_tc, it):
            acc = copy.deepcopy(zero)
            for x in it:
                acc = f(acc, x)
            return acc

        acc = copy.deepcopy(zero)
        for part in self.context.run_job(self, fold_partition):
            acc = f(acc, part)
        return acc

    def aggregate(self, zero, seq_func: Callable, comb_func: Callable):
        def agg_partition(_tc, it):
            acc = copy.deepcopy(zero)
            for x in it:
                acc = seq_func(acc, x)
            return acc

        acc = copy.deepcopy(zero)
        for part in self.context.run_job(self, agg_partition):
            acc = comb_func(acc, part)
        return acc

    def take(self, n: int) -> list:
        """The first n rows: one partition, then four times as many each
        round, until enough."""
        if n <= 0:
            return []
        taken: list = []
        total_parts = self.num_partitions
        scanned = 0
        num_to_scan = 1
        while scanned < total_parts and len(taken) < n:
            num_to_scan = min(num_to_scan, total_parts - scanned)
            need = n - len(taken)
            results = self.context.run_job(
                self, lambda _tc, it: list(itertools.islice(it, need)),
                partitions=list(range(scanned, scanned + num_to_scan)))
            for part in results:
                taken.extend(part)
                if len(taken) >= n:
                    break
            scanned += num_to_scan
            num_to_scan *= 4
        return taken[:n]

    def first(self):
        got = self.take(1)
        if not got:
            raise VegaError("first() of empty RDD")
        return got[0]

    def take_sample(self, with_replacement: bool, num: int,
                    seed: Optional[int] = None) -> list:
        import numpy as np

        from vega_tpu_torch import random as vrandom

        if num == 0:
            return []
        initial_count = self.count()
        if initial_count == 0:
            return []
        rng = np.random.Generator(
            np.random.PCG64(seed if seed is not None else 7))
        if not with_replacement and num >= initial_count:
            items = self.collect()
            rng.shuffle(items)
            return items
        fraction = vrandom.compute_fraction_for_sample_size(
            num, initial_count, with_replacement)
        samples = self.sample(with_replacement, fraction, seed).collect()
        attempts = 0
        while len(samples) < num and attempts < 20:
            attempts += 1
            samples = self.sample(with_replacement, fraction,
                                  (seed or 0) + attempts).collect()
        rng.shuffle(samples)
        return samples[:num]

    def for_each(self, f: Callable) -> None:
        def run(_tc, it):
            for x in it:
                f(x)

        self.context.run_job(self, run)

    def for_each_partition(self, f: Callable) -> None:
        self.context.run_job(self, lambda _tc, it: f(it))

    def save_as_text_file(self, path: str) -> None:
        """One part-NNNNN file a partition, one f"{row}\\n" a line, each
        written under a unique temporary name and replaced into place;
        across processes process 0 writes them."""
        import uuid

        from vega_tpu_torch.rdd.checkpoint import rank0_writes

        def write(tc, it):
            out = os.path.join(path, f"part-{tc.split_index:05d}")
            tmp = f"{out}.{uuid.uuid4().hex[:12]}.tmp"
            with open(tmp, "w") as f:
                for x in it:
                    f.write(f"{x}\n")
            os.replace(tmp, out)

        rank0_writes(self, path, write, "save_as_text_file")

    def max(self):
        return self.reduce(lambda a, b: a if a >= b else b)

    def min(self):
        return self.reduce(lambda a, b: a if a <= b else b)

    def top(self, n: int, key: Optional[Callable] = None) -> list:
        base_key = key or (lambda x: x)
        return self.take_ordered(n, key=_Neg(base_key))

    def take_ordered(self, n: int, key: Optional[Callable] = None) -> list:
        """The n smallest: a bounded heap a partition, merged here."""
        if n <= 0:
            return []

        def heap_partition(_tc, it):
            return BoundedPriorityQueue(n, key).extend(it)

        merged = BoundedPriorityQueue(n, key)
        for q in self.context.run_job(self, heap_partition):
            merged.merge(q)
        return merged.items_sorted()

    def count_by_value(self) -> dict:
        return dict(self.map(lambda x: (x, 1)).reduce_by_key(
            lambda a, b: a + b).collect())

    def is_empty(self) -> bool:
        return self.num_partitions == 0 or len(self.take(1)) == 0

    def to_local_iterator(self) -> Iterator:
        """The rows, one partition's job at a time."""
        for p in range(self.num_partitions):
            results = self.context.run_job(self, lambda _tc, it: list(it),
                                           partitions=[p])
            yield from results[0]

    def histogram(self, buckets):
        if isinstance(buckets, int):
            lo = self.min()
            hi = self.max()
            if lo == hi:
                return ([lo, hi], [self.count()])
            step = (hi - lo) / buckets
            edges = [lo + i * step for i in range(buckets)] + [hi]
        else:
            edges = list(buckets)
            buckets = len(edges) - 1

        def hist_partition(_tc, it):
            import bisect

            counts = [0] * buckets
            for x in it:
                if edges[0] <= x <= edges[-1]:
                    idx = min(bisect.bisect_right(edges, x) - 1, buckets - 1)
                    counts[idx] += 1
            return counts

        totals = [0] * buckets
        for part in self.context.run_job(self, hist_partition):
            for i, c in enumerate(part):
                totals[i] += c
        return edges, totals

    def stats(self) -> dict:
        """count / mean / stdev / min / max in one pass (Welford per
        partition, merged in partition order)."""
        def stat_partition(_tc, it):
            n = 0
            mean = 0.0
            m2 = 0.0
            mn = float("inf")
            mx = float("-inf")
            for x in it:
                n += 1
                d = x - mean
                mean += d / n
                m2 += d * (x - mean)
                mn = min(mn, x)
                mx = max(mx, x)
            return (n, mean, m2, mn, mx)

        def merge(a, b):
            (na, ma, sa, mna, mxa), (nb, mb, sb, mnb, mxb) = a, b
            if na == 0:
                return b
            if nb == 0:
                return a
            n = na + nb
            delta = mb - ma
            mean = ma + delta * nb / n
            m2 = sa + sb + delta * delta * na * nb / n
            return (n, mean, m2, min(mna, mnb), max(mxa, mxb))

        n, mean, m2, mn, mx = (0, 0.0, 0.0, float("inf"), float("-inf"))
        for p in self.context.run_job(self, stat_partition):
            n, mean, m2, mn, mx = merge((n, mean, m2, mn, mx), p)
        return {"count": n, "mean": mean if n else float("nan"),
                "stdev": math.sqrt(m2 / n) if n else float("nan"),
                "min": mn, "max": mx}

    # ----------------------------------------------------- approximate actions
    # Each merges every finished partition into its evaluator (partial/)
    # through run_approximate_job: the estimate when timeout_s passes
    # first, the final value once the job ends.
    def count_approx(self, timeout_s: float, confidence: float = 0.95):
        from vega_tpu_torch.partial.count_evaluator import CountEvaluator

        evaluator = CountEvaluator(self.num_partitions, confidence)
        return self.context.run_approximate_job(
            self, _count_partition, evaluator, timeout_s)

    def count_by_value_approx(self, timeout_s: float,
                              confidence: float = 0.95):
        from vega_tpu_torch.partial.grouped_count_evaluator import \
            GroupedCountEvaluator

        def count_partition(_tc, it):
            counts: dict = {}
            for x in it:
                counts[x] = counts.get(x, 0) + 1
            return counts

        evaluator = GroupedCountEvaluator(self.num_partitions, confidence)
        return self.context.run_approximate_job(
            self, count_partition, evaluator, timeout_s)

    def mean_approx(self, timeout_s: float, confidence: float = 0.95):
        from vega_tpu_torch.partial.mean_evaluator import MeanEvaluator

        def sum_partition(_tc, it):
            n = 0
            s = 0.0
            ss = 0.0
            for x in it:
                n += 1
                s += x
                ss += x * x
            return (n, s, ss)

        evaluator = MeanEvaluator(self.num_partitions, confidence)
        return self.context.run_approximate_job(
            self, sum_partition, evaluator, timeout_s)

    def count_approx_distinct(self, relative_sd: float = 0.05) -> int:
        """HyperLogLog of hash_key over the rows, one register array a
        partition, merged with a max (hll.py)."""
        import numpy as np

        from vega_tpu_torch import hll

        p = hll.precision_for(relative_sd)
        merged = np.zeros(1 << p, np.uint8)
        for reg in self.context.run_job(
                self, lambda _tc, it: hll.row_registers(it, p)):
            np.maximum(merged, reg, out=merged)
        return hll.estimate(merged)

    def to_debug_string(self) -> str:
        """The lineage, one line a node indented by depth: "+-" marks a
        shuffle edge, "(shared)" a node already printed."""
        lines: List[str] = []
        seen = set()

        def walk(rdd, depth, via_shuffle):
            marker = "+-" if via_shuffle else "| " if depth else ""
            part = rdd.partitioner
            extra = f" partitioner={part}" if part is not None else ""
            tag = " (shared)" if rdd.rdd_id in seen else ""
            name = rdd._debug_name or type(rdd).__name__
            lines.append(f"{'  ' * depth}{marker}({rdd.num_partitions}) "
                         f"{name}[{rdd.rdd_id}]{extra}{tag}")
            if rdd.rdd_id in seen:
                return
            seen.add(rdd.rdd_id)
            for dep in rdd.get_dependencies():
                walk(dep.rdd, depth + 1, isinstance(dep, ShuffleDependency))

        walk(self, 0, False)
        return "\n".join(lines)

    # ------------------------------------------------------------------- misc
    def id(self) -> int:
        return self.rdd_id

    def to_rdd(self):
        """Already a host RDD: itself (the reference's host RDD has no
        to_rdd; its DenseRDD's hands its shards to this layer)."""
        return self

    def __repr__(self):
        return (f"{type(self).__name__}(id={self.rdd_id}, "
                f"partitions={self.num_partitions})")


class _Neg:
    """A key function whose order is inverted (top())."""

    __slots__ = ("f",)

    def __init__(self, f):
        self.f = f

    def __call__(self, x):
        return _NegOrd(self.f(x))


class _NegOrd:
    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return other.v < self.v

    def __le__(self, other):
        return other.v <= self.v

    def __eq__(self, other):
        return other.v == self.v
