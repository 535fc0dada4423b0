"""The host RDD layer of vega_tpu_torch (vega_tpu_torch/rdd/) against
vega_tpu's (vega_tpu/rdd/), on the CPU.

The same rows, made from a seed with numpy, go through Context.parallelize
on both sides (vega_tpu.Context("local") and vega_tpu_torch's
Context(device="cpu", n_shards=8)), then through one call of the RDD API
each (API_CALLS: every name of dense_rdd.REFERENCE_RDD_API), as far as the
reference's tests/test_rdd.py and tests/test_pair_rdd.py exercise
vega_tpu/rdd/. Each outcome is compared whole: the result's repr after
norm() (RDDs collected, futures and partial results read, dicts sorted,
rdd ids masked), so row forms count as well as values; or, where the
reference raises, the same exception class name.

Rows are compared in order, partition by partition, except after a
shuffle of numeric pairs (an int key, an int or float value): there the
reference merges in its native C++ hash map, whose order within a
partition is its own, and the rows are compared order-free (BAG_OPS over
NUMERIC sources). The port's shuffle merges in map-partition order, which
is the reference's order on its pickled path (every other source).

API_CALLS, norm() and outcome() are shared with tests/test_torch_handoff.py
and tests/test_torch_hostapi.py.
"""

import gc
import operator
import os
import re

import numpy as np
import pytest

import vega_tpu as v
from vega_tpu.rdd.base import RDD as RefRDD
import vega_tpu_torch as vt
from vega_tpu_torch import dense_rdd
from vega_tpu_torch import partitioner as vpart
from vega_tpu_torch.rdd.base import RDD as PortRDD

N_SHARDS = 8
ACCEL_PLANS = {"dense_rbk_plan": "fused_sort", "dense_table_plan": "off",
               "dense_sort_impl": "xla"}
# the reference's Configuration settings these tests set: the card's
# plans (both packages retry a failing task max_failures times, then
# raise TaskError from its exception)
REF_CONF = dict(ACCEL_PLANS)


@pytest.fixture(scope="module")
def ctxs():
    """(reference, port) Contexts under the card's plans."""
    from vega_tpu.env import Env

    ref = v.Context("local", num_workers=2)
    conf = Env.get().conf
    old = {k: getattr(conf, k) for k in REF_CONF}
    for k, val in REF_CONF.items():
        setattr(conf, k, val)
    port = vt.Context(device="cpu", n_shards=N_SHARDS, **ACCEL_PLANS)
    try:
        yield ref, port
    finally:
        port.stop()
        for k, val in old.items():
            setattr(conf, k, val)
        ref.stop()


# ---------------------------------------------------------------------------
# outcomes
# ---------------------------------------------------------------------------

_IDS = re.compile(r"\[\d+\]")


def norm(x, obj=None):
    """A comparable form of one call's result: RDDs collected (with
    whether the call returned the object itself), futures and partial
    results read, BoundedDoubles as their fields, splits as indices,
    dependencies and partitioners by name, dicts sorted by key, rdd ids
    masked in strings."""
    from vega_tpu_torch.partial import BoundedDouble, PartialResult

    from vega_tpu.partial.bounded_double import BoundedDouble as RefBD
    from vega_tpu.partial.partial_result import PartialResult as RefPR

    if isinstance(x, (PortRDD, RefRDD)):
        return ("rdd", "self" if x is obj else "new", norm(x.collect()))
    if isinstance(x, (PartialResult, RefPR)):
        return ("partial", norm(x.initial_value))
    if isinstance(x, (BoundedDouble, RefBD)):
        return ("bounded", repr((x.mean, x.confidence, x.low, x.high)))
    if hasattr(x, "result") and hasattr(x, "add_done_callback"):
        return ("future", norm(x.result(timeout=60)))
    if type(x).__name__ == "Split":
        return ("split", x.index)
    if type(x).__name__.endswith("Dependency"):
        return ("dep", type(x).__name__, x.rdd._debug_name
                if getattr(x.rdd, "_debug_name", None)
                else type(x.rdd).__name__)
    if type(x).__name__.endswith("Partitioner"):
        return ("partitioner", repr(x))
    if isinstance(x, dict):
        return ("dict", sorted(((repr(k), norm(val)) for k, val in
                                x.items()), key=repr))
    if isinstance(x, list):
        return [norm(e) for e in x]
    if isinstance(x, str):
        return _IDS.sub("[#]", x)
    return x


def outcome(call, obj, *args):
    """("ok", repr(norm(result))) or ("raise", exception class name). A
    host job's failure is TaskError raised from the task's exception in
    both packages (tests/test_torch_scheduler.py holds the wrapping), and
    a check that one package makes on its device tier raises the
    exception itself, so the innermost class is the outcome."""
    try:
        out = call(obj, *args)
        return ("ok", repr(norm(out, obj)))
    except Exception as e:  # noqa: BLE001 — the class is the outcome
        while type(e).__name__ == "TaskError" and e.__cause__ is not None:
            e = e.__cause__
        return ("raise", type(e).__name__)


def bag(o):
    """An outcome with its rows order-free (a list's elements sorted by
    repr, through one level of a collected RDD)."""
    kind, text = o
    if kind != "ok":
        return o
    val = eval(text, {"np": np, "nan": float("nan"), "inf": float("inf")})
    if isinstance(val, tuple) and len(val) == 3 and val[0] == "rdd":
        val = (val[0], val[1], sorted(val[2], key=repr))
    elif isinstance(val, list):
        val = sorted(val, key=repr)
    return (kind, repr(val))


def _files(path):
    return {f: open(os.path.join(path, f)).read()
            for f in sorted(os.listdir(path)) if not f.startswith(".")}


def _other(ctx):
    """The second operand of binary calls: string values, so both sides'
    shuffles of it take the pickled path."""
    return ctx.parallelize([(1, "a"), (2, "b"), (9, "z"), (2, "c")], 2)


def _acc(fn):
    def run(r, *_):
        acc = []
        fn(r, acc)
        return acc
    return run


# name -> call(r, ctx, tmp): one call of each name of the RDD API on r
API_CALLS = {
    "aggregate": lambda r, c, t: r.aggregate(
        0, lambda a, x: a + 1, operator.add),
    "aggregate_by_key": lambda r, c, t: r.aggregate_by_key(
        0, lambda a, x: a + 1, operator.add),
    "cache": lambda r, c, t: r.cache(),
    "cached_splits": lambda r, c, t: r.cached_splits(),
    "cartesian": lambda r, c, t: r.cartesian(_other(c)),
    "checkpoint": lambda r, c, t: r.checkpoint(os.path.join(
        t, f"ck-{type(c).__module__}")).glom(),
    "coalesce": lambda r, c, t: r.coalesce(3).glom(),
    "cogroup": lambda r, c, t: r.cogroup(_other(c)),
    "collect": lambda r, c, t: r.collect(),
    "collect_as_map": lambda r, c, t: r.collect_as_map(),
    "collect_async": lambda r, c, t: r.collect_async(),
    "combine_by_key": lambda r, c, t: r.combine_by_key(
        lambda x: [x], lambda a, x: a + [x], operator.add),
    "compute": lambda r, c, t: [list(r.compute(s)) for s in r.splits()],
    "count": lambda r, c, t: r.count(),
    "count_approx": lambda r, c, t: r.count_approx(60.0),
    "count_approx_distinct": lambda r, c, t: r.count_approx_distinct(),
    "count_async": lambda r, c, t: r.count_async(),
    "count_by_key": lambda r, c, t: r.count_by_key(),
    "count_by_value": lambda r, c, t: r.count_by_value(),
    "count_by_value_approx": lambda r, c, t: r.count_by_value_approx(60.0),
    "dense": lambda r, c, t: r.dense(),
    "distinct": lambda r, c, t: r.distinct(),
    "filter": lambda r, c, t: r.filter(lambda x: hash(repr(x)) % 3 != 0),
    "first": lambda r, c, t: r.first(),
    "flat_map": lambda r, c, t: r.flat_map(lambda x: [x, x]),
    "flat_map_values": lambda r, c, t: r.flat_map_values(
        lambda x: [x, repr(x)]),
    "fold": lambda r, c, t: r.fold(
        0, lambda a, x: a + (x if isinstance(x, int) else 1)),
    "fold_by_key": lambda r, c, t: r.fold_by_key(
        0, lambda a, x: a + (x if isinstance(x, int) else 1)),
    "for_each": _acc(lambda r, acc: r.for_each(acc.append)),
    "for_each_partition": _acc(lambda r, acc: r.for_each_partition(
        lambda it: acc.append(list(it)))),
    "full_outer_join": lambda r, c, t: r.full_outer_join(_other(c)),
    "get_dependencies": lambda r, c, t: r.get_dependencies(),
    "glom": lambda r, c, t: r.glom(),
    "group_by": lambda r, c, t: r.group_by(lambda x: len(repr(x)) % 3),
    "group_by_key": lambda r, c, t: r.group_by_key(),
    "group_with": lambda r, c, t: r.group_with(_other(c)),
    "histogram": lambda r, c, t: r.histogram(4),
    "id": lambda r, c, t: r.id() == r.rdd_id,
    "intersection": lambda r, c, t: r.intersection(
        r.filter(lambda x: hash(repr(x)) % 2 == 0)),
    "is_empty": lambda r, c, t: r.is_empty(),
    "is_pinned": lambda r, c, t: r.is_pinned,
    "iterator": lambda r, c, t: [list(r.iterator(s)) for s in r.splits()],
    "join": lambda r, c, t: r.join(_other(c)),
    "key_by": lambda r, c, t: r.key_by(lambda x: len(repr(x))),
    "keys": lambda r, c, t: r.keys(),
    "left_outer_join": lambda r, c, t: r.left_outer_join(_other(c)),
    "lookup": lambda r, c, t: r.lookup(2),
    "map": lambda r, c, t: r.map(repr),
    "map_partitions": lambda r, c, t: r.map_partitions(
        lambda it: [sum(1 for _ in it)]),
    "map_partitions_with_index": lambda r, c, t: r.map_partitions_with_index(
        lambda i, it: [(i, [repr(x) for x in it])]),
    "map_values": lambda r, c, t: r.map_values(repr),
    "mask_keys": lambda r, c, t: r.mask_keys(lambda k: k != 2),
    "max": lambda r, c, t: r.max(),
    "mean_approx": lambda r, c, t: r.mean_approx(60.0),
    "min": lambda r, c, t: r.min(),
    "num_partitions": lambda r, c, t: r.num_partitions,
    "partition_by": lambda r, c, t: r.partition_by(3).glom(),
    "partition_by_key": lambda r, c, t: r.partition_by_key(2).glom(),
    "partitioner": lambda r, c, t: r.partitioner,
    "persist": lambda r, c, t: r.persist("MEMORY_AND_DISK"),
    "pin": lambda r, c, t: r.pin().is_pinned,
    "pipe": lambda r, c, t: r.pipe("cat"),
    "preferred_locations": lambda r, c, t: [
        r.preferred_locations(s) for s in r.splits()],
    "random_split": lambda r, c, t: r.random_split([0.6, 0.4], 3),
    "reduce": lambda r, c, t: r.reduce(
        lambda a, b: a if repr(a) <= repr(b) else b),
    "reduce_async": lambda r, c, t: r.reduce_async(
        lambda a, b: a if repr(a) <= repr(b) else b),
    "reduce_by_key": lambda r, c, t: r.reduce_by_key(
        lambda a, b: a if repr(a) >= repr(b) else b),
    "repartition": lambda r, c, t: r.repartition(3).glom(),
    "right_outer_join": lambda r, c, t: r.right_outer_join(_other(c)),
    "sample": lambda r, c, t: r.sample(False, 0.5, 3),
    "save_as_text_file": lambda r, c, t: (
        r.save_as_text_file(os.path.join(t, f"txt-{type(c).__module__}")),
        _files(os.path.join(t, f"txt-{type(c).__module__}")))[1],
    "sort_by": lambda r, c, t: r.sort_by(lambda x: repr(x), False),
    "sort_by_key": lambda r, c, t: r.sort_by_key(False),
    "splits": lambda r, c, t: r.splits(),
    "stats": lambda r, c, t: r.stats(),
    "subtract": lambda r, c, t: r.subtract(
        r.filter(lambda x: hash(repr(x)) % 2 == 0)),
    "subtract_by_key": lambda r, c, t: r.subtract_by_key(_other(c)),
    "take": lambda r, c, t: r.take(3),
    "take_ordered": lambda r, c, t: r.take_ordered(3, key=repr),
    "take_sample": lambda r, c, t: r.take_sample(False, 3, 7),
    "to_debug_string": lambda r, c, t: r.to_debug_string(),
    "to_local_iterator": lambda r, c, t: list(r.to_local_iterator()),
    "to_rdd": lambda r, c, t: r.to_rdd().collect(),
    "top": lambda r, c, t: r.top(2, key=repr),
    "union": lambda r, c, t: r.union(_other(c)),
    "unpersist": lambda r, c, t: r.cache().unpersist(),
    "values": lambda r, c, t: r.values(),
    "zip": lambda r, c, t: r.zip(r.map(repr)),
    "zip_with_index": lambda r, c, t: r.zip_with_index(),
}

# for_each / for_each_partition's side effects: the reference runs its
# tasks on worker threads, so their order is not defined there
UNORDERED = frozenset(("for_each", "for_each_partition"))
# the names whose rows come through a shuffle (a numeric source's rows
# then compare order-free, as the module docstring says)
BAG_OPS = frozenset((
    "aggregate_by_key", "cogroup", "combine_by_key", "distinct",
    "fold_by_key", "full_outer_join", "group_by", "group_by_key",
    "group_with", "intersection", "join", "left_outer_join",
    "partition_by", "partition_by_key", "reduce_by_key",
    "right_outer_join", "subtract", "subtract_by_key"))


def ref_call(name):
    """The reference's call of a name: its host RDD has no to_rdd (its
    DenseRDD's is the hand-off; the port's host RDD returns itself), so
    there the reference's rows are read directly."""
    if name == "to_rdd":
        return lambda r, c, t: (r.to_rdd() if hasattr(r, "to_rdd")
                                else r).collect()
    return API_CALLS[name]


def compare(name, port_obj, ref_obj, port_ctx, ref_ctx, tmp, ordered=True):
    """Both outcomes of one name, equal (order-free when not ordered)."""
    got = outcome(API_CALLS[name], port_obj, port_ctx, tmp)
    exp = outcome(ref_call(name), ref_obj, ref_ctx, tmp)
    if not ordered or name in UNORDERED:
        got, exp = bag(got), bag(exp)
    assert got == exp, (name, got, exp)
    return got


def test_api_calls_cover_the_reference_api():
    assert set(API_CALLS) == dense_rdd.REFERENCE_RDD_API
    assert BAG_OPS <= set(API_CALLS)


# ---------------------------------------------------------------------------
# the host layer over parallelize sources, op by op
# ---------------------------------------------------------------------------


def _rows(seed=19, n=240, keys=23):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, keys, n).tolist()
    return dict(
        ints=rng.integers(-500, 500, n).tolist(),
        floats=rng.standard_normal(n).round(3).tolist(),
        pairs=list(zip(k, rng.integers(-100, 100, n).tolist())),
        float_pairs=list(zip(k, rng.standard_normal(n).round(3).tolist())),
        str_pairs=[(f"w{x:02d}", y) for x, y in zip(
            k, rng.integers(0, 9, n).tolist())],
        mixed=[(x, f"s{y}") if x % 2 else (x, None)
               for x, y in zip(k, rng.integers(0, 50, n).tolist())],
    )


ROWS = _rows()
# sources whose shuffles the reference merges in its native hash map
NUMERIC = frozenset(("ints", "floats", "pairs", "float_pairs"))
SLICES = {"ints": 4, "floats": 3, "pairs": 5, "float_pairs": 4,
          "str_pairs": 6, "mixed": 3}


@pytest.mark.parametrize("src", sorted(ROWS))
@pytest.mark.parametrize("name", sorted(API_CALLS))
def test_host_op(ctxs, tmp_path, src, name):
    """One name of the API over one parallelize source, on both
    packages."""
    ref, port = ctxs
    rows = ROWS[src]
    a = port.parallelize(rows, SLICES[src])
    b = ref.parallelize(rows, SLICES[src])
    if name == "mean_approx" and src == "floats":
        # the reference's evaluator adds the partitions' float sums in
        # task completion order: equal to rtol 1e-12, not bit for bit
        got, exp = (x.mean_approx(60.0).initial_value for x in (a, b))
        assert got.confidence == exp.confidence == 1.0
        assert got.mean == pytest.approx(exp.mean, rel=1e-12)
        return
    compare(name, a, b, port, ref, str(tmp_path),
            ordered=not (src in NUMERIC and name in BAG_OPS))


# ---------------------------------------------------------------------------
# the layer's own pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,slices", [(0, 1), (1, 4), (10, 3), (17, 8),
                                      (100, 7)])
def test_parallelize_slices(ctxs, n, slices):
    ref, port = ctxs
    data = list(range(n))
    got = port.parallelize(data, slices).glom().collect()
    assert got == ref.parallelize(data, slices).glom().collect()
    assert port.parallelize(range(n), slices).glom().collect() == got


@pytest.mark.parametrize("args", [(10,), (3, 20), (3, 20, 4), (20, 3, -2),
                                  (0,)])
def test_range_union_empty(ctxs, args):
    ref, port = ctxs
    a, b = port.range(*args, num_slices=3), ref.range(*args, num_slices=3)
    assert a.glom().collect() == b.glom().collect()
    assert port.union([a, a.map(lambda x: -x)]).glom().collect() == \
        ref.union([b, b.map(lambda x: -x)]).glom().collect()
    assert port.empty_rdd().collect() == ref.empty_rdd().collect() == []
    assert port.empty_rdd().num_partitions == ref.empty_rdd().num_partitions


def test_default_parallelism_is_the_shard_count(ctxs):
    """The port's default slice count is its shard count (the reference's
    is its backend's parallelism, a recorded difference)."""
    _ref, port = ctxs
    assert port.default_parallelism == N_SHARDS
    assert port.parallelize(list(range(100))).num_partitions == N_SHARDS


@pytest.mark.parametrize("key", [0, 1, -1, 2**31, -2**63, 2**64 + 5, True,
                                 False, 2.0, -0.0, 0.5, float("nan"),
                                 float("inf"), "", "word", "ünï",
                                 (1, "a"), (), ((1, 2), 3.5), None])
def test_hash_key_is_the_reference_s(key):
    from vega_tpu.partitioner import hash_key as ref_hash_key

    assert vpart.hash_key(key) == ref_hash_key(key)


def test_hash_partitioner_vectorised_equals_scalar():
    """get_partitions over plain ints (one numpy pass) equals
    get_partition key by key, the reference's, and falls back for ints
    past int64 and for mixed keys."""
    from vega_tpu.partitioner import HashPartitioner as RefHP

    rng = np.random.default_rng(3)
    for keys in (rng.integers(-2**62, 2**62, 500).tolist(),
                 list(range(-50, 50)), [2**70, 1, -3], [1, "a", 2.5, True]):
        for n in (1, 3, 8, 16):
            hp, ref = vpart.HashPartitioner(n), RefHP(n)
            assert hp.get_partitions(keys) == \
                [hp.get_partition(k) for k in keys] == \
                [ref.get_partition(k) for k in keys]


def test_range_partitioner_and_equality():
    from vega_tpu.partitioner import RangePartitioner as RefRP

    for asc in (True, False):
        rp, ref = vpart.RangePartitioner([3, 7, 11], asc), RefRP([3, 7, 11],
                                                                  asc)
        assert [rp.get_partition(k) for k in range(-2, 15)] == \
            [ref.get_partition(k) for k in range(-2, 15)]
    assert vpart.HashPartitioner(4) == vpart.HashPartitioner(4)
    assert vpart.HashPartitioner(4) != vpart.HashPartitioner(5)
    assert vpart.RangePartitioner([1], True) != \
        vpart.RangePartitioner([1], False)


@pytest.mark.parametrize("fraction", [0.0, 0.05, 0.3, 0.4, 0.41, 0.9, 1.0])
def test_bernoulli_sampler_is_the_reference_s(fraction):
    """The host sample(False, ...) draws the reference's stream: gap
    sampling at or below 0.4, a coin a row above."""
    from vega_tpu.utils.random import BernoulliSampler as RefBS

    from vega_tpu_torch import random as vrandom

    items = list(range(3000))
    for seed in (None, 7):
        for split in (0, 5):
            assert list(vrandom.BernoulliSampler(fraction, seed).sample(
                iter(items), split)) == list(RefBS(fraction, seed).sample(
                    iter(items), split))


def test_shuffle_map_side_runs_once(ctxs):
    """A shuffle's map stage runs once: two actions over one ShuffledRDD
    read its parent once, the second reusing the registered outputs."""
    _ref, port = ctxs
    seen = []
    src = port.parallelize(list(range(40)), 4).map(
        lambda x: (seen.append(x), (x % 5, x))[1])
    red = src.reduce_by_key(operator.add)
    assert sorted(red.collect()) == sorted(red.collect())
    assert len(seen) == 40
    assert port.env.map_output_tracker.has_outputs(red.shuffle_id)
    assert port.env.shuffle_store.contains(red.shuffle_id, 0, 0)


@pytest.mark.parametrize("op", ["reduce_by_key", "cogroup"])
def test_dropped_shuffle_frees_its_outputs(op):
    """A shuffle's map outputs stay in the shuffle store, registered,
    while the node that reads them lives; once it is collected, the next
    job drops its buckets and its tracker entry, and the Context's stop
    drops the rest."""
    port = vt.Context(device="cpu", n_shards=N_SHARDS)

    def build():
        src = port.parallelize([(x % 5, x) for x in range(40)], 4)
        return (src.reduce_by_key(operator.add) if op == "reduce_by_key"
                else src.cogroup(port.parallelize([(1, "a")], 2)))

    def shuffle_ids(node):
        return [dep.shuffle_id for dep in node.get_dependencies()
                if type(dep).__name__ == "ShuffleDependency"]

    node, kept = build(), build()
    ids, kept_ids = shuffle_ids(node), shuffle_ids(kept)
    want = sorted(node.collect())
    assert sorted(kept.collect()) == want
    env = port.env
    assert ids and all(env.map_output_tracker.has_outputs(i)
                       for i in ids + kept_ids)
    del node
    gc.collect()
    port.parallelize([1], 1).count()
    assert not any(env.shuffle_store.contains(i, 0, 0)
                   or env.map_output_tracker.has_outputs(i) for i in ids)
    assert all(env.shuffle_store.contains(i, 0, 0)
               and env.map_output_tracker.has_outputs(i) for i in kept_ids)
    assert sorted(kept.collect()) == want
    assert port.metrics_summary()["stages_resubmitted"] == 0
    port.stop()
    assert len(env.shuffle_store) == 0


def test_exact_python_ints_through_the_shuffle(ctxs):
    """Sums past int64 stay exact (the reference redoes an overflowed
    native merge in Python ints)."""
    ref, port = ctxs
    rows = [(k % 3, 2**62 + k) for k in range(30)]
    got = sorted(port.parallelize(rows, 4).reduce_by_key(
        operator.add).collect())
    assert got == sorted(ref.parallelize(rows, 4).reduce_by_key(
        operator.add).collect())
    assert got[0][1] > 2**64


def test_combine_narrow_when_copartitioned(ctxs):
    """Over rows already placed by an equal partitioner the combine and
    the cogroup edge stay narrow (no new shuffle), as the reference's."""
    ref, port = ctxs
    rows = ROWS["str_pairs"]
    for c in (port, ref):
        placed = c.parallelize(rows, 4).partition_by_key(3)
        red = placed.reduce_by_key(operator.add, 3)
        assert red.partitioner == placed.partitioner
        cg = placed.cogroup(placed.map(lambda kv: kv))
        assert [type(d).__name__ for d in cg.get_dependencies()] == \
            ["OneToOneDependency", "ShuffleDependency"]
    assert port.parallelize(rows, 4).partition_by_key(3).reduce_by_key(
        operator.add, 3).glom().collect() == ref.parallelize(
            rows, 4).partition_by_key(3).reduce_by_key(
                operator.add, 3).glom().collect()


@pytest.mark.parametrize("level", ["MEMORY_ONLY", "MEMORY_AND_DISK",
                                   "DISK_ONLY"])
def test_persist_computes_once(ctxs, level):
    """A persisted host node computes each partition once through the
    cache tracker; DISK_ONLY keeps them in the Context's disk store (the
    tiered cache's disk tier); unpersist drops them."""
    _ref, port = ctxs
    seen = []
    node = port.parallelize(list(range(20)), 4).map(
        lambda x: (seen.append(x), x * 2)[1]).persist(level)
    assert node.collect() == node.collect() == [x * 2 for x in range(20)]
    assert len(seen) == 20
    on_disk = port._spill.contains("cache-rdd-%d-0" % node.rdd_id)
    assert on_disk == (level == "DISK_ONLY")
    node.unpersist()
    assert node.collect() == [x * 2 for x in range(20)]
    assert len(seen) == 40
    assert not port._spill.contains("cache-rdd-%d-0" % node.rdd_id)


def test_checkpoint_files_and_lineage(ctxs, tmp_path):
    """checkpoint(dir): the next job writes part-NNNNN.ckpt (stdlib
    pickle of the rows) and cuts the lineage, as the reference does with
    its own file format (a recorded difference)."""
    import pickle

    ref, port = ctxs
    for c, d in ((port, tmp_path / "p"), (ref, tmp_path / "r")):
        node = c.parallelize(ROWS["mixed"], 3).map_values(repr)
        node.checkpoint(str(d))
        assert node.get_dependencies() != []
        assert node.count() == len(ROWS["mixed"])
        assert node.get_dependencies() == []
        assert sorted(os.listdir(d)) == [f"part-0000{i}.ckpt"
                                         for i in range(3)]
    for i in range(3):
        with open(tmp_path / "p" / f"part-0000{i}.ckpt", "rb") as f:
            got = pickle.load(f)
        assert got == ref.parallelize(ROWS["mixed"], 3).map_values(
            repr).glom().collect()[i]


def test_debug_string_of_a_host_lineage(ctxs):
    ref, port = ctxs

    def build(c):
        a = c.parallelize(ROWS["str_pairs"], 3)
        return a.reduce_by_key(operator.add).union(a).map_values(
            str).to_debug_string()
    assert _IDS.sub("[#]", build(port)) == _IDS.sub("[#]", build(ref))


def test_async_actions_on_the_job_worker(ctxs):
    _ref, port = ctxs
    node = port.parallelize(list(range(50)), 4)
    futs = [node.count_async(), node.collect_async(),
            node.reduce_async(operator.add)]
    assert [f.result(timeout=60) for f in futs] == \
        [50, list(range(50)), sum(range(50))]
    err = port.empty_rdd().reduce_async(operator.add)
    with pytest.raises(Exception, match="empty"):
        err.result(timeout=60)


def test_pipe_runs_cat(ctxs):
    ref, port = ctxs
    rows = ROWS["mixed"]
    assert port.parallelize(rows, 3).pipe(["cat"]).glom().collect() == \
        ref.parallelize(rows, 3).pipe(["cat"]).glom().collect()
