"""The hand-offs of a vega_tpu_torch DenseRDD to its host RDD layer,
against vega_tpu's, on the CPU.

A reference DenseRDD is an RDD of its host tier, one partition per shard:
compute(split) yields the shard's rows, and the names it has no device
form for run over them (glom, map_partitions, coalesce, pipe, checkpoint,
the scheduler's splits and dependencies, to_rdd, ...). Its cogroup result
is a host RDD merging two device-grouped shards, its outer joins are that
cogroup's flat_map_values, a cogroup of several sides is its host
CoGroupedRDD, and RDD.dense() lifts host rows back. The port's DenseRDD
is its rdd.base.RDD the same way; this file holds each of those to the
reference on the same seeded inputs (both packages under the card's
plans: the reference on its 8-device CPU mesh, the port at
Context(device="cpu", n_shards=8)).

Shard contents, order, sizes and row forms are compared exactly (repr:
a named block's rows are tuples of numpy scalars on both sides, a wide
int64 one Python int, a string a str). Rows after a host shuffle of
numeric pairs compare order-free (the reference's native hash-map merge;
see tests/test_torch_rdd_host.py).
"""

import operator
import os
import re

import numpy as np
import pytest

from test_torch_rdd_host import (API_CALLS, BAG_OPS, REF_CONF, compare,
                                 norm, outcome)
import vega_tpu as v
import vega_tpu_torch as vt
from vega_tpu_torch import dense_rdd
from vega_tpu_torch.rdd.base import RDD as PortRDD

N_SHARDS = 8
ACCEL_PLANS = {"dense_rbk_plan": "fused_sort", "dense_table_plan": "off",
               "dense_sort_impl": "xla"}
_IDS = re.compile(r"\[\d+\]")


@pytest.fixture(scope="module")
def ctxs():
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


def _data(seed=19, n=600, keys=50):
    rng = np.random.default_rng(seed)
    return dict(
        k=rng.integers(0, keys, n).astype(np.int32),
        v=rng.integers(-1000, 1000, n).astype(np.int32),
        w=rng.integers(-2**40, 2**40, n),
        x=rng.standard_normal(n).astype(np.float32),
        s=np.array([f"w{i:02d}" for i in range(30)])[
            rng.integers(0, 30, n)])


D = _data()
T_KEYS = np.arange(0, 60, 2, dtype=np.int32)
T_VALS = np.arange(30, dtype=np.float32) * 0.5

# name -> build(ctx): the dense nodes whose shards are handed off
NODES = {
    "range": lambda c: c.dense_range(1000),
    "values": lambda c: c.dense_from_numpy(D["x"]),
    "pairs": lambda c: c.dense_from_numpy(D["k"], D["v"]),
    "wide_key": lambda c: c.dense_from_numpy(D["w"], D["v"]),
    "wide_value": lambda c: c.dense_from_numpy(D["k"], D["w"]),
    "string_value": lambda c: c.dense_from_numpy(D["k"], D["s"]),
    "string_key": lambda c: c.dense_from_numpy(D["s"], D["v"]),
    "reduced": lambda c: c.dense_from_numpy(D["k"], D["v"]).reduce_by_key(
        operator.add),
    "named": lambda c: c.dense_from_columns({"a": D["k"], "b": D["x"]}),
    "named_key": lambda c: c.dense_from_columns(
        {"k": D["k"], "a": D["v"], "b": D["x"]}, key="k"),
    "grouped": lambda c: c.dense_from_numpy(D["k"], D["v"]).group_by_key(),
    "joined": lambda c: c.dense_from_numpy(D["k"], D["v"]).join(
        c.dense_from_numpy(T_KEYS, T_VALS)),
    "sorted": lambda c: c.dense_from_numpy(D["k"], D["v"]).sort_by_key(),
    "filtered": lambda c: c.dense_range(1000).filter(lambda x: x % 3 != 0),
    "host_rows": lambda c: c.dense_range(40).map(lambda x: (x, x + 2**40)),
}
# nodes whose rows are numeric pairs (or whose repartition keys are)
NUMERIC_NODES = frozenset(("range", "values", "pairs", "wide_key",
                           "wide_value", "reduced", "sorted", "filtered",
                           "host_rows"))

# the 20 names a DenseRDD refused until the host layer came
HANDED_OFF = ("cached_splits", "checkpoint", "coalesce", "compute",
              "flat_map", "flat_map_values", "get_dependencies", "glom",
              "is_pinned", "iterator", "map_partitions",
              "map_partitions_with_index", "partitioner", "pin", "pipe",
              "preferred_locations", "repartition", "splits",
              "to_debug_string", "to_rdd")


def _node_name(rdd):
    """The name to_debug_string prints for a node."""
    return getattr(rdd, "_debug_name", None) or type(rdd).__name__


def _shards(node):
    return repr([list(node.compute(s)) for s in node.splits()])


# ---------------------------------------------------------------------------
# Part A: shard contents, order, sizes and row forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("node", sorted(NODES))
def test_shard_rows_and_forms(ctxs, node):
    """compute(split) of every shard: the same rows, order, sizes and row
    forms as the reference's (repr equality)."""
    ref, port = ctxs
    a, b = NODES[node](port), NODES[node](ref)
    assert a.num_partitions == b.num_partitions == N_SHARDS
    assert _shards(a) == _shards(b)
    assert [len(x) for x in a.glom().collect()] == \
        [len(x) for x in b.glom().collect()]


@pytest.mark.parametrize("node", sorted(NODES))
def test_glom_and_coalesce_expose_the_shards(ctxs, node):
    ref, port = ctxs
    a, b = NODES[node](port), NODES[node](ref)
    assert repr(a.glom().collect()) == repr(b.glom().collect())
    assert repr(a.coalesce(3).glom().collect()) == \
        repr(b.coalesce(3).glom().collect())


def test_named_rows_are_numpy_scalars(ctxs):
    """F20, repaired: a named block's compute rows are tuples of each
    column's numpy scalar, as the reference's _yield_rows gives them
    (collect() keeps Python scalars on both sides)."""
    _ref, port = ctxs
    node = NODES["named"](port)
    row = next(iter(node.compute(node.splits()[0])))
    assert type(row[0]) is np.int32 and type(row[1]) is np.float32
    assert type(node.collect()[0][0]) is int


@pytest.mark.parametrize("action", ["to_local_iterator", "for_each",
                                    "for_each_partition",
                                    "save_as_text_file"])
@pytest.mark.parametrize("node", ["named", "named_key", "pairs"])
def test_host_actions_read_the_compute_form(ctxs, tmp_path, action, node):
    """F20, repaired: the host actions read the shards as
    compute() forms them, as the reference's read its DenseRDD (a named
    block's text file holds np.int32(...) there too)."""
    ref, port = ctxs
    compare(action, NODES[node](port), NODES[node](ref), port, ref,
            str(tmp_path))


# ---------------------------------------------------------------------------
# the 20 names, on dense nodes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("node", ["pairs", "range", "string_key", "reduced",
                                  "wide_value", "grouped", "named"])
@pytest.mark.parametrize("name", HANDED_OFF)
def test_handed_off_name(ctxs, tmp_path, node, name):
    ref, port = ctxs
    ordered = not (node in NUMERIC_NODES and (
        name in BAG_OPS or name == "repartition"))
    compare(name, NODES[node](port), NODES[node](ref), port, ref,
            str(tmp_path), ordered=ordered)


def test_to_rdd_is_an_identity_map_partitions(ctxs):
    ref, port = ctxs
    a, b = NODES["reduced"](port).to_rdd(), NODES["reduced"](ref).to_rdd()
    assert type(a).__name__ == type(b).__name__ == "MapPartitionsRDD"
    assert not isinstance(a, dense_rdd.DenseRDD)
    assert a.collect() == b.collect()


def test_dependencies_and_debug_string_of_dense_lineages(ctxs):
    """get_dependencies() are OneToOneDependencies over the dense
    parents; to_debug_string() renders the reference's lines (rdd ids
    masked) for lineages of nodes of the same names."""
    ref, port = ctxs

    def lineages(c):
        kv = c.dense_from_numpy(D["k"], D["v"])
        t = c.dense_from_numpy(T_KEYS, T_VALS)
        return [kv.map(lambda r: (r[0], r[1] + 1)).reduce_by_key(
                    operator.add).join(t),
                kv.filter(lambda r: r[1] > 0).map_values(lambda x: x * 2),
                kv.group_by_key(),
                kv.cogroup(t).map_values(len),
                kv.right_outer_join(t),
                c.dense_range(100).map(lambda x: x * 2).glom(),
                # host-row nodes print the reference's host node names
                c.dense_range(40).map(lambda x: (x % 3, x + 2**40)).filter(
                    lambda r: r[1] % 2 == 0).map_values(lambda x: x * 3)]
    for a, b in zip(lineages(port), lineages(ref)):
        assert _IDS.sub("[#]", a.to_debug_string()) == \
            _IDS.sub("[#]", b.to_debug_string())
        assert [(type(d).__name__, _node_name(d.rdd))
                for d in a.get_dependencies()] == \
            [(type(d).__name__, _node_name(d.rdd))
             for d in b.get_dependencies()]


# lineages the port computes with other nodes than the reference's
# (device forms where the reference composes host nodes): pinned
# differences of to_debug_string, ids masked
DEBUG_DIFFERENCES = {
    "partition_by_key": (
        lambda c, kv, t: kv.partition_by_key(),
        "(8) _PartitionByKeyRDD[#]\n  | (8) _SourceRDD[#]",
        "(8) MapPartitionsRDD[#]\n  | (8) _GroupByKeyRDD[#]\n"
        "    | (8) _SourceRDD[#]"),
    "keys": (
        lambda c, kv, t: kv.keys(),
        "(8) _ProjectRDD[#]\n  | (8) _SourceRDD[#]",
        "(8) _MapRDD[#]\n  | (8) _SourceRDD[#]"),
    "subtract_by_key": (
        lambda c, kv, t: kv.subtract_by_key(t),
        "(8) _RenameRDD[#]\n  | (8) _SelectRDD[#]\n    | (8) _FilterRDD[#]"
        "\n      | (8) _JoinRDD[#]\n        | (8) _SourceRDD[#]\n"
        "        | (8) _ReduceByKeyRDD[#]\n          | (8) _OnesValueRDD[#]\n"
        "            | (8) _SourceRDD[#]",
        "(8) MapPartitionsRDD[#]\n  | (8) _DenseCoGroupRDD[#]\n"
        "    | (8) _GroupByKeyRDD[#]\n      | (8) _SourceRDD[#]\n"
        "    | (8) _GroupByKeyRDD[#]\n      | (8) _SourceRDD[#]"),
}


@pytest.mark.parametrize("case", sorted(DEBUG_DIFFERENCES))
def test_debug_string_differences_are_pinned(ctxs, case):
    """Where the port computes a name on the device and the reference
    composes host nodes (or another device node), the lineages differ;
    each side's lines are pinned (ROADMAP queue 3's recorded
    differences). Their rows are held equal elsewhere."""
    ref, port = ctxs
    build, port_lines, ref_lines = DEBUG_DIFFERENCES[case]
    for c, want in ((port, port_lines), (ref, ref_lines)):
        kv = c.dense_from_numpy(D["k"], D["v"])
        t = c.dense_from_numpy(T_KEYS, T_VALS)
        assert _IDS.sub("[#]", build(c, kv, t).to_debug_string()) == want


def test_checkpoint_cuts_the_host_lineage_not_the_dense_one(ctxs, tmp_path):
    """checkpoint(dir) on a DenseRDD marks it: a host job writes its
    shards and cuts its dependencies; a dense action does not, as the
    reference's dense actions bypass its scheduler."""
    ref, port = ctxs
    for c, d in ((port, tmp_path / "p"), (ref, tmp_path / "r")):
        node = NODES["reduced"](c)
        node.checkpoint(str(d))
        n = node.count()  # a dense action: nothing written
        assert not d.exists() and n == len(set(D["k"].tolist()))
        assert node.glom().count() == N_SHARDS
        assert sorted(os.listdir(d)) == [f"part-{i:05d}.ckpt"
                                         for i in range(N_SHARDS)]
        assert node.get_dependencies() == []
    assert NODES["reduced"](port).checkpoint(str(tmp_path / "p2")).glom(
        ).collect() == NODES["reduced"](ref).glom().collect()


# ---------------------------------------------------------------------------
# the result objects
# ---------------------------------------------------------------------------

RESULTS = {
    "cogroup": lambda c: c.dense_from_numpy(D["k"][:80], D["v"][:80]).cogroup(
        c.dense_from_numpy(T_KEYS, T_VALS)),
    "right_outer_join": lambda c: c.dense_from_numpy(
        D["k"][:80], D["v"][:80]).right_outer_join(
            c.dense_from_numpy(T_KEYS, T_VALS)),
    "full_outer_join": lambda c: c.dense_from_numpy(
        D["k"][:80], D["v"][:80]).full_outer_join(
            c.dense_from_numpy(T_KEYS, T_VALS)),
}


@pytest.mark.parametrize("obj", sorted(RESULTS))
@pytest.mark.parametrize("name", sorted(API_CALLS))
def test_result_object_name(ctxs, tmp_path, obj, name):
    """Every name of the RDD API on a cogroup / right / full outer join
    result, against the reference's host RDD (its rows are never numeric
    pairs, so every order compares)."""
    ref, port = ctxs
    a = RESULTS[obj](port)
    assert isinstance(a, PortRDD)
    compare(name, a, RESULTS[obj](ref), port, ref, str(tmp_path))


@pytest.mark.parametrize("obj", sorted(RESULTS))
def test_result_object_counts_on_the_device(ctxs, obj):
    """count() stays the device count (no rows formed), equal to the
    composition's row count."""
    ref, port = ctxs
    a = RESULTS[obj](port)
    assert a.count() == len(a.collect()) == RESULTS[obj](ref).count()


def test_cogroup_collect_grouped_is_kept(ctxs):
    ref, port = ctxs
    got = RESULTS["cogroup"](port).collect_grouped()
    exp = RESULTS["cogroup"](ref).collect_grouped()
    assert all(np.array_equal(g, e) for g, e in zip(got, exp))


@pytest.mark.parametrize("sides", [2, 3])
@pytest.mark.parametrize("partitioner", [None, 5])
def test_cogroup_of_several_sides(ctxs, sides, partitioner):
    """cogroup / group_with of two or more others: the host CoGroupedRDD
    over HashPartitioner(n_shards) (or the count given), keys in its
    order (string values keep both shuffles on the pickled path)."""
    ref, port = ctxs

    def build(c):
        base = c.dense_from_numpy(D["k"][:90], D["s"][:90])
        others = [c.dense_from_numpy(T_KEYS, T_VALS),
                  c.parallelize([(1, "a"), (3, "b"), (99, "z")], 2),
                  c.dense_from_numpy(D["k"][90:150], D["s"][90:150])][:sides]
        return base.cogroup(*others, partitioner_or_num=partitioner)
    a, b = build(port), build(ref)
    assert type(a).__name__ == type(b).__name__ == "CoGroupedRDD"
    assert repr(a.glom().collect()) == repr(b.glom().collect())
    assert repr(build(port).map_values(lambda g: [len(x) for x in g])
                .collect()) == repr(build(ref).map_values(
                    lambda g: [len(x) for x in g]).collect())


def test_group_with_of_two_others(ctxs):
    ref, port = ctxs

    def run(c):
        a = c.dense_from_numpy(D["s"][:50], D["v"][:50])
        return a.group_with(a, a.map_values(lambda x: x)).collect()
    assert repr(run(port)) == repr(run(ref))


# ---------------------------------------------------------------------------
# Part E: the Context's row sources and dense()
# ---------------------------------------------------------------------------

LIFTS = {
    "pairs": [(i % 7, i * 3) for i in range(100)],
    "float_pairs": [(i % 7, i * 0.25) for i in range(100)],
    "scalars": list(range(50)),
    "floats": [i * 0.5 for i in range(50)],
    "wide_keys": [(2**40 + i, i) for i in range(40)],
    "wide_values": [(i, 2**40 * i) for i in range(40)],
    "string_keys": [(f"k{i % 9}", i) for i in range(60)],
    "string_values": [(i, f"s{i % 4}") for i in range(60)],
    "strings": [f"s{i % 5}" for i in range(30)],
    "bools": [i % 3 == 0 for i in range(30)],
    "vector_values": [(i, (i, i * 0.5)) for i in range(30)],
    "mixed": [(1, "a"), (2, None), (3, 4.5)],
    "objects": [1, "a", None],
    "past_int64": [(1, 2**70), (2, 3)],
    "triples": [(1, 2, 3), (4, 5, 6)],
    "empty": [],
}


@pytest.mark.parametrize("rows", sorted(LIFTS))
def test_dense_lifts_as_the_reference(ctxs, rows):
    """RDD.dense(): a DenseRDD of the same rows where the reference lifts
    them, the host RDD itself where it keeps them ("degrade, never
    error"), the same exception where it raises."""
    ref, port = ctxs
    a, b = port.parallelize(LIFTS[rows], 3), ref.parallelize(LIFTS[rows], 3)
    got = outcome(lambda r: r.dense(), a)
    exp = outcome(lambda r: r.dense(), b)
    assert got == exp
    if got[0] == "ok":
        la, lb = a.dense(), b.dense()
        assert (la is a) == (lb is b)
        assert isinstance(la, dense_rdd.DenseRDD) == (la is not a)
        if la is not a:
            assert repr(la.collect()) == repr(lb.collect())
            assert la.columns == [n for n, _ in lb._schema()]


def test_lifted_rows_run_the_device_ops(ctxs):
    ref, port = ctxs

    def run(c):
        d = c.parallelize(LIFTS["pairs"], 4).dense()
        t = c.dense_from_numpy(T_KEYS, T_VALS)
        return (sorted(d.reduce_by_key(operator.add).collect()),
                sorted(d.join(t).collect()))
    assert run(port) == run(ref)


def test_union_and_zip_with_a_host_rdd(ctxs):
    """DenseRDD.union / zip with a host RDD: the reference's fall-through
    to the host union and zip."""
    ref, port = ctxs

    def run(c):
        d = c.dense_from_numpy(D["k"][:40], D["v"][:40])
        h = c.parallelize([(i, -i) for i in range(40)], N_SHARDS)
        u = d.union(h)
        return (type(u).__name__, repr(u.glom().collect()),
                repr(d.zip(h).glom().collect()))
    assert run(port) == run(ref)


def test_sources_feed_dense(ctxs):
    """parallelize / make_rdd / range / union / empty_rdd, each lifted."""
    ref, port = ctxs

    def run(c):
        r = c.range(5, 300, 7, 4)
        u = c.union([r, c.make_rdd(list(range(10)), 2)])
        return (r.dense().collect(), u.dense().collect(),
                c.empty_rdd().dense().collect(), u.num_partitions)
    assert run(port) == run(ref)


def test_a_misspelt_name_is_a_plain_attribute_error(ctxs):
    _ref, port = ctxs
    for obj in [NODES["pairs"](port)] + [f(port) for f in RESULTS.values()]:
        with pytest.raises(AttributeError) as info:
            obj.no_such_method
        assert not isinstance(info.value, vt.VegaError)
        assert all(hasattr(obj, n) for n in API_CALLS)


def test_norm_reads_every_result_kind():
    assert norm({"b": 1, "a": [2]}) == ("dict", [("'a'", [2]),
                                                 ("'b'", 1)])
