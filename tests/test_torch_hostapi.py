"""The host RDD API on a vega_tpu_torch DenseRDD against vega_tpu's, on
the CPU.

A reference DenseRDD inherits the host RDD API (vega_tpu/rdd/base.py's
RDD and its pair ops, rdd/pair.py). 24 of those names have device forms
on the port's DenseRDD, each held to the reference's result on the same
data: eight (first, is_empty, keys, values, count_by_key,
collect_as_map, lookup, right_outer_join), nine that the
reference's DenseRDD answers on its own device tier (fold_by_key,
aggregate_by_key, group_by, sort_by, mask_keys, cache, num_partitions,
dense, id); and seven its host tier answers (full_outer_join,
subtract_by_key, group_with, partition_by_key / partition_by, fold,
aggregate). Thirteen more that its host tier answers (the samplers,
count_approx_distinct, the approximate, async, iterator and file
actions) are held to it in tests/test_torch_host_actions.py. The other
20 a DenseRDD inherits from the port's host RDD (vega_tpu_torch/rdd/), as
the reference's does, and the results of cogroup and right_outer_join are
host RDDs answering every name: each is held to the reference here
(test_host_only_name_refuses, with the call of
tests/test_torch_rdd_host.py's API_CALLS). Both packages run under the
card's plans on the 8-device CPU mesh (the reference) and
Context(device="cpu", n_shards=8) (the port).
"""

import operator

import numpy as np
import pytest

import vega_tpu as v
from vega_tpu.errors import VegaError as RefVegaError
from vega_tpu.rdd.base import RDD as RefRDD
from vega_tpu.tpu import dense_rdd as ref_dense
import vega_tpu_torch as vt
from vega_tpu_torch import dense_rdd
from vega_tpu_torch.errors import VegaError
from test_torch_rdd_host import BAG_OPS, REF_CONF, compare

N_SHARDS = 8
ACCEL_PLANS = {"dense_rbk_plan": "fused_sort", "dense_table_plan": "off",
               "dense_sort_impl": "xla"}
K2 = np.array([1, 2], np.int32)
V2 = np.array([5, 6], np.int32)


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


def _data(seed=11, n=3000, keys=400):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, keys, n).astype(np.int32),
            rng.randint(-1000, 1000, n).astype(np.int32))


# ---------------------------------------------------------------------------
# device forms
# ---------------------------------------------------------------------------


def test_first(ctxs):
    ref, port = ctxs
    assert port.dense_from_numpy(K2, V2).first() == \
        ref.dense_from_numpy(K2, V2).first() == (1, 5)
    k, x = _data()
    exp = ref.dense_from_numpy(k, x).reduce_by_key(op="add").first()
    got = port.dense_from_numpy(k, x).reduce_by_key(op="add").first()
    assert got == exp
    assert port.dense_from_numpy(x).first() == \
        ref.dense_from_numpy(x).first()


def test_first_of_empty_raises(ctxs):
    ref, port = ctxs
    e = np.array([], np.int32)
    with pytest.raises(RefVegaError, match="first\\(\\) of empty RDD"):
        ref.dense_from_numpy(e, e).first()
    with pytest.raises(VegaError, match="first\\(\\) of empty RDD"):
        port.dense_from_numpy(e, e).first()


def test_is_empty(ctxs):
    ref, port = ctxs
    e = np.array([], np.int32)
    for c in ctxs:
        assert c.dense_from_numpy(K2, V2).is_empty() is False
        assert c.dense_from_numpy(e, e).is_empty() is True
    k, x = _data()
    kept = port.dense_from_numpy(k, x).filter(lambda kv: kv[1] > 5000)
    assert kept.is_empty() is ref.dense_from_numpy(k, x).filter(
        lambda kv: kv[1] > 5000).is_empty() is True


@pytest.mark.parametrize("method", ["keys", "values"])
def test_keys_values(ctxs, method):
    """keys() / values() collect the reference's rows. The node types
    differ: the reference maps each row through a traced row function (its
    pair ops' map(lambda kv: kv[0]), a _MapRDD), the port projects the
    column (keys_dense / values_dense, a _ProjectRDD)."""
    ref, port = ctxs
    k, x = _data()
    exp = getattr(ref.dense_from_numpy(k, x), method)()
    got = getattr(port.dense_from_numpy(k, x), method)()
    assert isinstance(got, dense_rdd._ProjectRDD)
    assert type(exp).__name__ == "_MapRDD"
    assert got.collect() == exp.collect()
    assert got.count() == exp.count()
    assert getattr(port.dense_from_numpy(K2, V2), method)().collect() == \
        getattr(ref.dense_from_numpy(K2, V2), method)().collect()


def test_count_by_key(ctxs):
    ref, port = ctxs
    assert port.dense_from_numpy(K2, V2).count_by_key() == \
        ref.dense_from_numpy(K2, V2).count_by_key() == {1: 1, 2: 1}
    k, x = _data()
    got = port.dense_from_numpy(k, x).count_by_key()
    assert got == ref.dense_from_numpy(k, x).count_by_key()
    assert all(type(a) is int and type(b) is int for a, b in got.items())


def test_collect_as_map(ctxs):
    """Equal on unique keys; with duplicate keys both sides keep the last
    row in collect() order (a dict over the same row order)."""
    ref, port = ctxs
    assert port.dense_from_numpy(K2, V2).collect_as_map() == \
        ref.dense_from_numpy(K2, V2).collect_as_map() == {1: 5, 2: 6}
    k, x = _data()
    assert port.dense_from_numpy(k, x).reduce_by_key(
        op="add").collect_as_map() == ref.dense_from_numpy(
        k, x).reduce_by_key(op="add").collect_as_map()
    d_k = np.array([1, 1, 2], np.int32)
    d_v = np.array([5, 6, 7], np.int32)
    assert port.dense_from_numpy(d_k, d_v).collect_as_map() == \
        ref.dense_from_numpy(d_k, d_v).collect_as_map() == {1: 6, 2: 7}
    assert port.dense_from_numpy(k, x).collect_as_map() == \
        ref.dense_from_numpy(k, x).collect_as_map()


def test_lookup(ctxs):
    """The values under a key, as a multiset; [] for an absent key."""
    ref, port = ctxs
    assert port.dense_from_numpy(K2, V2).lookup(2) == \
        ref.dense_from_numpy(K2, V2).lookup(2) == [6]
    k, x = _data()
    p, r = port.dense_from_numpy(k, x), ref.dense_from_numpy(k, x)
    for key in (int(k[0]), int(k[7]), 399, 10_000, -1):
        assert sorted(p.lookup(key)) == sorted(r.lookup(key))
    assert p.lookup(10_000) == [] and p.lookup(2**40) == []


@pytest.mark.parametrize("kind", ["uint32", "int64_wide", "float32",
                                  "string", "int8"])
def test_lookup_key_kinds(ctxs, kind):
    """lookup over each key encoding: a uint32 key past 2^31, a wide
    int64 key, float32, a string (dictionary) key and int8."""
    ref, port = ctxs
    rng = np.random.RandomState(12)
    if kind == "uint32":
        k = (rng.randint(0, 50, 500).astype(np.int64) * 80_000_000
             ).astype(np.uint32)
    elif kind == "int64_wide":
        k = rng.randint(0, 50, 500).astype(np.int64) * 2**36 - 2**40
    elif kind == "float32":
        k = (rng.randint(0, 50, 500) / 4).astype(np.float32)
    elif kind == "string":
        k = np.array([f"w{i:03d}" for i in rng.randint(0, 50, 500)])
    else:
        k = rng.randint(-50, 50, 500).astype(np.int8)
    x = rng.randint(0, 1000, 500).astype(np.int32)
    p, r = port.dense_from_numpy(k, x), ref.dense_from_numpy(k, x)
    for key in (k[0], k[3], k[-1]):
        key = key.item() if hasattr(key, "item") else key
        got = p.lookup(key)
        assert got and sorted(got) == sorted(r.lookup(key))
    absent = {"uint32": 7, "int64_wide": 3, "float32": 0.3,
              "string": "zzz", "int8": 120}[kind]
    assert p.lookup(absent) == r.lookup(absent) == []


def test_right_outer_join(ctxs):
    """(k, (lv, rv)) for matched right rows, (k, (None, rv)) for the
    rest, as the reference's host join; count() without the rows."""
    ref, port = ctxs
    rk = np.array([2, 3], np.int32)
    rv = np.array([7.0, 8.0], np.float32)
    exp = ref.dense_from_numpy(K2, V2).right_outer_join(
        ref.dense_from_numpy(rk, rv)).collect()
    res = port.dense_from_numpy(K2, V2).right_outer_join(
        port.dense_from_numpy(rk, rv))
    assert sorted(res.collect(), key=str) == sorted(exp, key=str) == \
        [(2, (6, 7.0)), (3, (None, 8.0))]
    assert res.count() == 2


def test_right_outer_join_duplicates(ctxs):
    """Duplicate keys on both sides, half the right keys missing from the
    left: the same multiset of rows as the reference's."""
    ref, port = ctxs
    k, x = _data(13, 1000, 200)
    rng = np.random.RandomState(14)
    rk = rng.randint(100, 300, 400).astype(np.int32)
    rv = rng.randint(0, 50, 400).astype(np.int32)
    exp = ref.dense_from_numpy(k, x).right_outer_join(
        ref.dense_from_numpy(rk, rv)).collect()
    res = port.dense_from_numpy(k, x).right_outer_join(
        port.dense_from_numpy(rk, rv))
    got = res.collect()
    assert sorted(got, key=str) == sorted(exp, key=str)
    assert res.count() == len(exp)
    assert any(lv is None for _, (lv, _r) in got)


def test_outer_join_fills_differ(ctxs):
    """The device left_outer_join fills a missing right value (0.0) in
    both packages, where the host right_outer_join gives None: so
    right_outer_join is not a swapped left_outer_join."""
    ref, port = ctxs
    rk = np.array([2, 3], np.int32)
    rv = np.array([7.0, 8.0], np.float32)
    for c in ctxs:
        assert sorted(c.dense_from_numpy(K2, V2).left_outer_join(
            c.dense_from_numpy(rk, rv)).collect()) == \
            [(1, (5, 0.0)), (2, (6, 7.0))]
        assert (3, (None, 8.0)) in c.dense_from_numpy(K2, V2) \
            .right_outer_join(c.dense_from_numpy(rk, rv)).collect()


# ---------------------------------------------------------------------------
# the nine names the reference's device tier answers
# ---------------------------------------------------------------------------

K6 = np.array([1, 1, 1, 2, 2, 3], np.int32)
V6 = np.arange(1, 7, dtype=np.int32)


def test_fold_by_key_folds_the_zero_once_per_row(ctxs):
    """vega_tpu/tpu/dense_rdd.py:1210-1216 says fold_by_key and
    aggregate_by_key have no device lowering and that their zero goes in
    once per key per partition. The reference's own result says
    otherwise: rdd/pair.py:74-90 calls its device combine_by_key, whose
    create_combiner folds the zero into every ROW. The port does the
    same: 36 = 1 + 2 + 3 + 3 x 10."""
    for c in ctxs:
        r = c.dense_from_numpy(K6, V6)
        assert sorted(r.fold_by_key(10, operator.add).collect()) == \
            [(1, 36), (2, 29), (3, 16)]
        assert sorted(r.aggregate_by_key(
            100, operator.add, operator.add).collect()) == \
            [(1, 306), (2, 209), (3, 106)]
    ref, port = ctxs
    assert type(ref.dense_from_numpy(K6, V6).fold_by_key(
        10, operator.add)).__name__ == "_ReduceByKeyRDD"
    assert isinstance(port.dense_from_numpy(K6, V6).fold_by_key(
        10, operator.add), dense_rdd._ReduceByKeyRDD)


def _float_data(seed=15, n=2000, keys=300):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, keys, n).astype(np.int32),
            (rng.standard_normal(n) * 10).astype(np.float32))


FOLD_BY_KEY_CASES = {
    "add_int": lambda r: r.fold_by_key(7, operator.add),
    "xor_traced": lambda r: r.fold_by_key(5, lambda a, b: a ^ b),
    "aggregate_add": lambda r: r.aggregate_by_key(
        -3, operator.add, lambda a, b: a + b),
    "aggregate_min": lambda r: r.aggregate_by_key(
        0, lambda a, b: a + b, min),
}


@pytest.mark.parametrize("case", sorted(FOLD_BY_KEY_CASES))
def test_fold_by_key_parity(ctxs, case):
    """Each zero is non-neutral; integers bit-identical."""
    ref, port = ctxs
    k, x = _data()
    f = FOLD_BY_KEY_CASES[case]
    assert sorted(f(port.dense_from_numpy(k, x)).collect()) == \
        sorted(f(ref.dense_from_numpy(k, x)).collect())


def test_fold_by_key_floats_and_empty(ctxs):
    """Float values with a float zero (rtol 1e-5), and an empty RDD."""
    ref, port = ctxs
    k, x = _float_data()
    exp = dict(ref.dense_from_numpy(k, x).fold_by_key(
        0.5, operator.add).collect())
    got = dict(port.dense_from_numpy(k, x).fold_by_key(
        0.5, operator.add).collect())
    assert sorted(got) == sorted(exp)
    np.testing.assert_allclose([got[kk] for kk in sorted(got)],
                               [exp[kk] for kk in sorted(exp)], rtol=1e-5)
    e = np.array([], np.int32)
    for c in ctxs:
        assert c.dense_from_numpy(e, e).fold_by_key(
            1, operator.add).collect() == []


def test_fold_by_key_streamed(ctxs):
    """A streamed operand folds as its resident build in both packages."""
    ref, port = ctxs

    def run(c):
        return sorted(c.dense_range(1000, chunk_rows=300).map(
            lambda x: (x % 7, x)).fold_by_key(1, operator.add).collect())
    assert run(port) == run(ref)


def test_fold_by_key_refusals(ctxs):
    """What the reference folds on its host tier, the port folds on its
    host RDD layer: string values (whose fold of an int zero fails there
    as on the reference's host tier) and a zero the trace cannot fold
    (builtin max branches on a value). Wide int64 values take the host
    tier's row form (host_rows.py) and give the reference's host rows."""
    ref, port = ctxs
    wide = np.array([2**40, 3], np.int64)
    # order-free: the reference's host shuffle places rows by its own
    # hash
    assert sorted(port.dense_from_numpy(K2, wide).fold_by_key(
        0, operator.add).collect()) == sorted(ref.dense_from_numpy(
            K2, wide).fold_by_key(0, operator.add).collect())
    strs = np.array(["a", "b"])
    for c in (ref, port):
        with pytest.raises(Exception) as info:
            c.dense_from_numpy(K2, strs).fold_by_key(0, operator.add) \
                .collect()
        e = info.value
        while type(e).__name__ == "TaskError" and e.__cause__ is not None:
            e = e.__cause__
        assert isinstance(e, TypeError)
    got = port.dense_from_numpy(K2, V2).fold_by_key(5, max)
    assert not isinstance(got, dense_rdd.DenseRDD)
    assert sorted(got.collect()) == sorted(
        ref.dense_from_numpy(K2, V2).fold_by_key(5, max).collect())


@pytest.mark.parametrize("src", ["resident", "streamed"])
def test_group_by(ctxs, src):
    """key_by(f).group_by_key(), as the reference composes it."""
    ref, port = ctxs

    def run(c):
        base = (c.dense_range(3000, chunk_rows=700) if src == "streamed"
                else c.dense_range(3000))
        node = base.group_by(lambda x: x % 37)
        return node, sorted((kk, sorted(vs)) for kk, vs in node.collect())
    node, got = run(port)
    _exp_node, exp = run(ref)
    assert got == exp
    assert isinstance(node, dense_rdd._GroupByKeyRDD)


SORT_BY_CASES = {
    "neg_ascending": (lambda x: -x, True),
    "mod_descending": (lambda x: x % 101, False),
    "float_key": (lambda x: x * 0.5 - 7.0, True),
}


@pytest.mark.parametrize("case", sorted(SORT_BY_CASES))
def test_sort_by(ctxs, case):
    """key_by(f).sort_by_key(ascending).values(): the values in key order;
    ties (equal keys) compared as multisets within each key."""
    ref, port = ctxs
    f, asc = SORT_BY_CASES[case]
    got = port.dense_range(5000).sort_by(f, asc).collect()
    exp = ref.dense_range(5000).sort_by(f, asc).collect()
    assert sorted(got) == sorted(exp)
    keys = [f(x) for x in got]
    assert keys == sorted(keys, reverse=not asc)
    if case == "neg_ascending":
        assert got == exp == list(range(4999, -1, -1))


def test_sort_by_streamed(ctxs):
    ref, port = ctxs
    assert port.dense_range(2000, chunk_rows=600).sort_by(
        lambda x: -x).collect() == ref.dense_range(2000).sort_by(
            lambda x: -x).collect()


def test_mask_keys(ctxs):
    """filter(lambda kv: pred(kv[0])): the same rows in the same order."""
    ref, port = ctxs
    k, x = _data()
    exp = ref.dense_from_numpy(k, x).mask_keys(lambda kk: kk % 3 == 1)
    got = port.dense_from_numpy(k, x).mask_keys(lambda kk: kk % 3 == 1)
    assert got.collect() == exp.collect()
    assert isinstance(got, dense_rdd._FilterRDD)
    assert type(exp).__name__ == "_FilterRDD"


def test_cache_is_persist_memory_only(ctxs, monkeypatch):
    """cache() returns the node at MEMORY_ONLY; a second action reads the
    block and does not recompute it."""
    ref, port = ctxs
    node = port.dense_range(5000).map(lambda x: (x % 9, x)) \
        .reduce_by_key(op="add")
    assert node.cache() is node
    assert node._storage_level.name == "MEMORY_ONLY"
    first = sorted(node.collect())
    calls = []
    orig = type(node)._materialize

    def counting(self):
        calls.append(self.rdd_id)
        return orig(self)
    monkeypatch.setattr(type(node), "_materialize", counting)
    assert sorted(node.collect()) == first == sorted(
        ref.dense_range(5000).map(lambda x: (x % 9, x))
        .reduce_by_key(op="add").cache().collect())
    assert calls == []


def test_num_partitions_dense_id(ctxs):
    """num_partitions is the shard count (a property in both), dense()
    the node itself, id() its rdd_id."""
    for c in ctxs:
        r = c.dense_from_numpy(K2, V2)
        assert r.num_partitions == N_SHARDS
        assert r.dense() is r
        assert r.id() == r.rdd_id
        assert r.map(lambda kv: (kv[0], kv[1] + 1)).id() > r.id()


# ---------------------------------------------------------------------------
# the seven its host tier answers
# ---------------------------------------------------------------------------

LK = np.array([1, 1, 2, 3], np.int32)
LV = np.array([10, 11, 20, 30], np.int32)
RK = np.array([2, 4, 4], np.int32)
RV = np.array([7.0, 8.0, 9.0], np.float32)


def _sides(c, lk=LK, lv=LV, rk=RK, rv=RV):
    return c.dense_from_numpy(lk, lv), c.dense_from_numpy(rk, rv)


def test_full_outer_join_values(ctxs):
    """None on the missing side, as the reference's host join."""
    ref, port = ctxs
    exp = ref.dense_from_numpy(LK, LV).full_outer_join(
        ref.dense_from_numpy(RK, RV)).collect()
    res = port.dense_from_numpy(LK, LV).full_outer_join(
        port.dense_from_numpy(RK, RV))
    assert sorted(res.collect(), key=str) == sorted(exp, key=str) == [
        (1, (10, None)), (1, (11, None)), (2, (20, 7.0)), (3, (30, None)),
        (4, (None, 8.0)), (4, (None, 9.0))]
    assert res.count() == 6
    assert isinstance(res, dense_rdd._DenseFullOuterJoin)


OUTER_CASES = ["duplicates", "floats", "empty_left", "empty_right",
               "streamed"]


def _outer_inputs(c, case):
    rng = np.random.RandomState(16)
    if case == "duplicates":
        k, x = _data(13, 1000, 200)
        rk = rng.randint(100, 300, 400).astype(np.int32)
        rv = rng.randint(0, 50, 400).astype(np.int32)
        return c.dense_from_numpy(k, x), c.dense_from_numpy(rk, rv)
    if case == "floats":
        k, x = _float_data(17, 800, 150)
        rk = rng.randint(75, 225, 300).astype(np.int32)
        return c.dense_from_numpy(k, x), c.dense_from_numpy(
            rk, rng.standard_normal(300).astype(np.float32))
    e = np.array([], np.int32)
    if case == "empty_left":
        return c.dense_from_numpy(e, e), c.dense_from_numpy(RK, RV)
    if case == "empty_right":
        return c.dense_from_numpy(LK, LV), c.dense_from_numpy(
            e, np.array([], np.float32))
    return (c.dense_range(1000, chunk_rows=300).map(lambda x: (x % 50, x)),
            c.dense_from_numpy(np.arange(25, 75, dtype=np.int32),
                               np.arange(50, dtype=np.int32)))


@pytest.mark.parametrize("case", OUTER_CASES)
def test_full_outer_join_parity(ctxs, case):
    ref, port = ctxs
    a, b = _outer_inputs(ref, case)
    exp = a.full_outer_join(b).collect()
    a, b = _outer_inputs(port, case)
    res = a.full_outer_join(b)
    assert sorted(res.collect(), key=str) == sorted(exp, key=str)
    assert res.count() == len(exp)


@pytest.mark.parametrize("case", OUTER_CASES)
def test_subtract_by_key_parity(ctxs, case):
    """The left rows (duplicates kept) whose key the right lacks."""
    ref, port = ctxs
    a, b = _outer_inputs(ref, case)
    exp = a.subtract_by_key(b).collect()
    a, b = _outer_inputs(port, case)
    got = a.subtract_by_key(b)
    assert sorted(got.collect()) == sorted(exp)
    assert got.count() == len(exp)
    assert isinstance(got, dense_rdd.DenseRDD)


def test_subtract_by_key_values(ctxs):
    for c in ctxs:
        a, b = _sides(c)
        assert sorted(a.subtract_by_key(b).collect()) == \
            [(1, 10), (1, 11), (3, 30)]


def test_subtract_by_key_string_keys(ctxs):
    """String keys of two dictionaries meet on their merged one."""
    ref, port = ctxs
    ak = np.array(["a", "b", "b", "c"])
    bk = np.array(["b", "d"])

    def run(c):
        return sorted(c.dense_from_numpy(ak, LV).subtract_by_key(
            c.dense_from_numpy(bk, np.array([1, 2], np.int32))).collect())
    assert run(port) == run(ref) == [("a", 10), ("c", 30)]


@pytest.mark.parametrize("case", ["values", "duplicates"])
def test_group_with(ctxs, case):
    """The reference's group_with is its host cogroup: (k, ([ls], [rs]))
    per key, compared with each list as a multiset."""
    ref, port = ctxs

    def run(c):
        a, b = _sides(c) if case == "values" else _outer_inputs(
            c, "duplicates")
        return sorted((kk, (sorted(ls), sorted(rs)))
                      for kk, (ls, rs) in a.group_with(b).collect())
    got = run(port)
    assert got == run(ref)
    if case == "values":
        assert got == [(1, ([10, 11], [])), (2, ([20], [7.0])),
                       (3, ([30], [])), (4, ([], [8.0, 9.0]))]


@pytest.mark.parametrize("name", ["partition_by_key", "partition_by"])
def test_partition_by_key(ctxs, name):
    """The same (k, v) rows, order-free, and every key's rows on one
    shard (a hash exchange, no combine)."""
    ref, port = ctxs
    k, x = _data()
    exp = getattr(ref.dense_from_numpy(k, x), name)(4).collect()
    got = getattr(port.dense_from_numpy(k, x), name)(4)
    assert sorted(got.collect()) == sorted(exp)
    assert got.num_partitions == N_SHARDS
    blk = got.block()
    seen = {}
    for s in range(blk.n_shards):
        for kk, _v in dense_rdd._host_rows(blk.shard_rows(s)):
            assert seen.setdefault(kk, s) == s
    assert got.hash_placed


FOLD_CASES = {
    "add_zero_10": (lambda c: c.dense_range(20), 10, operator.add),
    "past_int32": (lambda c: c.dense_range(100_000), 0, operator.add),
    "big_values": (lambda c: c.dense_range(20_000).map(
        lambda x: x * 100_000), 1, lambda a, b: a + b),
    "float_values": (lambda c: c.dense_from_numpy(
        _float_data()[1]), 0.25, operator.add),
    "float_zero_int_values": (lambda c: c.dense_range(50), 0.5,
                              operator.add),
    "max_zero": (lambda c: c.dense_range(20), 100, max),
    "min": (lambda c: c.dense_from_numpy(_data()[1]), 0, min),
    "prod": (lambda c: c.dense_from_numpy(
        np.array([1, 2, 3, -2, 5, 1, 1, 2, 3], np.int32)), 2,
        operator.mul),
    "xor_traced": (lambda c: c.dense_range(1000), 3, lambda a, b: a ^ b),
    "empty": (lambda c: c.dense_from_numpy(np.array([], np.int32)), 10,
              operator.add),
    "streamed": (lambda c: c.dense_range(1000, chunk_rows=300), 1,
                 operator.add),
}


@pytest.mark.parametrize("case", sorted(FOLD_CASES))
def test_fold(ctxs, case):
    """Each shard folds seeded with zero, then the caller's process folds
    zero and the num_partitions shard results: sum + zero x (num_partitions + 1)
    for add. Integers exact (past 2^31), floats within rtol 1e-5."""
    ref, port = ctxs
    src, zero, f = FOLD_CASES[case]
    exp = src(ref).fold(zero, f)
    got = src(port).fold(zero, f)
    assert type(got) is type(exp)
    if isinstance(exp, float):
        assert got == pytest.approx(exp, rel=1e-5)
    else:
        assert got == exp
    if case == "add_zero_10":
        assert got == 280
    if case == "past_int32":
        assert got == sum(range(100_000)) > 2**31


AGGREGATE_CASES = {
    "add_add": (lambda c: c.dense_range(20), 10, operator.add,
                operator.add),
    "max_then_sum": (lambda c: c.dense_range(20), 0, max, operator.add),
    "add_then_python_max": (lambda c: c.dense_from_numpy(_data()[1]), 3,
                            operator.add, lambda a, b: a if a > b else b),
    "float_add": (lambda c: c.dense_from_numpy(_float_data()[1]), 0.0,
                  operator.add, operator.add),
    "empty": (lambda c: c.dense_from_numpy(np.array([], np.int32)), 4,
              operator.add, operator.add),
}


@pytest.mark.parametrize("case", sorted(AGGREGATE_CASES))
def test_aggregate(ctxs, case):
    """seq_func a named monoid on the device; comb_func any Python
    function on the host, as the reference's."""
    ref, port = ctxs
    src, zero, seq, comb = AGGREGATE_CASES[case]
    exp = src(ref).aggregate(zero, seq, comb)
    got = src(port).aggregate(zero, seq, comb)
    if isinstance(exp, float):
        assert got == pytest.approx(exp, rel=1e-5)
    else:
        assert got == exp
    if case == "add_add":
        assert got == 280


def test_fold_refusals(ctxs):
    """What has no device fold is the host RDD layer's fold, as the
    reference's: pairs (f takes the (k, v) tuples), an aggregate whose
    seq_func is not a named monoid (it need not be associative over
    values); a product past int64 raises VegaError (the reference keeps
    exact Python ints)."""
    _ref, port = ctxs
    assert port.dense_from_numpy(K2, V2).fold((0, 0), operator.add) == \
        _ref.dense_from_numpy(K2, V2).fold((0, 0), operator.add)
    assert port.dense_range(20).aggregate(
        0, lambda acc, x: acc + 1, operator.add) == _ref.dense_range(
            20).aggregate(0, lambda acc, x: acc + 1, operator.add) == 20
    with pytest.raises(VegaError, match="passes int64"):
        port.dense_from_numpy(np.full(64, 2**30, np.int32)).fold(
            1, operator.mul)
    # one factor a shard: each shard's product fits, and the product
    # of the shard results as Python ints is exact, as the reference's
    assert port.dense_from_numpy(np.full(8, 2**30, np.int32)).fold(
        1, operator.mul) == _ref.dense_from_numpy(
            np.full(8, 2**30, np.int32)).fold(1, operator.mul) == 2**240


# ---------------------------------------------------------------------------
# every other name: the host RDD layer, held to the reference
# ---------------------------------------------------------------------------


def _port_objects(ctx):
    p = ctx.dense_from_numpy(K2, V2)
    return {"DenseRDD": p,
            "cogroup": p.cogroup(ctx.dense_from_numpy(K2, V2)),
            "right_outer_join": p.right_outer_join(
                ctx.dense_from_numpy(K2, V2))}


DEVICE_FORMS = (
    "first", "is_empty", "keys", "values", "count_by_key", "collect_as_map",
    "lookup", "right_outer_join",
    # the reference's device tier answers these nine
    "fold_by_key", "aggregate_by_key", "group_by", "sort_by", "mask_keys",
    "cache", "num_partitions", "dense", "id",
    # its host tier answers these seven
    "full_outer_join", "subtract_by_key", "group_with", "partition_by_key",
    "partition_by", "fold", "aggregate",
    # and these thirteen, held to it in tests/test_torch_host_actions.py
    "take_sample", "random_split", "count_approx_distinct", "count_approx",
    "mean_approx", "count_by_value_approx", "to_local_iterator",
    "for_each", "for_each_partition", "save_as_text_file",
    "collect_async", "count_async", "reduce_async")

# The names each object refused before the port had a host RDD layer
# (a DenseRDD's 20; a cogroup's and a right_outer_join's result every
# name but collect and count): each case now holds the name's answer to
# the reference's, through the host layer.
HANDED_OFF = tuple(sorted((
    "cached_splits", "checkpoint", "coalesce", "compute", "flat_map",
    "flat_map_values", "get_dependencies", "glom", "is_pinned",
    "iterator", "map_partitions", "map_partitions_with_index",
    "partitioner", "pin", "pipe", "preferred_locations", "repartition",
    "splits", "to_debug_string", "to_rdd")))
_RESULT_NAMES = sorted(dense_rdd.REFERENCE_RDD_API - {"collect", "count"})
REFUSALS = (
    [("DenseRDD", n) for n in HANDED_OFF]
    + [("cogroup", n) for n in _RESULT_NAMES]
    + [("right_outer_join", n) for n in _RESULT_NAMES])


def _ref_objects(ctx):
    r = ctx.dense_from_numpy(K2, V2)
    return {"DenseRDD": r,
            "cogroup": r.cogroup(ctx.dense_from_numpy(K2, V2)),
            "right_outer_join": r.right_outer_join(
                ctx.dense_from_numpy(K2, V2))}


@pytest.mark.parametrize("obj,name", REFUSALS)
def test_host_only_name_refuses(ctxs, obj, name, tmp_path):
    """The reference answers `name` on its host tier, and so does the
    port's object now, through its host RDD layer: the same outcome
    (tests/test_torch_rdd_host.py's compare: the result's rows and forms,
    or the same exception class). The K2 / V2 pairs are numeric, so a
    DenseRDD's shuffled rows compare order-free (the reference's native
    merge)."""
    ref, port = ctxs
    ordered = not (obj == "DenseRDD" and (
        name in BAG_OPS or name == "repartition"))
    compare(name, _port_objects(port)[obj], _ref_objects(ref)[obj], port,
            ref, str(tmp_path), ordered=ordered)


def test_reference_api_list_is_the_reference_s():
    """The port's copy of the name list is the reference RDD's public
    API plus DenseRDD.to_rdd: a name the reference adds or drops fails
    here."""
    ref_names = {n for n in dir(RefRDD) if not n.startswith("_")}
    assert dense_rdd.REFERENCE_RDD_API == ref_names | {"to_rdd"}
    assert hasattr(ref_dense.DenseRDD, "to_rdd")


def test_device_forms_and_refusals_cover_the_api(ctxs):
    """Every reference name answers on a port DenseRDD: the device forms
    its own class defines, and the 20 it inherits from the host RDD
    (rdd/base.py); a name outside the reference's API is still an
    AttributeError."""
    _ref, port = ctxs
    node = port.dense_from_numpy(K2, V2)
    for name in dense_rdd.REFERENCE_RDD_API:
        getattr(node, name)
    with pytest.raises(AttributeError):
        getattr(node, "no_such_method")
    inherited = sorted(n for n in dense_rdd.REFERENCE_RDD_API
                       if n not in vars(dense_rdd.DenseRDD)
                       and n not in DEVICE_FORMS)
    assert set(inherited) <= set(HANDED_OFF) | set(DEVICE_FORMS)
    assert len(HANDED_OFF) == 20
    assert set(DEVICE_FORMS) | set(HANDED_OFF) | {
        n for n in dense_rdd.REFERENCE_RDD_API
        if n in vars(dense_rdd.DenseRDD)} == dense_rdd.REFERENCE_RDD_API


@pytest.mark.parametrize("name", HANDED_OFF)
def test_refusal_says_why(ctxs, name, tmp_path):
    """Each of the 20 names on a streamed node answers as its resident
    build does, equal to the reference's streamed node."""
    ref, port = ctxs
    compare(name, port.dense_range(1000, chunk_rows=300),
            ref.dense_range(1000, chunk_rows=300), port, ref,
            str(tmp_path), ordered=name != "repartition")


@pytest.mark.parametrize("obj", ["DenseRDD", "cogroup", "right_outer_join",
                                 "streamed"])
def test_refusal_keeps_the_attribute_protocol(ctxs, obj):
    """Every port object keeps the attribute protocol: a name of the
    reference's API is there (hasattr is True), and a misspelt one is a
    plain AttributeError, not a VegaError, with getattr's default
    returned."""
    _ref, port = ctxs
    node = (port.dense_range(1000, chunk_rows=300) if obj == "streamed"
            else _port_objects(port)[obj])
    assert hasattr(node, "glom") is True
    assert getattr(node, "glom_misspelt", None) is None
    with pytest.raises(AttributeError) as info:
        node.glom_misspelt
    assert not isinstance(info.value, VegaError)


def test_streamed_refusal_builds_nothing(ctxs):
    """A host-layer name on a StreamedDenseRDD goes to its resident build
    (the stream delegates every name it does not define), which is built
    once; the stream's own narrow ops still build nothing."""
    _ref, port = ctxs
    src = port.dense_range(1000, chunk_rows=300)
    mapped = src.map(lambda x: (x % 3, x))
    assert src._resident_memo is None
    assert mapped.first() == \
        _ref.dense_range(1000).map(lambda x: (x % 3, x)).first()
    got = src.flat_map_values
    assert src._resident_memo is not None
    assert got.__self__ is src._resident_memo
    assert src.glom().map(len).collect() == \
        _ref.dense_range(1000).glom().map(len).collect()
