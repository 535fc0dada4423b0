"""The host RDD API on a vega_tpu_torch DenseRDD against vega_tpu's, on
the CPU.

A reference DenseRDD inherits the host RDD API (vega_tpu/rdd/base.py's
RDD and its pair ops, rdd/pair.py). The port has no host tier: eight of
those methods have device forms here (first, is_empty, keys, values,
count_by_key, collect_as_map, lookup, right_outer_join), each held to the
reference's host result on the same data; every other name of that API
raises VegaError ending in HOST_TIER_SUFFIX on a DenseRDD, on a cogroup's
result and on a right_outer_join's result, never AttributeError. Both
packages run under the card's plans on the 8-device CPU mesh (the
reference) and Context(device="cpu", n_shards=8) (the port).
"""

import numpy as np
import pytest

import vega_tpu as v
from vega_tpu.errors import VegaError as RefVegaError
from vega_tpu.rdd.base import RDD as RefRDD
from vega_tpu.tpu import dense_rdd as ref_dense
import vega_tpu_torch as vt
from vega_tpu_torch import dense_rdd
from vega_tpu_torch.errors import VegaError

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
    old = {k: getattr(conf, k) for k in ACCEL_PLANS}
    for k, val in ACCEL_PLANS.items():
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
# every other name refuses with the suffix
# ---------------------------------------------------------------------------


def _refused_names(cls):
    return sorted(n for n in dense_rdd.REFERENCE_RDD_API
                  if not hasattr(cls, n))


def _port_objects(ctx):
    p = ctx.dense_from_numpy(K2, V2)
    return {"DenseRDD": p,
            "cogroup": p.cogroup(ctx.dense_from_numpy(K2, V2)),
            "right_outer_join": p.right_outer_join(
                ctx.dense_from_numpy(K2, V2))}


REFUSALS = (
    [("DenseRDD", n) for n in _refused_names(dense_rdd.DenseRDD)]
    + [("cogroup", n) for n in _refused_names(dense_rdd._DenseCoGroupRDD)]
    + [("right_outer_join", n)
       for n in _refused_names(dense_rdd._DenseRightOuterJoin)])


@pytest.mark.parametrize("obj,name", REFUSALS)
def test_host_only_name_refuses(ctxs, obj, name):
    """The reference's DenseRDD answers `name`; the port's object raises
    VegaError ending in HOST_TIER_SUFFIX when it is read."""
    _ref, port = ctxs
    assert hasattr(ref_dense.DenseRDD, name)
    with pytest.raises(VegaError) as info:
        getattr(_port_objects(port)[obj], name)
    assert str(info.value).endswith(dense_rdd.HOST_TIER_SUFFIX)


def test_reference_api_list_is_the_reference_s():
    """The port's copy of the name list is the reference RDD's public
    API plus DenseRDD.to_rdd: a name the reference adds or drops fails
    here."""
    ref_names = {n for n in dir(RefRDD) if not n.startswith("_")}
    assert dense_rdd.REFERENCE_RDD_API == ref_names | {"to_rdd"}
    assert hasattr(ref_dense.DenseRDD, "to_rdd")


def test_device_forms_and_refusals_cover_the_api(ctxs):
    """Every reference name on a port DenseRDD is a device form or a
    VegaError refusal, never a bare AttributeError; a name outside the
    reference's API still is one."""
    _ref, port = ctxs
    node = port.dense_from_numpy(K2, V2)
    for name in dense_rdd.REFERENCE_RDD_API:
        try:
            getattr(node, name)
        except VegaError:
            pass
    with pytest.raises(AttributeError):
        getattr(node, "no_such_method")
    for name in ("first", "is_empty", "keys", "values", "count_by_key",
                 "collect_as_map", "lookup", "right_outer_join"):
        assert name not in _refused_names(dense_rdd.DenseRDD)


@pytest.mark.parametrize("obj", ["DenseRDD", "cogroup", "right_outer_join",
                                 "streamed"])
def test_refusal_keeps_the_attribute_protocol(ctxs, obj):
    """A refused name is also an AttributeError: hasattr() is False and
    getattr() with a default returns it, on every port object, while a
    read still raises the VegaError with the suffix."""
    _ref, port = ctxs
    node = (port.dense_range(1000, chunk_rows=300) if obj == "streamed"
            else _port_objects(port)[obj])
    assert hasattr(node, "fold") is False
    assert getattr(node, "fold", None) is None
    with pytest.raises(VegaError) as info:
        node.fold
    assert isinstance(info.value, AttributeError)
    assert str(info.value).endswith(dense_rdd.HOST_TIER_SUFFIX)


def test_streamed_refusal_builds_nothing(ctxs):
    """A host-tier name on a StreamedDenseRDD refuses before its resident
    build (the stream delegates every other missing name to it)."""
    _ref, port = ctxs
    src = port.dense_range(1000, chunk_rows=300)
    with pytest.raises(VegaError) as info:
        src.fold_by_key
    assert str(info.value).endswith(dense_rdd.HOST_TIER_SUFFIX)
    assert src._resident_memo is None
    assert src.map(lambda x: (x % 3, x)).first() == \
        _ref.dense_range(1000).map(lambda x: (x % 3, x)).first()
