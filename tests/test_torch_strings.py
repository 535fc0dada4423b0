"""String columns of vega_tpu_torch against vega_tpu, on the CPU with 8
shards: dictionary encoding (dict_encoding.py), the Block.dicts sidecar
decoded at the host boundary, and the unification of two dictionaries
(_DictUnifyRDD) before a keyed binary op.

One parity test for each string test of tests/test_dense.py (reduce /
group / count, sort / distinct / top-k on rank codes, a cross-dictionary
join, dictionary-overflow growth at a small dense_dict_capacity), then the
other ops a string column reaches (cogroup, union, the set ops, zip, the
value actions, each exchange program) and the string query of
benchmarks/strings_ab.py at a small size. Inputs are made from numpy
seeds; every result is exact (strings and integers).

Where the reference hands an op over strings to its host tier (a row
function, a fold of string values but min / max, distinct over pairs), so
does the port, to its host RDD layer, which sees the decoded strings.
"""

import numpy as np
import pytest

import vega_tpu as v
from vega_tpu.tpu import dict_encoding as ref_dict
import vega_tpu_torch as vt
from vega_tpu_torch import dense_rdd, dict_encoding
from vega_tpu_torch.errors import VegaError

N_SHARDS = 8


class _Ctxs:
    """A reference Context and a port Context of one dense_dict_capacity;
    the reference's settings restored on stop."""

    def __init__(self, capacity=65536, **port_kw):
        self.ref = v.Context("local", num_workers=2,
                             dense_dict_capacity=capacity)
        self.port = vt.Context(device="cpu", n_shards=N_SHARDS,
                               dense_dict_capacity=capacity, **port_kw)

    def stop(self):
        self.port.stop()
        self.ref.stop()


@pytest.fixture()
def ctxs():
    c = _Ctxs()
    try:
        yield c.ref, c.port
    finally:
        c.stop()


def _string_pairs(seed=0, n=600, nkeys=29):
    """tests/test_dense.py's generator."""
    rng = np.random.RandomState(seed)
    keys = np.array([f"w{i:02d}" for i in rng.randint(0, nkeys, size=n)])
    vals = rng.randint(-100, 100, size=n).astype(np.int32)
    return keys, vals


def _lineage_nodes(rdd):
    seen, todo = [], [rdd]
    while todo:
        node = todo.pop()
        if any(node is s for s in seen):
            continue
        seen.append(node)
        todo.extend(getattr(node, "_dense_parents", ()))
        for attr in ("parent", "left", "right"):
            child = getattr(node, attr, None)
            if child is not None:
                todo.append(child)
    return seen


# ---------------------------------------------------------------------------
# dict_encoding.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src", [
    np.array(["b", "a", "c", "a"]), np.array([b"x", b"y", b"x"]),
    np.array(["z", "é", "a"], dtype=object), np.array([], dtype="<U3"),
    np.array([1, 2, 3]),
])
def test_encode_matches_reference(src):
    assert dict_encoding.is_string_array(src) == ref_dict.is_string_array(src)
    if not dict_encoding.is_string_array(src):
        return
    codes, values = dict_encoding.encode_array(src)
    rcodes, rvalues = ref_dict.encode_array(src)
    np.testing.assert_array_equal(codes, rcodes)
    np.testing.assert_array_equal(values, rvalues)
    assert codes.dtype == rcodes.dtype == np.int32
    np.testing.assert_array_equal(dict_encoding.decode_codes(codes, values),
                                  ref_dict.decode_codes(rcodes, rvalues))


def test_merge_dicts_matches_reference():
    a = np.array(["a", "c", "e"])
    b = np.array(["b", "c", "f", "g"])
    for got, exp in zip(dict_encoding.merge_dicts(a, b),
                        ref_dict.merge_dicts(a, b)):
        np.testing.assert_array_equal(got, exp)
    assert not dict_encoding.is_string_array(np.array([1, "a"], object))


# ---------------------------------------------------------------------------
# tests/test_dense.py's string tests, as parity
# ---------------------------------------------------------------------------

def test_dense_string_reduce_group_count_parity(ctxs):
    ref, port = ctxs
    keys, vals = _string_pairs()
    dev = port.dense_from_numpy(keys, vals)
    rdev = ref.dense_from_numpy(keys, vals)
    assert dev._dicts()["k"].dtype.kind == "U"
    red = dict(dev.reduce_by_key(lambda a, b: a + b).collect())
    assert red == dict(rdev.reduce_by_key(lambda a, b: a + b).collect())
    assert all(isinstance(k, str) for k in red)
    for op in ("min", "max", "add"):
        assert dict(dev.reduce_by_key(op=op).collect()) == \
            dict(rdev.reduce_by_key(op=op).collect())
    assert {k: sorted(vs) for k, vs in dev.group_by_key().collect()} == \
        {k: sorted(vs) for k, vs in rdev.group_by_key().collect()}
    assert dict(dev.count_by_key_dense().collect()) == rdev.count_by_key()
    gk, off, gv = dev.group_by_key().collect_grouped()
    assert gk.dtype.kind == "U" and len(gk) == len(set(keys.tolist()))
    # string VALUES under min / max: rank codes order as the strings. The
    # oracle is Python: this lineage's fingerprint equals dev's, so the
    # reference runs it warm on its table plan, which combines min / max
    # with psum (the recorded difference of tests/test_torch_plans.py)
    sv = port.dense_from_numpy(vals % 7, keys)
    for op, fn in (("min", min), ("max", max)):
        exp = {}
        for k, w in zip((vals % 7).tolist(), keys.tolist()):
            exp[k] = fn(exp[k], w) if k in exp else w
        assert dict(sv.reduce_by_key(op=op).collect()) == exp


def test_dense_string_sort_distinct_topk_parity(ctxs):
    ref, port = ctxs
    keys, vals = _string_pairs(seed=3)
    dev = port.dense_from_numpy(keys, vals)
    rdev = ref.dense_from_numpy(keys, vals)
    srt = dev.sort_by_key().collect()
    assert [k for k, _ in srt] == sorted(keys.tolist())
    assert srt == rdev.sort_by_key().collect()
    desc = dev.sort_by_key(ascending=False).collect()
    assert [k for k, _ in desc] == sorted(keys.tolist(), reverse=True)
    col = port.dense_from_numpy(keys)
    rcol = ref.dense_from_numpy(keys)
    assert sorted(col.distinct().collect()) == \
        sorted(rcol.distinct().collect()) == sorted(set(keys.tolist()))
    assert col.count_by_value() == rcol.count_by_value()
    assert dev.take_ordered(7) == rdev.take_ordered(7) == \
        sorted(zip(keys.tolist(), vals.tolist()))[:7]
    assert dev.top(5) == rdev.top(5) == \
        sorted(zip(keys.tolist(), vals.tolist()), reverse=True)[:5]
    assert col.take_ordered(4) == rcol.take_ordered(4)
    assert col.top(4) == rcol.top(4)
    assert col.min() == rcol.min() == min(keys.tolist())
    assert col.max() == rcol.max() == max(keys.tolist())
    # distinct over pairs is the host tier's in both
    assert sorted(rdev.distinct().collect()) == \
        sorted(dev.distinct().collect()) == \
        sorted(set(zip(keys.tolist(), vals.tolist())))


def test_dense_string_join_cross_dict_parity(ctxs):
    """Two sides of different key sets carry different dictionaries: the
    join unifies them (one host merge, one device remap per side) and
    equals the reference, with no capacity retry at the default
    dense_dict_capacity."""
    ref, port = ctxs
    rng = np.random.RandomState(11)
    lk = np.array([f"k{i:02d}" for i in rng.randint(0, 40, size=300)])
    lv = rng.randint(0, 1000, size=300).astype(np.int32)
    rk = np.array([f"k{i:02d}" for i in range(20, 60)])
    rv = np.arange(40).astype(np.int32)
    j = port.dense_from_numpy(lk, lv).join(port.dense_from_numpy(rk, rv))
    rj = ref.dense_from_numpy(lk, lv).join(ref.dense_from_numpy(rk, rv))
    unify = [n for n in _lineage_nodes(j)
             if isinstance(n, dense_rdd._DictUnifyRDD)]
    assert len(unify) == 2
    assert unify[0]._unif is unify[1]._unif  # one host merge
    assert sorted(j.collect()) == sorted(rj.collect())
    assert len(j.collect()) == int(np.isin(lk, rk).sum())
    assert all(n._dict_retries == 0 for n in unify)
    assert len(j._dicts()["k"]) == len(np.union1d(lk, rk))


def test_dense_string_dict_overflow_grows_capacity():
    """dense_dict_capacity=2 (staged at the 128-entry floor) cannot hold a
    300-entry merged dictionary: the remap's overflow flag doubles the
    table and retries, in both packages, and the join is exact."""
    c = _Ctxs(capacity=2)
    try:
        lk = np.array([f"k{i:03d}" for i in range(200)])
        lv = np.arange(200).astype(np.int32)
        rk = np.array([f"k{i:03d}" for i in range(100, 300)])
        rv = (np.arange(200) * 7).astype(np.int32)
        j = c.port.dense_from_numpy(lk, lv).join(
            c.port.dense_from_numpy(rk, rv))
        rj = c.ref.dense_from_numpy(lk, lv).join(
            c.ref.dense_from_numpy(rk, rv))
        got = sorted(j.collect())
        assert got == sorted(rj.collect())
        assert got[0] == ("k100", (100, 0)) and len(got) == 100
        unify = [n for n in _lineage_nodes(j)
                 if isinstance(n, dense_rdd._DictUnifyRDD)]
        runify = [n for n in _lineage_nodes(rj)
                  if type(n).__name__ == "_DictUnifyRDD"]
        assert unify and any(n._dict_retries >= 1 for n in unify)
        assert sorted(n._dict_retries for n in unify) == \
            sorted(n._dict_retries for n in runify)
    finally:
        c.stop()


def test_dict_disabled_raises():
    """Context(dense_dict_enabled=False): no block holds a string column,
    so a (k, v) source degrades to the host tier's rows, as the
    reference's; a named block has no row form and raises the
    reference's error."""
    from vega_tpu.env import Env

    with vt.Context(device="cpu", dense_dict_enabled=False) as ctx:
        pairs = ctx.dense_from_numpy(np.array(["a", "b"]),
                                     np.arange(2, dtype=np.int32))
        assert not isinstance(pairs, dense_rdd.DenseRDD)
        assert pairs.collect() == [("a", 0), ("b", 1)]
        with pytest.raises(VegaError) as err:
            ctx.dense_from_columns({"k": np.array(["a", "b"])})
        # a numeric source is unaffected
        assert ctx.dense_from_numpy(np.arange(3)).count() == 3
    ref = v.Context("local", num_workers=2, dense_dict_enabled=False)
    try:
        assert Env.get().conf.dense_dict_enabled is False
        with pytest.raises(v.VegaError) as ref_err:
            ref_dict.encode_string_columns({"k": np.array(["a", "b"])})
    finally:
        ref.stop()
    assert str(err.value) == str(ref_err.value)


# ---------------------------------------------------------------------------
# the other ops a string column reaches
# ---------------------------------------------------------------------------

def test_string_binary_ops_unify(ctxs):
    """cogroup, left_outer_join (string keys), union and the set ops
    (string values) over two dictionaries equal the reference's."""
    ref, port = ctxs
    rng = np.random.RandomState(7)
    ak = np.array([f"a{i:02d}" for i in rng.randint(0, 30, size=200)])
    bk = np.array([f"a{i:02d}" for i in rng.randint(15, 45, size=150)])
    av = np.arange(200, dtype=np.int32)
    bv = np.arange(150, dtype=np.int32) * 2

    def both(fn):
        return fn(port), fn(ref)

    got, exp = both(lambda c: c.dense_from_numpy(ak, av).cogroup(
        c.dense_from_numpy(bk, bv)).collect())
    assert sorted((k, (sorted(a), sorted(b))) for k, (a, b) in got) == \
        sorted((k, (sorted(a), sorted(b))) for k, (a, b) in exp)
    got, exp = both(lambda c: c.dense_from_numpy(ak, av).left_outer_join(
        c.dense_from_numpy(bk, bv), fill_value=-1).collect())
    assert sorted(got) == sorted(exp)
    got, exp = both(lambda c: c.dense_from_numpy(ak, av).union(
        c.dense_from_numpy(bk, bv)).collect())
    assert sorted(got) == sorted(exp)
    for op in ("intersection", "subtract"):
        got, exp = both(lambda c: getattr(c.dense_from_numpy(ak), op)(
            c.dense_from_numpy(bk)).collect())
        assert sorted(got) == sorted(exp), op
    u = port.dense_from_numpy(ak).union(port.dense_from_numpy(bk))
    assert sorted(u.distinct().collect()) == sorted(set(ak) | set(bk))
    # one dictionary object on both sides: nothing to unify
    src = port.dense_from_numpy(ak, av)
    j = src.join(src.map_values(lambda x: x + 1))
    assert not any(isinstance(n, dense_rdd._DictUnifyRDD)
                   for n in _lineage_nodes(j))
    assert j.count() == ref.dense_from_numpy(ak, av).join(
        ref.dense_from_numpy(ak, av).map_values(lambda x: x + 1)).count()


def test_string_columns_through_narrow_nodes(ctxs):
    """Dictionaries follow their columns through select, rename, keys /
    values, filter of the set ops, zip, zip_with_index, sample and a
    named block's reduce; row forms decode at collect and take."""
    ref, port = ctxs
    keys, vals = _string_pairs(seed=5, n=200)
    names = np.array([f"n{i % 13}" for i in range(200)])

    def both(fn):
        return fn(port), fn(ref)

    got, exp = both(lambda c: c.dense_from_numpy(keys, vals).keys_dense()
                    .collect())
    assert sorted(got) == sorted(exp)
    got, exp = both(lambda c: c.dense_from_numpy(vals, keys).values_dense()
                    .collect())
    assert sorted(got) == sorted(exp)
    got, exp = both(lambda c: c.dense_from_numpy(keys).zip(
        c.dense_from_numpy(names)).collect())
    assert got == exp
    got, exp = both(lambda c: c.dense_from_numpy(keys).zip_with_index()
                    .collect())
    assert got == exp
    got, exp = both(lambda c: c.dense_from_columns(
        {"w": keys, "n": names, "x": vals}, key="w").select("k", "n")
        .rename({"n": "name"}).reduce_by_key(op="max").collect())
    assert sorted(got) == sorted(exp)
    got, exp = both(lambda c: c.dense_from_numpy(keys, vals)
                    .sample(False, 0.5, seed=3).collect())
    assert got == exp
    blk = port.dense_from_numpy(keys, vals).take(4)
    assert blk == ref.dense_from_numpy(keys, vals).take(4)
    assert all(isinstance(k, str) for k, _ in blk)


def _outcome(build):
    """Rows (an RDD's sorted by repr) or the exception's class (a
    reference task's TaskError as its cause)."""
    try:
        out = build()
        if hasattr(out, "collect"):
            out = sorted(out.collect(), key=repr)
        return ("ok", repr(out))
    except Exception as e:  # noqa: BLE001 — the class is the outcome
        while type(e).__name__ == "TaskError" and e.__cause__ is not None:
            e = e.__cause__
        return ("raise", type(e).__name__)


def test_string_row_functions_raise_where_the_reference_falls_back(ctxs):
    """A row function over a string column would see int32 codes, so the
    reference runs it on its host tier (on the strings), and the port on
    its host RDD layer: the same rows, or the same exception class where
    the host tier fails (stats of strings). So do a fold of string values
    (add concatenates there) and a join of a string key with an int one.
    A sum() of strings has no meaning and raises in both."""
    ref, port = ctxs
    keys, vals = _string_pairs(seed=1, n=50)
    builds = (
        lambda c: c.dense_from_numpy(keys, vals).map(
            lambda kv: (kv[0] + "!", kv[1])),
        lambda c: c.dense_from_numpy(keys, vals).filter(
            lambda kv: kv[1] > 0),
        lambda c: c.dense_from_numpy(keys).map_expand(lambda x: x, 2),
        lambda c: c.dense_from_numpy(vals, keys).map_values(
            lambda w: w.upper()),
        lambda c: c.dense_from_numpy(vals, keys).reduce_by_key(op="add"),
        lambda c: c.dense_from_numpy(vals, keys).combine_by_key(
            lambda x: x, lambda a, x: a, lambda a, b: a),
        lambda c: c.dense_from_numpy(keys).reduce(lambda a, b: a),
        lambda c: c.dense_from_numpy(keys[:8]).cartesian(
            c.dense_from_numpy(keys[:5])),
        lambda c: c.dense_from_numpy(keys).stats(),
        lambda c: c.dense_from_numpy(keys, vals).join(c.dense_from_numpy(
            np.arange(3, dtype=np.int32), np.arange(3))))
    for build in builds:
        got = _outcome(lambda: build(port))
        assert got == _outcome(lambda: build(ref))
        node = build(port) if got[0] == "ok" else None
        assert not isinstance(node, dense_rdd.DenseRDD)
    with pytest.raises(VegaError, match="no meaning"):
        port.dense_from_numpy(keys).sum()


@pytest.mark.parametrize("mode", ["all_to_all", "staged", "ring"])
def test_string_keys_under_each_program(mode):
    """Codes are int32 columns to every exchange program: group, reduce
    and a cross-dictionary join of string keys equal the reference's
    under each forced program (groups in arrival order)."""
    from vega_tpu.env import Env

    c = _Ctxs(dense_rbk_plan="sort_partition", dense_table_plan="off",
              dense_sort_impl="xla")
    conf = Env.get().conf
    old = conf.dense_exchange, conf.dense_table_plan, conf.dense_sort_impl
    conf.dense_exchange, conf.dense_table_plan, conf.dense_sort_impl = \
        mode, "off", "xla"
    try:
        keys, vals = _string_pairs(seed=8, n=3_000, nkeys=300)
        tk = np.array([f"w{i:02d}" for i in range(100, 400)])

        def run(ctx, ex):
            src = ctx.dense_from_numpy(keys, vals)
            return (src.group_by_key(exchange=ex).collect(),
                    dict(src.reduce_by_key(op="add", exchange=ex).collect()),
                    sorted(src.join(ctx.dense_from_numpy(
                        tk, np.arange(300, dtype=np.int32)),
                        exchange=ex).collect()))

        got = run(c.port, mode)
        exp = run(c.ref, None)
        assert got == exp
    finally:
        conf.dense_exchange, conf.dense_table_plan, conf.dense_sort_impl = \
            old
        c.stop()


def test_strings_ab_query(ctxs):
    """benchmarks/strings_ab.py's query at a small size: reduce_by_key
    (add) on string keys -> join with a dims table on string keys (half
    its words shared) -> sort_by_key -> collect, equal to the reference
    and to Python dicts."""
    ref, port = ctxs
    rng = np.random.RandomState(13)
    vocab = np.array([f"sku-{i:06d}" for i in range(2_000)])
    keys = vocab[rng.randint(0, 2_000, size=20_000)]
    vals = rng.randint(0, 100, size=20_000).astype(np.int32)
    dims_k = np.array([f"sku-{i:06d}" for i in range(1_000, 3_000)])
    dims_v = np.arange(2_000, dtype=np.int32)

    def query(ctx):
        return (ctx.dense_from_numpy(keys, vals).reduce_by_key(op="add")
                .join(ctx.dense_from_numpy(dims_k, dims_v)).sort_by_key()
                .collect())

    got = query(port)
    assert got == query(ref)
    sums = {}
    for k, x in zip(keys.tolist(), vals.tolist()):
        sums[k] = sums.get(k, 0) + x
    dims = dict(zip(dims_k.tolist(), dims_v.tolist()))
    # a joined block sorted by key is a named block: (k, lv, rv) rows
    assert got == sorted((k, s, dims[k]) for k, s in sums.items()
                         if k in dims)
