"""The reference's implicit host fall-throughs, held against vega_tpu_torch
on the CPU.

The reference's DenseRDD hands an op to its host tier on its own wherever
its device form does not apply: a closure jax's trace refuses (numpy or
math on the row, a branch on a value, a hash of it, a string column), a
keyed fold whose binop does not trace, a join under an explicit
partitioner, an outer join that fills None, a set op of mismatched sides,
an action over pairs or strings, a source no block holds. The port makes
the same choice (its trace refuses what jax's refuses, tracing.py) and
hands the op to its host RDD layer (vega_tpu_torch/rdd/), which runs the
same Python over the same compute() rows.

Each case builds one lineage on both packages (the reference on its
8-device CPU mesh under the card's plans, the port at
Context(device="cpu", n_shards=8)) and compares the outcome whole:
whether the result is a DenseRDD or a host RDD, its to_debug_string lines
(rdd ids masked), its rows with their element types (repr), and for the
cases under a partitioner its glom(); where the reference raises, the
exception's class. Rows compare exactly: both sides run the same Python
over the same rows. Rows after a host shuffle of numeric pairs compare
order-free, as tests/test_torch_rdd_host.py says.
"""

import math
import operator
import re

import numpy as np
import pytest

from test_torch_rdd_host import REF_CONF, norm
import vega_tpu as v
from vega_tpu.partitioner import HashPartitioner as RefHash
from vega_tpu.rdd.base import RDD as RefRDD
from vega_tpu.tpu.dense_rdd import DenseRDD as RefDense
import vega_tpu_torch as vt
from vega_tpu_torch import dense_rdd
from vega_tpu_torch.dense_rdd import DenseRDD as PortDense
from vega_tpu_torch.partitioner import HashPartitioner as PortHash
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


def _data(seed=20, n=400, keys=40):
    rng = np.random.default_rng(seed)
    return dict(
        k=rng.integers(0, keys, n).astype(np.int32),
        v=rng.integers(-1000, 1000, n).astype(np.int32),
        w=rng.integers(-2**40, 2**40, n),
        x=rng.standard_normal(n).astype(np.float32),
        s=np.array([f"w{i:02d}" for i in range(25)])[
            rng.integers(0, 25, n)])


D = _data()
T_KEYS = np.arange(0, 50, 2, dtype=np.int32)
T_VALS = np.arange(25, dtype=np.int32) * 3
T_WIDE = np.arange(25, dtype=np.int64) * 2**35
T_STR = np.array([f"t{i}" for i in range(25)])


def _is_ref(c):
    return isinstance(c, v.Context)


def _hash(c, n):
    return (RefHash if _is_ref(c) else PortHash)(n)


def _kv(c):
    return c.dense_from_numpy(D["k"], D["v"])


def _table(c, vals=T_VALS):
    return c.dense_from_numpy(T_KEYS, vals)


# ---------------------------------------------------------------------------
# outcomes
# ---------------------------------------------------------------------------


def _cause(e):
    while type(e).__name__ == "TaskError" and e.__cause__ is not None:
        e = e.__cause__
    return type(e).__name__


def _rows(rows, bag: bool):
    return sorted(rows, key=repr) if bag else rows


def _result(r, bag: bool, glom: bool):
    """The comparable form of one result: an RDD as its kind, debug
    lines, rows (and partitions under glom); anything else as its repr
    (a dict's items sorted)."""
    if isinstance(r, (PortRDD, RefRDD)):
        kind = "dense" if isinstance(r, (PortDense, RefDense)) else "host"
        out = [kind, _IDS.sub("[#]", r.to_debug_string())]
        try:
            out.append(repr(_rows(r.collect(), bag)))
            if glom:
                out.append(repr([_rows(p, True)
                                 for p in r.glom().collect()]))
        except Exception as e:  # noqa: BLE001 — the class is the outcome
            out.append(("raise", _cause(e)))
        return tuple(out)
    if isinstance(r, dict):
        return repr(sorted(r.items(), key=repr))
    return repr(r)


def observe(build, c, bag=False, glom=False):
    try:
        r = build(c)
    except Exception as e:  # noqa: BLE001 — the class is the outcome
        return ("raise", _cause(e))
    return _result(r, bag, glom)


def check(ctxs, build, bag=False, glom=False):
    ref, port = ctxs
    exp = observe(build, ref, bag, glom)
    got = observe(build, port, bag, glom)
    assert got == exp
    return got


# ---------------------------------------------------------------------------
# F21: the port's trace refuses what jax's refuses
# ---------------------------------------------------------------------------

# name -> row function over dense_range(40)
CATALOGUE = {
    "np_sqrt": lambda x: (x % 3, np.sqrt(x)),
    "np_where": lambda x: np.where(x > 1, x, 0),
    "math_sqrt": lambda x: math.sqrt(x),
    "float": lambda x: float(x),
    "int": lambda x: int(x),
    "branch": lambda x: x if x > 3 else 0,
    "format": lambda x: f"{x}",
    "dict_key": lambda x: {0: 1}[x],
    "item": lambda x: x.item(),
    "tolist": lambda x: x.tolist(),
    "len": lambda x: len(x),
    "np_scalar_times_row": lambda x: (x % 5, np.int32(3) * x),
    "control": lambda x: (x % 3, x * 2),
}


@pytest.mark.parametrize("name", sorted(CATALOGUE))
def test_trace_refuses_what_jax_refuses(ctxs, name):
    """The tier of each closure is jax's: a DenseRDD on both sides, or a
    host MapperRDD on both with the same rows and element types."""
    f = CATALOGUE[name]
    got = check(ctxs, lambda c: c.dense_range(40).map(f))
    assert got[0] == ("dense" if name in ("control", "np_scalar_times_row")
                      else "host") or got[0] == "raise"


def test_f21_np_sqrt_rows_are_the_hosts(ctxs):
    """dense_range(6).map(lambda x: (x % 3, np.sqrt(x))): a host node whose
    rows hold np.float64, as the reference's; on 394704a the port built a
    device node of float32 rows."""
    ref, port = ctxs
    r = port.dense_range(6).map(lambda x: (x % 3, np.sqrt(x)))
    assert not isinstance(r, PortDense)
    rows = r.collect()
    assert rows[2] == (2, np.float64(np.sqrt(2)))
    assert type(rows[2][1]) is np.float64
    assert repr(rows) == repr(ref.dense_range(6).map(
        lambda x: (x % 3, np.sqrt(x))).collect())


def test_string_method_on_a_string_column(ctxs):
    check(ctxs, lambda c: c.dense_from_numpy(D["s"]).map(str.upper))
    check(ctxs, lambda c: c.dense_from_numpy(D["s"]).filter(
        lambda w: w.endswith("3")))
    check(ctxs, lambda c: c.dense_from_numpy(D["k"], D["s"]).map(
        lambda kv: (kv[1], kv[0])).reduce_by_key(operator.add), bag=True)


def test_probe_conversions_refuse_on_every_device():
    """The trace's refusals are the mode's, not the probe device's: a
    CPU probe tensor refuses numpy and Python conversions inside it."""
    import torch

    from vega_tpu_torch import tracing

    p = torch.empty((8, 0), dtype=torch.int32)
    for conv in (np.asarray, np.sqrt, float, int, bool, hash, len,
                 lambda t: t.item(), lambda t: t.tolist()):
        with pytest.raises(tracing.TraceRefusal):
            with tracing.reference_trace():
                conv(p)
    with tracing.reference_trace():
        assert (p * 2).shape == p.shape
    assert np.asarray(p).shape == (8, 0)  # outside the trace, as before


# ---------------------------------------------------------------------------
# Part B 1: narrow ops
# ---------------------------------------------------------------------------

NARROW = {
    "filter_untraceable": lambda c: c.dense_range(40).filter(
        lambda x: x > 3 and x < 30),
    "filter_string_pairs": lambda c: c.dense_from_numpy(D["k"], D["s"])
    .filter(lambda kv: kv[1] < "w10"),
    "key_by_untraceable": lambda c: c.dense_range(40).key_by(math.sqrt),
    "key_by_pairs": lambda c: _kv(c).key_by(lambda kv: kv[0]),
    "key_by_string": lambda c: c.dense_from_numpy(D["s"]).key_by(len),
    "map_expand_untraceable": lambda c: c.dense_range(20).map_expand(
        lambda x: np.array([x, x * 10]), 2),
    "map_expand_pair_untraceable": lambda c: c.dense_range(20).map_expand(
        lambda x: (np.array([x, x]), np.array([float(x), -1.0])), 2),
    "map_expand_string": lambda c: c.dense_from_numpy(D["s"][:30])
    .map_expand(lambda w: [w, w + "!"], 2),
    "map_expand_wide": lambda c: c.dense_from_numpy(D["w"][:30])
    .map_expand(lambda x: [x, -x], 2),
    "flat_map_ragged_untraceable": lambda c: c.dense_range(20)
    .flat_map_ragged(lambda x: (np.array([x, 2 * x, 3 * x]), x % 5), 3),
    "flat_map_ragged_pairs": lambda c: c.dense_range(20).flat_map_ragged(
        lambda x: ((np.array([x, x + 1]), np.array([x * 0.5, -1.0])),
                   x % 4 - 1), 2),
    "flat_map_ragged_string": lambda c: c.dense_from_numpy(D["s"][:30])
    .flat_map_ragged(lambda w: ([w, w[::-1]], len(w) - 2), 2),
    "map_values_untraceable": lambda c: _kv(c).map_values(
        lambda x: math.sqrt(abs(x))),
    "map_values_string": lambda c: c.dense_from_numpy(D["k"], D["s"])
    .map_values(str.upper),
    "map_values_named_string": lambda c: c.dense_from_columns(
        {"k": D["k"], "a": D["s"]}, key="k").map_values(str.upper),
    "map_values_named_wide": lambda c: c.dense_from_columns(
        {"k": D["k"], "a": D["w"]}, key="k").map_values(lambda x: x + 1),
    "map_values_named_untraceable": lambda c: c.dense_from_columns(
        {"k": D["k"], "a": D["v"]}, key="k").map_values(math.sqrt),
    "map_output_shape": lambda c: c.dense_range(10).map(
        lambda x: np.stack([x, x])),
    "map_named_string_row": lambda c: c.dense_from_columns(
        {"a": D["k"], "b": D["s"]}).map(lambda r: r[1] + str(r[0])),
}


@pytest.mark.parametrize("name", sorted(NARROW))
def test_narrow_ops_fall_to_the_host_as_the_reference(ctxs, name):
    check(ctxs, NARROW[name])


# ---------------------------------------------------------------------------
# Part B 2: keyed folds with a binop that does not trace
# ---------------------------------------------------------------------------

def _fmod(a, b):
    return int(math.fmod(a + b, 1000))


KEYED = {
    "reduce_by_key_untraceable": lambda c: _kv(c).reduce_by_key(_fmod),
    "reduce_by_key_untraceable_p": lambda c: _kv(c).reduce_by_key(_fmod, 3),
    "reduce_by_key_string_add": lambda c: c.dense_from_numpy(
        D["k"], D["s"]).reduce_by_key(op="add"),
    "reduce_by_key_string_closure": lambda c: c.dense_from_numpy(
        D["k"], D["s"]).reduce_by_key(lambda a, b: a + "|" + b),
    "reduce_by_key_string_prod": lambda c: c.dense_from_numpy(
        D["k"], D["s"]).reduce_by_key(op="prod"),
    "reduce_by_key_named_string": lambda c: c.dense_from_columns(
        {"k": D["k"], "a": D["s"]}, key="k").reduce_by_key(op="add"),
    "reduce_by_key_named_untraceable": lambda c: c.dense_from_columns(
        {"k": D["k"], "a": D["v"], "b": D["x"]}, key="k").reduce_by_key(
        lambda a, b: (_fmod(a[0], b[0]), a[1] + b[1])),
    "combine_by_key_untraceable": lambda c: _kv(c).combine_by_key(
        lambda x: [x], lambda a, x: a + [x], operator.add),
    "combine_by_key_merge_untraceable": lambda c: _kv(c).combine_by_key(
        abs, _fmod, _fmod),
    "combine_by_key_string": lambda c: c.dense_from_numpy(
        D["k"], D["s"]).combine_by_key(len, lambda a, w: a + len(w),
                                       operator.add),
    "fold_by_key_untraceable": lambda c: _kv(c).fold_by_key(7, _fmod),
    "fold_by_key_string": lambda c: c.dense_from_numpy(
        D["k"], D["s"]).fold_by_key("", operator.add),
    "aggregate_by_key_untraceable": lambda c: _kv(c).aggregate_by_key(
        (0, 0), lambda a, x: (a[0] + x, a[1] + 1),
        lambda a, b: (a[0] + b[0], a[1] + b[1])),
    "aggregate_by_key_p": lambda c: _kv(c).aggregate_by_key(
        0, _fmod, _fmod, 4),
}


@pytest.mark.parametrize("name", sorted(KEYED))
def test_keyed_folds_fall_to_the_host_as_the_reference(ctxs, name):
    check(ctxs, KEYED[name], bag=True)


# ---------------------------------------------------------------------------
# Part B 3: joins and cogroup
# ---------------------------------------------------------------------------

JOINS = {
    "join_num": lambda c: _kv(c).join(_table(c), 16),
    "join_partitioner": lambda c: _kv(c).join(_table(c), _hash(c, 16)),
    "cogroup_partitioner": lambda c: _kv(c).cogroup(
        _table(c), partitioner_or_num=_hash(c, 16)),
    "cogroup_num": lambda c: _kv(c).cogroup(_table(c),
                                            partitioner_or_num=5),
    "left_outer_join_num": lambda c: _kv(c).left_outer_join(_table(c), 6),
    "right_outer_join_num": lambda c: _kv(c).right_outer_join(
        _table(c), 6),
    "full_outer_join_num": lambda c: _kv(c).full_outer_join(_table(c), 6),
    "subtract_by_key_num": lambda c: _kv(c).subtract_by_key(_table(c), 6),
    "left_outer_join_fill_none": lambda c: _kv(c).left_outer_join(
        _table(c), fill_value=None),
    "left_outer_join_string_right": lambda c: _kv(c).left_outer_join(
        _table(c, T_STR)),
    "left_outer_join_wide_right": lambda c: _kv(c).left_outer_join(
        _table(c, T_WIDE), fill_value=-1),
    "group_with_none": lambda c: _kv(c).group_with(),
    "cogroup_none": lambda c: _kv(c).cogroup(),
    "join_host_side": lambda c: _kv(c).join(c.parallelize(
        [(int(k), "r") for k in T_KEYS], 3)),
    "join_values": lambda c: c.dense_from_numpy(D["v"]).join(_table(c)),
    "join_named": lambda c: c.dense_from_columns(
        {"k": D["k"], "a": D["v"], "b": D["x"]}, key="k").join(_table(c)),
    "join_named_num": lambda c: _kv(c).join(c.dense_from_columns(
        {"k": T_KEYS, "a": T_VALS, "b": T_VALS}, key="k"), 4),
}


@pytest.mark.parametrize("name", sorted(JOINS))
def test_joins_fall_to_the_host_as_the_reference(ctxs, name):
    """Under a partitioner the partitions are the reference's (glom)."""
    check(ctxs, JOINS[name], bag=True, glom=True)


# ---------------------------------------------------------------------------
# Part B 4: cartesian and the set ops
# ---------------------------------------------------------------------------

SETS = {
    "cartesian_string": lambda c: c.dense_from_numpy(D["s"][:12])
    .cartesian(c.dense_from_numpy(D["v"][:5])),
    "cartesian_pairs": lambda c: _table(c).cartesian(
        c.dense_from_numpy(D["v"][:4])),
    "cartesian_host_side": lambda c: c.dense_from_numpy(D["v"][:6])
    .cartesian(c.parallelize(["a", "b"], 2)),
    "distinct_pairs": lambda c: c.dense_from_numpy(
        D["k"] % 5, D["v"] % 3).distinct(),
    "intersection_dtypes": lambda c: c.dense_from_numpy(D["v"] % 50)
    .intersection(c.dense_from_numpy((D["v"] % 30).astype(np.float32))),
    "subtract_dtypes": lambda c: c.dense_from_numpy(D["v"] % 50)
    .subtract(c.dense_from_numpy((D["v"] % 30).astype(np.float32))),
    "intersection_pairs": lambda c: c.dense_from_numpy(D["k"] % 5, D["v"] % 3)
    .intersection(c.dense_from_numpy(D["k"] % 4, D["v"] % 2)),
    "subtract_pairs": lambda c: c.dense_from_numpy(D["k"] % 5, D["v"] % 3)
    .subtract(c.dense_from_numpy(D["k"] % 4, D["v"] % 2)),
    "intersection_host_side": lambda c: c.dense_from_numpy(D["v"] % 50)
    .intersection(c.parallelize(list(range(0, 40, 3)), 3)),
    "subtract_host_side": lambda c: c.dense_from_numpy(D["v"] % 50)
    .subtract(c.parallelize(list(range(0, 40, 3)), 3)),
    "intersection_string_number": lambda c: c.dense_from_numpy(D["s"])
    .intersection(c.dense_from_numpy(D["v"])),
    "union_schemas": lambda c: _kv(c).union(c.dense_from_numpy(D["x"])),
    "union_value_dtypes": lambda c: c.dense_from_numpy(D["v"][:20]).union(
        c.dense_from_numpy(D["x"][:20])),
    "zip_pairs": lambda c: _kv(c).zip(_kv(c).map_values(lambda x: -x)),
    "zip_named": lambda c: c.dense_from_numpy(D["v"]).zip(
        c.dense_from_columns({"a": D["k"], "b": D["x"]})),
}
_ORDERED_SETS = ("cartesian_string", "cartesian_pairs", "cartesian_host_side",
                 "union_schemas", "union_value_dtypes", "zip_pairs",
                 "zip_named")


@pytest.mark.parametrize("name", sorted(SETS))
def test_set_ops_fall_to_the_host_as_the_reference(ctxs, name):
    check(ctxs, SETS[name], bag=name not in _ORDERED_SETS)


def test_cartesian_past_the_budget_is_the_hosts(ctxs, monkeypatch):
    """A product past the device budget: the host's lazy cartesian."""
    from vega_tpu.env import Env

    conf = Env.get().conf
    monkeypatch.setattr(conf, "dense_hbm_budget", 1 << 10)
    monkeypatch.setattr(dense_rdd, "CPU_CARTESIAN_BUDGET", 1 << 10)
    got = check(ctxs, lambda c: c.dense_from_numpy(D["v"][:300]).cartesian(
        c.dense_from_numpy(D["x"][:40])))
    assert got[0] == "host"


# ---------------------------------------------------------------------------
# Part B 5: actions
# ---------------------------------------------------------------------------

ACTIONS = {
    "reduce_pairs": lambda c: _kv(c).reduce(
        lambda a, b: a if a[1] >= b[1] else b),
    "reduce_wide": lambda c: c.dense_from_numpy(D["w"]).reduce(
        lambda a, b: a ^ b),
    "reduce_strings": lambda c: c.dense_from_numpy(D["s"][:40]).reduce(
        operator.add),
    "reduce_past_int32": lambda c: c.dense_range(30).reduce(
        lambda a, b: (a + b) % 2**40),
    "count_by_value_pairs": lambda c: c.dense_from_numpy(
        D["k"] % 4, D["v"] % 3).count_by_value(),
    "count_by_value_wide": lambda c: c.dense_from_numpy(
        D["w"] % 7).count_by_value(),
    "take_ordered_key": lambda c: c.dense_from_numpy(D["v"]).take_ordered(
        5, key=lambda x: (x % 7, -x)),
    "top_key": lambda c: _kv(c).top(4, key=lambda kv: kv[1] % 11),
    "take_ordered_key_strings": lambda c: c.dense_from_numpy(D["s"])
    .take_ordered(3, key=lambda w: w[::-1]),
    "stats_pairs": lambda c: _kv(c).stats(),
    "stats_wide": lambda c: c.dense_from_numpy(D["w"]).stats(),
    "stats_strings": lambda c: c.dense_from_numpy(D["s"]).stats(),
    "histogram_wide": lambda c: c.dense_from_numpy(D["w"]).histogram(5),
    "histogram_wide_edges": lambda c: c.dense_from_numpy(D["w"]).histogram(
        [-2**40, 0, 2**39, 2**40]),
    "histogram_strings": lambda c: c.dense_from_numpy(D["s"]).histogram(3),
    "histogram_pairs": lambda c: _kv(c).histogram(3),
    "aggregate_closure": lambda c: c.dense_from_numpy(D["v"]).aggregate(
        (0, 0), lambda a, x: (a[0] + x, a[1] + 1),
        lambda a, b: (a[0] + b[0], a[1] + b[1])),
    "aggregate_pairs": lambda c: _kv(c).aggregate(
        0, lambda a, kv: a + kv[1], operator.add),
    "fold_pairs": lambda c: _kv(c).fold(
        (0, 0), lambda a, b: (a[0] + b[0], a[1] + b[1])),
    "fold_strings": lambda c: c.dense_from_numpy(D["s"][:20]).fold(
        "", operator.add),
}


@pytest.mark.parametrize("name", sorted(ACTIONS))
def test_actions_fall_to_the_host_as_the_reference(ctxs, name):
    check(ctxs, ACTIONS[name])


def test_reduce_of_an_untraceable_binop_raises_as_the_reference(ctxs):
    """The reference's own reduce(f) over a value column traces f with no
    host fallback, so a binop its trace refuses raises there (jax's own
    error classes: ValueError for this one); the port raises what its
    trace raised (tracing.TraceRefusal, a TypeError), not a host
    answer."""
    from vega_tpu_torch import tracing

    ref, port = ctxs
    f = lambda a, b: max(a, b) if a % 2 else a + b  # noqa: E731
    assert observe(lambda c: c.dense_range(30).reduce(f), ref) == \
        ("raise", "ValueError")
    with pytest.raises(tracing.TraceRefusal):
        port.dense_range(30).reduce(f)


# ---------------------------------------------------------------------------
# Part B 6: sources no block holds
# ---------------------------------------------------------------------------

_OBJ = np.array([1, "a", 2.5, None, (1, 2)] * 4, dtype=object)
_U64 = np.array([0, 1, 2**63, 2**64 - 1] * 5, dtype=np.uint64)

SOURCES = {
    "object_values": lambda c: c.dense_from_numpy(_OBJ, num_partitions=3),
    "object_pairs": lambda c: c.dense_from_numpy(np.arange(20), _OBJ,
                                                 num_partitions=5),
    "object_three": lambda c: c.dense_from_numpy(
        np.arange(20), _OBJ, np.arange(20) * 0.5, num_partitions=2),
    "uint64_values": lambda c: c.dense_from_numpy(_U64, num_partitions=4),
    "uint64_pairs": lambda c: c.dense_from_numpy(
        _U64, np.arange(20), num_partitions=3),
    "columns_named": lambda c: c.dense_from_columns(
        {"a": np.arange(20), "b": _OBJ}),
    "object_then_ops": lambda c: c.dense_from_numpy(
        np.arange(20) % 4, _OBJ, num_partitions=3).group_by_key(),
}


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_sources_no_block_holds_are_parallelized(ctxs, name):
    check(ctxs, SOURCES[name], bag=name == "object_then_ops", glom=True)


@pytest.mark.parametrize("build", [
    lambda c: c.dense_from_numpy(_OBJ),
    lambda c: c.dense_from_columns({"k": np.arange(20), "v": _OBJ},
                                   key="k")])
def test_default_slices_are_the_ports_parallelism(ctxs, build):
    """With no num_partitions the rows are the reference's; the slices
    are each package's default parallelism (the port's is its shard
    count: a recorded difference of the host RDD layer)."""
    ref, port = ctxs
    got, exp = build(port), build(ref)
    assert not isinstance(got, PortDense) and not isinstance(exp, RefDense)
    assert repr(got.collect()) == repr(exp.collect())
    assert got.num_partitions == N_SHARDS


# ---------------------------------------------------------------------------
# Part B 7: streams
# ---------------------------------------------------------------------------

def _stream(c):
    return c.dense_range(1000, chunk_rows=300)


STREAMS = {
    "map_untraceable": lambda c: _stream(c).map(lambda x: (x % 7,
                                                           math.sqrt(x))),
    "filter_untraceable": lambda c: _stream(c).filter(
        lambda x: x % 3 == 0 and x > 500),
    "map_values_untraceable": lambda c: _stream(c).map(
        lambda x: (x % 7, x)).map_values(lambda x: float(x)),
    "map_expand_untraceable": lambda c: _stream(c).map_expand(
        lambda x: np.array([x, -x]), 2),
    "reduce_by_key_untraceable": lambda c: _stream(c).map(
        lambda x: (x % 7, x)).reduce_by_key(_fmod),
    "map_past_int32": lambda c: _stream(c).map(lambda x: x * 2**40),
    "traceable_control": lambda c: _stream(c).map(lambda x: (x % 7, x))
    .reduce_by_key(op="add"),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_stream_closures_take_the_resident_answer(ctxs, name):
    ref, port = ctxs
    exp = observe(STREAMS[name], ref, bag=True)
    got = observe(STREAMS[name], port, bag=True)
    if name == "map_past_int32":
        # the port answers a closure past int32 on the card in the host
        # tier's row form (PR 18's host_rows.py), the reference on its host
        assert got[0] == "dense" and exp[0] == "host"
        assert got[2:] == exp[2:]
        return
    assert got == exp


def test_stream_probe_decides_before_any_chunk(ctxs, monkeypatch):
    """An untraceable closure on a stream builds no chunk: the probe
    decides, and the resident build answers."""
    _ref, port = ctxs
    s = _stream(port)
    built = []
    make = s._make_chunks
    monkeypatch.setattr(s, "_make_chunks",
                        lambda: (built.append(1), make())[1])
    r = s.map(lambda x: (x % 7, math.sqrt(x)))
    assert built == [] and not isinstance(r, PortDense)
    assert len(r.collect()) == 1000


# ---------------------------------------------------------------------------
# Part B 8: what the host-row form still refused
# ---------------------------------------------------------------------------

def _float_key(c):
    return c.dense_range(40).map(lambda x: ((x % 4) * 0.5 - 0.5, x + 2**40))


HOST_ROWS = {
    "float_key_reduce": lambda c: _float_key(c).reduce_by_key(operator.add),
    "float_key_reduce_closure": lambda c: _float_key(c).reduce_by_key(
        lambda a, b: a - b if a > b else b - a),
    "float_key_group": lambda c: _float_key(c).group_by_key(),
    "float_key_join": lambda c: _float_key(c).join(
        c.parallelize([(0.0, "z"), (-0.0, "n"), (1.0, "o")], 2)),
    "float_key_sort": lambda c: _float_key(c).sort_by_key(),
    "float_key_fold": lambda c: _float_key(c).fold_by_key(0, operator.add),
    "key_by_pairs_past_int32": lambda c: c.dense_range(20).map(
        lambda x: (x % 3, x + 2**40)).key_by(lambda kv: kv[0]),
    "downstream_map_untraceable": lambda c: c.dense_range(20).map(
        lambda x: x + 2**40).map(lambda x: math.log(x)),
}


@pytest.mark.parametrize("name", sorted(HOST_ROWS))
def test_host_row_refusals_fall_to_the_host(ctxs, name):
    ref, port = ctxs
    got = observe(HOST_ROWS[name], port, bag=True)
    exp = observe(HOST_ROWS[name], ref, bag=True)
    # the port's host-row parent prints the reference's host node name,
    # and a host op over it is a host node on both sides
    assert got == exp


# ---------------------------------------------------------------------------
# F22: a host shuffle read twice
# ---------------------------------------------------------------------------

F22_CASES = {
    "group_by_key": lambda c: c.parallelize(
        [(i % 3, i) for i in range(12)], 4).group_by_key(),
    "combine_in_place": lambda c: c.parallelize(
        [(i % 3, i) for i in range(12)], 4).combine_by_key(
        lambda x: [x], lambda a, x: (a.append(x), a)[1],
        lambda a, b: (a.extend(b), a)[1]),
    "dense_object_group": lambda c: c.dense_from_numpy(
        np.arange(20) % 4, _OBJ, num_partitions=3).group_by_key(),
}


@pytest.mark.parametrize("name", sorted(F22_CASES))
def test_f22_a_host_shuffle_read_twice_is_unchanged(ctxs, name):
    """Every read of a host shuffle merges copies of its map outputs: a
    second collect (or a glom after a collect) gives the first's rows, as
    the reference's (which reads unpickled copies). On 394704a the port's
    merge extended the stored lists in place, so the second read doubled
    each group after its first map partition."""
    ref, port = ctxs
    for c in (ref, port):
        r = F22_CASES[name](c)
        first = sorted(r.collect(), key=repr)
        assert sorted(r.collect(), key=repr) == first
    check(ctxs, F22_CASES[name], bag=True, glom=True)


# ---------------------------------------------------------------------------
# F23: a named block's compute rows in the order of the column names
# ---------------------------------------------------------------------------

F23_CASES = {
    "key_renamed_last": lambda c: c.dense_from_columns(
        {"x": D["k"], "w": D["v"]}, key="x").glom(),
    "wide_key_renamed": lambda c: c.dense_from_columns(
        {"x": D["w"], "a": D["v"]}, key="x").to_rdd(),
    "three_unsorted": lambda c: c.dense_from_columns(
        {"z": D["k"], "a": D["x"], "m": D["s"]}).glom(),
    "untraceable_map": lambda c: c.dense_from_columns(
        {"z": D["k"], "a": D["v"]}).map(lambda r: math.copysign(1, r[0])),
}


@pytest.mark.parametrize("name", sorted(F23_CASES))
def test_f23_named_rows_in_column_name_order(ctxs, name):
    """The reference reads a shard's columns through jax.device_get, whose
    dict comes back ordered by key, so a named block's compute rows (and
    every host op over them) hold its columns in name order; on 394704a
    the port's were in schema order, so dense_from_columns({"x": k, "w":
    v}, key="x").glom() gave (w, k) tuples where the reference gives
    (k, w)."""
    check(ctxs, F23_CASES[name])


def test_histogram_of_a_host_row_wide_value(ctxs):
    """A wide value computed in the host tier's row form: the reference's
    host histogram over its Python ints (a MapperRDD there), the port's
    host RDD layer's over the node's rows."""
    ref, port = ctxs
    build = (lambda c: c.dense_range(50).map(lambda x: x * 2**40 - 7)
             .histogram(4))
    assert build(port) == build(ref)


APPROX = {
    "mean_approx_pairs": lambda c: _kv(c).mean_approx(60.0),
    "mean_approx_strings": lambda c: c.dense_from_numpy(D["s"])
    .mean_approx(60.0),
    "count_approx_distinct_grouped": lambda c: _kv(c).group_by_key()
    .count_approx_distinct(),
}


@pytest.mark.parametrize("name", sorted(APPROX))
def test_approximate_actions_over_host_rows(ctxs, name):
    """mean_approx over pairs or strings, and count_approx_distinct over
    rows holding lists, are the host tier's in the reference (its DenseRDD
    inherits them): the port's host RDD layer gives the same outcome (a
    PartialResult as norm() reads it, or the exception's class)."""
    ref, port = ctxs

    def outcome(c):
        try:
            return ("ok", repr(norm(APPROX[name](c))))
        except Exception as e:  # noqa: BLE001 — the class is the outcome
            return ("raise", _cause(e))
    assert outcome(port) == outcome(ref)
