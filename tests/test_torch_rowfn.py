"""Row functions, binops and NaN keys of vega_tpu_torch against vega_tpu,
on the CPU.

The port traces row functions and binops once on empty probe columns
(dtypes, no values), as the reference traces on abstract values: constants
broadcast to columns of the reference's weak types, bool columns are
carried, 64-bit outputs narrow to 32 bits, and control flow on a value
raises VegaError when the op is built. NaN keys survive every exchange,
each a key of its own. Each lineage runs through a vega_tpu
Context("local") on the 8-device CPU mesh and through vega_tpu_torch's
Context(device="cpu", n_shards=8), both under the card's plans (xla sorts,
fused_sort, no table plan), unless a test names others. Integer results are
bit-identical with equal per-shard counts and row order; the differences
of the reference that the port does not share are pinned here (ROADMAP
queue 3).
"""

import numpy as np
import pytest
import torch

import vega_tpu as v
import vega_tpu_torch as vt
from vega_tpu_torch.errors import VegaError

N_SHARDS = 8
ACCEL_PLANS = {"dense_rbk_plan": "fused_sort", "dense_table_plan": "off",
               "dense_sort_impl": "xla"}
CPU_PLANS = {"dense_rbk_plan": "auto", "dense_table_plan": "auto",
             "dense_sort_impl": "auto"}
A = np.arange(1, 40, dtype=np.int32)  # the queue-3 probes' input


def _contexts(plans):
    """(reference, port) under one set of plans; the caller stops both."""
    from vega_tpu.env import Env

    ref = v.Context("local", num_workers=2)
    conf = Env.get().conf
    old = {k: getattr(conf, k) for k in plans}
    for k, val in plans.items():
        setattr(conf, k, val)
    ref._restore_plans = old
    return ref, vt.Context(device="cpu", n_shards=N_SHARDS, **plans)


def _stop(ref, port):
    from vega_tpu.env import Env

    port.stop()
    for k, val in ref._restore_plans.items():
        setattr(Env.get().conf, k, val)
    ref.stop()


@pytest.fixture()
def ctxs():
    ref, port = _contexts(ACCEL_PLANS)
    try:
        yield ref, port
    finally:
        _stop(ref, port)


def _same(got, exp):
    """The same rows in the same order and the same placement."""
    np.testing.assert_array_equal(got.block().counts_np,
                                  exp.block().counts_np)
    assert got.collect() == exp.collect()


# ---------------------------------------------------------------------------
# F1: constant outputs; F2: value-free probes; F4: output dtypes
# ---------------------------------------------------------------------------

ROW_FORMS = {
    # F1: a Python scalar output broadcasts to a column
    "word count (x % 3, 1)": lambda d: d.map(lambda x: (x % 3, 1))
    .reduce_by_key(op="add"),
    "constant 7": lambda d: d.map(lambda x: 7),
    "float constant value": lambda d: d.map(lambda x: (x, 0.5)),
    "key_by constant": lambda d: d.key_by(lambda x: 0),
    "map_values constant": lambda d: d.map(lambda x: (x % 3, x))
    .map_values(lambda v: 1),
    "filter True": lambda d: d.filter(lambda x: True),
    "bool constant": lambda d: d.map(lambda x: (x, False)),
    # F2: no probe computes on a value (100 // 0 never runs)
    "100 // x": lambda d: d.map(lambda x: (x % 3, 100 // x)),
    "filter 100 // x": lambda d: d.filter(lambda x: 100 // x > 5),
    "map_values 100 // v": lambda d: d.map(lambda x: (x % 3, x))
    .map_values(lambda v: 100 // v),
    # F4: bool columns, and bool * int narrowed to int32
    "bool value": lambda d: d.map(lambda x: (x % 3, x > 5)),
    "bool times int": lambda d: d.map(lambda x: (x, (x % 3 == 0) * 1)),
    "bool value through group_by_key": lambda d: d.map(
        lambda x: (x % 3, x > 5)).group_by_key(),
    "bool value through sort_by_key": lambda d: d.map(
        lambda x: (x % 5, x % 2 == 0)).sort_by_key(),
}


@pytest.mark.parametrize("form", list(ROW_FORMS))
def test_row_forms_match_reference(ctxs, form):
    """Each queue-3 F1 / F2 / F4 input runs in the port and equals the
    reference: rows, order and per-shard counts."""
    ref, port = ctxs
    build = ROW_FORMS[form]
    exp, got = build(ref.dense_from_numpy(A)), build(port.dense_from_numpy(A))
    assert [dt for _, dt in got._schema()] == [
        torch.bool if np.dtype(dt) == np.bool_ else
        getattr(torch, np.dtype(dt).name) for _, dt in exp._schema()]
    if form.endswith("group_by_key"):
        assert got.collect() == exp.collect()
        return
    _same(got, exp)


@pytest.mark.parametrize("op", ["reduce_by_key", "group_by_key",
                                "sort_by_key", "join", "distinct"])
def test_bool_key_is_refused_as_the_reference_refuses_it(ctxs, op):
    """The reference's key sorts refuse a bool key (a ValueError from the
    sentinel of its dtype) in every keyed exchange; the port raises
    VegaError when the op is built. take_ordered runs in both."""
    ref, port = ctxs
    runs = {
        "reduce_by_key": lambda d, ctx: d.reduce_by_key(op="add").collect(),
        "group_by_key": lambda d, ctx: d.group_by_key().collect(),
        "sort_by_key": lambda d, ctx: d.sort_by_key().collect(),
        "join": lambda d, ctx: d.join(d).collect(),
        "distinct": lambda d, ctx: ctx.dense_from_numpy(A > 5).distinct()
        .collect(),
    }

    def pairs(ctx):
        return ctx.dense_from_numpy(A).map(lambda x: (x > 5, x))

    with pytest.raises(ValueError):
        runs[op](pairs(ref), ref)
    with pytest.raises(VegaError, match="bool key"):
        runs[op](pairs(port), port)
    assert pairs(port).take_ordered(3) == pairs(ref).take_ordered(3)


def test_bool_values_through_a_join(ctxs):
    """A bool column rides a join on either side."""
    ref, port = ctxs

    def run(ctx):
        d = ctx.dense_from_numpy(A).map(lambda x: (x % 7, x % 2 == 0))
        t = ctx.dense_from_numpy(np.arange(7, dtype=np.int32),
                                 np.arange(7, dtype=np.int32) > 3)
        return d.join(t)

    exp, got = run(ref), run(port)
    assert sorted(got.collect()) == sorted(exp.collect())


def test_constant_dtypes_and_narrowing(ctxs):
    """Python constants take the reference's weak types; int64 / float64
    outputs narrow to int32 / float32."""
    _ref, port = ctxs
    d = port.dense_from_numpy(A)
    assert d.map(lambda x: (1, 2.0))._schema() == (
        ("k", torch.int32), ("v", torch.float32))
    assert d.map(lambda x: True)._schema() == (("v", torch.bool),)
    wide = d.map(lambda x: (x.to(torch.int64) * 3, x.to(torch.float64)))
    assert wide._schema() == (("k", torch.int32), ("v", torch.float32))
    assert wide.collect() == [(int(x) * 3, float(x)) for x in A]


def test_probe_builds_the_main_path_unchanged(ctxs):
    """The main path's map traces to the same schema and rows."""
    ref, port = ctxs

    def run(ctx):
        return ctx.dense_range(5_000).map(lambda x: (x % 97, x * 0.5))

    got, exp = run(port), run(ref)
    assert got._schema() == (("k", torch.int32), ("v", torch.float32))
    _same(got, exp)
    assert sorted(got.reduce_by_key(op="add").collect()) == sorted(
        exp.reduce_by_key(op="add").collect())


def test_padded_rows_never_reach_the_function(ctxs):
    """Padded rows hold zeros; 100 // x must not see them on the CPU, in
    a ragged block and in empty shards."""
    ref, port = ctxs
    three = np.array([4, 5, 50], dtype=np.int32)  # five empty shards
    _same(port.dense_from_numpy(three).map(lambda x: 100 // x),
          ref.dense_from_numpy(three).map(lambda x: 100 // x))
    empty = port.dense_from_numpy(np.zeros(0, np.int32))
    assert empty.map(lambda x: 100 // x).collect() == []
    assert empty.filter(lambda x: 100 // x > 1).collect() == []


def test_padded_rows_never_reach_a_binop(ctxs):
    """A traced binop that divides by a value runs over every valid row
    (1..39) and never over the zeros of the padded rows, in
    reduce_by_key's scans and in reduce(f)."""
    ref, port = ctxs

    def binop(a, b):
        return a + b + 0 * (100 // a)

    _same(port.dense_from_numpy(A % 3, A).reduce_by_key(binop),
          ref.dense_from_numpy(A % 3, A).reduce_by_key(binop))
    assert port.dense_from_numpy(A).reduce(binop) == \
        ref.dense_from_numpy(A).reduce(binop) == int(A.sum())
    empty = port.dense_from_numpy(np.zeros(0, np.int32),
                                  np.zeros(0, np.int32))
    assert empty.reduce_by_key(binop).collect() == []


def test_division_by_zero_on_a_valid_row(ctxs):
    """Recorded difference: XLA defines integer division by zero, so the
    reference returns a value; torch raises on the CPU (and leaves the
    value undefined on CUDA). The port does not hide it."""
    ref, port = ctxs
    zero = np.array([0, 1, 2], dtype=np.int32)
    exp = ref.dense_from_numpy(zero).map(lambda x: 100 // x).collect()
    assert exp[1:] == [100, 50]
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        port.dense_from_numpy(zero).map(lambda x: 100 // x).collect()


def test_int64_intermediate_past_int32(ctxs):
    """Recorded difference: a Python constant beyond int32 sends the
    reference's trace to its host tier (exact Python ints), while torch
    promotes to int64 and the port narrows the result to int32."""
    ref, port = ctxs
    big = 3_000_000_000
    exp = ref.dense_from_numpy(A).map(lambda x: (x > 5) * big).collect()
    assert exp[-1] == big
    got = port.dense_from_numpy(A).map(lambda x: (x > 5) * big).collect()
    assert got[-1] == big - 2**32


# ---------------------------------------------------------------------------
# F3: control flow on a value
# ---------------------------------------------------------------------------


def test_control_flow_binop_raises_when_built(ctxs):
    """The reference hands a branching binop to its host tier; the port
    raises VegaError when the op is built, never at materialization."""
    ref, port = ctxs

    def pick(x, y):
        return x if x > y else y

    exp = ref.dense_from_numpy(A % 3, A).reduce_by_key(pick).collect()
    assert sorted(exp) == [(0, 39), (1, 37), (2, 38)]
    with pytest.raises(VegaError, match="host tier"):
        port.dense_from_numpy(A % 3, A).reduce_by_key(pick)


def test_reduce_max_error_type(ctxs):
    """Recorded difference: reduce(lambda x, y: max(x, y)) raises
    ValueError in the reference and VegaError in the port."""
    ref, port = ctxs
    with pytest.raises(ValueError):
        ref.dense_from_numpy(A).reduce(lambda x, y: max(x, y))
    with pytest.raises(VegaError, match="host tier"):
        port.dense_from_numpy(A).reduce(lambda x, y: max(x, y))


def test_branching_row_function_raises_at_one_shard():
    """With one shard the old (1, 1) probe let an `if` pass; a probe with
    no values raises at every shape."""
    with vt.Context(device="cpu", n_shards=1) as port:
        d = port.dense_from_numpy(A)
        with pytest.raises(VegaError, match="host tier"):
            d.map(lambda x: x if x > 5 else 0)
        with pytest.raises(VegaError, match="host tier"):
            d.filter(lambda x: bool(x > 5))


# ---------------------------------------------------------------------------
# F5: NaN keys through every exchange
# ---------------------------------------------------------------------------

NAN_KEYS = np.array([np.nan, 1, np.nan, 2, 1, np.nan, 3, np.nan], np.float32)
NAN_VALS = np.arange(1, 9, dtype=np.int32)
NAN_OPS = {
    "reduce_by_key": lambda d, ctx: d.reduce_by_key(op="add").collect(),
    "group_by_key": lambda d, ctx: [(k, sorted(vs)) for k, vs in
                                    d.group_by_key().collect()],
    "count_by_key_dense": lambda d, ctx: d.count_by_key_dense().collect(),
    "sort_by_key": lambda d, ctx: d.sort_by_key().collect(),
    "distinct": lambda d, ctx: ctx.dense_from_numpy(NAN_KEYS).distinct()
    .collect(),
    "join": lambda d, ctx: d.join(ctx.dense_from_numpy(
        np.float32([1, np.nan]), np.int32([10, 20]))).collect(),
    "left_outer_join": lambda d, ctx: d.left_outer_join(ctx.dense_from_numpy(
        np.float32([1, np.nan]), np.int32([10, 20])), fill_value=-1)
    .collect(),
}


def _nan_expected(op):
    """numpy / Python semantics: each NaN is a key of its own, equal to no
    other key, and sorts last."""
    rows = list(zip(NAN_KEYS.tolist(), NAN_VALS.tolist()))
    finite = [(k, x) for k, x in rows if not np.isnan(k)]
    nans = [(k, x) for k, x in rows if np.isnan(k)]
    sums = {}
    for k, x in finite:
        sums[k] = sums.get(k, 0) + x
    if op == "reduce_by_key":
        return sorted(sums.items()) + nans
    if op == "group_by_key":
        groups = {}
        for k, x in finite:
            groups.setdefault(k, []).append(x)
        return sorted(groups.items()) + [(k, [x]) for k, x in nans]
    if op == "count_by_key_dense":
        counts = {}
        for k, _x in finite:
            counts[k] = counts.get(k, 0) + 1
        return sorted(counts.items()) + [(k, 1) for k, _x in nans]
    if op == "sort_by_key":
        return sorted(finite) + nans
    if op == "distinct":
        return sorted(set(k for k, _x in finite)) + [k for k, _x in nans]
    if op == "join":
        return [(k, (x, 10)) for k, x in finite if k == 1.0]
    return ([(k, (x, 10 if k == 1.0 else -1)) for k, x in finite]
            + [(k, (x, -1)) for k, x in nans])


def _canonical(rows):
    """Rows in one order, NaN keys last, so numpy can compare them."""
    def key(r):
        k = r[0] if isinstance(r, tuple) else r
        return (np.isnan(k), 0.0 if np.isnan(k) else k, repr(r))
    return sorted(rows, key=key)


@pytest.mark.parametrize("plans", ["card", "cpu"])
@pytest.mark.parametrize("op", list(NAN_OPS))
def test_nan_keys_survive_every_exchange(op, plans):
    """Queue 3 F5: every NaN row survives as a key of its own and no
    (0.0, 0) padding row appears, on the card's plans and the CPU
    defaults. The reference loses the NaN rows through its exchange on
    the card's plans (it turns them into padding rows); that stays as it
    is, pinned here."""
    ref, port = _contexts(ACCEL_PLANS if plans == "card" else CPU_PLANS)
    try:
        run = NAN_OPS[op]
        got = run(port.dense_from_numpy(NAN_KEYS, NAN_VALS), port)
        exp = _nan_expected(op)
        assert repr(_canonical(got)) == repr(_canonical(exp))
        if op == "sort_by_key":
            assert repr(got) == repr(exp)  # NaN last, in key order
        if plans == "card" and op in ("reduce_by_key", "group_by_key",
                                      "sort_by_key", "count_by_key_dense"):
            lost = run(ref.dense_from_numpy(NAN_KEYS, NAN_VALS), ref)
            assert not any(np.isnan(r[0]) for r in lost)
            assert any(r[0] == 0.0 for r in lost)
    finally:
        _stop(ref, port)


def test_nan_keys_at_one_shard_match_the_exchange():
    """With one shard there is no exchange; the rows are the same."""
    with vt.Context(device="cpu", n_shards=1, **ACCEL_PLANS) as port:
        got = port.dense_from_numpy(NAN_KEYS, NAN_VALS) \
            .reduce_by_key(op="add").collect()
    assert repr(_canonical(got)) == repr(_canonical(
        _nan_expected("reduce_by_key")))


# ---------------------------------------------------------------------------
# the reference's warm table plan on float keys
# ---------------------------------------------------------------------------


def test_warm_table_plan_on_float_keys():
    """Recorded difference: on the CPU defaults the reference's warm rerun
    takes its table plan on float32 keys (it gates on the value dtype) and
    raises TypeError; its cold run is right. The port takes the table only
    for an int32 key, so both of its runs equal numpy and the reference's
    cold run."""
    keys = np.tile(np.float32([0.0, 1.5, -2.0]), 1000)
    vals = np.arange(3000, dtype=np.int32)
    exp = {float(k): int(vals[keys == k].sum()) for k in (0.0, 1.5, -2.0)}
    ref, port = _contexts(CPU_PLANS)
    try:
        def run(ctx):
            return dict(ctx.dense_from_numpy(keys, vals)
                        .reduce_by_key(op="add").collect())

        assert run(ref) == exp
        with pytest.raises(TypeError):
            run(ref)
        assert run(port) == exp
        node = port.dense_from_numpy(keys, vals).reduce_by_key(op="add")
        assert dict(node.collect()) == exp
        assert not node._table_plan
    finally:
        _stop(ref, port)
