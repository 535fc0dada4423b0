"""Closures the reference runs on its host tier, in vega_tpu_torch's host-row
form, against vega_tpu on the CPU.

The reference traces a closure with jax, 64-bit types off: a Python int
past int32 fails the trace (its literal rule), and so does a closure over a
wide int64 column; it then hands the node and everything downstream of it
to its host tier, which calls the closure on each row's Python values
(exact ints, floats as float64). The port traces such a closure again in
that row form (host_rows.py: an integer as a WideInt of exact int64, a
float as float64) and runs it on the device; its outputs are stored as
int32, the wide (name, name.lo) pair, float64 or bool columns.

Each lineage runs through a vega_tpu Context("local") on the 8-device CPU
mesh and through vega_tpu_torch's Context(device="cpu", n_shards=8), both
under the card's plans, on inputs at and around -2^31 and 2^31 - 1.
Integers are compared exactly, floats at rtol 1e-12 (both compute in
float64; a sum's order differs), rows order-free by key wherever the
reference's host shuffle places them (by its splitmix64 hash, where the
device tier places by hash32), in order otherwise. A row that leaves int64 raises VegaError
where the reference keeps a Python int (a recorded difference).
"""

import operator

import numpy as np
import pytest

import vega_tpu as v
import vega_tpu_torch as vt
from vega_tpu_torch import dense_rdd
from vega_tpu_torch import host_rows
from vega_tpu_torch.errors import TaskError, VegaError

N_SHARDS = 8
ACCEL_PLANS = {"dense_rbk_plan": "fused_sort", "dense_table_plan": "off",
               "dense_sort_impl": "xla"}
I32_MIN, I32_MAX = -2**31, 2**31 - 1


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


def _edges(seed=3, n=600):
    """int32 values with both ends of the range among them."""
    rng = np.random.default_rng(seed)
    x = rng.integers(I32_MIN, I32_MAX, n, dtype=np.int64)
    x[:6] = [I32_MIN, I32_MAX, I32_MIN + 1, I32_MAX - 1, 0, -1]
    return x.astype(np.int32)


X = _edges()
K = (np.arange(len(X)) % 13).astype(np.int32)
F = np.random.default_rng(4).standard_normal(len(X)).astype(np.float32)
W = X.astype(np.int64) * 3 + 2**40


def _close(got, exp):
    """Rows equal: ints exactly, floats at rtol 1e-12."""
    assert len(got) == len(exp)
    for a, b in zip(got, exp):
        if isinstance(a, tuple):
            _close(list(a), list(b))
        elif isinstance(a, float) or isinstance(b, float):
            assert a == pytest.approx(b, rel=1e-12, abs=1e-300), (a, b)
        else:
            assert a == b and type(a) is type(b), (a, b)


# name -> (build(ctx), order-free): every case runs the reference's host
# tier (its trace refuses the closure) and the port's host-row form
CASES = {
    # queue 3's open item (F18) at the int32 edges
    "filter_past_int32": (lambda c: c.dense_from_numpy(X).filter(
        lambda x: x < 2**40), False),
    "filter_edge": (lambda c: c.dense_from_numpy(X).filter(
        lambda x: x * 2 > 2**32 - 4), False),
    "map_pair_wide_value": (lambda c: c.dense_from_numpy(X).map(
        lambda x: (x, x + 2**40)), False),
    "map_constant_sum": (lambda c: c.dense_from_numpy(X).map(
        lambda x: x - 2**31 - 1), False),
    "map_bool_times_big": (lambda c: c.dense_from_numpy(X).map(
        lambda x: (x > 5) * 3_000_000_000), False),
    "map_constant_output": (lambda c: c.dense_from_numpy(X).map(
        lambda x: (x, 2**40)), False),
    "map_values_times_2_31": (lambda c: c.dense_from_numpy(K, X)
                              .map_values(lambda v: v * 2**31), False),
    "map_values_float_2_40": (lambda c: c.dense_from_numpy(K, F)
                              .map_values(lambda v: v * 2**40), False),
    "map_true_division": (lambda c: c.dense_from_numpy(X).map(
        lambda x: (x + 2**40) / 3), False),
    "map_mod_key": (lambda c: c.dense_from_numpy(X).map(
        lambda x: (x % 1000, x * 2**32)), False),
    "key_by": (lambda c: c.dense_from_numpy(X).key_by(
        lambda x: x + 2**35), False),
    "reduce_by_key_binop": (lambda c: c.dense_from_numpy(K, X)
                            .reduce_by_key(lambda a, b: a + b + 2**40),
                            True),
    "reduce_by_key_wide_sum": (lambda c: c.dense_from_numpy(X).map(
        lambda x: (x % 17, x + 2**40)).reduce_by_key(operator.add), True),
    "reduce_by_key_max": (lambda c: c.dense_from_numpy(X).map(
        lambda x: (x % 17, x * 2**31)).reduce_by_key(max), True),
    "reduce_by_key_product": (lambda c: c.dense_from_numpy(
        K, (X % 100).astype(np.int32)).map_values(
            lambda v: v + 2**31).reduce_by_key(lambda a, b: a * b % 2**31),
        True),
    "fold_by_key_big_zero": (lambda c: c.dense_from_numpy(K, X)
                             .fold_by_key(2**40, operator.add), True),
    "aggregate_by_key_big_zero": (lambda c: c.dense_from_numpy(K, X)
                                  .aggregate_by_key(2**41, operator.add,
                                                    operator.add), True),
    # the per-shard fold: a traced seq, a named seq over a hash-placed
    # host-row node (the merge's exchange elided), a product over wide
    # pairs (the row form)
    "fold_by_key_binop": (lambda c: c.dense_from_numpy(K, X).fold_by_key(
        2**40, lambda a, b: a + b - 1), True),
    "fold_by_key_max_after_reduce": (lambda c: c.dense_from_numpy(X).map(
        lambda x: (x % 17, x * 2**31)).reduce_by_key(max).fold_by_key(
            -2**62, max), True),
    "fold_by_key_min_float": (lambda c: c.dense_from_numpy(K, F)
                              .map_values(lambda v: v * 2**40)
                              .fold_by_key(-1e11, min), True),
    "aggregate_by_key_wide_product": (lambda c: c.dense_from_numpy(
        K, (X % 2 + 1).astype(np.int32)).filter(
            lambda kv: kv[1] < 2**40).aggregate_by_key(
                1, operator.mul, operator.mul), True),
    "combine_by_key": (lambda c: c.dense_from_numpy(K, X).combine_by_key(
        lambda v: v + 2**40, lambda a, b: a + b + 2**40, operator.add),
        True),
    "float_sum_after": (lambda c: c.dense_from_numpy(K, F).map_values(
        lambda v: v * 2**40).reduce_by_key(operator.add), True),
    # downstream of a host-row node the host tier's rules hold: exact int
    # arithmetic, int32 sums that do not wrap
    "int_arith_after": (lambda c: c.dense_from_numpy(X).filter(
        lambda x: x < 2**40).map(lambda x: x * 100_000), False),
    "int32_sum_after": (lambda c: c.dense_from_numpy(K, X).filter(
        lambda kv: kv[1] < 2**40).reduce_by_key(operator.add), True),
    "count_by_key_after": (lambda c: c.dense_from_numpy(K, X).filter(
        lambda kv: kv[1] > 2**40 - 2**41).map(
            lambda kv: (kv[0], 1)).reduce_by_key(operator.add), True),
    "join_after": (lambda c: c.dense_from_numpy(K, X).map_values(
        lambda v: v * 2**31).join(c.dense_from_numpy(
            np.arange(13, dtype=np.int32), np.arange(13, dtype=np.int32))),
        True),
    # a wide int64 column: no device row form in either package
    "wide_map_values": (lambda c: c.dense_from_numpy(K, W).map_values(
        lambda v: v * 3 - 7), False),
    "wide_filter": (lambda c: c.dense_from_numpy(K, W).filter(
        lambda kv: kv[1] % 2 == 0), False),
    "wide_key_map": (lambda c: c.dense_from_numpy(W, X).map(
        lambda kv: (kv[0] // 3, kv[1])), False),
    "wide_binop": (lambda c: c.dense_from_numpy(K, W).reduce_by_key(
        lambda a, b: a + b - 2**40), True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_rows_equal_the_reference(ctxs, name):
    ref, port = ctxs
    build, order_free = CASES[name]
    got_node = build(port)
    assert got_node.host_rows
    got, exp = got_node.collect(), build(ref).collect()
    if order_free:
        got, exp = sorted(got), sorted(exp)
    _close(got, exp)


ACTIONS = {
    "reduce_binop": lambda c: c.dense_from_numpy(X).map(
        lambda x: x + 2**40).reduce(lambda a, b: a + b - 2**40),
    "reduce_after_map": lambda c: c.dense_from_numpy(X).map(
        lambda x: x + 2**40).reduce(operator.add),
    "fold_after_map": lambda c: c.dense_from_numpy(X).map(
        lambda x: x + 2**40).fold(0, operator.add),
    "max_after_map": lambda c: c.dense_from_numpy(X).map(
        lambda x: x * 2**31).reduce(max),
    "count_after_filter": lambda c: c.dense_from_numpy(X).filter(
        lambda x: x > 2**40 - 2**41).count(),
    "take_after_map": lambda c: c.dense_from_numpy(X).map(
        lambda x: x * 2**31).take(5),
    "stats_after_map": lambda c: c.dense_from_numpy(X).map(
        lambda x: x * 2**31).stats()["count"],
    "sum_count_after_map": lambda c: sorted(c.dense_from_numpy(X).map(
        lambda x: x % 3 + 2**40).count_by_value().items()),
}


@pytest.mark.parametrize("name", sorted(ACTIONS))
def test_actions_over_host_rows(ctxs, name):
    ref, port = ctxs
    assert ACTIONS[name](port) == ACTIONS[name](ref)


# name -> build(ctx): a row's integer leaves int64 on the port; the
# reference keeps a Python int
OVERFLOWS = {
    "map": lambda c: c.dense_range(64).map(lambda x: x * 2**58),
    "map_values": lambda c: c.dense_from_numpy(K, X).map_values(
        lambda v: v * 2**40),
    "filter": lambda c: c.dense_range(64).filter(
        lambda x: x * 2**59 > 2**40),
    "reduce_by_key": lambda c: c.dense_from_numpy(K, X).map_values(
        lambda v: v + 2**62).reduce_by_key(lambda a, b: a + b + 2**40),
    "wide_sum": lambda c: c.dense_from_numpy(K, X).map_values(
        lambda v: v + 2**62).reduce_by_key(operator.add),
}


@pytest.mark.parametrize("name", sorted(OVERFLOWS))
def test_past_int64_raises(ctxs, name):
    """A recorded difference: the reference's host tier keeps the exact
    Python int; the port raises VegaError when the overflow flags are
    read, and never returns a wrapped value."""
    ref, port = ctxs
    exp = OVERFLOWS[name](ref).collect()
    assert any(abs(x if isinstance(x, int) else x[1]) > 2**63 - 1
               for x in exp) or name == "filter"
    with pytest.raises(VegaError, match="int64"):
        OVERFLOWS[name](port).collect()


def test_reduce_with_a_literal_past_int32(ctxs):
    """The reference's reduce(f) traces f with no host fallback: a Python
    int past int32 in f raises OverflowError there, and in the port when
    the reduce is called."""
    ref, port = ctxs
    with pytest.raises(OverflowError):
        ref.dense_from_numpy(X).reduce(lambda a, b: a + b + 2**40)
    with pytest.raises(OverflowError):
        port.dense_from_numpy(X).reduce(lambda a, b: a + b + 2**40)


def test_reduce_past_int64_raises(ctxs):
    """A binop's total past int64 raises (a recorded difference); a named
    add's does not: each shard's exact words come back and the host adds
    them as Python ints, the reference's bignum."""
    ref, port = ctxs
    total = (lambda c: c.dense_from_numpy(X).map(lambda x: x + 2**62)
             .reduce(operator.add))
    assert total(port) == total(ref) > 2**63
    build = (lambda c: c.dense_from_numpy(X).map(lambda x: x + 2**62)
             .reduce(lambda a, b: a + b + 1))
    assert build(ref) > 2**63
    with pytest.raises(VegaError, match="int64"):
        build(port)


def test_refused_by_both(ctxs):
    """flat_map_ragged and map_expand with a Python int past int32: the
    reference's host tier calls f on one Python value a row, which takes
    no array expansion, and its job fails; the port hands them to its
    host RDD layer, whose job fails the same way. A streamed source's
    closure takes the resident build's answer on both sides (the port's
    in the host tier's row form), rows equal."""
    ref, port = ctxs
    failing = [
        lambda c: c.dense_range(4).flat_map_ragged(
            lambda x: (x[..., None] + 2**40, 1), 1),
        lambda c: c.dense_range(4).map_expand(
            lambda x: x[..., None] + 2**40, 1),
    ]
    for build in failing:
        for c in (ref, port):
            with pytest.raises(Exception, match="not subscriptable"):
                build(c).collect()
    # map_expand on a host-row node: the reference's host MapperRDD has
    # no such name; the port's host-row node answers it as any DenseRDD
    # (the recorded difference of the DenseRDD-only names), its host
    # flat_map failing as above
    with pytest.raises(AttributeError):
        ref.dense_range(4).map(lambda x: x * 2**40).map_expand(
            lambda x: x[..., None], 1)
    with pytest.raises(TaskError, match="not subscriptable") as info:
        port.dense_range(4).map(lambda x: x * 2**40).map_expand(
            lambda x: x[..., None], 1).collect()
    assert isinstance(info.value.__cause__, TypeError)
    streamed = [
        lambda c: c.dense_range(1000, chunk_rows=300).map(
            lambda x: x * 2**40),
        lambda c: c.dense_range(1000, chunk_rows=300).map(
            lambda x: (x % 3, x)).reduce_by_key(lambda a, b: a + b + 2**40),
    ]
    for build in streamed:
        assert sorted(build(port).collect()) == sorted(build(ref).collect())


def test_host_rows_mark_downstream_only(ctxs):
    """A host-row node marks every node downstream of it, and nothing
    upstream; a closure over a device node that traces stays on the
    device trace (the literal rule's trace runs once)."""
    _ref, port = ctxs
    src = port.dense_from_numpy(K, X)
    dev = src.map_values(lambda v: v * 2)
    host = dev.map_values(lambda v: v * 2**31)
    down = host.reduce_by_key(operator.add).map_values(lambda v: v + 1)
    assert not src.host_rows and not dev.host_rows
    assert type(dev).__name__ == "_MapValuesRDD"
    assert host.host_rows and down.host_rows
    assert isinstance(host, host_rows.HostMapValuesRDD)
    joined = src.join(host)
    assert joined.host_rows


def test_output_forms(ctxs):
    """Stored forms: an int32 input as it came or its remainder modulo an
    int32 constant stays int32 (so its key takes hash_bucket), other
    integers are the wide pair, floats float64, bools bool."""
    _ref, port = ctxs
    node = port.dense_from_numpy(X).map(lambda x: (x % 1000, x + 2**40))
    assert node.columns == ["k", "v", "v.lo"]
    assert dict(node._schema())["k"] == dense_rdd.torch.int32
    f = port.dense_from_numpy(K, F).map_values(lambda v: v * 2**40)
    assert dict(f._schema())["v"] == dense_rdd.torch.float64
    b = port.dense_from_numpy(X).map(lambda x: x > 2**40)
    assert dict(b._schema())["v"] == dense_rdd.torch.bool
    assert b.collect() == [False] * len(X)


def test_float64_key_refuses(ctxs):
    """A float key computed in the host row form has no device exchange
    key here: the host groups -0.0 with 0.0 by Python equality, which
    its bits do not; the keyed op is the host RDD layer's, as the
    reference's host tier runs it, rows equal."""
    ref, port = ctxs

    def build(c):
        return c.dense_from_numpy(X).map(
            lambda x: (x / 2**40 - x / 2**40, 1)).reduce_by_key(
                operator.add)
    node = build(port)
    assert not isinstance(node, dense_rdd.DenseRDD)
    assert sorted(node.collect()) == sorted(build(ref).collect())


def test_device_only_names_on_host_rows(ctxs):
    """A recorded difference: the reference's host RDD has no op= keyword,
    no select and no columns (TypeError, AttributeError); the port's
    host-row node answers them as on any DenseRDD."""
    ref, port = ctxs
    r = ref.dense_from_numpy(K, X).map_values(lambda v: v * 2**31)
    with pytest.raises(TypeError):
        r.reduce_by_key(op="add")
    for name in ("select", "columns"):
        with pytest.raises(AttributeError):
            getattr(r, name)
    r = ref.dense_from_numpy(K, X).map_values(lambda v: v + 2**40)
    p = port.dense_from_numpy(K, X).map_values(lambda v: v + 2**40)
    assert sorted(p.reduce_by_key(op="add").collect()) == sorted(
        r.reduce_by_key(operator.add).collect())
    assert p.columns == ["k", "v", "v.lo"]
    assert p.select("v").count() == len(X)
