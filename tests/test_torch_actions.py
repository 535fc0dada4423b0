"""Traced reduces and value actions of vega_tpu_torch against vega_tpu, on
the CPU.

kernels.segment_reduce_sorted (the log-step segmented scan) against the
reference's associative scan; reduce_by_key / combine_by_key with a
traced binop, _infer_named_op taking the same path in both packages,
reduce(f); sum / min / max / mean / stats / histogram / count_by_value;
and each request the reference hands to its host tier, which the port
hands to its host RDD layer (the same outcome). Each runs through a vega_tpu Context("local") on the
8-device CPU mesh and through vega_tpu_torch's Context(device="cpu",
n_shards=8), both under the card's plans, on inputs from a numpy seed.
Integer results are bit-identical, with equal per-shard counts and row
order for reduce outputs; float results within rtol 1e-5 (float32 sums
in another order). Binops use operators only, or each package its own
function (jnp.maximum / torch.maximum).
"""

import functools
import operator

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vega_tpu as v
from vega_tpu.errors import VegaError as RefVegaError
from vega_tpu.rdd.pair import _infer_named_op as ref_infer
from vega_tpu.tpu import kernels as ref_kernels
import vega_tpu_torch as vt
from vega_tpu_torch import dense_rdd as port_dense
from vega_tpu_torch import kernels as port_kernels
from vega_tpu_torch.errors import TaskError, VegaError

N_SHARDS = 8
ACCEL_PLANS = {"dense_rbk_plan": "fused_sort", "dense_table_plan": "off",
               "dense_sort_impl": "xla"}


@pytest.fixture()
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


def _ref_scan(cols, count, combine, presorted=True, lo_name=None):
    """The reference's segment_reduce_sorted under jit (one compile,
    instead of the scan's many eager dispatches)."""
    fn = jax.jit(functools.partial(
        ref_kernels.segment_reduce_sorted, key_name="k", combine=combine,
        presorted=presorted, lo_name=lo_name))
    return fn({n: jnp.asarray(c) for n, c in cols.items()}, jnp.int32(count))


def _same(got, exp):
    """The same rows in the same order and the same placement."""
    np.testing.assert_array_equal(got.block().counts_np,
                                  exp.block().counts_np)
    assert got.collect() == exp.collect()


RNG = np.random.RandomState(11)
KEYS = RNG.randint(0, 700, size=9_000).astype(np.int32)
INTS = RNG.randint(-2**20, 2**20, size=9_000).astype(np.int32)
FLOATS = (RNG.rand(9_000) * 100).astype(np.float32)


# ---------------------------------------------------------------------------
# the segmented scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cap,count", [(1, 1), (7, 5), (128, 128),
                                       (1000, 999), (4096, 0)])
@pytest.mark.parametrize("wide", [False, True])
def test_segment_reduce_sorted_matches_reference(cap, count, wide):
    """One shard's sorted runs (with a two-column key's low word when
    wide), two value columns under a tuple-like combine (xor, max): the
    compacted segment ends equal the reference's bit for bit."""
    rng = np.random.RandomState(cap + count)
    keys = np.sort(rng.randint(0, 9, size=cap)).astype(np.int32)
    lo = rng.randint(0, 2, size=cap).astype(np.int32)
    order = np.lexsort([lo, keys])
    keys, lo = keys[order], lo[order]
    a = rng.randint(-1000, 1000, size=cap).astype(np.int32)
    b = (rng.rand(cap) * 10).astype(np.float32)
    cols = {"k": keys, "a": a, "b": b}
    if wide:
        cols["k.lo"] = lo
    lo_name = "k.lo" if wide else None

    def combine_for(maximum):
        return lambda x, y: {"a": x["a"] ^ y["a"],
                             "b": maximum(x["b"], y["b"])}

    exp, ecount = _ref_scan(cols, count, combine_for(jnp.maximum),
                            lo_name=lo_name)
    got, gcount = port_kernels.segment_reduce_sorted(
        {n: torch.from_numpy(c)[None] for n, c in cols.items()},
        torch.tensor([count], dtype=torch.int32), "k",
        combine_for(torch.maximum), presorted=True, lo_name=lo_name)
    n = int(ecount)
    assert int(gcount[0]) == n
    assert set(got) == set(exp)
    for name in exp:
        np.testing.assert_array_equal(got[name][0, :n].numpy(),
                                      np.asarray(exp[name])[:n])


def test_segment_reduce_sorted_sorts_unsorted_rows():
    """presorted=False sorts by key first (the reduce side's merge)."""
    rng = np.random.RandomState(2)
    keys = rng.randint(0, 50, size=(3, 300)).astype(np.int32)
    vals = rng.randint(0, 1 << 30, size=(3, 300)).astype(np.int32)
    count = torch.tensor([300, 17, 0], dtype=torch.int32)
    got, gcount = port_kernels.segment_reduce_sorted(
        {"k": torch.from_numpy(keys), "v": torch.from_numpy(vals)}, count,
        "k", lambda x, y: {"v": x["v"] ^ y["v"]})
    for s in range(3):
        exp, ecount = _ref_scan({"k": keys[s], "v": vals[s]}, int(count[s]),
                                lambda x, y: {"v": x["v"] ^ y["v"]},
                                presorted=False)
        n = int(ecount)
        assert int(gcount[s]) == n
        for name in ("k", "v"):
            np.testing.assert_array_equal(got[name][s, :n].numpy(),
                                          np.asarray(exp[name])[:n])


# ---------------------------------------------------------------------------
# traced reduce_by_key / combine_by_key / reduce
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["xor", "own max", "float add", "tuple"])
def test_traced_reduce_by_key(ctxs, case):
    """Binops no named op matches run the segmented scan in both
    packages (the node's op stays None), cold and warm (deferred), and
    over a reduce output (elided exchange, presorted merge)."""
    ref, port = ctxs
    if case == "xor":
        fns = (lambda a, b: a ^ b,) * 2
    elif case == "own max":
        fns = (jnp.maximum, torch.maximum)
    elif case == "float add":
        fns = (lambda a, b: a + b * 1.0,) * 2
    else:
        fns = (lambda a, b: (a[0] ^ b[0], a[1] + b[1] * 1.0),) * 2

    def run(ctx, f):
        if case == "tuple":
            src = ctx.dense_from_columns({"i": INTS, "f": FLOATS, "g": KEYS},
                                         key="g")
        elif case == "xor":
            src = ctx.dense_from_numpy(KEYS, INTS)
        else:
            src = ctx.dense_from_numpy(KEYS, FLOATS)
        red = src.reduce_by_key(f)
        return red, red.reduce_by_key(f)

    (exp, exp2), got_pairs = run(ref, fns[0]), [run(port, fns[1])
                                                for _ in range(2)]
    assert exp._op is None
    for got, got2 in got_pairs:
        assert got._op is None and got2._op is None
        for g, e in ((got, exp), (got2, exp2)):
            np.testing.assert_array_equal(g.block().counts_np,
                                          e.block().counts_np)
            ga, ea = g.collect_arrays(), e.collect_arrays()
            assert list(ga) == list(ea)
            for name in ea:
                if ea[name].dtype == np.float32:
                    np.testing.assert_allclose(ga[name], ea[name], rtol=1e-5)
                else:
                    np.testing.assert_array_equal(ga[name], ea[name])
    assert got_pairs[1][0]._last_counts_host is None  # warm: deferred
    assert got_pairs[0][1]._last_counts_host is None  # elided passthrough


FUNCS = {
    "operator.add": operator.add, "operator.mul": operator.mul,
    "min": min, "max": max, "lambda a + b": lambda a, b: a + b,
    "lambda x * y": lambda x, y: x * y, "a + b + 0": lambda a, b: a + b + 0,
    "a - b": lambda a, b: a - b, "xor": lambda a, b: a ^ b,
}


@pytest.mark.parametrize("name", list(FUNCS))
def test_infer_named_op_takes_the_same_path(ctxs, name):
    """The port's copy of _infer_named_op names the same ops as the
    reference's, and reduce_by_key takes the same path (named or traced)
    with the same rows."""
    ref, port = ctxs
    f = FUNCS[name]
    assert port_dense._infer_named_op(f) == ref_infer(f)
    if name in ("min", "max", "a - b"):
        return  # builtin min/max and a - b do not trace on tensors
    exp = ref.dense_from_numpy(KEYS % 50, INTS % 7).reduce_by_key(f)
    got = port.dense_from_numpy(KEYS % 50, INTS % 7).reduce_by_key(f)
    assert got._op == exp._op == ref_infer(f)
    _same(got, exp)


def test_builtin_min_max_take_the_named_ops(ctxs):
    ref, port = ctxs
    for f in (min, max):
        exp = ref.dense_from_numpy(KEYS, INTS).reduce_by_key(f)
        got = port.dense_from_numpy(KEYS, INTS).reduce_by_key(f)
        assert got._op == exp._op == f.__name__
        _same(got, exp)


def test_combine_by_key(ctxs):
    ref, port = ctxs

    def run(ctx, merge):
        return ctx.dense_from_numpy(KEYS, INTS).combine_by_key(
            lambda x: x * 3, lambda c, x: c ^ (x * 3), merge)

    for merge in (lambda a, b: a ^ b, lambda a, b: a + b):
        exp, got = run(ref, merge), run(port, merge)
        assert got._op == exp._op
        _same(got, exp)


def test_reduce(ctxs):
    """A per-shard fold, then the partials folded on the host: exact for
    ints, the reference's values for a max of floats (each package its own
    function); an empty RDD raises in both."""
    ref, port = ctxs
    assert port.dense_range(30_001).reduce(lambda a, b: a ^ b) == \
        ref.dense_range(30_001).reduce(lambda a, b: a ^ b)
    assert port.dense_from_numpy(FLOATS).reduce(torch.maximum) == \
        ref.dense_from_numpy(FLOATS).reduce(jnp.maximum) == FLOATS.max()
    assert port.dense_from_numpy(INTS[:5]).reduce(lambda a, b: a - b) == \
        ref.dense_from_numpy(INTS[:5]).reduce(lambda a, b: a - b)
    with pytest.raises(RefVegaError):
        ref.dense_range(100).filter(lambda x: x < 0).reduce(
            lambda a, b: a + b)
    with pytest.raises(VegaError, match="empty"):
        port.dense_range(100).filter(lambda x: x < 0).reduce(
            lambda a, b: a + b)


# ---------------------------------------------------------------------------
# value actions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source", ["ints", "floats", "half steps",
                                    "empty ints"])
def test_value_actions(ctxs, source):
    """sum / min / max / mean / stats / count_by_value against the
    reference: exact for ints (an empty RDD gives the identities as
    there), rtol 1e-5 for float sums and means. stats' stdev is the square
    root of a difference of float32 sums, sum(v^2) / n - mean^2, where
    the cancellation multiplies the sums' rounding error, so it gets rtol
    1e-4."""
    ref, port = ctxs

    def run(ctx):
        if source == "ints":
            return ctx.dense_from_numpy(INTS)
        if source == "floats":
            return ctx.dense_from_numpy(FLOATS)
        if source == "half steps":
            return ctx.dense_range(40_000).map(lambda x: x * 0.5)
        return ctx.dense_from_numpy(INTS).filter(lambda x: x > 2**21)

    exp, got = run(ref), run(port)
    exact = source in ("ints", "empty ints")
    for name in ("sum", "min", "max"):
        g, e = getattr(got, name)(), getattr(exp, name)()
        assert type(g) is type(e), name
        if exact or name != "sum":
            assert g == e, name
        else:
            np.testing.assert_allclose(g, e, rtol=1e-5)
    if source == "empty ints":
        for rdd, err in ((got, VegaError), (exp, RefVegaError)):
            with pytest.raises(err):
                rdd.mean()
        assert got.stats()["count"] == exp.stats()["count"] == 0
        return
    np.testing.assert_allclose(got.mean(), exp.mean(), rtol=1e-5)
    gs, es = got.stats(), exp.stats()
    assert gs["count"] == es["count"]
    assert (gs["min"], gs["max"]) == (es["min"], es["max"])
    np.testing.assert_allclose(gs["mean"], es["mean"], rtol=1e-5)
    np.testing.assert_allclose(gs["stdev"], es["stdev"], rtol=1e-4)
    if source == "ints":
        small = lambda ctx: ctx.dense_from_numpy(INTS % 37)  # noqa: E731
        assert small(port).count_by_value() == small(ref).count_by_value()


@pytest.mark.parametrize("buckets", [10, 7, [0.0, 10.0, 55.5, 99.0],
                                     [50.0, 60.0]])
@pytest.mark.parametrize("source", ["ints", "floats"])
def test_histogram(ctxs, buckets, source):
    """Even buckets between min and max, or given edges (values outside
    them dropped): edges and counts exactly the reference's."""
    ref, port = ctxs
    vals = INTS % 100 if source == "ints" else FLOATS
    exp = ref.dense_from_numpy(vals).histogram(buckets)
    got = port.dense_from_numpy(vals).histogram(buckets)
    assert got == exp
    assert sum(got[1]) <= len(vals)
    one = port.dense_from_numpy(np.full(9, 3, np.int32)).histogram(4)
    assert one == ref.dense_from_numpy(np.full(9, 3, np.int32)).histogram(4)


def _outcome(build):
    """A request's outcome: its rows (an RDD's sorted by repr) or its
    exception's class (a reference task's TaskError as its cause)."""
    try:
        out = build()
        if hasattr(out, "collect"):
            out = sorted(out.collect(), key=repr)
        return ("ok", repr(out))
    except Exception as e:  # noqa: BLE001 — the class is the outcome
        while type(e).__name__ == "TaskError" and e.__cause__ is not None:
            e = e.__cause__
        return ("raise", type(e).__name__)


# each request the reference hands to its host tier (or refuses):
# name -> build(ctx)
HOST_REQUESTS = {
    "reduce_by_key_to_string": lambda c: c.dense_from_numpy(
        KEYS, INTS).reduce_by_key(lambda a, b: f"{a}{b}"),
    "reduce_by_key_changes_dtype": lambda c: c.dense_from_numpy(
        KEYS, INTS).reduce_by_key(lambda a, b: a + 0.5),
    "reduce_pairs": lambda c: c.dense_from_numpy(KEYS, INTS).reduce(
        lambda a, b: a),
    "distinct_pairs": lambda c: c.dense_from_numpy(KEYS, INTS).distinct(),
    "intersection_dtypes": lambda c: c.dense_from_numpy(INTS).intersection(
        c.dense_from_numpy(FLOATS)),
    "left_outer_join_fill_none": lambda c: c.dense_from_numpy(
        KEYS, INTS).left_outer_join(c.dense_from_numpy(KEYS, INTS),
                                    fill_value=None),
    "keys_dense_wide": lambda c: c.dense_from_numpy(
        KEYS.astype(np.int64) << 33, INTS).keys_dense(),
    "count_by_value_pairs": lambda c: c.dense_from_numpy(
        KEYS, INTS).count_by_value(),
    "sum_pairs": lambda c: c.dense_from_numpy(KEYS, INTS).sum(),
    "stats_pairs": lambda c: c.dense_from_numpy(KEYS, INTS).stats(),
    "histogram_pairs": lambda c: c.dense_from_numpy(KEYS, INTS).histogram(3),
}


def test_host_tier_requests_raise(ctxs):
    """Each request the reference hands to its host tier has the
    reference's outcome in the port (its host RDD layer's rows, or the
    same exception class where the reference's host tier or device form
    raises); a filter over a wide key runs in the host tier's row form
    (host_rows.py) and gives the reference's rows. A binop written for
    the reference's scalar rows ((a * b).sum()) fails the port's column
    trace (the sum of a column is no scalar a row), so the port's host
    RDD layer calls it on Python ints, which fails there: the job raises
    TaskError from the AttributeError, as the reference's jobs do."""
    ref, port = ctxs
    for name, build in HOST_REQUESTS.items():
        assert _outcome(lambda: build(port)) == \
            _outcome(lambda: build(ref)), name
    pairs = port.dense_from_numpy(KEYS, INTS)
    wide = port.dense_from_numpy(KEYS.astype(np.int64) << 33, INTS)
    node = pairs.reduce_by_key(lambda a, b: (a * b).sum())
    assert not isinstance(node, port_dense.DenseRDD)
    with pytest.raises(TaskError) as info:
        node.collect()
    assert isinstance(info.value.__cause__, AttributeError)
    assert wide.filter(lambda r: r[1] > 0).collect() == ref.dense_from_numpy(
        KEYS.astype(np.int64) << 33, INTS).filter(
            lambda r: r[1] > 0).collect()
    # a wide key counts on the device now, as in the reference
    assert sum(c for _k, c in wide.count_by_key_dense().collect()) == \
        len(INTS)
