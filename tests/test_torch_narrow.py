"""Named columns and narrow ops of vega_tpu_torch against vega_tpu, on the
CPU.

Row forms (collect / take over value, pair, key-only and named blocks),
the named sources (dense_from_numpy with three columns, dense_from_columns
and its checks), select / rename / keys_dense / values_dense,
count_by_key_dense (BASELINE config 3: benchmarks/suite.py's word ids at
50,000 rows), reduce_by_key(op=) over several value columns, filter,
key_by and map_values. Each runs through a vega_tpu Context("local") on
the 8-device CPU mesh and through vega_tpu_torch's Context(device="cpu",
n_shards=8), both under the card's plans (xla sorts, fused_sort, no table
plan), on inputs from a numpy seed. Integer results are bit-identical,
with equal per-shard counts and row order; float sums within rtol 1e-5
(float32 sums are taken in another order).
"""

import numpy as np
import pytest

import vega_tpu as v
from vega_tpu.errors import VegaError as RefVegaError
import vega_tpu_torch as vt
from vega_tpu_torch.errors import VegaError

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


def _same(got, exp):
    """The same rows in the same order and the same placement."""
    np.testing.assert_array_equal(got.block().counts_np,
                                  exp.block().counts_np)
    assert got.collect() == exp.collect()


def _config3_ids(n):
    """benchmarks/suite.py:105-118's word ids: n rows, max(1000, n / 40)
    distinct."""
    k = max(1000, n // 40)
    return ((np.arange(n, dtype=np.uint64) * np.uint64(11400714819323198485))
            % np.uint64(k)).astype(np.int32)


# ---------------------------------------------------------------------------
# row forms and named sources
# ---------------------------------------------------------------------------

RNG = np.random.RandomState(3)
A = RNG.randint(-500, 500, size=3_001).astype(np.int32)
B = (RNG.rand(3_001) * 10).astype(np.float32)
C = RNG.randint(0, 40, size=3_001).astype(np.int32)

LAYOUTS = {
    "value": lambda ctx: ctx.dense_from_numpy(A),
    "pair": lambda ctx: ctx.dense_from_numpy(C, B),
    "key-only": lambda ctx: ctx.dense_from_columns({"word_id": C},
                                                   key="word_id"),
    "three columns": lambda ctx: ctx.dense_from_numpy(A, B, C),
    "named, key last": lambda ctx: ctx.dense_from_columns(
        {"a": A, "b": B}, key="a"),
    "named, keywords": lambda ctx: ctx.dense_from_columns(
        {"v": B}, k=C, w=A),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_row_forms_match_reference(ctxs, layout):
    """collect and take give the reference's rows: values, (k, v) pairs,
    or tuples of every column in schema order (1-tuples for a key-only
    block)."""
    ref, port = ctxs
    exp, got = LAYOUTS[layout](ref), LAYOUTS[layout](port)
    assert got.columns == exp.columns
    assert got.is_pair == exp.is_pair
    _same(got, exp)
    for n in (7, 500):
        assert got.take(n) == exp.collect()[:n]
        # the reference's take reads a shard's rows through jax.device_get
        # of a dict, which orders the columns by name (ROADMAP queue 3);
        # where schema order is name order both forms agree
        if exp.columns == sorted(exp.columns):
            assert got.take(n) == exp.take(n)


@pytest.mark.parametrize("case", ["duplicate", "reserved .lo", "lengths",
                                  "missing key", "key over k"])
def test_dense_from_columns_checks(ctxs, case):
    args = {
        "duplicate": (({"a": A},), {"a": A}),
        "reserved .lo": (({"a.lo": A},), {}),
        "lengths": (({"a": A, "b": A[:10]},), {}),
        "missing key": (({"a": A},), {"key": "b"}),
        "key over k": (({"a": A, "k": A},), {"key": "a"}),
    }[case]
    ref, port = ctxs
    with pytest.raises(RefVegaError):
        ref.dense_from_columns(*args[0], **args[1])
    with pytest.raises(VegaError):
        port.dense_from_columns(*args[0], **args[1])


# ---------------------------------------------------------------------------
# select / rename / keys / values
# ---------------------------------------------------------------------------


def test_select_rename_and_projections(ctxs):
    ref, port = ctxs

    def run(ctx):
        src = ctx.dense_from_numpy(A, B, C)
        named = ctx.dense_from_columns({"a": A, "b": B, "c": C}, key="c")
        return {
            "select": src.select("c2", "c0"),
            "rename": src.rename({"c1": "w"}),
            "keys": named.keys_dense(),
            "values": named.select("k", "b").rename({"b": "v"})
            .values_dense(),
        }

    exp, got = run(ref), run(port)
    for name in exp:
        assert got[name].columns == exp[name].columns, name
        _same(got[name], exp[name])


def test_select_and_rename_keep_placement(ctxs):
    """A select of the key or a rename over a reduce output stays
    hash-placed and key-sorted, so the next reduce elides its exchange
    (the rows stay on their shards); a select without the key does not."""
    ref, port = ctxs

    def run(ctx):
        red = ctx.dense_from_columns({"a": A, "b": C}, key="b") \
            .reduce_by_key(op="add")
        sel = red.select("k", "a").rename({"a": "v"})
        return red, sel, sel.reduce_by_key(op="max")

    (ered, _esel, eout), (gred, gsel, gout) = run(ref), run(port)
    _same(gout, eout)
    gsel._settle_placement()
    assert gsel.hash_placed and gsel.key_sorted
    np.testing.assert_array_equal(gout.block().counts_np,
                                  gred.block().counts_np)
    assert gout._last_counts_host is None  # a fixed-capacity passthrough
    assert not gred.select("a").hash_placed


def test_select_and_rename_checks(ctxs):
    """Unknown columns, the key and the '.lo' suffix: both packages
    refuse."""
    ref, port = ctxs
    for ctx, err in ((ref, RefVegaError), (port, VegaError)):
        src = ctx.dense_from_columns({"a": A, "b": C}, key="b")
        for bad in (lambda: src.select("x"),
                    lambda: src.rename({"x": "y"}),
                    lambda: src.rename({"a": "k"}),
                    lambda: src.rename({"k": "a"}),
                    lambda: src.rename({"a": "a.lo"}),
                    lambda: src.values_dense()):
            with pytest.raises(err):
                bad()


def test_wide_key_select_and_keys(ctxs):
    """Selecting a wide key keeps its low word, the low word alone is
    refused; keys_dense of a wide key goes to the reference's host tier,
    so the port raises."""
    ref, port = ctxs
    keys = (np.arange(2_000, dtype=np.int64) % 37) * (1 << 40) - 5
    vals = np.arange(2_000, dtype=np.int32)

    def run(ctx):
        return ctx.dense_from_columns({"x": keys, "w": vals}, key="x")

    exp, got = run(ref), run(port)
    assert got.select("k").columns == exp.select("k").columns == \
        ["k", "k.lo"]
    _same(got.select("w", "k"), exp.select("w", "k"))
    with pytest.raises(RefVegaError):
        exp.select("k.lo")
    with pytest.raises(VegaError):
        got.select("k.lo")
    with pytest.raises(VegaError, match="host tier"):
        got.keys_dense()
    # map_values keeps the wide key
    _same(got.rename({"w": "v"}).map_values(lambda x: x * 3),
          exp.rename({"w": "v"}).map_values(lambda x: x * 3))


# ---------------------------------------------------------------------------
# BASELINE config 3 and multi-column reduces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["config 3, key-only", "pair", "named"])
def test_count_by_key_dense(ctxs, layout):
    ref, port = ctxs
    ids = _config3_ids(50_000)

    def run(ctx):
        if layout == "config 3, key-only":
            src = ctx.dense_from_columns({"word_id": ids}, key="word_id")
        elif layout == "pair":
            src = ctx.dense_from_numpy(ids, ids.astype(np.float32))
        else:
            src = ctx.dense_from_columns({"w": ids, "x": B.repeat(17)[:50_000],
                                          "y": ids}, key="w")
        return src.count_by_key_dense()

    exp, got = run(ref), run(port)
    _same(got, exp)
    counts = np.bincount(ids)
    assert dict(got.collect()) == {i: int(c) for i, c in enumerate(counts)
                                   if c}
    # warm: the same lineage and sizes launch deferred and settle at the
    # read, with the same rows
    again = run(port)
    assert again.block_spec().settle is not None
    assert again.collect() == exp.collect()


@pytest.mark.parametrize("plans", ["card", "cpu"])
@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_reduce_by_key_reduces_every_value_column(ctxs, op, plans):
    """A named op over a named block with an int32 and a float32 value
    column: both reduced per key, cold (sized by histograms) and warm
    (deferred), under the card's plans and under the CPU's (packed sorts,
    sort_partition, the table plan on, which two value columns keep
    off)."""
    ref, port = ctxs
    if plans == "cpu":
        port = vt.Context(device="cpu", n_shards=N_SHARDS)
    rng = np.random.RandomState(4)
    n = 20_000
    keys = rng.randint(0, 900, size=n).astype(np.int32)
    ints = rng.randint(-1000, 1000, size=n).astype(np.int32)
    floats = rng.rand(n).astype(np.float32)

    def run(ctx):
        return ctx.dense_from_columns({"i": ints, "f": floats, "g": keys},
                                      key="g").reduce_by_key(op=op)

    exp, got = run(ref), run(port)
    for node in (got, run(port)):  # cold, then warm (deferred)
        np.testing.assert_array_equal(node.block().counts_np,
                                      exp.block().counts_np)
        e, g = exp.collect_arrays(), node.collect_arrays()
        assert list(g) == list(e) == ["i", "f", "k"]
        np.testing.assert_array_equal(g["k"], e["k"])
        np.testing.assert_array_equal(g["i"], e["i"])
        np.testing.assert_allclose(g["f"], e["f"], rtol=1e-5)
        assert not node._table_plan


# ---------------------------------------------------------------------------
# filter / key_by / map_values
# ---------------------------------------------------------------------------


def test_filter_key_by_map_values(ctxs):
    ref, port = ctxs

    def run(ctx):
        kv = ctx.dense_range(30_000).map(lambda x: (x % 1_000, x))
        return {
            "filter": kv.filter(lambda r: r[1] % 3 != 0),
            "map_values": kv.filter(lambda r: r[1] % 3 != 0)
            .map_values(lambda x: x ^ 0x5A5A),
            "filter value": ctx.dense_range(30_000).filter(
                lambda x: (x & 7) == 1),
            "filter named": ctx.dense_from_numpy(A, B, C).filter(
                lambda r: r[2] > 20),
            "key_by": ctx.dense_from_numpy(A).key_by(lambda x: x % 13),
            "map_values float": ctx.dense_from_numpy(C, B).map_values(
                lambda x: x * 2.0 + 1.0),
        }

    exp, got = run(ref), run(port)
    for name in exp:
        assert got[name].columns == exp[name].columns, name
        _same(got[name], exp[name])


def test_filter_and_map_values_keep_placement(ctxs):
    """Over a reduce output both stay hash-placed and key-sorted: the next
    reduce runs on a passthrough and equals the reference's."""
    ref, port = ctxs

    def run(ctx):
        red = ctx.dense_range(30_000).map(lambda x: (x % 2_000, x)) \
            .reduce_by_key(op="add")
        mid = red.filter(lambda r: r[0] % 2 == 0).map_values(
            lambda x: x & 0xFFF)
        return red, mid, mid.reduce_by_key(op="max")

    (_er, _em, exp), (_gr, gmid, got) = run(ref), run(port)
    _same(got, exp)
    gmid._settle_placement()
    assert gmid.hash_placed and gmid.key_sorted
    assert got._last_counts_host is None  # a fixed-capacity passthrough
    assert not port.dense_range(10).map(lambda x: (x, x)).filter(
        lambda r: r[0] > 1).hash_placed


def test_map_values_needs_one_value_column(ctxs):
    ref, port = ctxs
    for ctx, err in ((ref, RefVegaError), (port, VegaError)):
        named = ctx.dense_from_columns({"a": A, "b": B, "c": C}, key="c")
        with pytest.raises(err, match="exactly one value column"):
            named.map_values(lambda x: x)
        with pytest.raises(err):
            ctx.dense_from_numpy(A).map_values(lambda x: x)
