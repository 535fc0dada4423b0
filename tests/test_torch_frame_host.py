"""The frame plans the reference answers on its host tier, on the port's
device tier, on the CPU.

The reference compiles each of these plans on its host tier (its device
planner refuses them and falls back, silently): joins with several value
columns a side, string comparisons, min / max of a string column beside
other aggregates, int64 columns beyond int32 and float group / join keys.
The port runs them on its device tier (vega_tpu_torch/frame/planner.py,
columns.py, dense_rdd.frame_join / reduce_columns). Each case here gives
both packages the same seeded numpy columns (or the same parquet file):
the reference on Context("local", num_workers=2) with no tier hint, which
must explain as its host tier, the port on Context(device="cpu",
n_shards=8). Integers and strings must be exact, floats within rtol 1e-6,
NaN equal to NaN; rows compare as sorted lists (a NaN-aware order), and a
query that sorts by a unique key compares in order.

Pinned differences, each in a test naming both sides: the port's column
dtypes are its device forms (int32, float32, bool; int64 for a wide
column, float64 for a float computed from one, such as its mean) where
the host tier's are numpy's of Python values; an expression over a wide
column whose result leaves int64 raises VegaError where the reference's
host tier wraps it in numpy int64 (block layout) or keeps a Python int
(row layout). A float64 group, join or sort key (a float64 source
column, a float computed from a wide one) is the float64 itself. The
merged -0.0 / 0.0 group takes the sign of the first zero in row order
on both sides. The rules of the two tiers for bools, float64 and fills
are held in tests/test_torch_frame_tiers.py.

Also held here: a string literal's code is read from the dictionary of
the block the stage runs on, when it runs (one stage over two sources
with different dictionaries); a left join's fill in a wide int64 and a
string column; the hash route sending -0.0 and 0.0 to one bucket.
"""

import math

import numpy as np
import pytest
import torch

import vega_tpu as v
import vega_tpu.frame as ref_frame
import vega_tpu_torch as vt
import vega_tpu_torch.frame as port_frame
from vega_tpu_torch import dense_rdd
from vega_tpu_torch.errors import VegaError

N_SHARDS = 8
ACCEL_PLANS = {"dense_rbk_plan": "fused_sort", "dense_table_plan": "off",
               "dense_sort_impl": "xla"}


def S(*words):
    return np.array(words, dtype=object)


@pytest.fixture(scope="module")
def ctxs():
    """(reference, port) Contexts; the reference with no tier hint, so the
    plans below compile on its host tier."""
    ref = v.Context("local", num_workers=2)
    port = vt.Context(device="cpu", n_shards=N_SHARDS, **ACCEL_PLANS)
    try:
        yield ref, port
    finally:
        port.stop()
        ref.stop()


def _order_key(row):
    return tuple((1, 0) if isinstance(x, float) and math.isnan(x)
                 else (0, x) for x in row)


def _same(got, want):
    assert len(got) == len(want), (got, want)
    for rg, rw in zip(got, want):
        assert len(rg) == len(rw), (rg, rw)
        for a, b in zip(rg, rw):
            if isinstance(a, float) or isinstance(b, float):
                assert (math.isnan(a) and math.isnan(b)) or math.isclose(
                    a, b, rel_tol=1e-6, abs_tol=1e-6), (got, want)
            else:
                assert a == b and type(a) is type(b), (got, want)


def _host_parity(ctxs, build, ordered=False):
    """build(ctx, frame module) on both; the reference must explain as its
    host tier. Returns the port's rows."""
    ref, port = ctxs
    rq, pq = build(ref, ref_frame), build(port, port_frame)
    assert "host tier" in rq.explain()
    assert pq.explain().startswith("== physical: device tier ==")
    want, got = rq.collect(), pq.collect()
    if not ordered:
        want, got = sorted(want, key=_order_key), sorted(got, key=_order_key)
    _same(got, want)
    assert pq.count() == len(got)
    return got


# ------------------------------------------------------------ the probes

NAME3 = S("pear", "apple", "fig")
NAMES = S("ada", "bob", "ada", "cy", "bob", "ada")


def _fruit(ctx):
    return ctx.create_frame(name=NAME3, x=np.arange(3))


def _wide(ctx):
    return ctx.create_frame(k=np.array([1, 2, 3]),
                            big=np.array([2**40, 2, 3]))


# name -> (build(ctx, fr), ordered, the port's rows or None)
CASES = {
    "wide_join": (
        lambda ctx, fr: ctx.create_frame(
            k=np.arange(6) % 3, x=np.arange(6), y=np.arange(6) * 2).join(
                ctx.create_frame(k=np.arange(3), z=np.arange(3) * 5),
                on="k").sort("k"),
        False, [(0, 0, 0, 0), (0, 3, 6, 0), (1, 1, 2, 5), (1, 4, 8, 5),
                (2, 2, 4, 10), (2, 5, 10, 10)]),
    "wide_left_join": (
        lambda ctx, fr: ctx.create_frame(
            k=np.arange(6) % 4, x=np.arange(6), y=np.arange(6) * 2).join(
                ctx.create_frame(k=np.arange(3), z=np.arange(3) * 5,
                                 w=np.arange(3) * 1.5),
                on="k", how="left").sort("x"),
        True, None),
    "left_join_string_right": (
        lambda ctx, fr: ctx.create_frame(k=np.arange(4), x=np.arange(4))
        .join(ctx.create_frame(k=np.arange(2), s=S("a", "b"),
                               w=np.arange(2)), on="k", how="left")
        .sort("k"),
        True, [(0, 0, "a", 0), (1, 1, "b", 1), (2, 2, "0", 0),
               (3, 3, "0", 0)]),
    "string_literal_filter": (
        lambda ctx, fr: _fruit(ctx).filter(fr.col("name") == fr.lit("apple"))
        .select("x"),
        False, [(1,)]),
    "string_ne": (
        lambda ctx, fr: _fruit(ctx).filter(fr.col("name") != fr.lit("apple"))
        .select("x"),
        False, [(0,), (2,)]),
    "string_lt": (
        lambda ctx, fr: _fruit(ctx).filter(fr.col("name") < fr.lit("grape"))
        .select("x"),
        False, [(1,), (2,)]),
    "string_le_ge_gt": (
        lambda ctx, fr: _fruit(ctx).filter(
            (fr.col("name") <= fr.lit("fig")) | (fr.col("name") > fr.lit("p"))
        ).filter(fr.lit("apple") <= fr.col("name")).select("x"),
        False, [(0,), (1,), (2,)]),
    "string_absent_literal": (
        lambda ctx, fr: _fruit(ctx).filter(fr.col("name") == fr.lit("kiwi"))
        .select("x"),
        False, []),
    "string_with_column_eq": (
        lambda ctx, fr: _fruit(ctx).with_column(
            "is_a", fr.col("name") == fr.lit("apple")).select("x", "is_a"),
        False, [(0, False), (1, True), (2, False)]),
    "string_cross_frame": (
        lambda ctx, fr: ctx.create_frame(k=np.arange(3), a=S("p", "q", "r"))
        .join(ctx.create_frame(k=np.arange(3), b=S("q", "q", "r")), on="k")
        .filter(fr.col("a") == fr.col("b")).select("k"),
        False, [(1,), (2,)]),
    "string_mixed_min_max": (
        lambda ctx, fr: ctx.create_frame(name=NAMES, x=np.arange(6))
        .group_by("x").agg(fr.F.min("name", "lo"), fr.F.max("name", "hi")),
        False, None),
    "string_min_sum": (
        lambda ctx, fr: ctx.create_frame(name=NAMES, x=np.arange(6) % 2,
                                         y=np.arange(6))
        .group_by("x").agg(fr.F.min("name", "lo"), fr.F.sum("y", "s")),
        False, [(0, "ada", 6), (1, "ada", 9)]),
    "string_max_mean": (
        lambda ctx, fr: ctx.create_frame(name=S("a", "b", "c", "a"),
                                         x=np.array([0, 1, 1, 0]),
                                         y=np.array([0, 1, 2, 3]))
        .group_by("x").agg(fr.F.max("name", "hi"), fr.F.mean("y", "m")),
        False, [(0, "a", 1.5), (1, "c", 1.5)]),
    "int64_beyond_int32_source": (
        lambda ctx, fr: _wide(ctx).sort("k"),
        True, [(1, 2**40), (2, 2), (3, 3)]),
    "int64_sum": (
        lambda ctx, fr: ctx.create_frame(k=np.array([1, 1, 2]),
                                         big=np.array([2**40, 3, 2]))
        .group_by("k").agg(fr.F.sum("big", "s")),
        False, [(1, 2**40 + 3), (2, 2)]),
    "int64_mean_max_min": (
        lambda ctx, fr: ctx.create_frame(k=np.array([1, 1, 2]),
                                         big=np.array([2**40, 2**41, -3]))
        .group_by("k").agg(fr.F.mean("big", "m"), fr.F.max("big", "hi"),
                           fr.F.min("big", "lo"), fr.F.count("n")),
        False, None),
    "int64_filter": (
        lambda ctx, fr: ctx.create_frame(k=np.array([1, 2, 3]),
                                         big=np.array([2**40 + 1, 2, 2**40]))
        .filter(fr.col("big") > 2**40).select("k"),
        False, [(1,)]),
    "int64_arithmetic": (
        lambda ctx, fr: _wide(ctx).with_column(
            "b2", fr.col("big") * 2 + 1).with_column(
                "b3", (fr.col("big") - fr.col("k")) // 3 % 1000)
        .with_column("b4", -fr.col("big") + fr.col("k") * fr.col("big"))
        .sort("k"),
        True, None),
    "int64_times_minus_one": (
        lambda ctx, fr: ctx.create_frame(k=np.arange(3),
                                         big=np.array([2**40, -2**50, 3]))
        .with_column("n", fr.col("big") * -1).sort("k"),
        True, [(0, 2**40, -2**40), (1, -2**50, 2**50), (2, 3, -3)]),
    "int64_group_key": (
        lambda ctx, fr: ctx.create_frame(big=np.array([2**40, 2, 2**40, -2**35]),
                                         x=np.arange(4))
        .group_by("big").agg(fr.F.sum("x", "s")).sort("big"),
        True, [(-2**35, 3), (2, 1), (2**40, 2)]),
    "int64_join_key": (
        lambda ctx, fr: ctx.create_frame(big=np.array([2**40, 2, 7]),
                                         x=np.arange(3))
        .join(ctx.create_frame(big=np.array([2**40, 5, 7]),
                               y=np.arange(3) * 10), on="big"),
        False, [(7, 2, 20), (2**40, 0, 0)]),
    "int64_sort_wide": (
        lambda ctx, fr: ctx.create_frame(k=np.arange(4),
                                         big=np.array([2**40, -2**41, 5, 0]))
        .sort("big", ascending=False),
        True, [(0, 2**40), (2, 5), (3, 0), (1, -2**41)]),
    "float_group_key": (
        lambda ctx, fr: ctx.create_frame(
            f=np.array([0.5, 1.5, 0.5, np.nan, np.nan, -0.0, 0.0]),
            x=np.arange(7)).group_by("f").agg(fr.F.sum("x", "s")),
        False, None),
    "float_join_key": (
        lambda ctx, fr: ctx.create_frame(f=np.array([0.5, 1.5, -0.0, np.nan]),
                                         x=np.arange(4))
        .join(ctx.create_frame(f=np.array([0.5, 0.0, np.nan]),
                               y=np.arange(3)), on="f"),
        False, [(-0.0, 2, 1), (0.5, 0, 0)]),
    # a float64 computed from a wide column as a group key: the key is the
    # float64 itself (kernels.f64_key), where float32 would merge it
    "float64_group_key": (
        lambda ctx, fr: ctx.create_frame(k=np.array([1, 1, 2, 3]),
                                         big=np.array([2**40, 2**40 + 3, 5,
                                                       2**40 + 2]))
        .group_by("k").agg(fr.F.mean("big", "m")).group_by("m")
        .agg(fr.F.count("n")),
        False, [(5.0, 1), (2**40 + 1.5, 1), (2**40 + 2.0, 1)]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_tier_plan_runs_on_the_device(ctxs, name):
    build, ordered, expect = CASES[name]
    got = _host_parity(ctxs, build, ordered=ordered)
    if expect is not None:
        _same(sorted(got, key=_order_key) if not ordered else got,
              sorted(expect, key=_order_key) if not ordered else expect)


def test_float_key_groups_follow_the_host(ctxs):
    """Each NaN row is a group of its own; -0.0 and 0.0 are one group,
    keyed by the sign of the first zero in row order, on both sides."""
    ref, port = ctxs
    for zeros in ([-0.0, 0.0], [0.0, -0.0]):
        f = np.array([np.nan, 1.5] + zeros + [np.nan])
        got = _host_parity(ctxs, lambda ctx, fr: ctx.create_frame(
            f=f, x=np.arange(5)).group_by("f").agg(fr.F.count("n")))
        assert sum(1 for r in got if math.isnan(r[0])) == 2
        zero = [r for r in got if r[0] == 0.0]
        assert zero[0][1] == 2
        assert math.copysign(1.0, zero[0][0]) == math.copysign(1.0, zeros[0])


# ------------------------------------------------------------ seeded


def _seeded(seed=3, n=300):
    rng = np.random.RandomState(seed)
    vocab = np.array([f"w{i:03d}" for i in range(40)], dtype=object)
    return dict(
        k=rng.randint(0, 25, size=n),
        x=rng.randint(-1000, 1000, size=n),
        y=rng.randint(0, 50, size=n),
        f=rng.rand(n) * 10.0,
        name=vocab[rng.randint(0, 40, size=n)],
        big=rng.randint(0, 1000, size=n) + (1 << 40),
    )


def _dims(seed=4, n=20):
    rng = np.random.RandomState(seed)
    vocab = np.array([f"d{i:02d}" for i in range(7)], dtype=object)
    return dict(k=np.arange(0, 2 * n, 2), z=rng.randint(0, 100, size=n),
                label=vocab[rng.randint(0, 7, size=n)],
                big2=rng.randint(0, 9, size=n) - (1 << 38),
                w=rng.rand(n))


SEEDED = {
    "join_three_by_three": lambda ctx, fr: ctx.create_frame(**_seeded())
    .select("k", "x", "name", "big").join(
        ctx.create_frame(**_dims()).select("k", "z", "label", "big2"),
        on="k"),
    "left_join_every_form": lambda ctx, fr: ctx.create_frame(**_seeded())
    .select("k", "x", "f").join(ctx.create_frame(**_dims()), on="k",
                                how="left"),
    "string_predicates": lambda ctx, fr: ctx.create_frame(**_seeded())
    .filter((fr.col("name") >= fr.lit("w010"))
            & (fr.col("name") != fr.lit("w020"))
            & (fr.col("name") < fr.lit("w03")))
    .with_column("is_w15", fr.col("name") == fr.lit("w015"))
    .select("x", "name", "is_w15"),
    "mixed_aggregates": lambda ctx, fr: ctx.create_frame(**_seeded())
    .group_by("k").agg(fr.F.min("name", "lo"), fr.F.max("name", "hi"),
                       fr.F.sum("x", "sx"), fr.F.mean("y", "my"),
                       fr.F.count("n"), fr.F.max("big", "mb")),
    "wide_aggregates": lambda ctx, fr: ctx.create_frame(**_seeded())
    .with_column("b", fr.col("big") - fr.col("x") * 3)
    .filter(fr.col("b") > (1 << 40) - 1000)
    .group_by("y").agg(fr.F.sum("b", "s"), fr.F.min("b", "lo"),
                       fr.F.mean("b", "m")),
    "wide_group_and_sort": lambda ctx, fr: ctx.create_frame(**_seeded())
    .group_by("big").agg(fr.F.sum("x", "s")).sort("big"),
    "float_key_join": lambda ctx, fr: ctx.create_frame(
        f=np.round(np.random.RandomState(5).rand(200) * 20) / 2
        - np.r_[np.zeros(190), np.full(10, np.nan)], x=np.arange(200))
    .group_by("f").agg(fr.F.sum("x", "s"), fr.F.count("n"))
    .join(ctx.create_frame(f=np.arange(-2, 12, 0.5),
                           g=np.arange(28) * 3), on="f", how="left"),
}


@pytest.mark.parametrize("name", sorted(SEEDED))
def test_seeded_host_tier_plans(ctxs, name):
    got = _host_parity(ctxs, SEEDED[name],
                       ordered=name == "wide_group_and_sort")
    assert got


def test_parquet_int64_without_proof_it_fits_int32(ctxs, tmp_path):
    """A parquet int64 column with no statistics proving it fits int32 is
    the wide pair (the reference: host tier, "no proof it fits")."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    wide = str(tmp_path / "wide.parquet")
    pq.write_table(pa.table({"k": np.array([1, 2, 3]),
                             "big": np.array([2**40, 2, 3])}), wide)
    ref, port = ctxs
    rq = ref.read_parquet(wide).select("k", "big")
    assert "host tier" in rq.explain()
    assert "no proof it fits" in ref_frame.planner.last_fallback()
    pq_ = port.read_parquet(wide).select("k", "big")
    _same(sorted(pq_.collect()), sorted(rq.collect()))
    # the pushed-down predicate keeps only small values: still wide
    small = port.read_parquet(wide).filter(port_frame.col("big") < 10) \
        .select("big")
    cols = small.collect_columns()
    assert cols["big"].dtype == np.int64 and sorted(cols["big"]) == [2, 3]


# ------------------------------------------------------------ pinned


def test_dtypes_are_the_device_forms(ctxs):
    """The host tier's columns are numpy's of Python values (int64,
    float64); the port's are its device forms: a wide column int64, a
    narrow one int32, a float computed from a wide or an int32 column
    float64 (the host tier's numpy promotion; its values are held at
    rtol 1e-12 in test_torch_frame_tiers.py), a comparison bool."""
    ref, port = ctxs

    def build(ctx, fr):
        return _wide(ctx).with_column("m", fr.col("big") / 2).with_column(
            "is3", fr.col("k") == 3).with_column("f", fr.col("k") * 0.5)

    names = ("k", "big", "m", "is3", "f")
    rc = build(ref, ref_frame).collect_columns()
    pc = build(port, port_frame).collect_columns()
    assert [str(rc[c].dtype) for c in names] == \
        ["int64", "int64", "float64", "bool", "float64"]
    assert [str(pc[c].dtype) for c in names] == \
        ["int32", "int64", "float64", "bool", "float64"]


def test_wide_mean_is_the_hosts_float64(ctxs):
    """mean of a wide column: the device divides the exact int64 sum in
    float64 and keeps the float64 (its bits in a word pair), equal to the
    host tier's Python float where float32 would round it; it stays
    float64 through a filter, a multiply, a join value (a left join's
    fill 7.0) and a sort payload."""
    ref, port = ctxs

    def build(ctx, fr):
        return ctx.create_frame(k=np.array([1, 1, 2]),
                                big=np.array([2**40, 2**40 + 3, 5])) \
            .group_by("k").agg(fr.F.mean("big", "m"))

    host = dict(build(ref, ref_frame).collect())
    dev = dict(build(port, port_frame).collect())
    assert host == dev == {1: 2**40 + 1.5, 2: 5.0}
    assert float(np.float32(2**40 + 1.5)) != 2**40 + 1.5

    def chain(ctx, fr):
        return ctx.create_frame(k=np.arange(4), x=np.arange(4)).join(
            build(ctx, fr).filter(fr.col("m") > 1.0).with_column(
                "m3", fr.col("m") * 3), on="k", how="left",
            fill_value=7).sort("k")

    got = _host_parity(ctxs, chain, ordered=True)
    assert got[1] == (1, 1, 2**40 + 1.5, (2**40 + 1.5) * 3)
    assert got[0] == (0, 0, 7.0, 7.0)
    assert chain(port, port_frame).collect_columns()["m3"].dtype == \
        np.float64


def test_float64_aggregate_inputs_stay_float64(ctxs):
    """A float64 computed from a wide column (big / 2, a wide mean)
    aggregates as float64: min / max in the floats' order, sum and mean
    in float64, equal to the host tier's Python floats exactly, where
    float32 inputs would round them."""

    def halves(ctx, fr):
        return ctx.create_frame(
            k=np.array([1, 1, 2, 2, 3]),
            big=np.array([2**40 + 1, 2**40 + 3, -2**41 - 1, 5, 7])) \
            .with_column("h", fr.col("big") / 2).group_by("k").agg(
                fr.F.max("h", "hi"), fr.F.min("h", "lo"),
                fr.F.sum("h", "s"), fr.F.mean("h", "m"))

    def regrouped(ctx, fr):
        return ctx.create_frame(
            k=np.arange(6) + 1,
            big=np.array([2**40, 2**40 + 3, -2**41 - 1, 5, 7, 2**40 + 2])) \
            .group_by("k").agg(fr.F.mean("big", "m")).with_column(
                "g", fr.col("k") % 2).group_by("g").agg(
                    fr.F.max("m", "hi"), fr.F.min("m", "lo"),
                    fr.F.sum("m", "s"))

    want = {
        halves: [(1, 2**39 + 1.5, 2**39 + 0.5, 2**40 + 2.0, 2**39 + 1.0),
                 (2, 2.5, -2**40 - 0.5, -2**40 + 2.0, -2**39 + 1.0),
                 (3, 3.5, 3.5, 3.5, 3.5)],
        regrouped: [(0, 2**40 + 3.0, 5.0, 2**41 + 10.0),
                    (1, 2**40 + 0.0, -2**41 - 1.0, -2**40 + 6.0)]}
    ref, port = ctxs
    for build, rows in want.items():
        host = sorted(build(ref, ref_frame).collect())
        dev = sorted(build(port, port_frame).collect())
        assert host == dev == rows
        assert any(float(np.float32(x)) != x for r in rows for x in r[1:])
        cols = build(port, port_frame).collect_columns()
        assert all(cols[c].dtype == np.float64 for c in ("hi", "lo", "s"))


def test_wide_result_outside_int64_raises(ctxs):
    """big * big leaves int64: the reference's host tier wraps it in
    numpy int64 here (its block layout); the port raises VegaError at
    the action, and an in-range result of the same stage is exact."""
    ref, port = ctxs

    def build(ctx, fr):
        return _wide(ctx).with_column("sq", fr.col("big") * fr.col("big"))

    host = dict((k, sq) for k, _b, sq in build(ref, ref_frame).collect())
    assert host[1] == np.int64(2**40) * np.int64(2**40) == 0  # wrapped
    q = build(port, port_frame)
    with pytest.raises(VegaError, match="int64"):
        q.collect()
    ok = port.create_frame(k=np.array([1, 2]), big=np.array([2**40, 2])) \
        .with_column("sq", port_frame.col("big") * 1000)
    assert sorted(ok.collect()) == [(1, 2**40, 2**40 * 1000), (2, 2, 2000)]
    for e, what in ((port_frame.col("big") + (2**63 - 2**40 + 1), "add"),
                    (-port_frame.col("big") - (2**63 - 2**40 + 2), "sub"),
                    (port_frame.col("big") // 0, "floordiv by zero")):
        with pytest.raises(VegaError, match="int64"):
            _wide(port).with_column("r", e).collect()


# ------------------------------------------------------------ trouble spots


def test_literal_filter_across_frames_with_different_dictionaries(ctxs):
    """One filter on two frames whose dictionaries rank "m" differently:
    each resolves the literal against its own dictionary."""
    frames = (S("m", "a", "z", "m"), S("q", "m", "b", "c", "m", "zz"))

    for words in frames:
        _host_parity(ctxs, lambda ctx, fr, w=words: ctx.create_frame(
            s=w, x=np.arange(len(w))).filter(
                (fr.col("s") == fr.lit("m")) | (fr.col("s") > fr.lit("n")))
            .select("x"))
    # and across a join: the key's merged dictionary decides
    _host_parity(ctxs, lambda ctx, fr: ctx.create_frame(
        s=frames[0], x=np.arange(4)).join(ctx.create_frame(
            s=frames[1], y=np.arange(6)), on="s").filter(
                fr.col("s") == fr.lit("m")))


def test_one_stage_over_two_dictionaries(ctxs):
    """The compiled stage of a string-literal filter, applied to a second
    source whose dictionary gives "apple" another code, selects that
    source's apple rows: the code is read when the stage runs, and the
    stage's token holds the literal, never a code."""
    _ref, port = ctxs
    col, lit = port_frame.col, port_frame.lit
    a = port.create_frame(name=S("pear", "apple", "fig"), x=np.arange(3))
    b = port.create_frame(name=S("zebra", "apple", "aardvark", "apple"),
                          x=np.arange(10, 14))
    qa = a.filter(col("name") == lit("apple")).select("x")
    qb = b.filter(col("name") == lit("apple")).select("x")
    na, nb = qa._compiled().rdd, qb._compiled().rdd
    assert isinstance(na, dense_rdd._ColsPipelineRDD)
    assert na._user_fn == nb._user_fn and "apple" in repr(na._user_fn)
    assert na.parent._dicts() != {} and \
        list(na.parent._dicts().values())[0].tolist() == \
        ["apple", "fig", "pear"]
    # the first source's stage over the second source
    moved = dense_rdd.dense_pipeline(
        nb.parent, na._cols_fn, na._schema(), na._user_fn,
        dict_renames=na._dict_renames)
    assert sorted(moved.collect_arrays()["x"].tolist()) == [11, 13]
    assert sorted(na.collect_arrays()["x"].tolist()) == [1]
    # and again over the first: nothing of the second run stayed
    again = dense_rdd.dense_pipeline(
        na.parent, nb._cols_fn, nb._schema(), nb._user_fn,
        dict_renames=nb._dict_renames)
    assert again.collect_arrays()["x"].tolist() == [1]


def test_wide_and_string_left_join_fill(ctxs):
    """An unmatched left row fills a wide int64 right column with the
    encoding of the fill (0, not raw words) and a string column with the
    word '0', added to its dictionary in rank order."""
    got = _host_parity(ctxs, lambda ctx, fr: ctx.create_frame(
        k=np.arange(5), x=np.arange(5)).join(ctx.create_frame(
            k=np.array([1, 3]), big=np.array([-2**40, 2**41]),
            s=S("/", "1")), on="k", how="left").sort("k"), ordered=True)
    assert got == [(0, 0, 0, "0"), (1, 1, -2**40, "/"), (2, 2, 0, "0"),
                   (3, 3, 2**41, "1"), (4, 4, 0, "0")]


def test_plus_and_minus_zero_share_a_bucket(ctxs):
    """The frame layer's hash route reads -0.0 as 0.0 (here on the CPU;
    on the card chip_smoke.py phase 15e groups 1M float keys with both
    zeros), so its keyed reduce over many shards makes one group of them.
    The RDD API keeps the reference's device placement, which hashes the
    bits (tests/test_torch_keyed.py)."""
    keys = torch.tensor([[0.0, -0.0, 1.5, -1.5, float("nan")]])
    for n in (2, 7, 8):
        b = dense_rdd._bucket_cols({"k": keys}, n, zeros_one_key=True)
        assert b[0, 0] == b[0, 1]
    f = np.tile(np.array([-0.0, 0.0, 2.0], np.float32), 40)
    node = ctxs[1].dense_from_numpy(f, np.ones(len(f), np.int32))
    out = dense_rdd.reduce_columns(node, {"v": "add"}).collect()
    assert sorted(v_ for _k, v_ in out) == [40, 80]


# ------------------------------------------------- the port's host tier

REFUSED = {
    "string_arithmetic": (
        lambda ctx, fr: ctx.create_frame(name=NAMES, x=np.arange(6))
        .group_by("name").agg(fr.F.sum("name", "s")),
        "folds dictionary codes"),
    "string_concat_expression": (
        lambda ctx, fr: ctx.create_frame(name=NAMES, x=np.arange(6))
        .with_column("n2", fr.col("name") + fr.lit("x")),
        "computes on dictionary codes"),
    "string_against_number": (
        lambda ctx, fr: ctx.create_frame(name=NAMES, x=np.arange(6))
        .filter(fr.col("name") == 3),
        "computes on dictionary codes"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_still_refused(ctxs, name):
    """Arithmetic over a string column has no device form giving the host
    tier's rows: the port compiles it on its host tier (the reason in
    explain()), with the reference's rows, count and to_rdd() rows."""
    build, reason = REFUSED[name]
    ref, port = ctxs
    rq = build(ref, ref_frame)
    assert "host tier" in rq.explain()
    q = build(port, port_frame)
    text = q.explain()
    assert text.startswith("== physical: host tier ==") and reason in text
    assert sorted(q.collect()) == sorted(rq.collect())
    assert q.count() == rq.count()
    assert sorted(q.to_rdd().collect()) == sorted(rq.to_rdd().collect())


def test_parquet_string_predicate_pushed_into_the_reader(ctxs, tmp_path):
    """A string conjunct pushed into a parquet scan: the reader filters on
    the file's values (the reference's device tier refuses it, its host
    tier filters in the same reader), and the string column still
    arrives dictionary-encoded."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    path = str(tmp_path / "words.parquet")
    rng = np.random.RandomState(6)
    words = np.array([f"w{i:02d}" for i in rng.randint(0, 30, 400)])
    pq.write_table(pa.table({"w": words, "x": np.arange(400)}), path,
                   row_group_size=100)
    for build in (
            lambda ctx, fr: ctx.read_parquet(path).filter(
                fr.col("w") == fr.lit("w07")).select("w", "x"),
            lambda ctx, fr: ctx.read_parquet(path).filter(
                fr.col("w") >= fr.lit("w20")).filter(
                    fr.col("w") != fr.lit("w25")).select("x")):
        assert _host_parity(ctxs, build)
