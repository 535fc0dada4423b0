"""The frame planner's host tier, held against the reference's on the CPU.

The reference compiles a frame plan on its host tier when its device
lowering refuses it, or under hint(tier="host"): the same verbs over its
host RDD layer, numpy blocks until the first exchange and row tuples of
Python values after it. The port keeps a device form of every such plan
it has one for (PRs 15-17) and compiles the rest onto the same host
lowering over its own host RDD layer (vega_tpu_torch/rdd/):
vega_tpu_torch/frame/planner.py _compile_host.

Each case gives both packages the same seeded numpy columns (or the same
parquet files, written under tmp_path): the reference on
Context("local", num_workers=2) under the card's plans, the port on
Context(device="cpu", n_shards=8). It compares collect(), count() and
to_rdd().collect(): ints and strings exactly and with their types,
float64 within rtol 1e-12, NaN equal to NaN. A plan that sorts is
compared in its sort column's order; every plan's rows as a multiset
(the host shuffles of the two packages run with different partition
counts, so an unsorted result's order is not defined). The
fallback_count() deltas over the same actions must be equal.
"""

import math

import numpy as np
import pytest

import vega_tpu as v
import vega_tpu.frame as ref_frame
import vega_tpu_torch as vt
import vega_tpu_torch.frame as port_frame
from vega_tpu_torch.frame import logical as port_logical
from vega_tpu_torch.rdd.base import RDD as PortRDD

from test_torch_fallthrough import _cause
import test_torch_frame_tiers as tier_cases

N_SHARDS = 8
ACCEL_PLANS = {"dense_rbk_plan": "fused_sort", "dense_table_plan": "off",
               "dense_sort_impl": "xla"}


@pytest.fixture(scope="module")
def ctxs():
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


def S(*words):
    return np.array(words, dtype=object)


def _same_value(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or math.isclose(
            a, b, rel_tol=1e-12, abs_tol=0.0)
    return type(a) is type(b) and a == b


def _same_rows(got, want):
    assert len(got) == len(want), (got, want)
    for rg, rw in zip(got, want):
        assert len(rg) == len(rw) and all(
            _same_value(a, b) for a, b in zip(rg, rw)), (rg, rw)


def _bag(rows):
    return sorted(rows, key=repr)


def _sort_index(q):
    """The index of the column a frame sorts by last, or None."""
    plan = q._plan
    while isinstance(plan, port_logical.Limit):
        plan = plan.child
    if isinstance(plan, port_logical.Sort):
        return q.columns.index(plan.by)
    return None


def observe(q, planner):
    """(collect rows, count, to_rdd rows, fallback_count delta) of one
    frame; an exception's class (a reference task's TaskError as its
    cause) where an action raises."""
    before = planner.fallback_count()
    try:
        rows = q.collect()
        n = q.count()
        rdd_rows = q.to_rdd().collect()
    except Exception as e:  # noqa: BLE001 — the class is the outcome
        return ("raise", _cause(e), planner.fallback_count() - before)
    return rows, n, rdd_rows, planner.fallback_count() - before


def host_parity(ctxs, build, port_tier="host"):
    """build(ctx, frame module) on both packages: equal rows, count,
    to_rdd() rows and fallback deltas; the reference explains as its
    host tier and the port as port_tier. Returns the port's rows."""
    ref, port = ctxs
    rq, pq = build(ref, ref_frame), build(port, port_frame)
    assert rq.explain().startswith("== physical: host tier ==")
    assert pq.explain().startswith(f"== physical: {port_tier} tier ==")
    exp, got = observe(rq, ref_frame.planner), observe(pq, port_frame.planner)
    if exp[0] == "raise" or got[0] == "raise":
        assert got == exp
        return got
    rows, n, rdd_rows, delta = got
    assert (n, delta) == (exp[1], exp[3])
    _same_rows(_bag(rows), _bag(exp[0]))
    _same_rows(_bag(rdd_rows), _bag(exp[2]))
    idx = _sort_index(pq)
    if idx is not None:
        _same_rows([(r[idx],) for r in rows], [(r[idx],) for r in exp[0]])
    return rows


# ---------------------------------------------------------------------------
# the plans the port refused before it had a host tier
# ---------------------------------------------------------------------------

NAMES = S("ada", "bob", "ada", "cy", "bob", "ada")


def _lookup(fr):
    table = {i: i * 100 for i in range(13)}
    return fr.udf(lambda kk: table[int(kk)], fr.col("k"))


PLANS = {
    "string_sum": lambda c, fr: c.create_frame(
        name=NAMES, x=np.arange(6)).group_by("name").agg(
            fr.F.sum("name", "s")),
    "string_concat": lambda c, fr: c.create_frame(
        name=NAMES, x=np.arange(6)).with_column(
            "n2", fr.col("name") + fr.lit("x")),
    "string_against_number": lambda c, fr: c.create_frame(
        name=NAMES, x=np.arange(6)).filter(fr.col("name") == 3),
    "string_concat_group_by": lambda c, fr: c.create_frame(
        name=NAMES, x=np.arange(6) * 3).with_column(
            "tag", fr.col("name") + fr.lit("-z")).group_by("tag").agg(
                fr.F.sum("x", "sx"), fr.F.count("n"), fr.F.mean("x", "mx"))
        .sort("tag"),
    "lookup_udf": lambda c, fr: c.create_frame(
        k=np.arange(40) % 13, x=np.arange(40)).with_column(
            "m", _lookup(fr)).sort("x"),
    "numpy_udf": lambda c, fr: c.create_frame(
        k=np.arange(40) % 7, x=np.arange(40) * 0.25).with_column(
            "r", fr.udf(lambda a: np.sqrt(np.asarray(a)), fr.col("x")))
        .group_by("k").agg(fr.F.sum("r", "sr"), fr.F.max("x", "mx")),
    "object_source": lambda c, fr: c.create_frame(
        k=np.array([1, 2, 1, 3]),
        s=np.array(["a", 2, None, 4.5], dtype=object)).filter(
            fr.col("k") == 1).select("s"),
    "left_join_fill_none": lambda c, fr: c.create_frame(
        k=np.arange(6), x=np.arange(6) * 2).join(
            c.create_frame(k=np.arange(3), y=np.arange(3) * 7), on="k",
            how="left", fill_value=None).sort("k"),
    "string_fill_over_numbers": lambda c, fr: c.create_frame(
        k=np.arange(5), x=np.arange(5)).join(
            c.create_frame(k=np.arange(2), w=np.arange(2), s=S("a", "b")),
            on="k", how="left", fill_value="none").sort("k"),
    "string_fill_then_join": lambda c, fr: c.create_frame(
        k=np.arange(4), x=np.arange(4)).join(
            c.create_frame(k=np.arange(2), w=np.arange(2)), on="k",
            how="left", fill_value="none").join(
                c.create_frame(k=np.arange(4), z=np.arange(4) * 1.5),
                on="k").sort("k"),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_without_a_device_form_runs_on_the_host_tier(ctxs, name):
    host_parity(ctxs, PLANS[name])


@pytest.mark.parametrize("name", sorted(PLANS))
def test_tier_host_hint_on_those_plans(ctxs, name):
    host_parity(ctxs, lambda c, fr: PLANS[name](c, fr).hint(tier="host"))


def test_explain_names_both_tiers(ctxs):
    _ref, port = ctxs
    text = PLANS["lookup_udf"](port, port_frame).explain()
    assert text.startswith("== physical: host tier ==")
    assert "-- reference tier: host (stage does not trace" in text
    assert "-- host tier: stage does not trace" in text
    text = port.create_frame(k=np.arange(4)).hint(tier="host").explain()
    assert "-- reference tier: host (requested via hint)" in text


def test_no_device_retry_of_a_device_plan(ctxs):
    """A plan the device tier takes runs there; it is never sent to the
    host tier after the fact (nothing here raises on the device)."""
    _ref, port = ctxs
    q = port.create_frame(k=np.arange(8) % 2, x=np.arange(8)).group_by(
        "k").agg(port_frame.F.sum("x", "s")).sort("k")
    compiled = q._compiled()
    assert (compiled.kind, compiled.layout) == ("device", "block")
    assert q.collect() == [(0, 12), (1, 16)]


def test_tier_device_still_refuses_a_host_plan(ctxs):
    ref, port = ctxs
    for c, fr in ((ref, ref_frame), (port, port_frame)):
        with pytest.raises(Exception, match="tier='device' requested"):
            PLANS["lookup_udf"](c, fr).hint(tier="device").collect()


# ---------------------------------------------------------------------------
# hint(tier="host") over the existing frame cases
# ---------------------------------------------------------------------------

# cases whose closures differ between the packages on the host tier: a
# UDF written for torch tensors meets numpy arrays there, where the
# reference's jnp one does not fail the same way
_TORCH_CLOSURES = {"frame_verb_udf_vectorized"}
TIER_HOST = {name: build for name, build in tier_cases.TIER_CASES.items()
             if name not in _TORCH_CLOSURES}


@pytest.mark.parametrize("name", sorted(TIER_HOST))
def test_tier_host_matches_the_references_host_tier(ctxs, name):
    build = TIER_HOST[name]
    host_parity(ctxs, lambda c, fr: build(c, fr).hint(tier="host"))


def test_frame_cases_are_all_held():
    """Every case of the catalogue but the torch-closure ones runs under
    tier="host" above."""
    assert set(tier_cases.TIER_CASES) - set(TIER_HOST) == _TORCH_CLOSURES
    assert len(TIER_HOST) > 50


# ---------------------------------------------------------------------------
# parquet on the host tier
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def parquet_dir(tmp_path_factory):
    """Three files of a string column with nulls and ints, and one file
    of ints in row groups."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    root = tmp_path_factory.mktemp("hosttier")
    many = root / "many"
    many.mkdir()
    for i in range(3):
        n = 50 * (i + 1)
        x = np.arange(n) + 1000 * i
        words = [None if v % 7 == 3 else f"w{v % 11}" for v in x.tolist()]
        pq.write_table(pa.table({"w": words, "x": x,
                                 "f": np.arange(n) * 0.5}),
                       str(many / f"part{i}.parquet"), row_group_size=20)
    return str(many)


PARQUET = {
    "select_nulls": lambda df, fr: df.select("w", "x"),
    "pushdown_and_prune": lambda df, fr: df.filter(fr.col("x") > 1010)
    .select("w", "f").sort("f"),
    "group_strings_with_nulls": lambda df, fr: df.filter(
        fr.col("x") % 2 == 0).group_by("w").agg(fr.F.count("n"),
                                               fr.F.sum("f", "sf")),
    "string_concat": lambda df, fr: df.filter(fr.col("x") % 7 != 3)
    .with_column("w2", fr.col("w") + fr.lit("!")).select("x", "w2")
    .sort("x"),
    "string_concat_meets_a_null": lambda df, fr: df.with_column(
        "w2", fr.col("w") + fr.lit("!")).select("x", "w2"),
}


@pytest.mark.parametrize("name", sorted(PARQUET))
@pytest.mark.parametrize("parts", [None, 2])
def test_parquet_on_the_host_tier(ctxs, parquet_dir, name, parts):
    """The reference's file splits (size-balanced groups of files),
    column pruning and pushed-down conjuncts, over string columns with
    nulls."""
    build = PARQUET[name]
    host_parity(ctxs, lambda c, fr: build(
        c.read_parquet(parquet_dir, num_partitions=parts), fr))


def test_parquet_partitions_are_file_groups(ctxs, parquet_dir):
    _ref, port = ctxs
    q = port.read_parquet(parquet_dir, num_partitions=2).select("w", "x")
    rdd = q._compiled().rdd
    assert isinstance(rdd, PortRDD) and rdd.num_partitions == 2
    assert [len(b) for b in q.to_rdd().glom().collect()] == [150, 150]


# ---------------------------------------------------------------------------
# to_rdd()
# ---------------------------------------------------------------------------


def _device_query(c, fr):
    return c.create_frame(z=np.arange(12) % 5, a=np.arange(12) * 2,
                          b=np.arange(12) * 0.5).group_by("z").agg(
        fr.F.sum("a", "sa"), fr.F.max("b", "mb")).sort("z")


def test_to_rdd_of_a_device_plan_is_in_frame_order(ctxs):
    """A device plan's to_rdd() gives its DenseRDD's rows in frame order
    as Python values, equal to the reference's host tier's rows.
    Pinned: the reference's own device to_rdd() puts each row's columns
    in its block's name order and then reorders them by schema position,
    so where the two orders differ its rows are permuted (here (z, sa,
    mb) comes back as (z, mb, sa))."""
    ref, port = ctxs
    pq = _device_query(port, port_frame)
    assert pq._compiled().kind == "device"
    got = pq.to_rdd()
    assert isinstance(got, PortRDD)
    rows = got.collect()
    assert rows == pq.collect()
    assert all(type(r[0]) is int and type(r[1]) is int
               and type(r[2]) is float for r in rows)
    exp = _device_query(ref, ref_frame).hint(tier="host").to_rdd().collect()
    _same_rows(_bag(rows), _bag(exp))
    ref_device = _device_query(ref, ref_frame).to_rdd().collect()
    assert [(r[0], r[2], r[1]) for r in ref_device] == rows


def test_to_rdd_decodes_float64_and_bool_keys(ctxs):
    """A device plan that holds a float64 column as its bits and a bool
    key as 0 / 1 words gives the values back in to_rdd()."""
    ref, port = ctxs

    def build(c, fr):
        return c.create_frame(x=np.arange(10),
                              f=np.arange(10) * 0.1).with_column(
            "big", fr.col("x") > 4).group_by("big").agg(
                fr.F.sum("f", "sf")).sort("big")

    pq = build(port, port_frame)
    compiled = pq._compiled()
    assert compiled.kind == "device" and compiled.float64 and compiled.bools
    rows = pq.to_rdd().collect()
    assert rows == pq.collect()
    _same_rows(rows, build(ref, ref_frame).to_rdd().collect())


def test_to_rdd_of_a_limit_reparallelizes(ctxs):
    ref, port = ctxs

    def build(c, fr):
        return _device_query(c, fr).limit(3)

    rows = build(port, port_frame).to_rdd().collect()
    assert rows == build(port, port_frame).collect()
    assert len(rows) == 3
    _same_rows(rows, build(ref, ref_frame).to_rdd().collect())
    host = host_parity(ctxs, lambda c, fr: PLANS["lookup_udf"](c, fr).limit(5))
    assert len(host) == 5


def test_to_rdd_feeds_the_rdd_api(ctxs):
    _ref, port = ctxs
    rdd = PLANS["string_concat"](port, port_frame).to_rdd()
    assert rdd.map(lambda r: r[2]).collect() == [
        n + "x" for n in NAMES.tolist()]
    pairs = _device_query(port, port_frame).to_rdd().map(
        lambda r: (r[0] % 2, r[1]))
    assert sorted(pairs.reduce_by_key(lambda a, b: a + b).collect()) == [
        (0, 74), (1, 58)]
