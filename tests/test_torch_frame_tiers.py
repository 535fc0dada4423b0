"""The reference's two tiers, held apart in the port's frame layer.

The reference's planner picks one tier per plan (its device lowering takes
the whole plan, or some site raises HostFallback and its host tier runs
the whole plan), and the two tiers answer differently for bools, float64
and fill values. The port runs every plan on its device tier and applies
the picked tier's rules (vega_tpu_torch/frame/planner.py, reference_tier).
Each case gives both packages the same numpy columns: the reference on
Context("local", num_workers=2) on its accelerator plans, with no tier
hint, the port on Context(device="cpu", n_shards=8). The reference's
explain() must name the tier the case expects, and the port's
reference_tier() the same one.

Rows compare as sorted lists (a NaN-aware order, the sign of a zero
kept), or in order where the query sorts. Integers, bools and strings
are exact, with their Python type; a float equals exactly where both
values are integers below 2^53, else within rtol 1e-12; NaN equals NaN;
a zero's sign must match.

The repairs (each case here failed before them): a computed bool under
sum / mean (F12: a logical or beside other monoids on the device tier, a
count on the host tier), a computed bool as a group, sort or join key
(F13), a float64 group or join key (F14; also where it meets an int32,
bool or wide key), a left join's fill (F15), a float64 value (F16) and
the numpy arithmetic and Python sums over int32, bool and float32 columns
(F17) in plans the reference compiles on its host tier.
The agreements keep holding: a float64 sum alone or beside max(x) and a
float64 sort on the device tier narrow to float32; a bool source column
sums as int32; a count beside max of a computed bool; a left join with
one int32 column a side casts its fill; an all-add bool sum is refused by
both. The differences still pinned name both sides.

The last two tests hold the port's reference_tier() to the tier the
reference's explain() prints on every frame parity case of
tests/test_torch_frame.py, tests/test_torch_frame_host.py and this file
(the parquet and string-key queries those files build inline rebuilt
here), and to the reference's reason at a scan.
"""

import math
import types

import numpy as np
import pytest

import vega_tpu as v
import vega_tpu.frame as ref_frame
import vega_tpu_torch as vt
import vega_tpu_torch.frame as port_frame
from vega_tpu_torch import dense_rdd
from vega_tpu_torch.errors import VegaError
from vega_tpu_torch.frame import logical as port_logical
from vega_tpu_torch.frame import planner as port_planner

import test_torch_frame as frame_cases
import test_torch_frame_host as host_cases

N_SHARDS = 8
ACCEL_PLANS = {"dense_rbk_plan": "fused_sort", "dense_table_plan": "off",
               "dense_sort_impl": "xla"}
X6 = np.arange(6)
X8 = np.arange(8)
# an int64 source whose values fit int32 (the port holds it as int32) and
# an int32 one
X64 = np.array([5, -2**31, 3, 2**31 - 1])
X32 = np.array([100000, -2**31, 3, 7], np.int32)


def S(*words):
    return np.array(words, dtype=object)


def _rows_of(*cols):
    """Rows of Python ints from numpy columns (their own wrapping)."""
    with np.errstate(over="ignore"):
        return [tuple(int(v) for v in row) for row in zip(*cols)]


@pytest.fixture(scope="module")
def ctxs():
    """(reference, port) Contexts on the accelerator plans; the
    reference's settings restored after."""
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


# ------------------------------------------------------------ comparison


def _order_key(row):
    return tuple((2, 0) if isinstance(x, float) and math.isnan(x)
                 else (1, x) if isinstance(x, str) else (0, x) for x in row)


def _same_value(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        if math.copysign(1.0, a) != math.copysign(1.0, b):
            return False
        if a == int(a) and b == int(b) and abs(a) < 2**53:
            return a == b
        return math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0)
    return a == b and type(a) is type(b)


def _exact(got, want):
    assert len(got) == len(want), (got, want)
    for rg, rw in zip(got, want):
        assert len(rg) == len(rw) and all(
            _same_value(a, b) for a, b in zip(rg, rw)), (got, want)


def _port_tier(q):
    """The port's reference_tier() of a port DataFrame, as compile_plan
    computes it (also for a plan the port refuses to lower)."""
    plan = q._plan
    while isinstance(plan, port_logical.Limit):
        plan = plan.child
    options = {**port_planner.DEFAULT_OPTIONS, **q._options}
    opt = port_logical.optimize(plan) if options["pushdown"] else plan
    return port_planner.reference_tier(
        opt, port_planner.scan_sources(q._ctx, opt), options)


def _ref_tier(rq) -> str:
    head = rq.explain().splitlines()[0]
    assert head in ("== physical: host tier ==",
                    "== physical: device tier =="), head
    return "host" if "host" in head else "device"


# ------------------------------------------------------------ the cases


def _bools(ctx, fr, n=6):
    col = fr.col
    x = np.arange(n)
    return ctx.create_frame(x=x, k=x % 2).with_column("b", col("x") > 2)


def _f12(ctx, fr, *aggs, s=False):
    col = fr.col
    data = dict(x=X6, k=X6 % 2)
    if s:
        data["s"] = S("a", "b", "a", "b", "a", "b")
    return ctx.create_frame(**data).with_column("b", col("x") > 2) \
        .group_by("k").agg(*aggs)


F16_VALUES = np.array([1e8, 1.0, -1e8, 2.0, 0.1, 0.2 + 1e8])
F16_KEYS = np.array([0, 0, 0, 1, 2, 2])


def _f16(ctx, **more):
    return ctx.create_frame(k=F16_KEYS, f=F16_VALUES, **more)


def _mixed_keys(ctx, left, right, how="inner"):
    return ctx.create_frame(k=left, x=np.arange(len(left))).join(
        ctx.create_frame(k=right, y=np.arange(len(right)) + 10), on="k",
        how=how, fill_value=-1)


def _f14_zeros(first, second):
    return lambda ctx, fr: ctx.create_frame(
        f=np.array([np.nan, 0.1, first, second, np.nan, 0.1 + 1e-12]),
        x=np.arange(6)).group_by("f").agg(fr.F.count("n"), fr.F.min("x", "m"))


# name -> (build(ctx, fr), tier, the index of the column the query sorts
# by (None: compare as sorted rows), the expected rows or None)
CASES = {
    # F12: a computed bool under sum / mean
    "f12a_or_beside_max": (
        lambda ctx, fr: _f12(ctx, fr, fr.F.sum("b"), fr.F.max("x")),
        "device", None, [(0, True, 4), (1, True, 5)]),
    "f12_min_max_sum": (
        lambda ctx, fr: _f12(ctx, fr, fr.F.min("b"), fr.F.max("b"),
                             fr.F.sum("b")),
        "device", None, [(0, False, True, True), (1, False, True, True)]),
    "f12_mean_is_or_over_count": (
        lambda ctx, fr: _bools(ctx, fr, 8).group_by("k").agg(
            fr.F.mean("b"), fr.F.max("x")),
        "device", None, [(0, 0.25, 6), (1, 0.25, 7)]),
    "f12b_count_beside_string_min": (
        lambda ctx, fr: _f12(ctx, fr, fr.F.sum("b"), fr.F.min("s"), s=True),
        "host", None, [(0, 1, "a"), (1, 2, "b")]),
    "f12c_mean_beside_string_min": (
        lambda ctx, fr: _f12(ctx, fr, fr.F.mean("b"), fr.F.min("s"), s=True),
        "host", None, [(0, 1 / 3, "a"), (1, 2 / 3, "b")]),
    "f12_count_beside_wide": (
        lambda ctx, fr: ctx.create_frame(
            x=X8, k=X8 % 2, w=X8 + 2**40).with_column(
                "b", fr.col("x") > 2).group_by("k").agg(
                    fr.F.sum("b", "n"), fr.F.mean("b", "m"),
                    fr.F.sum("w", "sw")),
        "host", None, [(0, 2, 0.5, 4 * 2**40 + 12),
                       (1, 3, 0.75, 4 * 2**40 + 16)]),
    # F13: a computed bool as a key
    "f13_group_by_bool": (
        lambda ctx, fr: _bools(ctx, fr).group_by("b").count(),
        "host", None, [(False, 3), (True, 3)]),
    "f13_group_by_bool_then_filter": (
        lambda ctx, fr: _bools(ctx, fr).group_by("b").agg(
            fr.F.sum("x", "s")).filter(fr.col("b")),
        "host", None, [(True, 12)]),
    "f13_sort_by_bool": (
        lambda ctx, fr: _bools(ctx, fr).select("x", "b").sort("b"),
        "host", 1, [(0, False), (1, False), (2, False), (3, True),
                    (4, True), (5, True)]),
    "f13_join_bool_with_source_bool": (
        lambda ctx, fr: _bools(ctx, fr).select("b", "x").join(
            ctx.create_frame(b=np.array([True]), y=np.array([9])), on="b"),
        "host", None, [(True, 3, 9), (True, 4, 9), (True, 5, 9)]),
    "f13_string_eq_key": (
        lambda ctx, fr: ctx.create_frame(s=S("a", "b", "a"),
                                         x=np.arange(3)).with_column(
            "e", fr.col("s") == fr.lit("a")).group_by("e").count(),
        "host", None, [(False, 1), (True, 2)]),
    # F14: a float64 key on the host tier
    "f14_group_by_float64": (
        lambda ctx, fr: ctx.create_frame(
            f=np.array([0.1, 0.1 + 1e-12, 0.2]), x=np.arange(3))
        .group_by("f").count(),
        "host", None, [(0.1, 1), (0.1 + 1e-12, 1), (0.2, 1)]),
    "f14_join_on_float64": (
        lambda ctx, fr: ctx.create_frame(
            f=np.array([0.1, 0.1 + 1e-12, 0.2, 0.3]), x=np.arange(4))
        .join(ctx.create_frame(f=np.array([0.1, 0.3]), y=np.arange(2)),
              on="f"),
        "host", None, [(0.1, 0, 0), (0.3, 3, 1)]),
    "f14_group_nan_then_zero_then_minus_zero": (
        _f14_zeros(0.0, -0.0), "host", None,
        [(0.0, 2, 2), (0.1, 1, 1), (0.1 + 1e-12, 1, 5), (math.nan, 1, 0),
         (math.nan, 1, 4)]),
    "f14_group_minus_zero_first": (
        _f14_zeros(-0.0, 0.0), "host", None,
        [(-0.0, 2, 2), (0.1, 1, 1), (0.1 + 1e-12, 1, 5), (math.nan, 1, 0),
         (math.nan, 1, 4)]),
    "f14_inner_join_nan_and_zeros": (
        lambda ctx, fr: ctx.create_frame(
            f=np.array([0.1, np.nan, -0.0, 0.1 + 1e-12]), x=np.arange(4))
        .join(ctx.create_frame(f=np.array([0.0, np.nan, 0.1]),
                               y=np.arange(3)), on="f"),
        "host", None, [(-0.0, 2, 0), (0.1, 0, 2)]),
    "f14_left_join_nan_joins_nothing": (
        lambda ctx, fr: ctx.create_frame(
            f=np.array([np.nan, 0.1, np.nan, 0.1 + 1e-12]), x=np.arange(4))
        .join(ctx.create_frame(f=np.array([np.nan, 0.1]), y=np.array([7, 8])),
              on="f", how="left", fill_value=-1),
        "host", None, [(0.1, 1, 8), (0.1 + 1e-12, 3, -1), (math.nan, 0, -1),
                       (math.nan, 2, -1)]),
    "f14_sort_float64_beside_wide": (
        lambda ctx, fr: ctx.create_frame(
            f=np.array([0.1, 0.1 + 1e-12, 0.05, -3.0]), x=np.arange(4),
            w=np.full(4, 2**40)).sort("f", ascending=False),
        "host", 0, [(0.1 + 1e-12, 1, 2**40), (0.1, 0, 2**40),
                    (0.05, 2, 2**40), (-3.0, 3, 2**40)]),
    "f14_float64_key_meets_float32": (
        lambda ctx, fr: ctx.create_frame(
            f=np.array([0.1, float(np.float32(0.1)), 0.25]), x=np.arange(3))
        .join(ctx.create_frame(f=np.array([0.1, 0.25], np.float32),
                               y=np.arange(2)), on="f"),
        "host", None, [(0.25, 2, 1), (float(np.float32(0.1)), 1, 0)]),
    # F14: a float64 key meets an int32, bool or wide key: Python matches
    # 1 with 1.0 and True with 1.0; a wide int no float64 holds (2^53 + 1)
    # matches nothing; the join gives back the left key in its own form
    "f14_int32_key_meets_float64": (
        lambda ctx, fr: _mixed_keys(ctx, np.arange(4),
                                    np.array([1.0, 2.0, 2.5])),
        "host", None, [(1, 1, 10), (2, 2, 11)]),
    "f14_float64_key_meets_int32_left_join": (
        lambda ctx, fr: _mixed_keys(ctx, np.array([1.0, 2.0, 2.5]),
                                    np.arange(4), how="left"),
        "host", None, [(1.0, 0, 11), (2.0, 1, 12), (2.5, 2, -1)]),
    "f14_bool_key_meets_float64": (
        lambda ctx, fr: _mixed_keys(ctx, np.array([True, False, True]),
                                    np.array([1.0, 0.0, 3.0])),
        "host", None, [(False, 1, 11), (True, 0, 10), (True, 2, 10)]),
    "f14_float64_key_meets_bool_left_join": (
        lambda ctx, fr: _mixed_keys(ctx, np.array([1.0, 0.0, 3.0]),
                                    np.array([True, False]), how="left"),
        "host", None, [(0.0, 1, 11), (1.0, 0, 10), (3.0, 2, -1)]),
    "f14_wide_key_meets_float64_left_join": (
        lambda ctx, fr: _mixed_keys(
            ctx, np.array([2**40, 2**53 + 1, 3, 2**60, -2**63]),
            np.array([2.0**40, 2.0**53, 3.0, 2.0**60, -2.0**63, np.nan]),
            how="left"),
        "host", None, [(-2**63, 4, 14), (3, 2, 12), (2**40, 0, 10),
                       (2**53 + 1, 1, -1), (2**60, 3, 13)]),
    "f14_float64_key_meets_wide": (
        lambda ctx, fr: _mixed_keys(
            ctx, np.array([2.0**40, 2.0**53, 3.5, 2.0**60]),
            np.array([2**40, 2**53 + 1, 3, 2**60])),
        "host", None, [(2.0**40, 0, 10), (2.0**60, 3, 13)]),
    # F15: a left join's fill on the host tier
    "f15_float_fill": (
        lambda ctx, fr: ctx.create_frame(k=np.arange(4), x=np.arange(4))
        .join(ctx.create_frame(k=np.arange(2), w=np.arange(2),
                               v=2 * np.arange(2)),
              on="k", how="left", fill_value=0.5),
        "host", None, [(0, 0, 0.0, 0.0), (1, 1, 1.0, 2.0), (2, 2, 0.5, 0.5),
                       (3, 3, 0.5, 0.5)]),
    "f15_float_fill_over_wide": (
        lambda ctx, fr: ctx.create_frame(k=np.arange(3), x=np.arange(3))
        .join(ctx.create_frame(k=np.arange(2), w=np.array([2**40 + 1, 3]),
                               v=np.arange(2)),
              on="k", how="left", fill_value=0.5),
        "host", None, [(0, 0, 2.0**40 + 1, 0.0), (1, 1, 3.0, 1.0),
                       (2, 2, 0.5, 0.5)]),
    "f15_int_fill_past_int32": (
        lambda ctx, fr: ctx.create_frame(k=np.arange(3), x=np.arange(3))
        .join(ctx.create_frame(k=np.arange(2), w=np.arange(2),
                               v=2 * np.arange(2)),
              on="k", how="left", fill_value=2**40),
        "host", None, [(0, 0, 0, 0), (1, 1, 1, 2), (2, 2, 2**40, 2**40)]),
    # F16: a float64 value on the host tier
    "f16_sum_beside_string_min": (
        lambda ctx, fr: _f16(ctx, s=S("a", "b", "c", "d", "e", "f"))
        .group_by("k").agg(fr.F.sum("f"), fr.F.min("s")),
        "host", None, [(0, 1.0, "a"), (1, 2.0, "d"), (2, 0.3 + 1e8, "e")]),
    "f16_sum_after_a_join_with_two_values": (
        lambda ctx, fr: _f16(ctx).join(ctx.create_frame(
            k=np.arange(3), a=np.arange(3), b=np.arange(3) * 2), on="k")
        .group_by("b").agg(fr.F.sum("f"), fr.F.max("a")),
        "host", None, [(0, 1.0, 0), (2, 2.0, 1), (4, 0.3 + 1e8, 2)]),
    "f16_sum_beside_wide_sum": (
        lambda ctx, fr: _f16(ctx, w=np.full(6, 2**40)).group_by("k").agg(
            fr.F.sum("f"), fr.F.sum("w")),
        "host", None, [(0, 1.0, 3 * 2**40), (1, 2.0, 2**40),
                       (2, 0.3 + 1e8, 2**41)]),
    "f16_mean_min_max_and_a_stage": (
        lambda ctx, fr: _f16(ctx, s=S("a", "b", "c", "d", "e", "f"))
        .with_column("g", fr.col("f") * 3 + 0.1)
        .group_by("k").agg(fr.F.mean("f", "m"), fr.F.min("g", "lo"),
                           fr.F.max("f", "hi"), fr.F.min("s")),
        "host", None, [(0, 1 / 3, -3e8 + 0.1, 1e8, "a"),
                       (1, 2.0, 6.1, 2.0, "d"),
                       (2, (0.3 + 1e8) / 2, 0.4, 0.2 + 1e8, "e")]),
    "f16_sort_payload": (
        lambda ctx, fr: _f16(ctx, w=np.full(6, 2**40) + np.arange(6))
        .sort("w"),
        "host", 2, [(int(k), float(f), 2**40 + i) for i, (k, f) in
                    enumerate(zip(F16_KEYS, F16_VALUES))]),
    "f17_float32_sum_beside_string_min": (
        lambda ctx, fr: ctx.create_frame(
            k=F16_KEYS, f=F16_VALUES.astype(np.float32),
            s=S("a", "b", "c", "d", "e", "f")).group_by("k").agg(
                fr.F.sum("f"), fr.F.mean("f", "m"), fr.F.min("s")),
        "host", None, [(0, 1.0, 1 / 3, "a"), (1, 2.0, 2.0, "d"),
                       (2, float(np.float32(0.1)) + 1e8,
                        (float(np.float32(0.1)) + 1e8) / 2, "e")]),
    # F17: the host tier's numpy arithmetic and Python sums: an int or
    # bool column beside a float, or divided with /, computes in float64;
    # + - * of int32 columns and an int32 column's sum in int64; a
    # float32 column's sum in float64
    "f17_int_arithmetic_is_float64": (
        lambda ctx, fr: ctx.create_frame(
            k=np.arange(3), x=np.array([1, 3, 7]),
            f=np.array([0.1, 0.3, 0.7], np.float32),
            b=np.array([True, False, True]), s=S("a", "b", "c"))
        .with_column("g", fr.col("x") * 0.1)
        .with_column("h", fr.col("x") / 3)
        .with_column("i", fr.col("x") * fr.col("f"))
        .with_column("j", fr.col("b") / 3)
        .with_column("m", fr.col("x") * fr.col("x") - 1)
        .filter(fr.col("s") != fr.lit("z")).select("k", "g", "h", "i", "j",
                                                   "m"),
        "host", None, [
            (0, 0.1, 1 / 3, float(np.float32(0.1)), 1 / 3, 0),
            (1, 3 * 0.1, 1.0, 3 * float(np.float32(0.3)), 0.0, 8),
            (2, 7 * 0.1, 7 / 3, 7 * float(np.float32(0.7)), 1 / 3, 48)]),
    "f17_int_product_past_int32": (
        lambda ctx, fr: ctx.create_frame(
            k=np.arange(3), x=np.array([100000, 3, -70000]),
            s=S("a", "b", "c")).with_column("m", fr.col("x") * fr.col("x"))
        .with_column("p", fr.col("x") + 2**31 - 1)
        .filter(fr.col("s") != fr.lit("z")).select("k", "m", "p"),
        "host", None, [(0, 10**10, 100000 + 2**31 - 1),
                       (1, 9, 2**31 + 2), (2, 49 * 10**8, 2**31 - 70001)]),
    "f17_int_sum_past_int32": (
        lambda ctx, fr: ctx.create_frame(
            k=np.array([0, 0, 0, 1]), x=np.array([2**30, 2**30, 2**30, 5]),
            s=S("a", "b", "c", "d")).group_by("k").agg(
                fr.F.sum("x"), fr.F.mean("x", "m"), fr.F.count("n"),
                fr.F.min("s")),
        "host", None, [(0, 3 * 2**30, float(2**30), 3, "a"),
                       (1, 5, 5.0, 1, "d")]),
    # F18: a constant past int32 does not trace on the reference's device
    # tier, so the plan runs on its host tier, exact over the int64
    # source (X64 holds -2^31 and 2^31 - 1, int32 in the port)
    "f18_filter_below_2_40": (
        lambda ctx, fr: ctx.create_frame(x=X64).filter(fr.col("x") < 2**40),
        "host", None, [(-2**31,), (3,), (5,), (2**31 - 1,)]),
    "f18_filter_equal_past_int32": (
        lambda ctx, fr: ctx.create_frame(x=X64).filter(
            fr.col("x") == 2**32 + 5), "host", None, []),
    "f18_add_and_multiply_past_int32": (
        lambda ctx, fr: ctx.create_frame(x=X64)
        .with_column("q", fr.col("x") + 2**31)
        .with_column("m", fr.col("x") * 2**31),
        "host", None, [(int(x), int(x) + 2**31, int(x) * 2**31)
                       for x in X64]),
    "f18_group_key_past_int32": (
        lambda ctx, fr: ctx.create_frame(x=X64).with_column(
            "g", fr.col("x") % 2 + 2**40).group_by("g").count(),
        "host", None, [(2**40, 1), (2**40 + 1, 3)]),
    "f18_bool_times_past_int32": (
        lambda ctx, fr: ctx.create_frame(x=X64).with_column(
            "b", (fr.col("x") > 4) * 3_000_000_000).select("b"),
        "host", None, [(0,), (0,), (3_000_000_000,), (3_000_000_000,)]),
    "f18_constant_past_int32": (
        lambda ctx, fr: ctx.create_frame(x=X64[:2]).with_column(
            "c", fr.lit(2**40)), "host", None,
        [(-2**31, 2**40), (5, 2**40)]),
    # F19: an int32 source on the host tier computes in numpy's int32
    # and wraps; int32 beside an int64 source gives int64
    "f19_int32_source_wraps": (
        lambda ctx, fr: ctx.create_frame(
            x=X32, y=X64, s=S("a", "b", "c", "d"))
        .filter(fr.col("s") != fr.lit("z"))
        .with_column("p", fr.col("x") * fr.col("x"))
        .with_column("t", fr.col("x") * 3)
        .with_column("d", fr.col("x") + fr.col("x"))
        .with_column("n", -fr.col("x"))
        .with_column("w", fr.col("x") + fr.col("y"))
        .select("x", "p", "t", "d", "n", "w"),
        "host", None, _rows_of(X32, X32 * X32, X32 * np.int32(3), X32 + X32,
                               -X32, X32 + X64)),
    "f19_int32_division_by_zero_and_minus_one": (
        lambda ctx, fr: ctx.create_frame(
            x=X32, z=np.array([0, -1, 2, 0], np.int32),
            s=S("a", "b", "c", "d"))
        .filter(fr.col("s") != fr.lit("z"))
        .with_column("q", fr.col("x") // fr.col("z"))
        .with_column("r", fr.col("x") % fr.col("z"))
        .select("x", "q", "r"),
        "host", None, [(100000, 0, 0), (-2**31, -2**31, 0), (3, 1, 1),
                       (7, 0, 0)]),
    "f19_narrow_sources_wrap_in_their_width": (
        lambda ctx, fr: ctx.create_frame(
            a=np.array([100, -100, 7], np.int8),
            u=np.array([3, 2**32 - 1, 0], np.uint32),
            h=np.array([40000, 1, 65535], np.uint16),
            s=S("a", "b", "c"))
        .filter(fr.col("s") != fr.lit("z"))
        .with_column("a2", fr.col("a") * 2)
        .with_column("u5", fr.col("u") - 5)
        .with_column("h2", fr.col("h") * fr.col("h"))
        .with_column("au", fr.col("a") + fr.col("u"))
        .select("a2", "u5", "h2", "au"),
        "host", None, [(-56, 2**32 - 2, 40000 * 40000 % 2**16, 103),
                       (56, 2**32 - 6, 1, 2**32 - 101),
                       (14, 2**32 - 5, 1, 7)]),
    "f19_int32_source_sums_exactly": (
        lambda ctx, fr: ctx.create_frame(
            k=np.array([0, 0, 1], np.int32),
            x=np.array([2**30, 2**30, 5], np.int32), s=S("a", "b", "c"))
        .with_column("x2", fr.col("x") * 2)
        .group_by("k").agg(fr.F.sum("x2"), fr.F.min("s")),
        "host", None, [(0, -2**32, "a"), (1, 10, "c")]),
    "f19_after_an_exchange_ints_are_pythons": (
        lambda ctx, fr: ctx.create_frame(
            k=np.array([100000, -70000, 100000], np.int32),
            x=np.array([2**31 - 1, 5, 2**31 - 1], np.int32),
            s=S("a", "b", "c"))
        .group_by("k").agg(fr.F.max("x", "mx"), fr.F.min("s"))
        .with_column("kk", fr.col("k") * fr.col("k"))
        .with_column("m3", fr.col("mx") * 3).select("k", "kk", "m3"),
        "host", None, [(100000, 10**10, 3 * (2**31 - 1)),
                       (-70000, 49 * 10**8, 15)]),
    # F17's rest: an int64 source's negation and floor division by -1 or
    # by a column leave int32; // by another literal and % stay in it
    "f17_negation_and_floor_division_of_int64": (
        lambda ctx, fr: ctx.create_frame(
            x=X64, z=np.array([-1, -1, 2, -1]), s=S("a", "b", "c", "d"))
        .filter(fr.col("s") != fr.lit("z"))
        .with_column("n", -fr.col("x"))
        .with_column("d", fr.col("x") // -1)
        .with_column("c", fr.col("x") // fr.col("z"))
        .with_column("e", fr.col("x") // 8)
        .with_column("r", fr.col("x") % fr.col("z"))
        .select("x", "n", "d", "c", "e", "r"),
        "host", None, [(int(x), -int(x), -int(x), int(x) // int(z),
                        int(x) // 8, int(x) % int(z))
                       for x, z in zip(X64, (-1, -1, 2, -1))]),
    "f17_key_by_floor_division": (
        lambda ctx, fr: ctx.create_frame(
            k=np.arange(40) - 20, s=S(*("ab" * 20)))
        .with_column("g", fr.col("k") // 8).group_by("g").agg(
            fr.F.count("n"), fr.F.min("s")),
        "host", None, [(-3, 4, "a"), (-2, 8, "a"), (-1, 8, "a"), (0, 8, "a"),
                       (1, 8, "a"), (2, 4, "a")]),
    # the agreements
    "agree_int32_and_int64_sources_on_the_device_tier": (
        lambda ctx, fr: ctx.create_frame(x=X32, y=X64)
        .with_column("m", fr.col("x") % 7)
        .with_column("d", fr.col("y") // -1)
        .with_column("s", fr.col("x") + fr.col("y")),
        "device", None, _rows_of(X32, X64, X32 % 7, -X64.astype(np.int32),
                                 X32 + X64.astype(np.int32))),
    "agree_float32_times_a_constant_on_the_host_tier": (
        lambda ctx, fr: ctx.create_frame(
            k=np.arange(3), f=np.array([0.1, 0.3, 0.7], np.float32),
            s=S("a", "b", "c")).with_column("g", fr.col("f") * 0.1)
        .filter(fr.col("s") != fr.lit("z")).select("k", "g"),
        "host", None, [(i, float(np.float32(v) * np.float32(0.1)))
                       for i, v in enumerate((0.1, 0.3, 0.7))]),
    "agree_float64_sum_alone": (
        lambda ctx, fr: _f16(ctx).group_by("k").agg(fr.F.sum("f")),
        "device", None, [(0, 0.0, ), (1, 2.0), (2, 100000000.0)]),
    "agree_float64_sum_beside_max": (
        lambda ctx, fr: _f16(ctx, x=np.arange(6)).group_by("k").agg(
            fr.F.sum("f"), fr.F.max("x")),
        "device", None, [(0, 0.0, 2), (1, 2.0, 3), (2, 100000000.0, 5)]),
    "agree_source_bool_sum": (
        lambda ctx, fr: ctx.create_frame(x=X6, k=X6 % 2, b=X6 > 2)
        .group_by("k").agg(fr.F.sum("b"), fr.F.max("x")),
        "device", None, [(0, 1, 4), (1, 2, 5)]),
    "agree_count_beside_bool_max": (
        lambda ctx, fr: _bools(ctx, fr).group_by("k").agg(
            fr.F.count("n"), fr.F.max("b")),
        "device", None, [(0, 3, True), (1, 3, True)]),
    "agree_float64_sort_narrows": (
        lambda ctx, fr: ctx.create_frame(
            f=np.array([0.1, 0.1 + 1e-12, 0.05]), x=np.arange(3)).sort("f"),
        "device", 0, [(float(np.float32(0.05)), 2),
                      (float(np.float32(0.1)), 0),
                      (float(np.float32(0.1)), 1)]),
    "agree_left_join_one_int32_column": (
        lambda ctx, fr: ctx.create_frame(k=np.arange(4), x=np.arange(4))
        .join(ctx.create_frame(k=np.arange(2), w=np.arange(2) + 5),
              on="k", how="left", fill_value=0.5),
        "device", None, [(0, 0, 5), (1, 1, 6), (2, 2, 0), (3, 3, 0)]),
}


def _rows(q, ordered_by):
    rows = q.collect()
    return rows if ordered_by is not None else sorted(rows, key=_order_key)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tier_rules_match_the_reference(ctxs, name):
    build, tier, ordered_by, expect = CASES[name]
    ref, port = ctxs
    rq, pq = build(ref, ref_frame), build(port, port_frame)
    assert _ref_tier(rq) == tier
    want, got = _rows(rq, ordered_by), _rows(pq, ordered_by)
    if ordered_by is not None:
        # ties of the sort column may come in either order: the column in
        # order, the rows as sets
        assert [r[ordered_by] for r in got] == [r[ordered_by] for r in want]
        _exact([r[ordered_by:ordered_by + 1] for r in got],
               [r[ordered_by:ordered_by + 1] for r in want])
        want = sorted(want, key=_order_key)
        got = sorted(got, key=_order_key)
    _exact(got, want)
    if expect is not None:
        _exact(got, sorted(expect, key=_order_key))
    assert pq.count() == len(got)


def test_dtypes_follow_the_tier(ctxs):
    """The port's column dtypes under each tier's rules: a host-tier float
    fill makes an int32 column float64 and an int fill past int32 a wide
    one; a float64 source and its mean stay float64 on the host tier and
    narrow on the device tier; a bool key comes back bool; a host-tier
    bool sum counts the True rows and its mean is a float64; a host-tier
    int32 sum is an int64, a float32 sum a float64, and the host's numpy
    arithmetic gives float64 and int64. A host-tier count and bool sum are
    int64, as numpy holds the host's Python ints; a device-tier count
    stays int32 (test_device_tier_count_stays_int32)."""
    _ref, port = ctxs
    cols = CASES["f15_float_fill"][0](port, port_frame).collect_columns()
    assert cols["w"].dtype == cols["v"].dtype == np.float64
    cols = CASES["f15_int_fill_past_int32"][0](
        port, port_frame).collect_columns()
    assert cols["w"].dtype == np.int64
    cols = CASES["f16_mean_min_max_and_a_stage"][0](
        port, port_frame).collect_columns()
    assert all(cols[c].dtype == np.float64 for c in ("m", "lo", "hi"))
    cols = CASES["agree_float64_sum_alone"][0](
        port, port_frame).collect_columns()
    assert cols["sum_f"].dtype == np.float32
    cols = CASES["f13_group_by_bool"][0](port, port_frame).collect_columns()
    assert cols["b"].dtype == np.bool_
    cols = CASES["f12_count_beside_wide"][0](
        port, port_frame).collect_columns()
    assert cols["n"].dtype == np.int64 and cols["m"].dtype == np.float64
    cols = CASES["f17_int_sum_past_int32"][0](
        port, port_frame).collect_columns()
    assert cols["sum_x"].dtype == np.int64 and cols["n"].dtype == np.int64
    cols = CASES["f18_group_key_past_int32"][0](
        port, port_frame).collect_columns()
    assert cols["g"].dtype == cols["count"].dtype == np.int64
    cols = CASES["f17_float32_sum_beside_string_min"][0](
        port, port_frame).collect_columns()
    assert cols["sum_f"].dtype == cols["m"].dtype == np.float64
    cols = CASES["f17_int_arithmetic_is_float64"][0](
        port, port_frame).collect_columns()
    assert [str(cols[c].dtype) for c in "ghijm"] == \
        ["float64", "float64", "float64", "float64", "int64"]


# one column of each numpy dtype a frame source may have (no zero, so
# every integer divides by every other), and a string column whose
# predicate sends the plan to the reference's host tier
NP_COLUMNS = {
    "i8": np.array([100, -100, 7, -3, 127, -128], np.int8),
    "u8": np.array([200, 1, 255, 7, 3, 128], np.uint8),
    "i16": np.array([30000, -30000, 7, -3, 32767, -32768], np.int16),
    "u16": np.array([60000, 1, 65535, 7, 3, 40000], np.uint16),
    "i32": np.array([2**31 - 1, -2**31, 100000, -70000, 3, -5], np.int32),
    "u32": np.array([2**32 - 1, 2**31, 5, 100000, 3, 7], np.uint32),
    "i64": np.array([5, -2**31, 3, 2**31 - 1, -9, 11]),
    "b": np.array([True, False, True, True, False, True]),
    "f32": np.array([0.5, -1.5, 3.25, 100.0, -7.0, 1e-3], np.float32),
}
NP_OPS = ("+", "-", "*", "/", "//", "%", "<", "==", "&")


@pytest.mark.parametrize("op", NP_OPS)
def test_host_arithmetic_is_numpys(ctxs, op):
    """Every pair of source dtypes under one operator, each column with the
    constants 3 and 100 on either side, and - and ~ of each column, on
    the reference's host tier before its first exchange: the port's rows
    equal numpy's, wrapping in each narrow dtype, exact in int64, float32
    where numpy keeps it. numpy refuses bool - bool and & with a float;
    bools do not divide (an int64 column divided by False raises in the
    port, where numpy gives 0)."""
    ref, port = ctxs
    names = list(NP_COLUMNS)
    exprs = []
    for a, b in [(a, b) for a in names for b in names + [3, 100]] + [
            (c, b) for c in (3, 100) for b in names]:
        if "f32" in (a, b) and op == "&":
                continue
        if a == "b" and b == "b" and op == "-":
            continue
        if op in ("//", "%", "/") and "b" in (a, b):
            continue
        exprs.append((a, b))

    def build(ctx, fr):
        q = ctx.create_frame(**NP_COLUMNS, s=S(*"abcdef")).filter(
            fr.col("s") != fr.lit("z"))
        out = []
        for i, (a, b) in enumerate(exprs):
            lhs, rhs = (fr.col(x) if isinstance(x, str) else fr.lit(x)
                        for x in (a, b))
            q = q.with_column(f"e{i}", fr.expr.BinOp(op, lhs, rhs))
            out.append(f"e{i}")
        for i, (a, kind) in enumerate(
                (a, kind) for a in names for kind in "-~"
                if not (a == "b" and kind == "-")
                and not (a == "f32" and kind == "~")):
            q = q.with_column(f"u{i}", fr.expr.UnaryOp(kind, fr.col(a)))
            out.append(f"u{i}")
        return q.select(*out)

    rq, pq = build(ref, ref_frame), build(port, port_frame)
    assert _ref_tier(rq) == "host"
    with np.errstate(all="ignore"):
        want = rq.collect()
    got = pq.collect()
    for i in range(len(want[0])):
        _exact(sorted([(r[i],) for r in got], key=_order_key),
               sorted([(r[i],) for r in want], key=_order_key))


def test_device_tier_count_stays_int32(ctxs):
    _ref, port = ctxs
    cols = CASES["agree_count_beside_bool_max"][0](
        port, port_frame).collect_columns()
    assert cols["n"].dtype == np.int32


def _exchange_key_words(q) -> int:
    """How many words the exchange key of a group-by takes: 1 for an
    int32 key, which the hash_bucket kernel hashes, 2 for a wide one
    (hash32_pair)."""
    node = q._compiled().rdd
    while not isinstance(node, dense_rdd._ReduceByKeyRDD):
        node = node.parent
    schema = dict(node.parent._schema())
    return 2 if dense_rdd.KEY_LO in schema else 1


@pytest.mark.parametrize("key, words", [
    (lambda fr: fr.col("k") // 8, 1), (lambda fr: fr.col("k") % 5, 1),
    (lambda fr: fr.col("k") % fr.col("z"), 1),
    (lambda fr: fr.col("k") // -1, 2), (lambda fr: -fr.col("k"), 2),
    (lambda fr: fr.col("k") // fr.col("z"), 2),
    (lambda fr: fr.col("k") + 1, 2)], ids=[
        "floordiv_8", "mod_5", "mod_column", "floordiv_minus_1", "negate",
        "floordiv_column", "plus_1"])
def test_host_tier_keys_stay_int32_where_proven(ctxs, key, words):
    """A host-tier key over an int64 source held as int32 keeps one word
    where its value provably fits int32 (// by a literal other than 0 and
    -1, % by anything of int32), and takes the wide pair where it may
    leave int32; the rows equal the reference's either way."""
    ref, port = ctxs
    k = np.array([-2**31, -9, 0, 7, 2**31 - 1, 16])
    z = np.array([3, -1, 5, -1, 7, 2])

    def build(ctx, fr):
        return ctx.create_frame(k=k, z=z, s=S(*"abcdef")).with_column(
            "g", key(fr)).group_by("g").agg(fr.F.count("n"), fr.F.min("s"))

    rq, pq = build(ref, ref_frame), build(port, port_frame)
    assert _ref_tier(rq) == "host"
    _exact(sorted(pq.collect(), key=_order_key),
           sorted(rq.collect(), key=_order_key))
    assert _exchange_key_words(pq) == words


@pytest.mark.parametrize("host", [False, True], ids=["alone", "host_plan"])
def test_int32_source_past_int32_raises(ctxs, host):
    """An int32 source meets a constant past int32: the reference's trace
    refuses it and its host tier's numpy raises OverflowError (NEP 50);
    the port raises VegaError naming it, when the plan compiles."""
    ref, port = ctxs

    def build(ctx, fr):
        q = ctx.create_frame(x=X32, s=S("a", "b", "c", "d"))
        if host:
            q = q.filter(fr.col("s") != fr.lit("z"))
        return q.with_column("q", fr.col("x") + 2**40)

    with pytest.raises(Exception, match="OverflowError.*out of bounds"):
        build(ref, ref_frame).collect()
    q = build(port, port_frame)
    assert _port_tier(q)[0] == "host"
    for action in (q.collect, q.explain):
        with pytest.raises(VegaError, match="OverflowError: Python integer "
                           "1099511627776 out of bounds for int32"):
            action()


def test_explain_names_the_reference_tier(ctxs):
    """explain() carries the reference's tier in one line, its reason
    beside a host tier."""
    _ref, port = ctxs
    text = CASES["f12b_count_beside_string_min"][0](
        port, port_frame).explain()
    assert text.startswith("== physical: device tier ==")
    assert ("-- reference tier: host (mixed-op aggregation with a string "
            "column has no device combiner; host tier aggregates it)") in \
        text.splitlines()
    text = CASES["f12a_or_beside_max"][0](port, port_frame).explain()
    assert "-- reference tier: device" in text.splitlines()


# ------------------------------------------------------------ refusals


def test_all_add_bool_sum_refused_by_both(ctxs):
    """Every aggregate an add over a computed bool: the reference's named
    add raises TypeError (jnp's add takes no bool), the port VegaError
    saying so."""
    ref, port = ctxs
    for build in (lambda ctx, fr: _f12(ctx, fr, fr.F.sum("b")),
                  lambda ctx, fr: _f12(ctx, fr, fr.F.sum("b"),
                                       fr.F.sum("x"))):
        rq = build(ref, ref_frame)
        assert _ref_tier(rq) == "device"
        with pytest.raises(TypeError):
            rq.collect()
        with pytest.raises(VegaError, match="the reference refuses it"):
            build(port, port_frame).collect()


def test_string_fill_over_a_number_column_is_refused(ctxs):
    """A string fill over an int column beside a string column: the
    reference's host tier turns the int column into strings ('0', '1',
    'none') in collect() (its to_rdd() rows keep the ints beside the
    fill); no device column holds strings and numbers in one, so the port
    compiles the plan on its host tier too, with the same rows."""
    ref, port = ctxs

    def build(ctx, fr):
        return ctx.create_frame(k=np.arange(4), x=np.arange(4)).join(
            ctx.create_frame(k=np.arange(2), w=np.arange(2),
                             s=S("a", "b")),
            on="k", how="left", fill_value="none").sort("k")

    rq = build(ref, ref_frame)
    assert _ref_tier(rq) == "host"
    rows = [(0, 0, "0", "a"), (1, 1, "1", "b"), (2, 2, "none", "none"),
            (3, 3, "none", "none")]
    assert rq.collect() == rows
    q = build(port, port_frame)
    text = q.explain()
    assert text.startswith("== physical: host tier ==")
    assert "string fill 'none' over the number column 'w'" in text
    assert q.collect() == rows and q.count() == 4
    assert q.to_rdd().collect() == rq.to_rdd().collect() == [
        (0, 0, 0, "a"), (1, 1, 1, "b"), (2, 2, "none", "none"),
        (3, 3, "none", "none")]


def test_tier_device_on_a_host_plan_raises_as_the_reference(ctxs):
    """hint(tier="device") on a plan the reference compiles on its host
    tier: both raise "tier='device' requested but the plan has no device
    lowering", with the same reason; on a device plan both run."""
    ref, port = ctxs
    build = CASES["f13_group_by_bool"][0]
    with pytest.raises(v.errors.VegaError) as rei:
        build(ref, ref_frame).hint(tier="device").collect()
    with pytest.raises(VegaError) as pei:
        build(port, port_frame).hint(tier="device").collect()
    assert str(pei.value) == str(rei.value)
    assert str(pei.value).startswith(
        "tier='device' requested but the plan has no device lowering: ")
    build = CASES["f12a_or_beside_max"][0]
    assert sorted(build(port, port_frame).hint(tier="device").collect()) \
        == sorted(build(ref, ref_frame).hint(tier="device").collect())


# ------------------------------------------------------------ pinned


def test_string_fill_then_a_predicate(ctxs):
    """A left join fills the string column s with '0', then a filter on
    s == '0'. The reference's host tier holds the fill as the int 0 (its
    collect() shows '0'), so the predicate keeps nothing; the port's fill
    is the string '0' in s's dictionary, so it keeps the unmatched rows,
    as both packages' collect() of the join shows them."""
    ref, port = ctxs

    def joined(ctx, fr):
        return ctx.create_frame(k=np.arange(6) % 3, x=np.arange(6)).join(
            ctx.create_frame(k=np.arange(2), s=S("a", "b"), w=np.arange(2)),
            on="k", how="left")

    def build(ctx, fr):
        return joined(ctx, fr).filter(fr.col("s") == fr.lit("0")) \
            .select("x")

    want = [(2, 2, "0", 0), (2, 5, "0", 0)]
    assert sorted(r for r in joined(ref, ref_frame).collect()
                  if r[0] == 2) == want
    assert sorted(r for r in joined(port, port_frame).collect()
                  if r[0] == 2) == want
    assert _ref_tier(build(ref, ref_frame)) == "host"
    assert build(ref, ref_frame).collect() == []
    assert sorted(build(port, port_frame).collect()) == [(2,), (5,)]


def test_float_join_key_across_zeros(ctxs):
    """A left join on a float key whose left side holds -0.0 then 0.0,
    against a right 0.0: the reference's host tier keys both zero rows
    -0.0 (the first zero's sign, its cogroup key); the port keeps each
    left row's own key. Signs compared."""
    ref, port = ctxs

    def build(ctx, fr):
        return ctx.create_frame(
            f=np.array([0.5, np.nan, -0.0, 0.0, -1.5, np.nan, 2.0]),
            x=np.arange(7)).join(ctx.create_frame(
                f=np.array([0.0, np.nan, 2.0]), y=np.arange(3)),
                on="f", how="left")

    def zeros(rows):
        return sorted((r[1], math.copysign(1.0, r[0])) for r in rows
                      if r[0] == 0)

    rq, pq = build(ref, ref_frame), build(port, port_frame)
    assert _ref_tier(rq) == "host"
    assert zeros(rq.collect()) == [(2, -1.0), (3, -1.0)]
    assert zeros(pq.collect()) == [(2, -1.0), (3, 1.0)]
    # every other row agrees
    rest = [r for r in pq.collect() if r[0] != 0]
    _exact(sorted(rest, key=_order_key),
           sorted((r for r in rq.collect() if r[0] != 0), key=_order_key))


def test_left_join_fill_none(ctxs):
    """A frame left join with fill_value=None: the reference's host tier
    fills None; a device column cannot hold None, so the port compiles
    the plan on its host tier and fills None too."""
    ref, port = ctxs

    def build(ctx, fr):
        return ctx.create_frame(k=np.arange(3), x=np.arange(3)).join(
            ctx.create_frame(k=np.arange(2), y=np.arange(2) * 7), on="k",
            how="left", fill_value=None).sort("k")

    rq = build(ref, ref_frame)
    assert _ref_tier(rq) == "host"
    assert rq.collect() == [(0, 0, 0), (1, 1, 7), (2, 2, None)]
    q = build(port, port_frame)
    assert q.explain().startswith("== physical: host tier ==")
    assert q.collect() == [(0, 0, 0), (1, 1, 7), (2, 2, None)]
    assert q.count() == 3


# ------------------------------------------------------------ the tier


def _frame_verbs():
    out = {}
    for name, (build, _ordered) in frame_cases.VERBS.items():
        def make(ctx, fr, build=build):
            xp = None
            if fr is port_frame:
                import torch as xp
            else:
                import jax.numpy as xp
            ns = types.SimpleNamespace(F=fr.F, col=fr.col, lit=fr.lit,
                                       udf=fr.udf, xp=xp)
            return build(ctx.create_frame(**frame_cases._data()), ns)
        out["frame_verb_" + name] = make
    return out


def _tier_cases():
    cases = _frame_verbs()
    for name, (build, _reason) in frame_cases.FALLBACKS.items():
        cases["frame_fallback_" + name] = build
    for name, (build, _o, _e) in host_cases.CASES.items():
        cases["host_" + name] = build
    for name, build in host_cases.SEEDED.items():
        cases["host_seeded_" + name] = build
    for name, (build, _reason) in host_cases.REFUSED.items():
        cases["host_refused_" + name] = build
    for name, (build, _t, _o, _e) in CASES.items():
        cases["tiers_" + name] = build
    return cases


TIER_CASES = _tier_cases()


@pytest.mark.parametrize("name", sorted(TIER_CASES))
def test_reference_tier_is_the_references(ctxs, name):
    """The port's reference_tier() names the tier the reference's explain()
    prints, on every frame parity case of the three files."""
    ref, port = ctxs
    build = TIER_CASES[name]
    assert _port_tier(build(port, port_frame))[0] == \
        _ref_tier(build(ref, ref_frame))


def _string_key_case(case):
    """test_torch_frame.py's string-key queries (its
    test_string_keys_match_reference builds them inline)."""
    def build(ctx, fr):
        names = frame_cases.NAMES
        dims = ctx.create_frame(name=S("ada", "cy", "dan"),
                                w=np.array([10, 20, 30]))
        g = ctx.create_frame(name=names, x=np.arange(6)).group_by("name").agg(
            fr.F.sum("x", "sx"), fr.F.count("n")).sort("name")
        if case == "group_sort":
            return g
        if case == "join":
            return g.select("name", "sx").join(dims, on="name").sort("name")
        if case == "left_join_key":
            return g.select("name", "sx").join(
                dims, on="name", how="left", fill_value=-1).sort("name")
        if case == "agg_min_max":
            return ctx.create_frame(
                k=np.arange(5) % 2,
                s=S("pear", "apple", "fig", "apple", "date")).group_by(
                    "k").agg(fr.F.max("s", "hi"))
        return ctx.create_frame(
            name=S("pear", "apple", "fig", "apple", "date"),
            x=np.arange(5)).select("name", "x").sort("name")
    return build


@pytest.fixture(scope="module")
def parquet_files(tmp_path_factory):
    """The parquet files of the frame parity tests: six int columns, a
    string column with nulls, an int64 column beyond int32 and a string
    column read under a pushed-down conjunct."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    root = tmp_path_factory.mktemp("tiers")
    n = 1000
    pq.write_table(pa.table({f"c{i}": np.arange(n) * (i + 1)
                             for i in range(6)}),
                   str(root / "ints.parquet"), row_group_size=100)
    pq.write_table(pa.table({"w": ["a", None, "b", "a"], "x": [1, 2, 3, 4]}),
                   str(root / "nulls.parquet"))
    pq.write_table(pa.table({"k": np.array([1, 2, 3]),
                             "big": np.array([2**40, 2, 3])}),
                   str(root / "wide.parquet"))
    words = np.array([f"w{i % 30:02d}" for i in range(400)])
    pq.write_table(pa.table({"w": words, "x": np.arange(400)}),
                   str(root / "words.parquet"), row_group_size=100)
    return {nm: str(root / f"{nm}.parquet")
            for nm in ("ints", "nulls", "wide", "words")}


PARQUET_CASES = {
    "select": ("ints", lambda df, fr: df.select("c0", "c3")),
    "pushdown": ("ints", lambda df, fr: df.filter(fr.col("c0") < 100)
                 .select("c0", "c2")),
    "group_join_sort": ("ints", lambda df, fr: df.with_column(
        "g", fr.col("c0") % 7).group_by("g").agg(fr.F.sum("c1", "s"))
        .join(df.with_column("g", fr.col("c0") % 5).group_by("g")
              .agg(fr.F.max("c2", "m")), on="g").sort("g")),
    "string_nulls": ("nulls", lambda df, fr: df.select("w", "x")),
    "int64_without_proof": ("wide", lambda df, fr: df.select("k", "big")),
    "string_pushdown": ("words", lambda df, fr: df.filter(
        fr.col("w") == fr.lit("w07")).select("w", "x")),
}


@pytest.mark.parametrize("name", sorted(PARQUET_CASES) + [
    "string_key_" + c for c in ("group_sort", "join", "sort_ties",
                                "agg_min_max", "left_join_key")])
def test_reference_tier_of_parquet_and_string_key_cases(ctxs, parquet_files,
                                                        name):
    """The same for test_torch_frame.py's parquet and string-key queries
    and test_torch_frame_host.py's parquet scans (built inline there): the
    scan's verdicts (string columns with nulls, an int64 column with no
    statistics proving it fits int32, a string conjunct pushed into the
    reader) and the exchange keys of string columns."""
    ref, port = ctxs
    if name.startswith("string_key_"):
        build = _string_key_case(name[len("string_key_"):])
        rq, pq = build(ref, ref_frame), build(port, port_frame)
    else:
        file, build = PARQUET_CASES[name]
        path = parquet_files[file]
        rq = build(ref.read_parquet(path), ref_frame)
        pq = build(port.read_parquet(path), port_frame)
    tier, why = _port_tier(pq)
    assert tier == _ref_tier(rq)
    if tier == "host":
        assert why == ref_frame.planner.last_fallback()
