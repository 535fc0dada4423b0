"""Outer joins, set ops, union and zips of vega_tpu_torch against
vega_tpu, on the CPU.

left_outer_join (duplicate keys on both sides, per-side elision, the fill
value cast to the right column's dtype), distinct / intersection /
subtract, union, zip and zip_with_index run through a vega_tpu
Context("local") on the 8-device CPU mesh and through vega_tpu_torch's
Context(device="cpu", n_shards=8), both under the card's plans, on inputs
from a numpy seed. Every comparison is exact, with equal per-shard counts
and row order: nothing here sums floats.
"""

import numpy as np
import pytest
import torch

import vega_tpu as v
from vega_tpu.errors import VegaError as RefVegaError
from vega_tpu.tpu import kernels as ref_kernels
import vega_tpu_torch as vt
from vega_tpu_torch import kernels as port_kernels
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


RNG = np.random.RandomState(5)
X = RNG.randint(0, 100_000, size=12_000).astype(np.int32)


# ---------------------------------------------------------------------------
# left_outer_join
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fill", [0, -1, 2.5])
@pytest.mark.parametrize("right_dtype", [np.int32, np.float32])
def test_left_outer_join_duplicates_both_sides(ctxs, fill, right_dtype):
    """Left keys 0..59, right keys the even ones below 40, duplicates on
    both sides: matched rows give the dup x dup product, unmatched left
    rows keep the fill, cast to the right column's dtype. Neither side is
    hash-placed, so both exchange; the product outgrows the exchange's
    capacity, so the exact rerun runs too."""
    ref, port = ctxs
    rng = np.random.RandomState(6)
    lk = rng.randint(0, 60, size=4_000).astype(np.int32)
    lv = rng.randint(-9, 9, size=4_000).astype(np.int32)
    rk = (rng.randint(0, 20, size=600) * 2).astype(np.int32)
    rv = rng.randint(0, 1_000, size=600).astype(right_dtype)

    def run(ctx):
        return ctx.dense_from_numpy(lk, lv).left_outer_join(
            ctx.dense_from_numpy(rk, rv), fill_value=fill)

    exp, got = run(ref), run(port)
    _same(got, exp)
    n_right = np.bincount(rk, minlength=60)
    assert got.count() == int(np.maximum(n_right[lk], 1).sum())
    rows = got.collect_arrays()
    assert rows["rv"].dtype == rv.dtype
    unmatched = n_right[rows["k"]] == 0
    np.testing.assert_array_equal(rows["rv"][unmatched],
                                  np.asarray(fill, dtype=rv.dtype))


def test_left_outer_join_elides_the_reduced_side(ctxs):
    """A reduce output on the left skips its exchange (and sort); a warm
    rerun launches deferred and equals the reference too."""
    ref, port = ctxs
    table_k = np.arange(0, 3_000, 2, dtype=np.int32)
    table_v = np.arange(1_500, dtype=np.int32) * 3

    def run(ctx):
        red = ctx.dense_range(30_000).map(lambda x: (x % 3_000, x)) \
            .reduce_by_key(lambda a, b: a ^ b)
        return red.left_outer_join(ctx.dense_from_numpy(table_k, table_v),
                                   fill_value=-1)

    exp = run(ref)
    for got in (run(port), run(port)):
        _same(got, exp)
    again = run(port)
    assert again.block_spec().settle is not None
    _same(again, exp)
    rows = again.collect_arrays()
    np.testing.assert_array_equal(rows["rv"],
                                  np.where(rows["k"] % 2 == 0,
                                           rows["k"] // 2 * 3, -1))


@pytest.mark.parametrize("fill,expect", [(0.5, 0), (-1.5, -1)])
def test_outer_join_fill_takes_the_column_dtype(ctxs, fill, expect):
    """A float fill over an int32 right column gives int32 values, as the
    reference's jnp.asarray(fill, dtype=col.dtype): 0.5 -> 0, -1.5 -> -1
    (torch.where with a Python float would promote the column to
    float32). At the kernel and through left_outer_join."""
    ref, port = ctxs
    lk = np.array([[1, 2, 3, 4]], dtype=np.int32)
    rk = np.array([[2, 4, 9, 9]], dtype=np.int32)
    rv = np.array([[20, 40, 90, 91]], dtype=np.int32)
    count = np.array([4], dtype=np.int32)
    got, gcount, _ = port_kernels.merge_join_expand(
        {"k": torch.from_numpy(lk)}, torch.from_numpy(count),
        {"k": torch.from_numpy(rk), "v": torch.from_numpy(rv)},
        torch.from_numpy(count), "k", 8, outer=True, fill_value=fill)
    exp, ecount, _ = ref_kernels.merge_join_expand(
        {"k": lk[0]}, count[0], {"k": rk[0], "v": rv[0]}, count[0], "k", 8,
        outer=True, fill_value=fill)
    assert got["r_v"].dtype == torch.int32
    n = int(ecount)
    assert int(gcount[0]) == n == 4
    np.testing.assert_array_equal(got["r_v"][0, :n].numpy(),
                                  np.asarray(exp["r_v"])[:n])
    assert got["r_v"][0, :n].tolist() == [expect, 20, expect, 40]

    def run(ctx):
        return ctx.dense_from_numpy(lk[0], lk[0]).left_outer_join(
            ctx.dense_from_numpy(rk[0], rv[0]), fill_value=fill)

    e, g = run(ref), run(port)
    _same(g, e)
    assert dict(g._schema())["rv"] == torch.int32


def test_left_outer_join_fill_none_raises(ctxs):
    """fill_value=None goes to the reference's host tier (a dense column
    cannot hold None): the port raises."""
    _ref, port = ctxs
    a = port.dense_from_numpy(np.arange(10, dtype=np.int32),
                              np.arange(10, dtype=np.int32))
    with pytest.raises(VegaError, match="host tier"):
        a.left_outer_join(a, fill_value=None)
    named = port.dense_from_columns({"x": np.arange(10), "y": np.arange(10),
                                     "z": np.arange(10)}, key="x")
    with pytest.raises(VegaError, match="canonical"):
        a.left_outer_join(named)


# ---------------------------------------------------------------------------
# distinct / intersection / subtract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_set_ops_match_reference_and_numpy(ctxs, dtype):
    """The set ops of x % (n / 7) and x % (n / 11): exact against the
    reference and against np.unique / np.intersect1d / np.isin; subtract
    keeps self's duplicates."""
    ref, port = ctxs
    a_np = (X % (len(X) // 7)).astype(dtype)
    b_np = (X % (len(X) // 11)).astype(dtype)

    def run(ctx):
        a, b = ctx.dense_from_numpy(a_np), ctx.dense_from_numpy(b_np)
        return {"distinct": a.distinct(), "intersection": a.intersection(b),
                "subtract": a.subtract(b)}

    exp, got = run(ref), run(port)
    for name in exp:
        _same(got[name], exp[name])
    np.testing.assert_array_equal(np.sort(got["distinct"].collect()),
                                  np.unique(a_np))
    np.testing.assert_array_equal(np.sort(got["intersection"].collect()),
                                  np.intersect1d(a_np, b_np))
    np.testing.assert_array_equal(np.sort(got["subtract"].collect()),
                                  np.sort(a_np[~np.isin(a_np, b_np)]))


def test_set_ops_refuse_what_the_host_tier_takes(ctxs):
    """Unequal value dtypes and pair operands go to the reference's host
    tier: the port raises VegaError naming it."""
    _ref, port = ctxs
    ints = port.dense_from_numpy(np.arange(10, dtype=np.int32))
    floats = port.dense_from_numpy(np.arange(10, dtype=np.float32))
    pairs = port.dense_from_numpy(np.arange(10, dtype=np.int32),
                                  np.arange(10, dtype=np.int32))
    for bad in (lambda: ints.intersection(floats),
                lambda: ints.subtract(floats), lambda: pairs.distinct(),
                lambda: pairs.intersection(pairs),
                lambda: ints.union(floats), lambda: pairs.zip(ints)):
        with pytest.raises(VegaError, match="host tier"):
            bad()


# ---------------------------------------------------------------------------
# union / zip / zip_with_index
# ---------------------------------------------------------------------------


def test_union_matches_reference(ctxs):
    """Values and pairs, capacity from the host counts; the union of two
    reduce outputs stays hash-placed, so a reduce over it elides its
    exchange."""
    ref, port = ctxs

    def run(ctx):
        vals = ctx.dense_from_numpy(X).union(ctx.dense_range(5_000))
        pairs = ctx.dense_from_numpy(X % 97, X).union(
            ctx.dense_range(3_000).map(lambda x: (x % 50, x)))
        r1 = ctx.dense_range(9_000).map(lambda x: (x % 300, x)) \
            .reduce_by_key(op="add")
        r2 = ctx.dense_from_numpy(X % 200, X).reduce_by_key(op="max")
        both = r1.union(r2)
        small = ctx.dense_from_numpy(np.arange(8 * 129, dtype=np.int32)) \
            .union(ctx.dense_from_numpy(np.arange(8, dtype=np.int32)))
        return {"values": vals, "pairs": pairs, "reduced": both,
                "reduce of union": both.reduce_by_key(op="add"),
                "sized by counts": small}

    exp, got = run(ref), run(port)
    for name in exp:
        _same(got[name], exp[name])
    # 130 rows a shard: 256, where the capacities' sum would give 512.
    # (A map's block keeps its host counts in the port, not in the
    # reference, so "pairs" sizes from counts only in the port.)
    for name in ("values", "sized by counts"):
        assert got[name].block().capacity == exp[name].block().capacity
    assert got["sized by counts"].block().capacity == 256
    got["reduced"]._settle_placement()
    assert got["reduced"].hash_placed
    assert got["reduce of union"]._last_counts_host is None  # passthrough


def test_zip_and_zip_with_index(ctxs):
    ref, port = ctxs

    def run(ctx):
        a = ctx.dense_from_numpy(X)
        return {"zip": a.zip(ctx.dense_range(len(X)).map(lambda x: x * 0.5)),
                "zip_with_index": a.zip_with_index(),
                "index of filtered": a.filter(lambda x: x % 3 == 0)
                .zip_with_index()}

    exp, got = run(ref), run(port)
    for name in exp:
        _same(got[name], exp[name])
    assert got["zip_with_index"].collect() == list(zip(X.tolist(),
                                                       range(len(X))))


def test_zip_needs_equal_shard_counts(ctxs):
    """Unequal per-shard counts raise with the reference's message."""
    ref, port = ctxs
    for ctx, err in ((ref, RefVegaError), (port, VegaError)):
        z = ctx.dense_from_numpy(X).zip(ctx.dense_range(len(X) - 1))
        with pytest.raises(err, match="dense zip requires equal per-shard "
                                      "counts"):
            z.count()
    with pytest.raises(VegaError, match="pair"):
        port.dense_from_numpy(X, X).zip_with_index()
