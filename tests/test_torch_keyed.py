"""The keyed ops of vega_tpu_torch against vega_tpu, on the CPU.

group_by_key, sort_by_key, take / take_ordered / top, cogroup and
cartesian run through a vega_tpu Context("local") on the 8-device CPU
mesh and through vega_tpu_torch's Context(device="cpu", n_shards=8), both
under the same plans (the card's: xla sorts, fused_sort, no table plan,
unless a test names a dense_sort_impl). Inputs come from a numpy seed.
Every comparison is exact: keys, values, counts, per-shard counts (same
placement), sampled bounds and selected rows; nothing here sums floats.
The slice as a whole: BASELINE configs 1, 4 and 5 with benchmarks/suite.py's
generators at ~20,000 rows through both packages.
"""

import numpy as np
import pytest

import vega_tpu as v
from vega_tpu.tpu import mesh as ref_mesh
import vega_tpu_torch as vt
from vega_tpu_torch import block as port_block
from vega_tpu_torch import dense_rdd as port_dense_rdd

N_SHARDS = 8
KNOBS = ("dense_sort_impl", "dense_rbk_plan", "dense_table_plan")
ACCEL_PLANS = {"dense_rbk_plan": "fused_sort", "dense_table_plan": "off",
               "dense_sort_impl": "xla"}
SORT_IMPLS = ["xla", "packed", "radix", "radix4"]
I32 = np.iinfo(np.int32)


@pytest.fixture()
def ref_env():
    """A vega_tpu Context and its Configuration pinned to the card's
    plans; the knobs are restored afterwards."""
    from vega_tpu.env import Env

    context = v.Context("local", num_workers=2)
    conf = Env.get().conf
    old = {k: getattr(conf, k) for k in KNOBS}
    for k, val in ACCEL_PLANS.items():
        setattr(conf, k, val)
    try:
        yield context, conf
    finally:
        for k, val in old.items():
            setattr(conf, k, val)
        context.stop()


def _contexts(ref_env, impl="xla"):
    """(reference, port) under dense_sort_impl=impl."""
    ref_ctx, conf = ref_env
    conf.dense_sort_impl = impl
    port = vt.Context(device="cpu", n_shards=N_SHARDS,
                      **dict(ACCEL_PLANS, dense_sort_impl=impl))
    return ref_ctx, port


def _assert_same(got, exp):
    """Bit-identical arrays (NaN payloads and the sign of zero included)."""
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.dtype == exp.dtype and got.shape == exp.shape
    if got.dtype == np.float32:
        got, exp = got.view(np.int32), exp.view(np.int32)
    np.testing.assert_array_equal(got, exp)


def _assert_rows_same(got, exp):
    """Lists of scalars or tuples, equal bit for bit (NaN == NaN here)."""
    assert len(got) == len(exp)
    if got and isinstance(got[0], tuple):
        for i in range(len(got[0])):
            g = np.array([r[i] for r in got])
            e = np.array([r[i] for r in exp])
            _assert_same(g, e)
    else:
        _assert_same(np.array(got), np.array(exp))


def _keys(kind, n, rng):
    """n keys of one kind, with duplicates and the kind's edge values."""
    if kind == "int32":
        k = rng.randint(-300, 300, size=n).astype(np.int32)
        k[:4] = [I32.min, I32.max, 0, -1]
    elif kind == "float32":
        k = (rng.randint(-300, 300, size=n) * 0.5).astype(np.float32)
        k[:4] = [np.inf, -np.inf, -0.0, 0.0]
    else:  # wide int64 beyond int32, some within it, edge words
        k = (rng.randint(-300, 300, size=n).astype(np.int64) << 33) \
            + rng.randint(0, 3, size=n)
        k[:6] = [2**62, -2**62, 0, -1, I32.min, I32.max + 1]
    return k


# ---------------------------------------------------------------------------
# group_by_key
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["int32", "float32", "wide"])
def test_group_by_key_matches_reference(ref_env, kind):
    rng = np.random.RandomState(1)
    n = 6_000
    keys = _keys(kind, n, rng)
    vals = rng.randint(-1000, 1000, size=n).astype(np.int32)
    ref_ctx, port = _contexts(ref_env)
    with port:
        exp = ref_ctx.dense_from_numpy(keys, vals).group_by_key()
        got = port.dense_from_numpy(keys, vals).group_by_key()
        np.testing.assert_array_equal(got.block().counts_np,
                                      exp.block().counts_np)
        assert got.collect() == exp.collect()
        for g, e in zip(got.collect_grouped(), exp.collect_grouped()):
            _assert_same(g, e)
        # a rerun of the same lineage and sizes launches deferred and
        # settles at the read
        again = port.dense_from_numpy(keys, vals).group_by_key()
        assert again.block_spec().settle is not None
        assert again.collect() == exp.collect()


def test_group_by_key_over_a_reduce_elides_the_exchange(ref_env):
    """A hash-placed, key-sorted parent (a reduce output) skips both the
    exchange and the sort: the rows stay on their shards."""
    ref_ctx, port = _contexts(ref_env)

    def run(ctx):
        red = ctx.dense_range(20_000).map(lambda x: (x % 777, x)) \
            .reduce_by_key(op="add")
        return red, red.group_by_key()

    with port:
        (got_red, got), (_exp_red, exp) = run(port), run(ref_ctx)
        assert got.collect() == exp.collect()
        np.testing.assert_array_equal(got.block().counts_np,
                                      exp.block().counts_np)
        np.testing.assert_array_equal(got.block().counts_np,
                                      got_red.block().counts_np)
        assert got._last_counts_host is None  # a fixed-capacity passthrough


def test_group_by_key_count_counts_groups(ref_env):
    """count() is the number of groups, as collect() has them. (The
    reference returns the number of rows: ROADMAP queue 3.)"""
    ref_ctx, port = _contexts(ref_env)
    keys = np.arange(5_000, dtype=np.int32) % 37
    vals = np.arange(5_000, dtype=np.int32)
    with port:
        got = port.dense_from_numpy(keys, vals).group_by_key()
        exp = ref_ctx.dense_from_numpy(keys, vals).group_by_key()
        assert got.count() == len(exp.collect()) == 37
        assert exp.count() == 5_000


# ---------------------------------------------------------------------------
# sort_by_key
# ---------------------------------------------------------------------------


def _sort_keys(kind, n, rng):
    if kind == "int32":
        k = rng.randint(-50_000, 50_000, size=n).astype(np.int32)
        k[:5] = [I32.min, I32.max, I32.min, 0, -1]  # INT32_MIN twice
    elif kind == "float32":
        k = (rng.randn(n) * 1000).astype(np.float32)
        k[:6] = [np.inf, -np.inf, -0.0, 0.0, -0.0, 0.0]
    else:
        k = rng.randint(-(1 << 45), 1 << 45, size=n, dtype=np.int64)
        k[:5] = [I32.min, I32.max, 0, -1, 2**62]
    k[n // 2:n // 2 + 300] = k[:300]  # ties: stability shows in the values
    return k


def _ref_bounds(monkeypatch):
    """Record the range bounds the reference puts on its mesh."""
    seen = []
    real = ref_mesh.host_put

    def spy(value, spec):
        if isinstance(value, np.ndarray) and value.shape == (N_SHARDS - 1,):
            seen.append(np.array(value))
        return real(value, spec)

    monkeypatch.setattr(ref_mesh, "host_put", spy)
    return seen


@pytest.mark.parametrize("kind", ["int32", "float32", "wide"])
@pytest.mark.parametrize("impl", SORT_IMPLS)
def test_sort_by_key_matches_reference(ref_env, monkeypatch, impl, kind):
    rng = np.random.RandomState(2)
    n = 12_000
    keys = _sort_keys(kind, n, rng)
    vals = np.arange(n, dtype=np.int32)
    ref_ctx, port = _contexts(ref_env, impl)
    seen = _ref_bounds(monkeypatch)
    with port:
        for ascending in (True, False):
            seen.clear()
            exp = ref_ctx.dense_from_numpy(keys, vals).sort_by_key(ascending)
            exp_counts = exp.block().counts_np
            got = port.dense_from_numpy(keys, vals).sort_by_key(ascending)
            np.testing.assert_array_equal(got.block().counts_np, exp_counts)
            exp_bounds = (seen[0] if kind != "wide" else
                          port_block.decode_i64(seen[0], seen[1]))
            _assert_same(got._bounds_host, exp_bounds)
            g, e = got.collect_arrays(), exp.collect_arrays()
            for nm in ("k", "v"):
                _assert_same(g[nm], e[nm])
            order = np.argsort(keys if ascending else -keys.astype(
                np.float64), kind="stable")
            if kind == "float32":  # -0.0 ties +0.0: compare as floats
                np.testing.assert_array_equal(g["k"], keys[order])
            else:
                _assert_same(g["k"], keys[order])


def test_sort_by_key_over_a_map_and_warm_rerun(ref_env):
    """The sampler applies the fused narrow chain; a rerun with the same
    counts and bounds launches deferred, at the hinted capacities."""
    ref_ctx, port = _contexts(ref_env)

    def run(ctx):
        return ctx.dense_range(30_000).map(
            lambda x: ((x * 7919) % 30_011, x)).sort_by_key()

    with port:
        exp = run(ref_ctx).collect()
        assert run(port).collect() == exp
        warm = run(port)
        assert warm.block_spec().settle is not None
        assert warm.collect() == exp


# ---------------------------------------------------------------------------
# take / take_ordered / top
# ---------------------------------------------------------------------------


def _selection_cases(ctx, rng):
    n = 3_000
    ints = rng.randint(-10**6, 10**6, size=n).astype(np.int32)
    ints[:3] = [I32.min, I32.max, I32.min]
    flo = (rng.randn(n) * 100).astype(np.float32)
    flo[:6] = [-0.0, 0.0, np.nan, -np.nan, np.inf, -np.inf]
    keys = rng.randint(-40, 40, size=n).astype(np.int32)
    wide = rng.randint(-(1 << 45), 1 << 45, size=n, dtype=np.int64)
    wide[:40] = wide[40:80]  # tied wide keys: the value decides
    zeros = np.where(rng.rand(n) < 0.5, -0.0, 0.0).astype(np.float32)
    zeros[::97] = np.nan
    return {
        "int values": ctx.dense_from_numpy(ints),
        "float values (+-0, NaN, inf)": ctx.dense_from_numpy(flo),
        "int pairs": ctx.dense_from_numpy(keys, ints),
        "float-valued pairs (+-0, NaN)": ctx.dense_from_numpy(keys, zeros),
        "wide pairs": ctx.dense_from_numpy(wide, flo[::-1].copy()),
    }


@pytest.mark.parametrize("impl", SORT_IMPLS)
def test_take_ordered_top_match_reference(ref_env, impl):
    ref_ctx, port = _contexts(ref_env, impl)
    with port:
        exp_cases = _selection_cases(ref_ctx, np.random.RandomState(3))
        got_cases = _selection_cases(port, np.random.RandomState(3))
        for name, exp in exp_cases.items():
            got = got_cases[name]
            for n in (0, 9, 5_000):  # 5_000 > the 3_000 rows
                if n > 3_000 and "NaN, inf" in name:
                    # Every value comes back. The reference ranks its
                    # ghost-row sentinels before a valid NaN, so it loses
                    # one (ROADMAP queue 3, F5's topk_values site).
                    every = np.sort(np.array(got.collect(), np.float32))
                    np.testing.assert_array_equal(got.take_ordered(n),
                                                  every)
                    np.testing.assert_array_equal(got.top(n), every[::-1])
                    assert np.isnan(exp.take_ordered(n)).sum() < \
                        np.isnan(every).sum()
                    continue
                _assert_rows_same(got.take_ordered(n), exp.take_ordered(n))
                _assert_rows_same(got.top(n), exp.top(n))
        # a key function is the host tier's in both packages
        assert got_cases["int pairs"].take_ordered(3, key=lambda kv: kv[1]) \
            == exp_cases["int pairs"].take_ordered(3, key=lambda kv: kv[1])
        assert got_cases["int values"].top(3, key=abs) == \
            exp_cases["int values"].top(3, key=abs)


def test_take_matches_reference(ref_env):
    """Shard by shard, the first n rows in shard order; wide keys come
    back as int64."""
    ref_ctx, port = _contexts(ref_env)
    with port:
        exp_cases = _selection_cases(ref_ctx, np.random.RandomState(4))
        got_cases = _selection_cases(port, np.random.RandomState(4))
        for name, exp in exp_cases.items():
            for n in (0, 1, 500, 5_000):
                _assert_rows_same(got_cases[name].take(n), exp.take(n))
        srt = port.dense_from_numpy(np.arange(1000, 0, -1, dtype=np.int64)
                                    + (1 << 40), np.arange(1000)).sort_by_key()
        assert srt.take(3) == [((1 << 40) + i, 1000 - i) for i in (1, 2, 3)]


# ---------------------------------------------------------------------------
# cogroup
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["int32", "wide"])
def test_cogroup_matches_reference(ref_env, kind):
    rng = np.random.RandomState(5)
    ak = rng.randint(0, 60, size=4_000).astype(np.int64)
    bk = rng.randint(30, 95, size=900).astype(np.int64)
    if kind == "wide":
        ak, bk = ak + (1 << 40), bk + (1 << 40)
    else:
        ak, bk = ak.astype(np.int32), bk.astype(np.int32)
    av = rng.randint(0, 1000, size=4_000).astype(np.int32)
    bv = rng.rand(900).astype(np.float32)
    ref_ctx, port = _contexts(ref_env)
    with port:
        def run(ctx):
            return ctx.dense_from_numpy(ak, av).cogroup(
                ctx.dense_from_numpy(bk, bv))

        got, exp = run(port), run(ref_ctx)
        assert got.collect() == exp.collect()
        for g, e in zip(got.collect_grouped(), exp.collect_grouped()):
            _assert_same(g, e)
        assert got.count() == exp.count() == len(np.union1d(ak, bk))
        empty = port.dense_from_numpy(ak[:0], av[:0])
        assert empty.cogroup(empty).count() == 0
        assert empty.cogroup(empty).collect() == []


# ---------------------------------------------------------------------------
# cartesian
# ---------------------------------------------------------------------------


def test_cartesian_matches_reference_and_budget_gate(ref_env, monkeypatch):
    ref_ctx, port = _contexts(ref_env)
    with port:
        def run(ctx, right):
            return ctx.dense_range(300).cartesian(ctx.dense_from_numpy(right))

        right = np.array([10, 20, 30], dtype=np.int32)
        got, exp = run(port, right), run(ref_ctx, right)
        assert got.count() == exp.count() == 900
        assert sorted(got.collect()) == sorted(exp.collect()) == sorted(
            (x, y) for x in range(300) for y in (10, 20, 30))
        np.testing.assert_array_equal(got.block().counts_np,
                                      exp.block().counts_np)
        # pair ops compose on the product
        assert dict(got.reduce_by_key(op="add").collect()) == {
            x: 60 for x in range(300)}
        empty = run(port, right[:0])
        assert empty.count() == run(ref_ctx, right[:0]).count() == 0
        assert empty.collect() == []
    # the gate at 16 MiB: 20,000 x 10 needs 8 shards x 32,768 slots x 40 B
    # (10 MiB) and runs on the device; 20,000 x 5,000 needs ~4.4 GB: the
    # host tier's lazy product, as the reference's past its budget
    monkeypatch.setattr(port_dense_rdd, "CPU_CARTESIAN_BUDGET", 16 << 20)
    with vt.Context(device="cpu", n_shards=N_SHARDS) as small:
        a = small.dense_range(20_000)
        lazy = a.cartesian(small.dense_range(5_000))
        assert not isinstance(lazy, port_dense_rdd.DenseRDD)
        assert lazy.take(3) == [(0, 0), (0, 1), (0, 2)]
        assert lazy.num_partitions == N_SHARDS * N_SHARDS
        dense = a.cartesian(small.dense_range(10))
        assert isinstance(dense, port_dense_rdd.DenseRDD)
        assert dense.count() == 200_000


# ---------------------------------------------------------------------------
# BASELINE configs 1, 4 and 5 (benchmarks/suite.py's generators)
# ---------------------------------------------------------------------------


def _config1(ctx, n):
    """suite.py:56-64: group_by over (i64, f64) pairs."""
    k = max(1000, n // 40)
    keys = (1 << 40) + (np.arange(n, dtype=np.int64) * 2654435761 % k)
    vals = np.arange(n, dtype=np.float64) * 0.5
    return ctx.dense_from_numpy(keys, vals).group_by_key().collect_grouped()


def _config4(ctx, n):
    """suite.py:157-174: cogroup + cartesian, counted."""
    k = max(1000, n // 20)
    ak = np.arange(n, dtype=np.int32) % k
    av = np.arange(n, dtype=np.float32)
    bk = np.arange(n, dtype=np.int32) * 3 % k
    bv = np.arange(n, dtype=np.float32) * 2.0
    m = 150
    cx = np.arange(m, dtype=np.int32)
    cg = ctx.dense_from_numpy(ak, av).cogroup(ctx.dense_from_numpy(bk, bv))
    cart = ctx.dense_from_numpy(cx).cartesian(ctx.dense_from_numpy(cx))
    return cg.count(), cg.collect_grouped(), cart.count()


def _config5(ctx, n):
    """suite.py:194-210: sort_by_key + take / take_ordered over i64 keys."""
    rng = np.random.default_rng(7)
    keys = rng.integers(-(1 << 45), 1 << 45, size=n, dtype=np.int64)
    vals = rng.standard_normal(n).astype(np.float32)
    r = ctx.dense_from_numpy(keys, vals)
    return r.sort_by_key().take(10), r.take_ordered(10), keys


def test_baseline_configs_1_4_5(ref_env):
    ref_ctx, port = _contexts(ref_env)
    with port:
        for g, e in zip(_config1(port, 20_000), _config1(ref_ctx, 20_000)):
            _assert_same(g, e)
        gk, offs, _gv = _config1(port, 20_000)
        k = np.unique((np.arange(20_000, dtype=np.int64) * 2654435761) % 1000)
        np.testing.assert_array_equal(np.sort(gk), k + (1 << 40))
        assert offs[-1] == 20_000

        got4, exp4 = _config4(port, 20_000), _config4(ref_ctx, 20_000)
        assert got4[0] == exp4[0] == 1000
        for g, e in zip(got4[1], exp4[1]):
            _assert_same(g, e)
        assert got4[2] == exp4[2] == 150 * 150

        first, top, keys = _config5(port, 20_000)
        exp_first, exp_top, _ = _config5(ref_ctx, 20_000)
        assert first == exp_first and top == exp_top
        assert [k_ for k_, _ in first] == np.sort(keys)[:10].tolist()
