"""Narrow and uint32 columns, bool adds and 2-D keys of vega_tpu_torch
against vega_tpu, on the CPU.

int8 / int16 / uint8 / uint16 / float16 columns (ROADMAP's F6) and
uint32 columns on both sides of 2^31 (F7) through every path the
reference runs: reduce_by_key under each named op and a traced binop,
group_by_key, join, left_outer_join, sort_by_key, distinct,
count_by_value, take_ordered / top, union, min / max / sum / mean /
stats, histogram, map, map_values, filter, reduce(f) and
fold_pairs_device. A named add / prod over a bool value column (F8) and a
key column that is not 1-D (F9) raise VegaError. Each case runs the same
lineage through a vega_tpu Context("local") on the 8-device CPU mesh and
through vega_tpu_torch's Context(device="cpu", n_shards=8), both under
the card's plans (xla sorts, fused_sort, no table plan), on inputs from a
numpy seed. Integer results are bit-identical, wraps included, in value
and numpy dtype; float16 results are within rtol 2e-3 of the reference's
float16 result, float32 ones within rtol 1e-5. The differences that
remain are pinned, each naming both sides.
"""

import numpy as np
import pytest

import vega_tpu as v
from vega_tpu.tpu import dense_rdd as ref_dense
from vega_tpu.tpu.state_fold import fold_pairs_device as ref_fold
import vega_tpu_torch as vt
from vega_tpu_torch.errors import KernelError, VegaError
from vega_tpu_torch.state_fold import fold_pairs_device as port_fold

N_SHARDS = 8
ACCEL_PLANS = {"dense_rbk_plan": "fused_sort", "dense_table_plan": "off",
               "dense_sort_impl": "xla"}
NARROW = ("int8", "int16", "uint8", "uint16", "float16")
U31 = 2**31


@pytest.fixture(scope="module")
def ctxs():
    """(reference, port) Contexts under the card's plans, shared by the
    module (the reference's Env is a process singleton)."""
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


def _keys(dt, n, rng):
    """Keys of dtype dt over about n / 8 values, negatives included where
    the dtype has them (float16: halves)."""
    if dt == "float16":
        return (rng.randint(-60, 60, n) / 2).astype(np.float16)
    lo = 0 if dt.startswith("u") else -60
    return rng.randint(lo, lo + 120, n).astype(dt)


def _values(dt, n, rng, small=False):
    """Values of dtype dt over its whole range, so sums and products wrap;
    small: magnitudes products keep finite in float16."""
    if dt == "float16":
        return ((rng.rand(n) + 0.5) if small else rng.rand(n) * 4
                ).astype(np.float16)
    info = np.iinfo(dt)
    return rng.randint(int(info.min), int(info.max) + 1, n).astype(dt)


def _close(got, exp, dt):
    """Rows equal: exactly, or within rtol 2e-3 where dt is float16."""
    if dt != "float16":
        assert got == exp
        return
    assert len(got) == len(exp)
    g = np.asarray(got, dtype=np.float64)
    e = np.asarray(exp, dtype=np.float64)
    np.testing.assert_allclose(g, e, rtol=2e-3, atol=0)


def _flat(rows):
    """(k, (a, b)) rows as (k, a, b) tuples, for numeric comparison."""
    return [(k,) + tuple(x) if isinstance(x, tuple) else (k, x)
            for k, x in rows]


def _dtypes(arrays):
    return {nm: a.dtype for nm, a in arrays.items()}


# ---------------------------------------------------------------------------
# F6: narrow columns
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", NARROW)
def test_narrow_keys_reduce(ctxs, dt):
    """Narrow keys hash as the reference's astype(uint32) does: the same
    per-shard rows in the same order, the key dtype kept."""
    ref, port = ctxs
    rng = np.random.RandomState(1)
    k = _keys(dt, 1500, rng)
    x = rng.randint(-1000, 1000, 1500).astype(np.int32)
    exp = ref.dense_from_numpy(k, x).reduce_by_key(op="add")
    got = port.dense_from_numpy(k, x).reduce_by_key(op="add")
    assert got.collect() == exp.collect()
    np.testing.assert_array_equal(got.block().counts_np,
                                  exp.block().counts_np)
    assert _dtypes(got.collect_arrays()) == _dtypes(exp.collect_arrays())


@pytest.mark.parametrize("op", ["add", "min", "max", "prod"])
@pytest.mark.parametrize("dt", NARROW)
def test_narrow_values_reduce(ctxs, dt, op):
    """Every named op over narrow values: an integer add or prod wraps mod
    2^width as the reference's does; float16 within rtol 2e-3."""
    ref, port = ctxs
    rng = np.random.RandomState(2)
    n = 1200
    k = rng.randint(0, 150, n).astype(np.int32)
    x = _values(dt, n, rng, small=op == "prod")
    exp = ref.dense_from_numpy(k, x).reduce_by_key(op=op)
    got = port.dense_from_numpy(k, x).reduce_by_key(op=op)
    e, g = exp.collect_arrays(), got.collect_arrays()
    assert _dtypes(g) == _dtypes(e) == {"k": np.int32, "v": np.dtype(dt)}
    _close(_flat(got.collect()), _flat(exp.collect()), dt)


def test_int8_add_wraps_as_the_reference(ctxs):
    """The motivating inputs: int8 keys reduce, and int8 values [100,
    100] under one key add to -56 (int8 wraps)."""
    ref, port = ctxs
    k8 = np.array([3, 3, 4], np.int8)
    x32 = np.array([1, 2, 3], np.int32)
    for c in ctxs:
        assert sorted(c.dense_from_numpy(k8, x32).reduce_by_key(
            op="add").collect()) == [(3, 3), (4, 3)]
    k = np.array([1, 1], np.int32)
    x8 = np.array([100, 100], np.int8)
    exp = ref.dense_from_numpy(k, x8).reduce_by_key(op="add")
    got = port.dense_from_numpy(k, x8).reduce_by_key(op="add")
    assert got.collect() == exp.collect() == [(1, -56)]
    assert got.collect_arrays()["v"].dtype == np.int8
    # float16: a float16 result, as the reference's
    x16 = np.array([0.1, 0.2], np.float16)
    exp = ref.dense_from_numpy(k, x16).reduce_by_key(op="add").collect()
    got = port.dense_from_numpy(k, x16).reduce_by_key(op="add").collect()
    np.testing.assert_allclose(got[0][1], exp[0][1], rtol=2e-3)
    assert port.dense_from_numpy(k, x16).reduce_by_key(
        op="add").collect_arrays()["v"].dtype == np.float16


@pytest.mark.parametrize("dt", NARROW)
def test_narrow_traced_binop(ctxs, dt):
    """A traced binop sees the logical values (torch's own narrow dtype,
    int64 for uint16) and its result wraps to the column's dtype."""
    ref, port = ctxs
    rng = np.random.RandomState(3)
    # associative and commutative, so the fold order (which the two scans
    # take differently) cannot matter; but no named op either
    n = 800 if dt != "float16" else 240  # float16: few terms per key
    k = rng.randint(0, 60, n).astype(np.int32)
    x = _values(dt, n, rng)
    f = (lambda a, b: a * b + 0) if dt != "float16" else \
        (lambda a, b: a + b + 0.0)
    exp = ref.dense_from_numpy(k, x).reduce_by_key(f)
    got = port.dense_from_numpy(k, x).reduce_by_key(f)
    assert got._op is None  # the segmented scan, not a named op
    assert got.collect_arrays()["v"].dtype == np.dtype(dt)
    _close(_flat(sorted(got.collect())), _flat(sorted(exp.collect())), dt)


def _group(rdd):
    return sorted((k, sorted(vs)) for k, vs in rdd.collect())


def _pairs(c, k, x):
    return c.dense_from_numpy(k, x)


NARROW_OPS = {
    # name: (run(ctx, k, x, table_k, table_v) -> comparable, float16-close)
    "group_by_key": lambda c, k, x, tk, tv: [
        (g, tuple(vs)) for g, vs in _group(_pairs(c, k, x).group_by_key())],
    "join": lambda c, k, x, tk, tv: sorted(_flat(
        _pairs(c, k, x).join(c.dense_from_numpy(tk, tv)).collect())),
    "left_outer_join": lambda c, k, x, tk, tv: sorted(_flat(
        _pairs(c, k, x).left_outer_join(
            c.dense_from_numpy(tk, tv)).collect())),
    "sort_by_key": lambda c, k, x, tk, tv: [
        r[0] for r in _pairs(c, k, x).sort_by_key().collect()],
    "sort_by_key_desc": lambda c, k, x, tk, tv: [
        r[0] for r in _pairs(c, k, x).sort_by_key(False).collect()],
    "distinct": lambda c, k, x, tk, tv: sorted(
        c.dense_from_numpy(k).distinct().collect()),
    "count_by_value": lambda c, k, x, tk, tv: sorted(
        c.dense_from_numpy(k).count_by_value().items()),
    "take_ordered": lambda c, k, x, tk, tv: c.dense_from_numpy(
        x).take_ordered(7),
    "top": lambda c, k, x, tk, tv: c.dense_from_numpy(x).top(7),
    "union": lambda c, k, x, tk, tv: sorted(c.dense_from_numpy(x).union(
        c.dense_from_numpy(k)).collect()),
    "max": lambda c, k, x, tk, tv: c.dense_from_numpy(x).max(),
    "min": lambda c, k, x, tk, tv: c.dense_from_numpy(x).min(),
    "sum": lambda c, k, x, tk, tv: c.dense_from_numpy(x).sum(),
    "histogram": lambda c, k, x, tk, tv: c.dense_from_numpy(k).histogram(5),
    "map_plus_one": lambda c, k, x, tk, tv: c.dense_from_numpy(x).map(
        lambda y: y + 1).collect_arrays(),
    "map_values": lambda c, k, x, tk, tv: _pairs(c, tk, x[:len(tk)])
    .map_values(lambda y: y * 3).collect_arrays(),
    "filter": lambda c, k, x, tk, tv: c.dense_from_numpy(k).filter(
        lambda y: y > 3).collect(),
    "collect_arrays": lambda c, k, x, tk, tv: _pairs(c, k, x)
    .collect_arrays(),
}


@pytest.mark.parametrize("op", sorted(NARROW_OPS))
@pytest.mark.parametrize("dt", NARROW)
def test_narrow_ops(ctxs, dt, op):
    """Each keyed, set, action and row op over narrow columns equals the
    reference's, in value and (where it returns arrays) in dtype."""
    ref, port = ctxs
    rng = np.random.RandomState(4)
    n = 900
    k = _keys(dt, n, rng)
    x = _values(dt, n, rng)
    tk = np.unique(k)[::2]
    tv = np.arange(len(tk), dtype=np.int32)
    run = NARROW_OPS[op]
    exp = run(ref, k, x, tk, tv)
    got = run(port, k, x, tk, tv)
    if isinstance(exp, dict):  # collect_arrays
        assert _dtypes(got) == _dtypes(exp)
        for nm in exp:
            if dt == "float16":
                np.testing.assert_allclose(got[nm].astype(np.float64),
                                           exp[nm].astype(np.float64),
                                           rtol=2e-3)
            else:
                np.testing.assert_array_equal(got[nm], exp[nm])
        return
    if op == "histogram":
        np.testing.assert_allclose(got[0], exp[0], rtol=1e-6)
        assert got[1] == exp[1]
        return
    if op in ("group_by_key",):
        assert [g for g, _ in got] == [g for g, _ in exp]
        for (_, a), (_, b) in zip(got, exp):
            _close(list(a), list(b), dt)
        return
    if op == "sum" and dt == "float16":
        np.testing.assert_allclose(got, exp, rtol=2e-3)
        return
    if op in ("max", "min", "sum"):
        assert type(got) is type(exp) and got == exp
        return
    _close(got, exp, dt)


def test_narrow_fold_runs_on_the_device(ctxs):
    """fold_pairs_device folds int8 keys on the device (not a host fold's
    None), equal to the reference's fold."""
    ref, port = ctxs
    pairs = list(zip(np.array([1, 1, 2, -3, 2], np.int8), [1, 2, 3, 4, 5]))
    for op in ("add", "min", "max", "prod"):
        exp = ref_fold(ref, pairs, op)
        got = port_fold(port, pairs, op)
        assert got is not None and got == exp
    assert port_fold(port, [(np.int8(1), 2), (np.int8(1), 3)], "add") == \
        ref_fold(ref, [(np.int8(1), 2), (np.int8(1), 3)], "add") == {1: 5}


# ---------------------------------------------------------------------------
# F7: uint32 beyond int32
# ---------------------------------------------------------------------------

U32_KEYS = np.array([4_000_000_000, 4_000_000_000, 5, U31, U31 - 1, 0,
                     2**32 - 1, 5], np.uint32)


def test_uint32_keys_reduce(ctxs):
    """uint32 keys on both sides of 2^31 reduce with the reference's
    placement and row order; the key stays uint32."""
    ref, port = ctxs
    x = np.arange(len(U32_KEYS), dtype=np.int32) + 1
    exp = ref.dense_from_numpy(U32_KEYS, x).reduce_by_key(op="add")
    got = port.dense_from_numpy(U32_KEYS, x).reduce_by_key(op="add")
    assert got.collect() == exp.collect()
    np.testing.assert_array_equal(got.block().counts_np,
                                  exp.block().counts_np)
    assert _dtypes(got.collect_arrays()) == _dtypes(exp.collect_arrays()) \
        == {"k": np.uint32, "v": np.int32}
    k3 = np.array([4_000_000_000, 4_000_000_000, 5], np.uint32)
    x3 = np.array([1, 2, 3], np.int32)
    assert sorted(port.dense_from_numpy(k3, x3).reduce_by_key(
        op="add").collect()) == [(5, 3), (4_000_000_000, 3)]


@pytest.mark.parametrize("op", ["add", "min", "max", "prod"])
def test_uint32_values_reduce(ctxs, op):
    """uint32 values: add and prod wrap mod 2^32 in the same bits (not the
    wide encoding's exact int64), min / max compare unsigned."""
    ref, port = ctxs
    rng = np.random.RandomState(5)
    k = rng.randint(0, 40, 600).astype(np.int32)
    x = rng.randint(0, 2**32, 600, dtype=np.int64).astype(np.uint32)
    exp = ref.dense_from_numpy(k, x).reduce_by_key(op=op)
    got = port.dense_from_numpy(k, x).reduce_by_key(op=op)
    assert got.collect() == exp.collect()
    assert got.collect_arrays()["v"].dtype == np.uint32


def test_uint32_value_add_wraps_not_widens(ctxs):
    """[4e9, 4e9] under one key add to 3705032704 (mod 2^32), where the
    wide encoding would give 8000000000; the keyless sum() is exact."""
    ref, port = ctxs
    k = np.array([1, 1, 2], np.int32)
    x = np.array([4_000_000_000, 4_000_000_000, 5], np.uint32)
    for c in ctxs:
        assert sorted(c.dense_from_numpy(k, x).reduce_by_key(
            op="add").collect()) == [(1, 3705032704), (2, 5)]
        col = c.dense_from_numpy(x)
        assert col.sum() == 8_000_000_005
        assert col.max() == 4_000_000_000 and col.min() == 5
    assert port.dense_from_numpy(x).mean() == ref.dense_from_numpy(
        x).mean()


# row functions over pairs that mix dtypes: (key dtype, value dtype, f)
MIXED_ROW_FNS = {
    "u16_plus_i32": ("uint16", "int32", lambda kv: (kv[0], kv[1] + kv[0])),
    "u32_plus_i8": ("uint32", "int8", lambda kv: (kv[0], kv[0] + kv[1])),
    "swap_u32_u16": ("uint32", "uint16", lambda kv: (kv[1], kv[0])),
    "u16_plus_u32": ("uint16", "uint32", lambda kv: (kv[0], kv[0] + kv[1])),
    "i8_plus_u16": ("int8", "uint16", lambda kv: (kv[0], kv[0] + kv[1])),
    "u8_plus_i8": ("uint8", "int8", lambda kv: (kv[1], kv[0] + kv[1])),
    "u32_floordiv_then_i8": ("uint32", "int8",
                             lambda kv: (kv[0], kv[0] // 3 + kv[1])),
    "u32_gt_i8": ("uint32", "int8", lambda kv: (kv[0], kv[0] > kv[1])),
    "u32_times_i32": ("uint32", "int32", lambda kv: (kv[1], kv[0] * kv[1])),
    # a wrap between two ops: the difference wraps before the compare
    "u16_sub_then_gt": ("uint16", "uint16",
                        lambda kv: (kv[0], (kv[0] - kv[1]) > 100)),
    "u32_add_then_lt": ("uint32", "uint32",
                        lambda kv: (kv[1], (kv[0] + kv[1]) < kv[0])),
    "u16_neg_then_shift": ("uint16", "uint16",
                           lambda kv: (kv[0], (-kv[1]) >> 3)),
    "u32_where": ("uint32", "int32", None),
}


def _mixed_cols(dt, n, rng):
    """n values of dtype dt over its range; unsigned ones on both sides of
    half their range."""
    info = np.iinfo(dt)
    x = rng.randint(int(info.min), int(info.max) + 1, n, dtype=np.int64)
    if dt in ("uint16", "uint32"):
        x[:4] = [0, int(info.max), int(info.max) // 2 + 1, 5]
    return x.astype(dt)


@pytest.mark.parametrize("case", sorted(MIXED_ROW_FNS))
def test_mixed_dtype_row_functions(ctxs, case):
    """A row function over a pair that mixes an emulated uint16 / uint32
    column with another integer column gives jnp's promotion, op by op:
    uint16 + int32 and uint32 + int8 are int32 (uint32 wrapped to int32
    first), a swapped (uint32, uint16) pair keeps each column's dtype,
    and an unsigned difference or sum wraps before the next op reads it.
    Values and dtypes equal the reference's."""
    import jax.numpy as jnp
    import torch

    ref, port = ctxs
    kdt, vdt, f = MIXED_ROW_FNS[case]
    rng = np.random.RandomState(17)
    k, x = _mixed_cols(kdt, 300, rng), _mixed_cols(vdt, 300, rng)
    fr = fp = f
    if f is None:  # jnp.where / torch.where: the same function per side
        fr = lambda kv: (kv[0], jnp.where(kv[1] > 0, kv[0], kv[1]))
        fp = lambda kv: (kv[0], torch.where(kv[1] > 0, kv[0], kv[1]))
    exp = ref.dense_from_numpy(k, x).map(fr).collect_arrays()
    got = port.dense_from_numpy(k, x).map(fp).collect_arrays()
    assert _dtypes(got) == _dtypes(exp)
    for nm in exp:
        np.testing.assert_array_equal(got[nm], exp[nm])


def test_uint32_sort_by_key_unsigned(ctxs):
    """sort_by_key in unsigned order, both directions, equal to the
    reference's rows."""
    ref, port = ctxs
    x = np.arange(len(U32_KEYS), dtype=np.int32)
    for asc in (True, False):
        exp = ref.dense_from_numpy(U32_KEYS, x).sort_by_key(asc).collect()
        got = port.dense_from_numpy(U32_KEYS, x).sort_by_key(asc).collect()
        keys = [r[0] for r in got]
        assert keys == sorted(keys, reverse=not asc)
        assert keys == [r[0] for r in exp]
        assert sorted(got) == sorted(exp)


def test_uint32_join_across_2_31(ctxs):
    """A join and a left outer join whose keys sit on both sides of 2^31
    (a uint32 table), as the reference's."""
    ref, port = ctxs
    rng = np.random.RandomState(6)
    k = (rng.randint(0, 64, 500).astype(np.int64) * 67_108_864
         + rng.randint(0, 3, 500)).astype(np.uint32)
    x = rng.randint(0, 100, 500).astype(np.int32)
    tk = np.unique(k)[::3]
    tv = (tk.astype(np.uint64) ^ 0xFFFF).astype(np.uint32)
    for method in ("join", "left_outer_join"):
        exp = getattr(ref.dense_from_numpy(k, x), method)(
            ref.dense_from_numpy(tk, tv)).collect()
        got = getattr(port.dense_from_numpy(k, x), method)(
            port.dense_from_numpy(tk, tv)).collect()
        assert sorted(got) == sorted(exp)
    assert any(a >= U31 for a in tk) and any(a < U31 for a in tk)


UINT32_OPS = {
    "take_ordered": lambda c, x: c.dense_from_numpy(x).take_ordered(5),
    "top": lambda c, x: c.dense_from_numpy(x).top(5),
    "pair_take_ordered": lambda c, x: c.dense_from_numpy(
        x, np.arange(len(x), dtype=np.int32)).take_ordered(4),
    "distinct": lambda c, x: sorted(c.dense_from_numpy(x).distinct()
                                    .collect()),
    "count_by_value": lambda c, x: c.dense_from_numpy(x).count_by_value(),
    "histogram": lambda c, x: c.dense_from_numpy(x).histogram(4),
    "stats": lambda c, x: c.dense_from_numpy(x).stats(),
    "map_wraps": lambda c, x: c.dense_from_numpy(x).map(
        lambda y: y + 7).collect_arrays(),
    "map_to_pairs": lambda c, x: c.dense_from_numpy(x).map(
        lambda y: (y % 1000, 1)).reduce_by_key(op="add").collect_arrays(),
    "filter": lambda c, x: c.dense_from_numpy(x).filter(
        lambda y: y > U31).collect(),
    "reduce_xor": lambda c, x: c.dense_from_numpy(x).reduce(
        lambda a, b: a ^ b),
    "collect_arrays": lambda c, x: c.dense_from_numpy(
        x, x).collect_arrays(),
}


@pytest.mark.parametrize("op", sorted(UINT32_OPS))
def test_uint32_ops(ctxs, op):
    """The actions and row ops over a uint32 column on both sides of 2^31
    (2^32 - 1 included) equal the reference's, dtypes included."""
    ref, port = ctxs
    rng = np.random.RandomState(7)
    x = np.concatenate([rng.randint(0, 2**32, 300, dtype=np.int64),
                        [2**32 - 1, U31, U31 - 1, 0, 0]]).astype(np.uint32)
    exp = UINT32_OPS[op](ref, x)
    got = UINT32_OPS[op](port, x)
    if isinstance(exp, dict) and isinstance(next(iter(exp.values())),
                                            np.ndarray):
        assert _dtypes(got) == _dtypes(exp)
        for nm in exp:
            np.testing.assert_array_equal(got[nm], exp[nm])
    elif op == "stats":
        assert got["count"] == exp["count"]
        for nm in ("mean", "stdev", "min", "max"):
            np.testing.assert_allclose(got[nm], exp[nm], rtol=1e-5)
    elif op == "histogram":
        np.testing.assert_allclose(got[0], exp[0], rtol=1e-6)
        assert got[1] == exp[1]
    else:
        assert got == exp


def test_uint32_fold(ctxs):
    """fold_pairs_device over uint32 keys beyond int32 folds on the
    device, equal to the reference's."""
    ref, port = ctxs
    pairs = list(zip(U32_KEYS, range(len(U32_KEYS))))
    for op in ("add", "max"):
        got = port_fold(port, pairs, op)
        assert got is not None and got == ref_fold(ref, pairs, op)


# ---------------------------------------------------------------------------
# F8: add over bool, F9: 2-D keys
# ---------------------------------------------------------------------------

B_KEYS = np.array([1, 1, 2, 2, 2], np.int32)
B_VALS = np.array([True, True, False, True, True])
BOOL_ADDS = {
    "op_add": lambda c: c.dense_from_numpy(B_KEYS, B_VALS).reduce_by_key(
        op="add").collect(),
    "op_prod": lambda c: c.dense_from_numpy(B_KEYS, B_VALS).reduce_by_key(
        op="prod").collect(),
    "sum_by_key": lambda c: c.dense_from_numpy(B_KEYS, B_VALS).sum_by_key()
    .collect(),
    "traced_x_plus_y": lambda c: c.dense_from_numpy(
        B_KEYS, B_VALS).reduce_by_key(lambda x, y: x + y).collect(),
    "count_matching_idiom": lambda c: c.dense_range(1000).map(
        lambda x: (x % 7, x % 3 == 0)).reduce_by_key(op="add").collect(),
}


@pytest.mark.parametrize("case", sorted(BOOL_ADDS))
def test_bool_add_refused(ctxs, case):
    """F8: the port raised nothing and returned a logical OR; now it
    refuses as the reference does (the reference: TypeError "add does not
    accept dtype bool"; the port: VegaError)."""
    ref, port = ctxs
    with pytest.raises(TypeError, match="does not accept dtype bool"):
        BOOL_ADDS[case](ref)
    with pytest.raises(VegaError, match="does not accept dtype bool"):
        BOOL_ADDS[case](port)


@pytest.mark.parametrize("op", ["min", "max"])
def test_bool_min_max_agree(ctxs, op):
    ref, port = ctxs
    exp = sorted(ref.dense_from_numpy(B_KEYS, B_VALS).reduce_by_key(
        op=op).collect())
    got = sorted(port.dense_from_numpy(B_KEYS, B_VALS).reduce_by_key(
        op=op).collect())
    assert got == exp


def test_bool_keyless_sum_counts(ctxs):
    """sum() of a bool column counts the true rows on both sides (jnp.sum
    promotes bool), and a traced + of two bools is a logical or in both
    (jnp.add of bools is logical or; only the named segment add
    refuses)."""
    ref, port = ctxs
    assert port.dense_from_numpy(B_VALS).sum() == \
        ref.dense_from_numpy(B_VALS).sum() == 4
    f = lambda a, b: b + a  # noqa: E731 — not the canonical add
    assert sorted(port.dense_from_numpy(B_KEYS, B_VALS).reduce_by_key(
        f).collect()) == sorted(ref.dense_from_numpy(
            B_KEYS, B_VALS).reduce_by_key(f).collect())


def test_tuple_keys_fold_to_none(ctxs):
    """F9: tuple keys in a micro-batch leave the fold to the host (None)
    on both sides; the port no longer escapes as KernelError."""
    ref, port = ctxs
    assert ref_fold(ref, [((1, 2), 3)], "add") is None
    assert port_fold(port, [((1, 2), 3)], "add") is None


def test_2d_key_column_refused(ctxs):
    """F9: a 2-D key column raises when the source is built: VegaError in
    the port (never KernelError, kept for the kernels), ValueError in the
    reference (its broadcast inside the exchange)."""
    ref, port = ctxs
    k2d = np.array([[1, 2], [1, 2], [3, 4]], np.int32)
    x = np.array([1, 2, 3], np.int32)
    with pytest.raises(ValueError):
        ref.dense_from_numpy(k2d, x).reduce_by_key(op="add").collect()
    with pytest.raises(VegaError, match="1-D") as info:
        port.dense_from_numpy(k2d, x).reduce_by_key(op="add").collect()
    assert not isinstance(info.value, KernelError)


# ---------------------------------------------------------------------------
# the differences that remain, each naming both sides
# ---------------------------------------------------------------------------

SUBNORMALS = np.array([1e-40, 1e-40, 2e-40], np.float32)


@pytest.mark.parametrize("path", ["sum", "reduce_by_key", "fold"])
def test_subnormal_sums_differ(ctxs, path):
    """XLA:CPU flushes float32 subnormals to 0.0 in the reference; the
    port keeps IEEE (3.99999e-40)."""
    ref, port = ctxs
    k = np.ones(3, np.int32)

    def run(c, fold):
        if path == "sum":
            return c.dense_from_numpy(SUBNORMALS).sum()
        if path == "reduce_by_key":
            return c.dense_from_numpy(k, SUBNORMALS).reduce_by_key(
                op="add").collect()[0][1]
        return fold(c, list(zip([1, 1, 1], SUBNORMALS.tolist())),
                    "add")[1]
    assert run(ref, ref_fold) == 0.0
    np.testing.assert_allclose(run(port, port_fold), 4e-40, rtol=1e-5)


def test_wide_distinct_error_classes(ctxs):
    """distinct() over a wide int64 column: the reference raises its
    private _NotTraceable (built outside any fallback), the port
    VegaError naming the host tier."""
    ref, port = ctxs
    x = np.array([1, 2**40, 2**40], np.int64)
    with pytest.raises(ref_dense._NotTraceable):
        ref.dense_from_numpy(x).distinct().collect()
    with pytest.raises(VegaError, match="host tier"):
        port.dense_from_numpy(x).distinct().collect()


U16_OPS = {
    "sort_by_key": lambda c, k, x: c.dense_from_numpy(k, x).sort_by_key()
    .collect(),
    "max": lambda c, k, x: c.dense_from_numpy(x).max(),
    "filter": lambda c, k, x: c.dense_from_numpy(x).filter(
        lambda y: y > 30000).collect(),
    "union": lambda c, k, x: sorted(c.dense_from_numpy(x).union(
        c.dense_from_numpy(x)).collect()),
    "left_outer_join": lambda c, k, x: sorted(c.dense_from_numpy(
        k, x).left_outer_join(c.dense_from_numpy(k[:5], x[:5])).collect()),
}


@pytest.mark.parametrize("op", sorted(U16_OPS))
def test_uint16_ops_agree(ctxs, op):
    """ROADMAP recorded uint16 sort_by_key / max / filter / union /
    left_outer_join as a TypeError ('int' object is not iterable) in the
    reference. It does not reproduce on this mesh and these plans: the
    reference returns rows, and the port returns the same rows."""
    ref, port = ctxs
    rng = np.random.RandomState(8)
    k = rng.randint(0, 65536, 200).astype(np.uint16)
    x = rng.randint(0, 65536, 200).astype(np.uint16)
    got = U16_OPS[op](port, k, x)
    exp = U16_OPS[op](ref, k, x)
    if op == "sort_by_key":
        assert [r[0] for r in got] == [r[0] for r in exp]
        assert sorted(got) == sorted(exp)
    else:
        assert got == exp


def test_uint32_sum_exact_where_reference_shard_wraps(ctxs):
    """sum() of uint32 is exact in the port (int64 partials). The
    reference's per-shard partial is uint32 and wraps mod 2^32 once a
    shard's sum passes 2^32: 16 rows of 4e9 over 8 shards (two per
    shard) give 8 x (8e9 mod 2^32) there."""
    ref, port = ctxs
    x = np.full(16, 4_000_000_000, np.uint32)
    assert port.dense_from_numpy(x).sum() == 64_000_000_000
    assert ref.dense_from_numpy(x).sum() == 8 * (8_000_000_000 % 2**32)


def test_uint16_sum_exact_where_reference_shard_wraps(ctxs):
    """sum() of uint16 is exact in the port too (one rule for every
    unsigned dtype: int64 partials). The reference accumulates each
    shard in uint32, which wraps once a shard's sum passes 2^32: 65,538
    rows of 65535 per shard over 8 shards."""
    ref, port = ctxs
    x = np.full(8 * 65538, 65535, np.uint16)
    exact = 8 * 65538 * 65535
    assert port.dense_from_numpy(x).sum() == exact
    assert ref.dense_from_numpy(x).sum() == 8 * (65538 * 65535 % 2**32)


@pytest.mark.parametrize("dt", NARROW + ("uint32",))
def test_dense_range_dtypes(ctxs, dt):
    """dense_range(n, dtype): the reference adds a dtype iota to an int32
    shard base, so a narrow or unsigned integer dtype gives int32 rows (no
    wrap) and float16 float16 rows; the port gives the same rows and
    dtypes."""
    import jax.numpy as jnp
    import torch

    ref, port = ctxs
    exp = ref.dense_range(300, dtype=getattr(jnp, dt)).collect_arrays()
    got = port.dense_range(300, dtype=getattr(torch, dt)).collect_arrays()
    assert _dtypes(got) == _dtypes(exp)
    np.testing.assert_array_equal(got["v"], exp["v"])
