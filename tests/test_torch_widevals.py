"""Wide int64 values and keys of vega_tpu_torch against vega_tpu, on the
CPU.

An int64 column beyond int32 is the reference's two-column encoding
(<name> = high word, <name>.lo = biased low word), keys and values alike.
Named reduces over wide values run exactly: each pair becomes two int64
addends (add) or the int64 it encodes (min / max), so a total outside int64
raises VegaError ("int64 range") and a keyless sum beyond it comes back as
the exact bignum, with no host refold. Wide keys reduce and join on the
device, and an int32 key meeting an int64 one widens (_WidenKeyRDD). Each
lineage runs through a vega_tpu Context("local") on the 8-device CPU mesh
and through vega_tpu_torch's Context(device="cpu", n_shards=8), under the
card's plans (xla sorts, fused_sort, no table plan) unless a test names
others. Integers are bit-identical, with equal per-shard counts and row
order where the reference defines them; floats within rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vega_tpu as v
from vega_tpu.tpu import block as ref_block
from vega_tpu.tpu import kernels as ref_kernels
import vega_tpu_torch as vt
from vega_tpu_torch import block as port_block
from vega_tpu_torch import dense_rdd as port_dense
from vega_tpu_torch import kernels
from vega_tpu_torch.errors import VegaError

N_SHARDS = 8
ACCEL_PLANS = {"dense_rbk_plan": "fused_sort", "dense_table_plan": "off",
               "dense_sort_impl": "xla"}
PLANS = {
    "card": ACCEL_PLANS,
    "sort_partition": dict(ACCEL_PLANS, dense_rbk_plan="sort_partition"),
    "cpu defaults (packed, table on)": {"dense_rbk_plan": "auto",
                                        "dense_table_plan": "auto",
                                        "dense_sort_impl": "auto"},
}
BIG = 1 << 40


def _contexts(plans):
    from vega_tpu.env import Env

    ref = v.Context("local", num_workers=2)
    conf = Env.get().conf
    ref._restore_plans = {k: getattr(conf, k) for k in plans}
    for k, val in plans.items():
        setattr(conf, k, val)
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


@pytest.fixture(params=list(PLANS))
def plan_ctxs(request):
    ref, port = _contexts(PLANS[request.param])
    try:
        yield ref, port
    finally:
        _stop(ref, port)


def _same(got, exp):
    """The same rows in the same order and the same placement."""
    np.testing.assert_array_equal(got.block().counts_np,
                                  exp.block().counts_np)
    assert got.collect() == exp.collect()


def _wide_pairs(seed=0, n=3_000):
    """Keys 0..39 (int32) with int64 values straddling the 32-bit words:
    near +-2^40, near 2^32 - 1 (carries), and small negatives."""
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, 40, size=n).astype(np.int32)
    vals = rng.randint(-BIG, BIG, size=n, dtype=np.int64)
    vals[::7] = 0xFFFFFFFF - rng.randint(0, 3, size=len(vals[::7]))
    vals[1::11] = -rng.randint(1, 5, size=len(vals[1::11]))
    return keys, vals


def _i64_keys(seed=0, n=3_000):
    """The reference tests' int64 keys: +-5 * 3e9 plus 0..2 (both words
    vary), with int32 values."""
    rng = np.random.RandomState(seed)
    keys = (rng.randint(-5, 5, size=n).astype(np.int64) * 3_000_000_000
            + rng.randint(0, 3, size=n))
    return keys, rng.randint(0, 1000, size=n).astype(np.int32)


# ---------------------------------------------------------------------------
# the encoding and the wide arithmetic
# ---------------------------------------------------------------------------


def test_encode_value_columns_matches_reference():
    """In-range int64 stays narrow, beyond int32 takes (name, name.lo)
    with the reference's biased low word, a pre-encoded .lo passes
    through, uint64 beyond int64 raises; the key is left to
    encode_key_columns."""
    cols = {"k": np.array([1, 2**40], np.int64),
            "a": np.array([5, -6], np.int64),
            "b": np.array([2**40 + 3, -2**35], np.int64),
            "c": np.array([1.5, 2.5]),
            "d": np.array([2**62, 0], np.uint64)}
    exp = ref_block.encode_value_columns(dict(cols))
    got = port_block.encode_value_columns(dict(cols))
    assert list(got) == list(exp) == ["k", "a", "b", "b.lo", "c", "d",
                                      "d.lo"]
    for nm in exp:
        np.testing.assert_array_equal(got[nm], exp[nm])
    again = port_block.encode_value_columns(dict(got))
    assert list(again) == list(got)
    with pytest.raises(VegaError, match="uint64"):
        port_block.encode_value_columns(
            {"x": np.array([2**63], np.uint64)})


@pytest.mark.parametrize("fn", ["wide_add", "wide_add_checked",
                                "wide_select_min", "wide_select_max"])
def test_wide_arithmetic_matches_reference(fn):
    """Bit-identical words (and overflow flags) on pairs that carry,
    wrap and tie."""
    rng = np.random.RandomState(11)
    a = rng.randint(-2**63, 2**63 - 1, size=2_000, dtype=np.int64)
    b = rng.randint(-2**63, 2**63 - 1, size=2_000, dtype=np.int64)
    a[:100] = 0xFFFFFFFF
    b[:100] = 1
    a[100:200] = 2**63 - 1
    b[100:200] = rng.randint(1, 9, size=100)
    b[200:300] = a[200:300]
    ah, al = port_block.encode_i64(a)
    bh, bl = port_block.encode_i64(b)
    args_t = [torch.from_numpy(x) for x in (ah, al, bh, bl)]
    args_j = [jnp.asarray(x) for x in (ah, al, bh, bl)]
    if fn.startswith("wide_select"):
        take_min = fn.endswith("min")
        got = kernels.wide_select(*args_t, take_min)
        exp = ref_kernels.wide_select(*args_j, take_min)
    else:
        got = getattr(kernels, fn)(*args_t)
        exp = getattr(ref_kernels, fn)(*args_j)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


def test_wide_sums_are_exact():
    """wide_sum_words / wide_from_sums give the exact total and flag one
    outside int64, where the pairwise add wraps."""
    vals = np.array([2**62, 2**62, -2**62, 2**62 - 1, 5], np.int64)
    h, lo = port_block.encode_i64(vals)
    hs, ls = kernels.wide_sum_words(torch.from_numpy(h), torch.from_numpy(lo))
    for take, total in ((slice(0, 2), 2**63), (slice(0, 3), 2**62),
                        (slice(3, 5), 2**62 + 4)):
        hi, low, bad = kernels.wide_from_sums(hs[take].sum(0, keepdim=True),
                                              ls[take].sum(0, keepdim=True))
        assert bool(bad[0]) == (total > 2**63 - 1)
        if not bad[0]:
            assert port_block.decode_i64(hi.numpy(), low.numpy())[0] == total


# ---------------------------------------------------------------------------
# wide values through the keyed ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_wide_value_reduce_matches_reference(plan_ctxs, op):
    """Both reduce plans, and the table plan's CPU default (which the
    reference, like the port, never takes for wide values)."""
    ref, port = plan_ctxs
    keys, vals = _wide_pairs(1)
    got = port.dense_from_numpy(keys, vals).reduce_by_key(op=op)
    exp = ref.dense_from_numpy(keys, vals).reduce_by_key(op=op)
    _same(got, exp)
    agg = {"add": np.add, "min": np.minimum, "max": np.maximum}[op]
    expect = {}
    for k, x in zip(keys.tolist(), vals.tolist()):
        expect[k] = x if k not in expect else int(agg(expect[k], x))
    assert dict(got.collect()) == expect
    again = port.dense_from_numpy(keys, vals).reduce_by_key(op=op)
    assert dict(again.collect()) == expect  # the warm (deferred) run


def test_wide_values_carry_and_boundary_totals(ctxs):
    """Carries across the 32-bit boundary; totals at the int64 edges;
    a total inside int64 whose partials wrap comes back exact. There the
    reference's conservative flag sends it to a host refold, which drops
    its hash placement; the port decides exactly on the device and keeps
    it."""
    ref, port = ctxs
    cases = [
        (np.array([1, 1, 2, 2], np.int32),
         np.array([0xFFFFFFFF, 1, 2**33, 2**33], np.int64)),
        (np.array([7, 7, 8, 8], np.int32),
         np.array([2**62, 2**62 - 1, -2**62, -2**62 + 1], np.int64)),
        (np.array([3, 3, 3], np.int32),
         np.array([2**62, 2**62, -2**62], np.int64)),
    ]
    for i, (keys, vals) in enumerate(cases):
        got = port.dense_from_numpy(keys, vals).reduce_by_key(op="add")
        exp = ref.dense_from_numpy(keys, vals).reduce_by_key(op="add")
        if i < 2:
            _same(got, exp)
        else:
            assert got.collect() == exp.collect() == [(3, 2**62)]
            assert exp._host_folded and not exp.hash_placed
        assert got.hash_placed
    assert dict(port.dense_from_numpy(*cases[1]).reduce_by_key(op="add")
                .collect()) == {7: 2**63 - 1, 8: -2**63 + 1}


def test_wide_sum_outside_int64_raises(ctxs):
    """Never a silent wrap: both packages raise VegaError naming the int64
    range, cold and warm."""
    ref, port = ctxs
    keys = np.array([1, 1, 1, 2], np.int64)
    vals = np.array([2**62, 2**62, 2**62, 5], np.int64)
    with pytest.raises(v.VegaError, match="int64 range"):
        ref.dense_from_numpy(keys, vals).reduce_by_key(op="add").collect()
    for _ in range(2):
        with pytest.raises(VegaError, match="int64 range"):
            port.dense_from_numpy(keys, vals).reduce_by_key(
                op="add").collect()
    neg = np.array([-2**63, -1], np.int64)
    with pytest.raises(VegaError, match="int64 range"):
        port.dense_from_numpy(np.zeros(2, np.int32), neg).reduce_by_key(
            op="add").collect()


def test_wide_values_through_joins_groups_sorts(ctxs):
    """Joins carry wide values on either side; group_by_key, sort_by_key,
    take_ordered / top, count_by_key_dense, union and a named block with
    wide and narrow columns equal the reference's."""
    ref, port = ctxs
    keys, vals = _wide_pairs(2, n=600)
    t_keys = np.arange(0, 40, 2, dtype=np.int32)

    def run(ctx):
        d = ctx.dense_from_numpy(keys, vals)
        red = d.reduce_by_key(op="add")
        table = ctx.dense_from_numpy(t_keys, t_keys * 3)
        named = ctx.dense_from_columns(
            {"k2": keys, "w": vals, "x": keys.astype(np.float32)}, key="k2")
        return {
            "join": red.join(table),
            "join, table left": table.join(red),
            "outer, wide left": red.left_outer_join(table, fill_value=-1),
            "group": d.group_by_key(),
            "sort": d.sort_by_key(),
            "sort desc": d.sort_by_key(False),
            "count": d.count_by_key_dense(),
            "union": d.union(d),
            "named": named.reduce_by_key(op="add"),
        }, d

    got_all, gd = run(port)
    exp_all, ed = run(ref)
    for name, exp in exp_all.items():
        got = got_all[name]
        if name in ("join", "join, table left", "outer, wide left",
                    "group"):
            assert sorted(got.collect()) == sorted(exp.collect()), name
        elif name == "named":
            g, e = got.collect_arrays(), exp.collect_arrays()
            order_g, order_e = np.argsort(g["k"]), np.argsort(e["k"])
            np.testing.assert_array_equal(g["w"][order_g], e["w"][order_e])
            np.testing.assert_allclose(g["x"][order_g], e["x"][order_e],
                                       rtol=1e-5)
        else:
            _same(got, exp)
    for n in (5, 700):
        assert gd.take_ordered(n) == ed.take_ordered(n)
        assert gd.top(n) == ed.top(n)
    _gk, _offs, gv = got_all["group"].collect_grouped()
    assert gv.dtype == np.int64


def test_keyless_wide_actions(ctxs):
    """sum / min / max / mean return Python ints (mean a float), a sum
    beyond int64 the exact bignum; collect, take, take_ordered / top and
    values_dense decode."""
    ref, port = ctxs
    data = [2**40, -2**35, 7, 2**62, -2**40, 0, 2**40]
    arr = np.array(data, np.int64)
    got, exp = port.dense_from_numpy(arr), ref.dense_from_numpy(arr)
    assert got.columns == ["v", "v.lo"]
    for action in ("sum", "min", "max", "mean", "count", "collect"):
        assert getattr(got, action)() == getattr(exp, action)()
    assert got.take(3) == exp.take(3)
    assert got.take_ordered(3) == exp.take_ordered(3) == sorted(data)[:3]
    assert got.top(3) == exp.top(3)
    over = np.array([2**62, 2**62, 2**62], np.int64)
    assert port.dense_from_numpy(over).sum() == 3 * 2**62 == \
        ref.dense_from_numpy(over).sum()
    mixed = np.array([2**62, 2**62, -2**62, 5], np.int64)
    assert port.dense_from_numpy(mixed).sum() == 2**62 + 5
    pairs = port.dense_from_numpy(np.array([1, 2, 1], np.int32),
                                  np.array([2**40, 5, 2**41], np.int64))
    vals = pairs.values_dense()
    assert vals.columns == ["v", "v.lo"]
    assert vals.sum() == 2**40 + 2**41 + 5 and vals.max() == 2**41
    blank = np.zeros(N_SHARDS * 128, np.int32)
    empty = port_block.from_reference_arrays(
        {"v": blank, "v.lo": blank}, np.zeros(N_SHARDS, np.int32), 128,
        port.mesh)
    with pytest.raises(VegaError, match="empty"):
        port_dense.dense_from_block(port, empty).min()
    assert port_dense.dense_from_block(port, empty).sum() == 0


def test_wide_host_tier_requests_raise(ctxs):
    """Where the reference hands a wide column to its host tier, the port
    runs a closure in the host tier's row form (host_rows.py), with the
    reference's rows (order-free by key after its host shuffle), and
    every other request on its host RDD layer, as the reference's."""
    ref, port = ctxs
    keys, vals = _wide_pairs(3, n=100)
    pairs = port.dense_from_numpy(keys, vals)
    bare = port.dense_from_numpy(vals)
    narrow = port.dense_from_numpy(keys, keys)
    for op in (lambda c: c.dense_from_numpy(keys, vals).map(lambda kv: kv),
               lambda c: c.dense_from_numpy(keys, vals).filter(
                   lambda kv: kv[1] > 0),
               lambda c: c.dense_from_numpy(keys, vals).map_values(
                   lambda x: x + 1),
               lambda c: c.dense_from_numpy(keys, vals).reduce_by_key(
                   lambda a, b: a ^ b),
               lambda c: c.dense_from_numpy(keys, vals).combine_by_key(
                   lambda x: x, lambda c, x: c + x, lambda a, b: a + b),
               lambda c: c.dense_from_numpy(vals).map(lambda x: x)):
        assert sorted(op(port).collect()) == sorted(op(ref).collect())
    assert bare.reduce(lambda a, b: a + b) == \
        ref.dense_from_numpy(vals).reduce(lambda a, b: a + b)
    assert bare.count_by_value() == \
        ref.dense_from_numpy(vals).count_by_value()
    # a product of these values leaves int64: the reference keeps the
    # Python int, the port raises
    with pytest.raises(VegaError, match="int64"):
        pairs.reduce_by_key(lambda a, b: a * b).collect()
    # the host tier's answers: the reference's host join, stats,
    # histogram and zip_with_index over the decoded int64s, rows equal
    for op in (lambda c: c.dense_from_numpy(keys, keys).left_outer_join(
                   c.dense_from_numpy(keys, vals), fill_value=0),
               lambda c: c.dense_from_numpy(vals).zip_with_index()):
        assert sorted(op(port).collect()) == sorted(op(ref).collect())
    for op in (lambda c: c.dense_from_numpy(vals).stats(),
               lambda c: c.dense_from_numpy(vals).histogram(3)):
        assert op(port) == op(ref)
    # distinct has no device form over a wide value (the reference's
    # device form fails there too, on its own trace)
    with pytest.raises(VegaError, match="host tier"):
        bare.distinct()
    with pytest.raises(VegaError, match="prod"):
        pairs.reduce_by_key(op="prod")
    # the canonical add closure is the named add, exact
    assert dict(pairs.reduce_by_key(lambda a, b: a + b).collect()) == \
        dict(pairs.reduce_by_key(op="add").collect())


# ---------------------------------------------------------------------------
# wide keys through reduce and join
# ---------------------------------------------------------------------------

WIDE_KEY_OPS = {
    "reduce add": lambda d: d.reduce_by_key(op="add"),
    "reduce max": lambda d: d.reduce_by_key(op="max"),
    "sum_by_key": lambda d: d.sum_by_key(),
    "count_by_key_dense": lambda d: d.count_by_key_dense(),
    "traced xor": lambda d: d.reduce_by_key(lambda a, b: a ^ b),
    "combine_by_key": lambda d: d.combine_by_key(
        lambda x: x * 2, lambda c, x: c + x * 2, lambda a, b: a + b),
    "reduce of a reduce": lambda d: d.reduce_by_key(op="add")
    .reduce_by_key(op="max"),
}


@pytest.mark.parametrize("op", list(WIDE_KEY_OPS))
def test_wide_key_reduces_match_reference(plan_ctxs, op):
    ref, port = plan_ctxs
    keys, vals = _i64_keys(4)
    got = WIDE_KEY_OPS[op](port.dense_from_numpy(keys, vals))
    exp = WIDE_KEY_OPS[op](ref.dense_from_numpy(keys, vals))
    _same(got, exp)


@pytest.mark.parametrize("outer", [False, True])
def test_wide_key_joins_match_reference(ctxs, outer):
    ref, port = ctxs
    keys, vals = _i64_keys(5, n=2_000)
    t_keys = np.unique(keys)[::2]

    def run(ctx):
        d = ctx.dense_from_numpy(keys, vals)
        table = ctx.dense_from_numpy(t_keys,
                                     np.arange(len(t_keys), dtype=np.int32))
        red = d.reduce_by_key(op="add")
        if outer:
            return d.left_outer_join(table, fill_value=-1), \
                red.left_outer_join(table, fill_value=-1)
        return d.join(table), red.join(table)

    for got, exp in zip(run(port), run(ref)):
        np.testing.assert_array_equal(got.block().counts_np,
                                      exp.block().counts_np)
        assert sorted(got.collect()) == sorted(exp.collect())


def test_mixed_width_sides_widen(ctxs):
    """An int32 key meets an int64 one in join, left_outer_join and
    cogroup through _WidenKeyRDD, either side; the widened side's
    placement resets; keys of two other kinds (a float32 key) are the
    host tier's join and cogroup, whose rows are the reference's."""
    ref, port = ctxs

    def run(ctx):
        fact = ctx.dense_from_numpy(
            np.array([0, -7, 2**40, 2**40, 5], np.int64),
            np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32))
        t32 = ctx.dense_from_numpy(np.array([0, -7, 9, 5], np.int32),
                                   np.array([10., 20., 90., 50.], np.float32))
        return fact, t32

    (gf, gt), (ef, et) = run(port), run(ref)
    for build in (lambda f, t: f.join(t), lambda f, t: t.join(f),
                  lambda f, t: f.left_outer_join(t, fill_value=-1),
                  lambda f, t: t.left_outer_join(f, fill_value=-1)):
        got, exp = build(gf, gt), build(ef, et)
        np.testing.assert_array_equal(got.block().counts_np,
                                      exp.block().counts_np)
        assert sorted(got.collect()) == sorted(exp.collect())
    assert sorted(gf.cogroup(gt).collect()) == sorted(ef.cogroup(et).collect())
    assert sorted(gt.cogroup(gf).collect()) == sorted(et.cogroup(ef).collect())
    red = gt.reduce_by_key(op="add")
    red.count()
    widened = port_dense._WidenKeyRDD(red)
    assert red.hash_placed and not widened.hash_placed
    assert widened.columns == ["k", "k.lo", "v"]
    fk, fv = np.array([5.0, 0.0], np.float32), np.ones(2)
    got = gf.join(port.dense_from_numpy(fk, fv))
    assert not isinstance(got, port_dense.DenseRDD)
    assert sorted(got.collect()) == sorted(
        ef.join(ref.dense_from_numpy(fk, fv)).collect())
    got = gt.cogroup(port.dense_from_numpy(fk, fv))
    assert sorted(got.collect()) == sorted(
        et.cogroup(ref.dense_from_numpy(fk, fv)).collect())


def test_wide_key_row_functions_raise(ctxs):
    """map / filter / key_by over a wide key have no device row form: the
    reference takes its host tier, and the port the host tier's row form
    (host_rows.py), with the reference's rows for map and filter; key_by
    over pairs makes a (k, v) tuple a value, which no column holds: the
    host RDD layer's map, as the reference's host tier. map_values over
    a narrow value keeps the wide key."""
    ref, port = ctxs
    keys = np.array([2**40, 1, 2**40], np.int64)
    vals = np.array([1, 2, 3], np.int32)
    d = port.dense_from_numpy(keys, vals)
    e = ref.dense_from_numpy(keys, vals)
    for op in (lambda r: r.map(lambda kv: (kv[0], kv[1] * 10)),
               lambda r: r.filter(lambda kv: kv[1] > 1)):
        got = op(d)
        assert got.host_rows
        assert sorted(got.collect()) == sorted(op(e).collect())
    got = d.key_by(lambda kv: kv[1])
    assert not isinstance(got, port_dense.DenseRDD)
    assert got.collect() == e.key_by(lambda kv: kv[1]).collect()
    _same(d.map_values(lambda x: x * 10),
          ref.dense_from_numpy(keys, vals).map_values(lambda x: x * 10))
