"""The plans and deferred exchanges of vega_tpu_torch against vega_tpu, on
the CPU.

Every dense_sort_impl x dense_rbk_plan runs the bench pipeline (and an
int32 min reduce) through vega_tpu on the 8-device CPU mesh with the same
settings on its Configuration and through vega_tpu_torch's
Context(device="cpu", n_shards=8): per-shard counts and keys equal (same
placement), int32 results bit-identical, float sums within rtol 1e-5
(float32 sums are taken in another order). The table plan, the deferred
launches with their settlement and repair, and misspelt plans follow the
reference's own tests (tests/test_dense.py). The fault regression runs the
pipeline at 256 and 300 shards against numpy.
"""

import numpy as np
import pytest
import torch

import vega_tpu as v
import vega_tpu_torch as vt
from vega_tpu_torch import cuda_kernels
from vega_tpu_torch import kernels
from vega_tpu_torch.errors import VegaError

N_SHARDS = 8
KNOBS = ("dense_sort_impl", "dense_rbk_plan", "dense_table_plan")
SORT_IMPLS = ["xla", "packed", "radix", "radix4"]
RBK_PLANS = ["fused_sort", "sort_partition"]


@pytest.fixture()
def ref_env():
    """A vega_tpu Context and its Configuration; the plan knobs are
    restored afterwards."""
    from vega_tpu.env import Env

    context = v.Context("local", num_workers=2)
    conf = Env.get().conf
    old = {k: getattr(conf, k) for k in KNOBS}
    try:
        yield context, conf
    finally:
        for k, val in old.items():
            setattr(conf, k, val)
        context.stop()


def _pipeline(ctx, n_rows=20_000, n_keys=500):
    kv = ctx.dense_range(n_rows).map(lambda x: (x % n_keys, x * 0.5))
    reduced = kv.reduce_by_key(op="add")
    table = ctx.dense_from_numpy(np.arange(n_keys, dtype=np.int32),
                                 np.arange(n_keys, dtype=np.float32) * 2.0)
    mins = ctx.dense_range(n_rows).map(
        lambda x: ((x * 7) % n_keys, x)).reduce_by_key(op="min")
    return reduced, reduced.join(table), mins


def _assert_reduce_equal(got, exp, exact):
    """Same rows on the same shards in the same (key-sorted) order."""
    np.testing.assert_array_equal(got.block().counts_np,
                                  exp.block().counts_np)
    g, e = got.collect_arrays(), exp.collect_arrays()
    np.testing.assert_array_equal(g["k"], np.asarray(e["k"]))
    if exact:
        np.testing.assert_array_equal(g["v"], np.asarray(e["v"]))
    else:
        np.testing.assert_allclose(g["v"], np.asarray(e["v"]), rtol=1e-5)


def _assert_join_equal(got, exp):
    g = sorted(got.collect())
    e = sorted((int(k), (float(lv), float(rv))) for k, (lv, rv)
               in exp.collect())
    assert [r[0] for r in g] == [r[0] for r in e]
    np.testing.assert_allclose([r[1][0] for r in g], [r[1][0] for r in e],
                               rtol=1e-5)
    assert [r[1][1] for r in g] == [r[1][1] for r in e]


def _numpy_sums(n_rows, n_keys):
    x = np.arange(n_rows)
    return np.bincount(x % n_keys, weights=x * 0.5, minlength=n_keys)


# ---------------------------------------------------------------- plans
@pytest.mark.parametrize("rbk_plan", RBK_PLANS)
@pytest.mark.parametrize("sort_impl", SORT_IMPLS)
def test_pipeline_matches_reference(ref_env, sort_impl, rbk_plan):
    """Cold (blocking, histogram-sized) and warm (deferred, hinted) runs
    of every sort form under both reduce plans."""
    ref_ctx, conf = ref_env
    conf.dense_sort_impl, conf.dense_rbk_plan = sort_impl, rbk_plan
    conf.dense_table_plan = "off"
    with vt.Context(device="cpu", n_shards=N_SHARDS,
                    dense_sort_impl=sort_impl, dense_rbk_plan=rbk_plan,
                    dense_table_plan="off") as ctx:
        for _run in ("cold", "warm"):
            got_red, got_join, got_min = _pipeline(ctx)
            exp_red, exp_join, exp_min = _pipeline(ref_ctx)
            assert got_join.count() == exp_join.count() == 500
            _assert_reduce_equal(got_red, exp_red, exact=False)
            _assert_reduce_equal(got_min, exp_min, exact=True)
            _assert_join_equal(got_join, exp_join)
        assert got_red._last_attempts == 1 and not ctx._pending


def test_cpu_auto_pipeline_matches_reference(ref_env):
    """'auto' on the CPU resolves alike in both packages (packed,
    sort_partition, the table plan on): cold run, then the warm run, whose
    add reduce takes the table plan in both."""
    ref_ctx, conf = ref_env
    for k in KNOBS:
        setattr(conf, k, "auto")
    with vt.Context(device="cpu", n_shards=N_SHARDS) as ctx:
        for run in ("cold", "warm"):
            got_red, got_join, _ = _pipeline(ctx)
            exp_red, exp_join, _ = _pipeline(ref_ctx)
            _assert_reduce_equal(got_red, exp_red, exact=False)
            _assert_join_equal(got_join, exp_join)
            assert got_red._table_plan == exp_red._table_plan \
                == (run == "warm")
    sums = _numpy_sums(20_000, 500)
    np.testing.assert_allclose(
        got_join.collect_arrays()["lv"],
        sums[got_join.collect_arrays()["k"]], rtol=1e-5)


@pytest.mark.parametrize("knob,bad", [("dense_rbk_plan", "sort-partition"),
                                      ("dense_sort_impl", "Radix"),
                                      ("dense_table_plan", "yes")])
def test_misspelt_plan_raises(ref_env, knob, bad):
    """A misspelt value raises naming the setting and the allowed values,
    in the reference when the reduce materializes, in the port when the
    Context is made."""
    ref_ctx, conf = ref_env
    setattr(conf, knob, bad)
    with pytest.raises(v.VegaError, match=knob):
        (ref_ctx.dense_range(1_000).map(lambda x: (x % 7, x))
         .reduce_by_key(op="add").collect())
    with pytest.raises(VegaError, match=knob) as err:
        vt.Context(device="cpu", **{knob: bad})
    assert "'auto'" in str(err.value)


def test_auto_resolves_by_device(ref_env):
    """cpu -> packed / sort_partition / on (the reference's CPU choices);
    cuda -> xla / fused_sort / off; explicit values pass through."""
    from vega_tpu.tpu import kernels as ref_kernels

    _ref_ctx, conf = ref_env
    conf.dense_sort_impl = "auto"
    with vt.Context(device="cpu") as ctx:
        assert (ctx.dense_sort_impl, ctx.dense_rbk_plan,
                ctx.dense_table_plan) == ("packed", "sort_partition", "on")
        assert ctx.dense_sort_impl == ref_kernels.resolve_sort_impl()
    cuda = torch.device("cuda")
    for name, allowed, cpu_choice, gpu_choice in (
            ("dense_sort_impl", kernels.SORT_IMPLS, "packed", "xla"),
            ("dense_rbk_plan", kernels.RBK_PLANS, "sort_partition",
             "fused_sort"),
            ("dense_table_plan", kernels.TABLE_PLANS, "on", "off")):
        assert kernels.resolve_backend_mode(
            name, "auto", allowed, cpu_choice, gpu_choice,
            cuda) == gpu_choice
        for value in allowed[1:]:
            assert kernels.resolve_backend_mode(
                name, value, allowed, cpu_choice, gpu_choice, cuda) == value


@pytest.mark.parametrize("n_shards", [256, 300])
def test_pipeline_past_256_shards(n_shards):
    """Fault regression: the exchange's bucket counts above the kernel's
    256 bins take the per-shard bincount (the reference dispatcher's
    rule), so 256 and more shards run; numpy is the oracle (no 256-device
    reference mesh here). digit_hist itself still refuses 257 bins."""
    with vt.Context(device="cpu", n_shards=n_shards) as ctx:
        _red, joined, _mins = _pipeline(ctx, 5_000, 700)
        got = joined.collect_arrays()
    np.testing.assert_array_equal(np.sort(got["k"]), np.arange(700))
    np.testing.assert_allclose(got["lv"], _numpy_sums(5_000, 700)[got["k"]],
                               rtol=1e-5)
    np.testing.assert_array_equal(got["rv"], got["k"] * 2.0)
    with pytest.raises(VegaError, match="n_bins"):
        cuda_kernels.digit_hist(torch.zeros((2, 8), dtype=torch.int32),
                                n_shards + 1)


# ---------------------------------------------------------------- table
def _keyed(ctx, op, vdtype, n_rows=20_000, n_keys=1_000):
    if vdtype == np.int32:
        kv = ctx.dense_range(n_rows).map(lambda x: (x % n_keys, x - 7_000))
    else:
        kv = ctx.dense_range(n_rows).map(
            lambda x: (x % n_keys, (x - 7_000) * 0.25))
    return kv.reduce_by_key(op=op)


def _numpy_reduce(op, vdtype, n_rows=20_000, n_keys=1_000):
    x = np.arange(n_rows)
    vals = (x - 7_000) if vdtype == np.int32 else (x - 7_000) * 0.25
    out = {"add": np.zeros(n_keys), "min": np.full(n_keys, np.inf),
           "max": np.full(n_keys, -np.inf)}[op]
    {"add": np.add, "min": np.minimum, "max": np.maximum}[op].at(
        out, x % n_keys, vals)
    return out


@pytest.mark.parametrize("op,vdtype", [("add", np.int32),
                                       ("add", np.float32),
                                       ("min", np.int32),
                                       ("max", np.float32)])
def test_table_plan_matches_reference(ref_env, op, vdtype):
    """The warm table run equals the reference's reduce: per shard (the
    table output is hash-placed) and against numpy. The reference's table
    plan combines its per-shard tables with a sum, which is right for add
    only; for min and max the port reduces the tables by the op, so it is
    held against the reference's standard plan there."""
    ref_ctx, conf = ref_env
    conf.dense_sort_impl = "auto"
    conf.dense_rbk_plan = "auto"
    conf.dense_table_plan = "on" if op == "add" else "off"
    exact = vdtype == np.int32
    with vt.Context(device="cpu", n_shards=N_SHARDS,
                    dense_table_plan="on") as ctx:
        cold = _keyed(ctx, op, vdtype)
        cold.count()
        assert cold._table_plan is False
        warm = _keyed(ctx, op, vdtype)
        assert warm.block_spec().settle is not None
        for exp in (_keyed(ref_ctx, op, vdtype), _keyed(ref_ctx, op, vdtype)):
            _assert_reduce_equal(warm, exp, exact=exact)
        assert warm._table_plan is True and warm.hash_placed \
            and warm.key_sorted
        if op == "add":
            assert exp._table_plan is True
        _assert_reduce_equal(warm, cold, exact=exact)
    got = warm.collect_arrays()
    np.testing.assert_allclose(got["v"], _numpy_reduce(op, vdtype)[got["k"]],
                               rtol=1e-5)


def test_table_plan_warm_reduce_and_repair():
    """Port of the reference's test_table_plan_warm_reduce_and_repair: a
    warm rerun whose key range was observed small takes the table plan
    (hash-placed, key-sorted output, a downstream join still elides); a
    poisoned (too small) range flags on the device and settles through the
    standard plan, which learns the range again."""
    with vt.Context(device="cpu", n_shards=N_SHARDS) as ctx:
        def build():
            return (ctx.dense_range(20_000).map(lambda x: (x % 1_000, x))
                    .reduce_by_key(op="add"))

        r1 = build()
        exp = dict(r1.collect())  # cold: standard plan, learns [0, 999]
        assert r1._table_plan is False
        r2 = build()
        assert dict(r2.collect()) == exp
        assert r2._table_plan is True
        assert r2.hash_placed and r2.key_sorted
        table = ctx.dense_from_numpy(np.arange(1_000, dtype=np.int32),
                                     np.arange(1_000, dtype=np.int32) * 2)
        assert dict(r2.join(table).collect())[7] == (exp[7], 14)

        r3 = build()
        ctx._key_range_hints[r3._hint_key()] = (0, 99)  # claims [0, 100)
        blk = r3.block_spec()
        assert r3._table_plan is True  # the speculative launch happened
        assert blk.settle is not None
        assert dict(r3.collect()) == exp  # flag -> standard-plan repair
        assert not ctx._pending
        r4 = build()
        assert dict(r4.collect()) == exp
        assert r4._table_plan is True  # the repair learned the range again


# ------------------------------------------------------------- deferral
def _plain_ctx():
    """Standard plans (no table plan) on the CPU."""
    return vt.Context(device="cpu", n_shards=N_SHARDS,
                      dense_table_plan="off")


def test_warm_rerun_defers_overflow_to_settlement():
    """Port of the reference's test of the same name: a warm rerun
    launches without its blocking fetch, the block carries a settle hook,
    and the first host read verifies and commits every pending entry in
    one transfer."""
    with vt.Context(device="cpu", n_shards=N_SHARDS) as ctx:
        def build():
            kv = ctx.dense_range(20_000).map(lambda x: (x % 500, x * 1.0))
            red = kv.reduce_by_key(op="add")
            table = ctx.dense_from_numpy(np.arange(500, dtype=np.int32),
                                         np.arange(500, dtype=np.float32))
            return red, red.join(table)

        red1, j1 = build()
        assert j1.count() == 500  # cold: blocking, seeds the hints
        assert j1.block().settle is None and not ctx._pending
        red2, j2 = build()
        blk = j2.block_spec()  # warm: hinted -> deferred
        assert blk.settle is not None, "warm join should defer its fetch"
        assert blk.counts_host is None
        assert red2._last_attempts == 1
        assert [e["rdd"] for e in ctx._pending] == [red2, j2]
        assert j2.count() == 500  # settles everything
        assert blk.settle is None and blk.counts_host is not None
        assert red2.block_spec().settle is None
        assert not ctx._pending
        assert sorted(j2.collect()) == sorted(j1.collect())


def test_failed_speculation_repairs_downstream_consumers():
    """Port of the reference's test of the same name: a poisoned reduce
    hint makes the join consume capacity-truncated data; settlement sees
    the reduce's overflow and rebuilds both, in order, before any host
    read sees results."""
    with _plain_ctx() as ctx:
        def build():
            kv = ctx.dense_range(30_000).map(lambda x: (x % 3_000, x * 1.0))
            red = kv.reduce_by_key(op="add")
            table = ctx.dense_from_numpy(np.arange(3_000, dtype=np.int32),
                                         np.arange(3_000, dtype=np.float32))
            return red, red.join(table)

        red1, j1 = build()
        expected = sorted(j1.collect())  # cold run: the oracle
        red2, j2 = build()
        ctx._capacity_hints[red2._hint_key()] = (128, 128)  # poison
        jblk = j2.block_spec()
        assert len(ctx._pending) == 2
        assert sorted(j2.collect()) == expected
        assert j2.block_spec() is jblk  # repaired in place
        assert not ctx._pending
        assert ctx._capacity_hints[red2._hint_key()] != (128, 128)


def test_settlement_midway_error_requeues_failed_entries():
    """Port of the reference's test of the same name: a later entry's
    validator raising mid-settlement puts the entries already triaged as
    failed back on the backlog too; the next read repairs them."""
    with _plain_ctx() as ctx:
        def build_a():
            kv = ctx.dense_range(20_000).map(lambda x: (x % 2_000, x * 1.0))
            return kv.reduce_by_key(op="add")

        def build_b():
            kv = ctx.dense_range(24_000).map(lambda x: (x % 500, x * 1.0))
            return kv.reduce_by_key(op="add")

        exp_a = dict(build_a().collect())
        exp_b = dict(build_b().collect())
        a2, b2 = build_a(), build_b()
        assert a2._hint_key() != b2._hint_key()
        ctx._capacity_hints[a2._hint_key()] = (64, 64)  # A overflows
        a2.block_spec()
        b2.block_spec()
        assert [e["rdd"] for e in ctx._pending] == [a2, b2]

        def dies(head):
            raise RuntimeError("transient settlement failure")

        ctx._pending[1]["validate"] = dies
        with pytest.raises(RuntimeError, match="transient settlement"):
            a2.count()
        assert [e["rdd"] for e in ctx._pending] == [a2, b2]
        ctx._pending[1]["validate"] = None
        assert dict(a2.collect()) == exp_a
        assert dict(b2.collect()) == exp_b
        assert not ctx._pending


def test_blocking_exchange_settles_backlog_first():
    """A blocking exchange sizes from its input's counts and histograms:
    it settles the backlog before it trusts them, so a consumer of a
    failed speculation sees the repaired rows."""
    with _plain_ctx() as ctx:
        def build():
            return (ctx.dense_range(30_000).map(lambda x: (x % 3_000, x))
                    .reduce_by_key(op="add"))

        exp = dict(build().collect())
        red = build()
        ctx._capacity_hints[red._hint_key()] = (128, 128)  # poison
        blk = red.block_spec()
        assert blk.settle is not None
        # a new lineage over the pending reduce: no hint, so blocking
        swapped = red.map(lambda kv: (kv[1] % 11, kv[0])) \
            .reduce_by_key(op="max")
        got = dict(swapped.collect())
        assert blk.settle is None and dict(red.collect()) == exp
        want = {}
        for k, s in exp.items():
            want[s % 11] = max(want.get(s % 11, -1), k)
        assert got == want


def test_blocking_exchange_applies_the_narrow_chain_once():
    """A cold (blocking) reduce reads its narrow chain once: the sizing
    histograms and the build round share the mapped columns."""
    calls = [0]

    def f(x):
        calls[0] += 1
        return x % 500, x * 0.5

    with _plain_ctx() as ctx:
        kv = ctx.dense_range(20_000).map(f)
        traced = calls[0]
        red = kv.reduce_by_key(op="add")
        np.testing.assert_allclose(
            [s for _k, s in sorted(red.collect())],
            _numpy_sums(20_000, 500), rtol=1e-5)
        assert red._last_attempts == 1
        assert calls[0] - traced == 1


def _warm_pending(ctx, poison=False):
    """A cold run of the bench pipeline, then its warm rerun left pending
    (a reduce and a join; with poison, the reduce launched at capacities
    too small, so it overflows); returns (expected join rows, warm reduce,
    warm join)."""
    def build():
        kv = ctx.dense_range(20_000).map(lambda x: (x % 500, x * 1.0))
        red = kv.reduce_by_key(op="add")
        table = ctx.dense_from_numpy(np.arange(500, dtype=np.int32),
                                     np.arange(500, dtype=np.float32))
        return red, red.join(table)

    expected = sorted(build()[1].collect())
    red, join = build()
    if poison:
        ctx._capacity_hints[red._hint_key()] = (16, 16)
    join.block_spec()
    assert [e["rdd"] for e in ctx._pending] == [red, join]
    return expected, red, join


@pytest.mark.parametrize("poison", [False, True])
def test_stop_settles_pending_blocks(poison):
    """stop() settles the backlog (repairing a poisoned hint's overflow),
    so blocks a caller holds read correctly after it, and the stopped
    Context holds no block."""
    ctx = _plain_ctx()
    expected, red, join = _warm_pending(ctx, poison)
    jblk = join.block_spec()
    ctx.stop()
    if poison:
        assert ctx._capacity_hints == {}  # the repair's hints went too
    assert not ctx._pending
    assert jblk.settle is None and jblk.counts_host is not None
    assert join.block_spec() is jblk
    assert sorted(join.collect()) == expected
    with pytest.raises(VegaError, match="stopped"):
        ctx.dense_range(10)


def test_stop_after_failed_settlement_blocks_raise():
    """A settlement that dies inside stop() raises, and the blocks it
    left unverified raise on read instead of serving unchecked rows."""
    ctx = _plain_ctx()
    _expected, red, join = _warm_pending(ctx)

    def dies(head):
        raise RuntimeError("transient settlement failure")

    ctx._pending[0]["validate"] = dies
    with pytest.raises(RuntimeError, match="transient settlement"):
        ctx.stop()
    assert not ctx._pending and ctx._stopped
    for node in (red, join):
        with pytest.raises(VegaError, match="repair did not complete"):
            node.count()


def test_validator_failure_keeps_the_exchange_hint():
    """A deferred join whose product outgrows its capacity fails its
    validator at settlement: the repair reruns at the exact product size
    the validator stashed, and the exchange's own hint stays."""
    rng = np.random.RandomState(8)
    lk = rng.randint(0, 20, size=3_000).astype(np.int32)
    rk = rng.randint(0, 20, size=500).astype(np.int32)
    with _plain_ctx() as ctx:
        def build(right_keys):
            return ctx.dense_from_numpy(lk, np.ones(3_000, np.float32)).join(
                ctx.dense_from_numpy(right_keys, np.ones(500, np.int32)))

        small = np.where(rk < 10, rk + 100, rk)  # fewer matches: small cap
        assert build(small).count() == sum(int(np.sum(small == k))
                                           for k in lk)
        j = build(rk)  # same lineage and sizes: hinted, deferred
        assert j.block_spec().settle is not None
        hint = ctx._capacity_hints[j._hint_key()]
        jc_key = (j._hint_key(), "join_cap")
        join_cap = ctx._capacity_hints[jc_key]
        assert j.count() == sum(int(np.sum(rk == k)) for k in lk)
        assert ctx._capacity_hints[j._hint_key()] == hint
        assert ctx._capacity_hints[jc_key] > join_cap  # the validator's fix
        assert not ctx._pending
