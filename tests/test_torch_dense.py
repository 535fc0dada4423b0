"""The dense main path of vega_tpu_torch against vega_tpu, on the CPU.

The bench pipeline (dense_range -> map -> reduce_by_key(op="add") -> join
against a K-row table -> count/collect) runs through a vega_tpu
Context("local") on the 8-device CPU mesh, pinned to the reference's
accelerator plans (fused_sort, no table plan, xla sorts), and through the
port's Context(device="cpu", n_shards=8). Counts and keys must be exact,
the reduce output's per-shard counts equal (same placement), float sums
within rtol=1e-5 (float32 sums are taken in another order).
"""

import numpy as np
import pytest
import torch

import vega_tpu as v
from vega_tpu.tpu import block as ref_block
from vega_tpu.tpu import mesh as ref_mesh
import vega_tpu_torch as vt
from vega_tpu_torch import block as port_block
from vega_tpu_torch import dense_rdd as port_dense
from vega_tpu_torch.errors import VegaError

N_SHARDS = 8
ACCEL_PLANS = {"dense_rbk_plan": "fused_sort", "dense_table_plan": "off",
               "dense_sort_impl": "xla"}


@pytest.fixture()
def ref_ctx():
    from vega_tpu.env import Env

    context = v.Context("local", num_workers=2)
    conf = Env.get().conf
    old = {k: getattr(conf, k) for k in ACCEL_PLANS}
    for k, val in ACCEL_PLANS.items():
        setattr(conf, k, val)
    try:
        yield context
    finally:
        for k, val in old.items():
            setattr(conf, k, val)
        context.stop()


@pytest.fixture()
def port_ctx():
    """The port pinned to the same accelerator plans, which are what
    'auto' resolves to on the card."""
    with vt.Context(device="cpu", n_shards=N_SHARDS, **ACCEL_PLANS) as context:
        yield context


def _pipeline(ctx, n_rows, n_keys):
    kv = ctx.dense_range(n_rows).map(lambda x: (x % n_keys, x * 0.5))
    reduced = kv.reduce_by_key(op="add")
    table = ctx.dense_from_numpy(np.arange(n_keys, dtype=np.int32),
                                 np.arange(n_keys, dtype=np.float32) * 2.0)
    return reduced, reduced.join(table)


def _sorted_rows(rows):
    return sorted(rows, key=lambda r: (r[0], r[1]))


def _assert_rows_equal(got, exp):
    assert len(got) == len(exp)
    got, exp = _sorted_rows(got), _sorted_rows(exp)
    assert [r[0] for r in got] == [r[0] for r in exp]
    g = np.array([r[1] for r in got], dtype=np.float64)
    e = np.array([r[1] for r in exp], dtype=np.float64)
    np.testing.assert_allclose(g, e, rtol=1e-5)


def _assert_join_rows_equal(got, exp):
    _assert_rows_equal([(k, lv) for k, (lv, _rv) in got],
                       [(k, lv) for k, (lv, _rv) in exp])
    _assert_rows_equal([(k, rv) for k, (_lv, rv) in got],
                       [(k, rv) for k, (_lv, rv) in exp])


@pytest.mark.parametrize("n_rows,n_keys", [(50_000, 1_000), (20_000, 3),
                                           (1_000, 5_000)])
def test_bench_pipeline_matches_reference(ref_ctx, port_ctx, n_rows, n_keys):
    ref_red, ref_join = _pipeline(ref_ctx, n_rows, n_keys)
    got_red, got_join = _pipeline(port_ctx, n_rows, n_keys)
    assert got_join.count() == ref_join.count() == min(n_rows, n_keys)
    # same placement: the reduce output holds the same rows on each shard
    np.testing.assert_array_equal(got_red.block().counts_np,
                                  ref_red.block().counts_np)
    _assert_rows_equal(got_red.collect(), ref_red.collect())
    _assert_join_rows_equal(got_join.collect(), ref_join.collect())
    assert got_red.hash_placed and got_red.key_sorted
    # numpy reference: sum of x * 0.5 per key
    x = np.arange(n_rows)
    sums = np.bincount(x % n_keys, weights=x * 0.5, minlength=n_keys)
    got = got_join.collect_arrays()
    np.testing.assert_allclose(got["lv"], sums[got["k"]], rtol=1e-5)
    np.testing.assert_array_equal(got["rv"], got["k"] * 2.0)


def _skewed_keys(n_keys, n_shards):
    """n_keys distinct int32 keys that all hash to bucket 0."""
    from vega_tpu_torch.cuda_kernels import hash_bucket_plain

    cand = torch.arange(n_keys * n_shards * 4, dtype=torch.int32)
    b = hash_bucket_plain(cand[None, :], n_shards)[0]
    keys = cand[b == 0][:n_keys].numpy()
    assert len(keys) == n_keys
    return keys


@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_skew_forces_overflow_retry(ref_ctx, port_ctx, op):
    """A capacity hint learned on uniform keys is too small for a skewed
    run of the same lineage and sizes: the hinted launch is deferred, its
    overflow shows at settlement, the repair reruns at histogram-sized
    capacities (replacing the hint), and the result still equals the
    reference."""
    rng = np.random.RandomState(7)
    n = 8_000
    uniform = rng.randint(0, 1_000, size=n).astype(np.int32)
    skewed = rng.choice(_skewed_keys(1_000, N_SHARDS), size=n)
    vals = rng.randint(-100, 100, size=n).astype(np.int32)

    def run(ctx, keys):
        return ctx.dense_from_numpy(keys, vals).reduce_by_key(op=op)

    first = run(port_ctx, uniform)
    first.count()
    assert first._last_attempts == 1
    hint = port_ctx._capacity_hints[first._hint_key()]
    got = run(port_ctx, skewed)
    blk = got.block_spec()
    assert blk.settle is not None  # hinted: launched deferred
    got.count()
    # the hinted capacities overflowed: the repair sized them anew
    assert port_ctx._capacity_hints[got._hint_key()] != hint
    assert blk.settle is None and not port_ctx._pending
    exp = run(ref_ctx, skewed)
    np.testing.assert_array_equal(got.block().counts_np,
                                  exp.block().counts_np)
    assert sorted(got.collect()) == sorted(exp.collect())
    assert sorted(run(port_ctx, uniform).collect()) == \
        sorted(run(ref_ctx, uniform).collect())


def test_join_duplicate_keys_both_sides(ref_ctx, port_ctx):
    """Neither side hash-placed (both exchange through the counting
    partition) and a dup x dup product larger than the exchange capacity
    (the exact-size rerun)."""
    rng = np.random.RandomState(8)
    lk = rng.randint(0, 20, size=3_000).astype(np.int32)
    rk = rng.randint(0, 20, size=500).astype(np.int32)
    lvals = rng.rand(3_000).astype(np.float32)
    rvals = rng.randint(0, 1_000, size=500).astype(np.int32)

    def run(ctx):
        return ctx.dense_from_numpy(lk, lvals).join(
            ctx.dense_from_numpy(rk, rvals))

    got, exp = run(port_ctx), run(ref_ctx)
    assert got.count() == exp.count() == sum(
        int(np.sum(rk == k)) for k in lk)
    np.testing.assert_array_equal(got.block().counts_np,
                                  exp.block().counts_np)
    assert sorted(got.collect()) == sorted(exp.collect())


def test_reduce_of_reduce_elides_exchange(port_ctx):
    """A hash-placed parent (a reduce output) skips the exchange: the
    second reduce runs on a passthrough, at fixed capacities."""
    r1 = port_ctx.dense_range(10_000).map(lambda x: (x % 97, x)) \
        .reduce_by_key(op="add")
    r2 = r1.reduce_by_key(op="max")
    assert sorted(r2.collect()) == sorted(r1.collect())
    np.testing.assert_array_equal(r2.block().counts_np, r1.block().counts_np)


def test_from_reference_arrays_round_trip(port_ctx):
    """A vega_tpu Block's exported state carries across with its placement
    and comes back through to_numpy unchanged."""
    rng = np.random.RandomState(9)
    keys = rng.randint(-50, 50, size=1_001).astype(np.int32)
    vals = rng.rand(1_001).astype(np.float32)
    ref = ref_block.from_numpy({"k": keys, "v": vals},
                               ref_mesh.default_mesh())
    cols = {n: np.asarray(c) for n, c in ref.cols.items()}
    blk = port_block.from_reference_arrays(cols, ref.counts_np, ref.capacity,
                                           port_ctx.mesh)
    np.testing.assert_array_equal(blk.counts_np, ref.counts_np)
    exp, got = ref.to_numpy(), blk.to_numpy()
    assert list(got) == list(exp)
    for n in exp:
        np.testing.assert_array_equal(got[n], exp[n])
    for s in range(N_SHARDS):
        for n, col in blk.shard_rows(s).items():
            np.testing.assert_array_equal(col, ref.shard_rows(s)[n])
    # and the port reduces the carried data as the reference does
    from vega_tpu.tpu.dense_rdd import dense_from_block

    got_r = port_dense.dense_from_block(port_ctx, blk).reduce_by_key(op="add")
    with v.Context("local", num_workers=2) as rctx:
        exp_r = dense_from_block(rctx, ref).reduce_by_key(op="add")
        np.testing.assert_array_equal(got_r.block().counts_np,
                                      exp_r.block().counts_np)
        _assert_rows_equal(got_r.collect(), exp_r.collect())
    with pytest.raises(VegaError):
        port_block.from_reference_arrays(cols, ref.counts_np,
                                         ref.capacity * 2, port_ctx.mesh)


def test_dtype_contract(port_ctx):
    """int64 narrows to int32 when it fits; beyond int32 a key or a value
    column takes the two-column encoding; float64 narrows to float32; a
    row function that needs the host raises (no host tier)."""
    r = port_ctx.dense_from_numpy(np.arange(10, dtype=np.int64),
                                  np.arange(10, dtype=np.float64))
    assert dict(r._schema()) == {"k": torch.int32, "v": torch.float32}
    wide = port_ctx.dense_from_numpy(np.array([0, 2**40], dtype=np.int64),
                                     np.zeros(2))
    assert dict(wide._schema()) == {"k": torch.int32, "k.lo": torch.int32,
                                    "v": torch.float32}
    wide_v = port_ctx.dense_from_numpy(np.zeros(2, dtype=np.int32),
                                       np.array([0, 2**40], dtype=np.int64))
    assert dict(wide_v._schema()) == {"k": torch.int32, "v": torch.int32,
                                      "v.lo": torch.int32}
    assert wide_v.collect() == [(0, 0), (0, 2**40)]
    with pytest.raises(VegaError):
        port_ctx.dense_range(10).map(lambda x: (int(x), str(x)))
    with pytest.raises(VegaError):
        r.reduce_by_key(lambda a, b: f"{a}{b}")  # no tensor result
    assert port_ctx.dense_range(1_000).map(lambda x: x * 2).collect() == \
        list(range(0, 2_000, 2))


@pytest.mark.parametrize("n_shards", [1, 3])
def test_pipeline_other_shard_counts(n_shards):
    """One shard takes the passthrough (no kernel at all); three shards
    the full exchange. Both equal numpy."""
    with vt.Context(device="cpu", n_shards=n_shards) as ctx:
        _red, joined = _pipeline(ctx, 30_000, 700)
        got = joined.collect_arrays()
    x = np.arange(30_000)
    sums = np.bincount(x % 700, weights=x * 0.5, minlength=700)
    np.testing.assert_array_equal(np.sort(got["k"]), np.arange(700))
    np.testing.assert_allclose(got["lv"], sums[got["k"]], rtol=1e-5)
    np.testing.assert_array_equal(got["rv"], got["k"] * 2.0)


def test_exchange_gives_up_after_six_rounds(port_ctx, monkeypatch):
    """Capacities that never fit: six overflowing rounds, then VegaError."""
    monkeypatch.setattr(port_dense, "_histogram_capacities",
                        lambda hists, attempt, slot_hists=None: (128, 128))
    red = port_ctx.dense_range(50_000).map(lambda x: (x % 5_000, x)) \
        .reduce_by_key(op="add")
    with pytest.raises(VegaError, match="overflow after retries"):
        red.count()
    assert red._last_attempts == 6
