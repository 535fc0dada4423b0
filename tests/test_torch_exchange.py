"""The exchange planner and the staged / ring exchanges of vega_tpu_torch
against vega_tpu, on the CPU with 8 shards.

The planner (exchange_plan.py) must choose what the reference chooses at
every shape, mode and budget; the staged and ring exchanges (ring.py) must
move the reference's rows in the reference's arrival order (its ring.py run
under shard_map on the 8-device CPU mesh); and the reference's planner
tests (tests/test_dense.py, tests/test_tpu_kernels.py) rerun as
port-against-reference parity: the same budgets, the same chosen programs,
the same results. Inputs are made from numpy seeds. Stated tolerance:
integer data bit-identical; float sums within rtol 1e-5.

Recorded difference, pinned here: memory_sharing_factor is n_shards on
every device in the port (its shards are rows of one device's tensors),
where the reference gives 1 on a TPU or GPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vega_tpu as v
from vega_tpu.tpu import exchange_plan as ref_plan
from vega_tpu.tpu import mesh as ref_mesh
from vega_tpu.tpu import ring as ref_ring
from vega_tpu.tpu.dense_rdd import _SPEC, _shard_program
import vega_tpu_torch as vt
from vega_tpu_torch import exchange_plan, kernels, ring
from vega_tpu_torch.errors import VegaError

N_SHARDS = 8
PLANS = {"dense_rbk_plan": "sort_partition", "dense_table_plan": "off",
         "dense_sort_impl": "xla"}


class _Ctxs:
    """A reference Context and a port Context under one budget, one
    dense_exchange and the same plans; the reference's settings restored
    on stop."""

    def __init__(self, budget=4 << 30, exchange="auto", plans=PLANS):
        from vega_tpu.env import Env

        self.ref = v.Context("local", num_workers=2)
        conf = Env.get().conf
        ref_conf = dict(plans, dense_hbm_budget=budget,
                        dense_exchange=exchange)
        self._restore = {k: getattr(conf, k) for k in ref_conf}
        for k, val in ref_conf.items():
            setattr(conf, k, val)
        self.port = vt.Context(device="cpu", n_shards=N_SHARDS,
                               dense_hbm_budget=budget,
                               dense_exchange=exchange, **plans)

    def budget(self, value):
        from vega_tpu.env import Env

        Env.get().conf.dense_hbm_budget = value
        self.port.dense_hbm_budget = value

    def stop(self):
        from vega_tpu.env import Env

        self.port.stop()
        for k, val in self._restore.items():
            setattr(Env.get().conf, k, val)
        self.ref.stop()


@pytest.fixture()
def ctxs():
    c = _Ctxs()
    try:
        yield c
    finally:
        c.stop()


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------

# (n_shards, capacity, slot, out, row_bytes, budget, blocks): bench-main's
# launch (capacity 3,145,728, slot 1,048,576, out 5,242,880), the planner
# tests' shapes, budgets either side of each program's estimate, one shard,
# and the two join cases (two operand blocks in one launch)
PLAN_GRID = [
    (8, 3_145_728, 1_048_576, 5_242_880, 8, 4 << 30, None),
    (8, 3_145_728, 1_048_576, 5_242_880, 8, 226_492_416, None),
    (8, 3_145_728, 1_048_576, 5_242_880, 8, 226_492_415, None),
    (8, 3_145_728, 1_048_576, 5_242_880, 8, 160 << 20, None),
    (8, 3_145_728, 1_048_576, 5_242_880, 8, 64 << 20, None),
    (8, 32_768, 4_096, 32_768, 8, 1_280_000, None),
    (8, 32_768, 4_096, 32_768, 8, 500_000, None),
    (8, 16_384, 2_048, 16_384, 8, 1_100_000, None),
    (8, 1_048_576, 262_144, 1_048_576, 12, 1 << 30, None),
    (4, 65_536, 16_384, 65_536, 4, 1 << 20, None),
    (16, 8_192, 1_024, 8_192, 8, 400_000, None),
    (1, 1_000, 1_000, 1_000, 8, 10, None),
    (8, 32_768, 4_096, 32_768, 8, 1_280_000,
     [(32_768, 8), (1_024, 8)]),
    (8, 131_072, 32_768, 262_144, 8, 6 << 20,
     [(131_072, 8), (131_072, 12)]),
]


@pytest.mark.parametrize("n,cap,slot,out,rb,budget,blocks", PLAN_GRID)
def test_planner_matches_reference(n, cap, slot, out, rb, budget, blocks):
    """plan_exchange under each mode, estimate_peak_bytes and
    transient_rows of each program, and planned_stream_rows /
    predict_for_rows over the case's rows, equal to the reference's."""
    for mode in exchange_plan.MODES:
        got = exchange_plan.plan_exchange(n, cap, slot, out, rb, budget,
                                          mode=mode, blocks=blocks)
        exp = ref_plan.plan_exchange(n, cap, slot, out, rb, budget,
                                     mode=mode, blocks=blocks)
        assert dataclasses.asdict(got) == dataclasses.asdict(exp), mode
    for program, group in (("all_to_all", 1), ("ring", 1), ("staged", 2),
                           ("staged", 3)):
        assert exchange_plan.estimate_peak_bytes(
            program, n, cap, slot, out, rb, group, blocks=blocks) == \
            ref_plan.estimate_peak_bytes(program, n, cap, slot, out, rb,
                                         group, blocks=blocks)
        assert exchange_plan.transient_rows(program, n, slot, group) == \
            ref_plan.transient_rows(program, n, slot, group)
    rows = cap * n
    assert exchange_plan.planned_stream_rows(rows, rb, budget, n) == \
        ref_plan.planned_stream_rows(rows, rb, budget, n)
    assert dataclasses.asdict(exchange_plan.predict_for_rows(
        rows, rb, n, budget)) == dataclasses.asdict(
            ref_plan.predict_for_rows(rows, rb, n, budget))


def test_bench_main_resolves_to_all_to_all_at_the_default_budget():
    """bench-main's reduce launch (capacity 3,145,728, slot 1,048,576,
    out 5,242,880, 8-byte rows) stays the one-shot under auto at 4 GiB:
    226,492,416 B per shard, as the reference's model gives it."""
    plan = exchange_plan.plan_exchange(8, 3_145_728, 1_048_576, 5_242_880,
                                       8, 4 << 30)
    assert plan.program == "all_to_all" and plan.fits
    assert plan.est_peak_bytes == 226_492_416
    ring_plan = exchange_plan.plan_exchange(8, 3_145_728, 1_048_576,
                                            5_242_880, 8, 4 << 30,
                                            mode="ring")
    # about half: 117,440,512 B, the reference's figure too
    assert ring_plan.est_peak_bytes == 117_440_512 == ref_plan.plan_exchange(
        8, 3_145_728, 1_048_576, 5_242_880, 8, 4 << 30,
        mode="ring").est_peak_bytes


def test_row_bytes_of_matches_reference():
    cols = [(np.dtype(np.int32), ()), (np.dtype(np.float32), (3,)),
            (np.dtype(np.int64), (2, 2))]
    assert exchange_plan.row_bytes_of(cols) == ref_plan.row_bytes_of(cols)
    assert exchange_plan.row_bytes_of([(torch.int32, ()),
                                       (torch.float32, (3,))]) == 16
    assert exchange_plan.row_bytes_of([]) == ref_plan.row_bytes_of([]) == 1


def test_memory_sharing_factor_difference_is_pinned(monkeypatch):
    """Recorded difference: the port's n shards share one device's memory
    on the CPU and on the card alike, so the factor is n_shards (n > 1)
    everywhere. On the CPU that equals the reference; on a GPU the
    reference gives 1 (each of its shards owns a device)."""
    for n in (1, 2, 8, 16):
        assert exchange_plan.memory_sharing_factor(n) == \
            ref_plan.memory_sharing_factor(n) == (n if n > 1 else 1)
        assert exchange_plan.per_shard_budget(n, 4 << 30) == \
            ref_plan.per_shard_budget(n, 4 << 30)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert ref_plan.memory_sharing_factor(8) == 1
    assert exchange_plan.memory_sharing_factor(8) == 8
    assert exchange_plan.per_shard_budget(8, 4 << 30) == (4 << 30) // 8


def test_misspelt_mode_raises_the_reference_error():
    with pytest.raises(v.VegaError) as ref_err:
        ref_plan.plan_exchange(8, 128, 128, 128, 8, 1 << 20, mode="rnig")
    with pytest.raises(VegaError) as port_err:
        exchange_plan.plan_exchange(8, 128, 128, 128, 8, 1 << 20,
                                    mode="rnig")
    assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(VegaError) as ctx_err:
        vt.Context(device="cpu", dense_exchange="rnig")
    assert str(ctx_err.value) == str(ref_err.value)
    with vt.Context(device="cpu") as ctx:
        src = ctx.dense_from_numpy(np.arange(8, dtype=np.int32),
                                   np.arange(8, dtype=np.int32))
        with pytest.raises(VegaError, match="dense_exchange must be"):
            src.group_by_key(exchange="rnig")


# ---------------------------------------------------------------------------
# the exchanges, against the reference's ring.py under shard_map
# ---------------------------------------------------------------------------

def _exchange_inputs(seed, cap, skew=False):
    """[n, cap] int32 keys (many duplicates), float32 values, per-shard
    counts (one shard empty) and target buckets (skewed: half of every
    shard's rows to one target)."""
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, 40, size=(N_SHARDS, cap)).astype(np.int32)
    vals = rng.randn(N_SHARDS, cap).astype(np.float32)
    counts = rng.randint(cap // 2, cap + 1, size=N_SHARDS).astype(np.int32)
    counts[3] = 0
    bucket = rng.randint(0, N_SHARDS, size=(N_SHARDS, cap)).astype(np.int32)
    if skew:
        bucket[:, ::2] = 5
    return keys, vals, counts, bucket


def _pregroup(keys, vals, bucket, counts):
    """Rows stably grouped by bucket within each shard, invalid rows last
    (a pregrouped layout both packages trust)."""
    keys, vals, bucket = keys.copy(), vals.copy(), bucket.copy()
    for s in range(N_SHARDS):
        b = np.where(np.arange(keys.shape[1]) < counts[s], bucket[s],
                     N_SHARDS)
        o = np.argsort(b, kind="stable")
        keys[s], vals[s], bucket[s] = keys[s, o], vals[s, o], bucket[s, o]
    return keys, vals, bucket


def _reference_exchange(keys, vals, counts, bucket, slot, out_cap, group,
                        pregrouped):
    mesh = ref_mesh.default_mesh()

    def fn(cnt, k, vv, b):
        out, n_in, ovf = ref_ring.staged_exchange(
            {"k": k, "v": vv}, cnt[0], b, N_SHARDS, slot, out_cap,
            pregrouped=pregrouped, group=group)
        return out["k"], out["v"], n_in.reshape(1), ovf.reshape(1)

    prog = _shard_program(mesh, fn, 4, (_SPEC,) * 4)
    k, vv, n_in, ovf = prog(jnp.asarray(counts), jnp.asarray(keys.reshape(-1)),
                            jnp.asarray(vals.reshape(-1)),
                            jnp.asarray(bucket.reshape(-1)))
    return (np.asarray(k).reshape(N_SHARDS, out_cap),
            np.asarray(vv).reshape(N_SHARDS, out_cap),
            np.asarray(n_in), np.asarray(ovf))


def _port_exchange(fn, keys, vals, counts, bucket, slot, out_cap,
                   pregrouped):
    out, n_in, ovf = fn({"k": torch.from_numpy(keys),
                         "v": torch.from_numpy(vals)},
                        torch.from_numpy(counts), torch.from_numpy(bucket),
                        N_SHARDS, slot, out_cap, pregrouped=pregrouped)
    return out["k"].numpy(), out["v"].numpy(), n_in.numpy(), ovf.numpy()


@pytest.mark.parametrize("pregrouped", [False, True])
@pytest.mark.parametrize("group", [1, 2, 3, 7])
def test_staged_exchange_matches_reference_row_for_row(group, pregrouped):
    """Every shard's received rows, in order (own rows first, then
    shards j-1, j-2, ...), its count and its overflow flag equal the
    reference's staged_exchange; group 1 is ring_exchange."""
    cap, slot, out_cap = 512, 256, 1024
    keys, vals, counts, bucket = _exchange_inputs(group, cap)
    if pregrouped:
        keys, vals, bucket = _pregroup(keys, vals, bucket, counts)
    fn = (ring.ring_exchange if group == 1 else
          lambda *a, **kw: ring.staged_exchange(*a, group=group, **kw))
    gk, gv, gn, go = _port_exchange(fn, keys, vals, counts, bucket, slot,
                                    out_cap, pregrouped)
    rk, rv, rn, ro = _reference_exchange(keys, vals, counts, bucket, slot,
                                         out_cap, group, pregrouped)
    np.testing.assert_array_equal(gn, rn)
    np.testing.assert_array_equal(go, ro)
    assert not go.any()
    for s in range(N_SHARDS):
        np.testing.assert_array_equal(gk[s, :gn[s]], rk[s, :rn[s]])
        np.testing.assert_array_equal(gv[s, :gn[s]], rv[s, :rn[s]])
    # the same rows as the one-shot, in another order
    ak, av, an, _ = _port_exchange(kernels.bucket_exchange, keys, vals,
                                   counts, bucket, slot, out_cap, pregrouped)
    np.testing.assert_array_equal(an, gn)
    for s in range(N_SHARDS):
        assert sorted(zip(ak[s, :an[s]].tolist(), av[s, :an[s]].tolist())) \
            == sorted(zip(gk[s, :gn[s]].tolist(), gv[s, :gn[s]].tolist()))


@pytest.mark.parametrize("group", [1, 3])
def test_staged_exchange_overflow_flags_match_reference(group):
    """A slot below the skewed send counts and an output below the
    arrivals set the reference's flags on the same shards, and the
    counts report every row that arrived."""
    cap = 512
    keys, vals, counts, bucket = _exchange_inputs(11, cap, skew=True)
    for slot, out_cap in ((32, 1024), (256, 128)):
        gk, gv, gn, go = _port_exchange(
            lambda *a, **kw: ring.staged_exchange(*a, group=group, **kw),
            keys, vals, counts, bucket, slot, out_cap, False)
        rk, rv, rn, ro = _reference_exchange(keys, vals, counts, bucket,
                                             slot, out_cap, group, False)
        np.testing.assert_array_equal(gn, rn)
        np.testing.assert_array_equal(go, ro)
        assert go.any()
        for s in range(N_SHARDS):
            n_kept = min(gn[s], out_cap)
            np.testing.assert_array_equal(gk[s, :n_kept], rk[s, :n_kept])


def test_one_shard_passes_through():
    cols = {"k": torch.arange(10, dtype=torch.int32)[None, :]}
    count = torch.tensor([7], dtype=torch.int32)
    bucket = torch.zeros((1, 10), dtype=torch.int32)
    for fn in (ring.ring_exchange, ring.staged_exchange):
        out, n_in, ovf = fn(cols, count, bucket, 1, 16, 16)
        assert n_in.tolist() == [7] and not ovf.any()
        assert out["k"][0, :7].tolist() == list(range(7))


# ---------------------------------------------------------------------------
# the reference's planner tests, rerun as parity
# ---------------------------------------------------------------------------

def _pipelines(ctx, keys, vals, tk, tv, skeys):
    src = ctx.dense_from_numpy(keys, vals)
    nodes = {
        "rbk": src.reduce_by_key(op="add"),
        "gbk": src.group_by_key(),
        "join": src.join(ctx.dense_from_numpy(tk, tv)),
        "sort": ctx.dense_from_numpy(skeys, vals).sort_by_key(),
    }
    out = {
        "rbk": dict(nodes["rbk"].collect()),
        "gbk": {k: sorted(vs) for k, vs in nodes["gbk"].collect()},
        "join": sorted(nodes["join"].collect()),
        "sort": nodes["sort"].collect(),
    }
    return nodes, out


def _same_plan(port_node, ref_node):
    got, exp = port_node._exchange_plan, ref_node._exchange_plan
    assert got is not None and exp is not None
    assert dataclasses.asdict(got) == dataclasses.asdict(exp)
    return got


def test_exchange_planner_program_parity():
    """tests/test_dense.py::test_exchange_planner_program_parity: a forced
    all_to_all leg, then auto under 1.28 MB, where every pipeline stages
    at more than one round in both packages with the same plan; results
    equal across programs and packages, the plan counters agree."""
    rng = np.random.RandomState(3)
    keys = rng.randint(0, 997, size=200_000).astype(np.int32)
    vals = rng.randint(0, 1 << 20, size=200_000).astype(np.int32)
    tk = np.arange(997, dtype=np.int32)
    tv = (tk * 7).astype(np.int32)
    skeys = rng.permutation(200_000).astype(np.int32)

    c = _Ctxs(exchange="all_to_all")
    try:
        nodes_a, leg_a = _pipelines(c.port, keys, vals, tk, tv, skeys)
        rnodes_a, rleg_a = _pipelines(c.ref, keys, vals, tk, tv, skeys)
    finally:
        c.stop()
    assert leg_a == rleg_a
    for name, node in nodes_a.items():
        assert _same_plan(node, rnodes_a[name]).program == "all_to_all"

    c = _Ctxs(budget=1_280_000)
    try:
        exchange_plan.reset_plan_counters()
        ref_plan.reset_plan_counters()
        nodes_b, leg_b = _pipelines(c.port, keys, vals, tk, tv, skeys)
        rnodes_b, rleg_b = _pipelines(c.ref, keys, vals, tk, tv, skeys)
        summary = c.port.exchange_plans()
        ref_summary = c.ref.metrics_summary()["exchange_plans"]
    finally:
        c.stop()
    assert leg_b == leg_a == rleg_b
    assert exchange_plan.plan_counters() == ref_plan.plan_counters()
    assert exchange_plan.plan_counters().get("staged", 0) >= 4
    assert summary == ref_summary
    for name, node in nodes_b.items():
        plan = _same_plan(node, rnodes_b[name])
        assert plan.program == "staged" and plan.rounds > 1, (name, plan)
        assert plan.fits and plan.est_peak_bytes <= 1_280_000


def test_exchange_planner_ring_when_no_group_fits():
    """::test_exchange_planner_ring_when_no_group_fits: under 500 kB no
    staged group fits; both packages run ring (fits may be False) with
    the unbounded run's groups, in the reference's arrival order."""
    rng = np.random.RandomState(4)
    keys = rng.randint(0, 500, size=120_000).astype(np.int32)
    vals = rng.randint(0, 1000, size=120_000).astype(np.int32)
    c = _Ctxs()
    try:
        expected = {k: sorted(vs) for k, vs in
                    c.port.dense_from_numpy(keys, vals).group_by_key()
                    .collect()}
        c.budget(500_000)
        exchange_plan.reset_plan_counters()
        node = c.port.dense_from_numpy(keys, vals).group_by_key()
        rnode = c.ref.dense_from_numpy(keys, vals).group_by_key()
        got, rgot = node.collect(), rnode.collect()
    finally:
        c.stop()
    assert {k: sorted(vs) for k, vs in got} == expected
    assert got == rgot  # duplicate keys: the same arrival order
    assert _same_plan(node, rnode).program == "ring"
    assert exchange_plan.plan_counters().get("ring", 0) >= 1


def test_exchange_planner_overflow_retry_keeps_contract():
    """::test_exchange_planner_overflow_retry_keeps_contract: a poisoned
    (too small) capacity hint overflows the first launch; the blocking
    retry re-plans at the histogram capacities, crosses to the staged
    program under 1.1 MB, and lands the right groups, as in the
    reference."""
    rng = np.random.RandomState(5)
    keys = rng.randint(0, 700, size=200_000).astype(np.int32)
    vals = rng.randint(0, 1000, size=200_000).astype(np.int32)
    c = _Ctxs()
    try:
        expected = {k: sorted(vs) for k, vs in
                    c.port.dense_from_numpy(keys, vals).group_by_key()
                    .collect()}
        node = c.port.dense_from_numpy(keys, vals).group_by_key()
        rnode = c.ref.dense_from_numpy(keys, vals).group_by_key()
        c.port._capacity_hints[node._hint_key()] = (64, 256)
        c.ref.__dict__.setdefault("_dense_capacity_hints", {})[
            rnode._hint_key()] = (64, 256)
        c.budget(1_100_000)
        c.port._no_defer = True
        c.ref.__dict__["_dense_no_defer"] = True
        try:
            got, rgot = node.collect(), rnode.collect()
        finally:
            c.port._no_defer = False
            c.ref.__dict__["_dense_no_defer"] = False
    finally:
        c.stop()
    assert {k: sorted(vs) for k, vs in got} == expected
    assert got == rgot
    assert node._last_attempts >= 2
    assert node._last_attempts == rnode._last_attempts
    plan = _same_plan(node, rnode)
    assert plan.program == "staged" and plan.rounds > 1


def test_ring_skew_overflow():
    """tests/test_tpu_kernels.py::test_ring_skew_overflow: every row under
    one key through the ring program: the slot grows until it holds a
    whole shard, in both packages."""
    c = _Ctxs(exchange="ring")
    try:
        got = dict(c.port.dense_range(4096).map(lambda x: (x * 0, x))
                   .reduce_by_key(op="add").collect())
        exp = dict(c.ref.dense_range(4096).map(lambda x: (x * 0, x))
                   .reduce_by_key(op="add").collect())
        assert c.port.exchange_plans()["ring"] >= 1
    finally:
        c.stop()
    assert got == exp == {0: sum(range(4096))}


@pytest.mark.parametrize("mode", ["ring", "staged", "all_to_all"])
def test_forced_program_per_op_matches_reference(mode):
    """exchange= on each keyed op forces its program in both packages:
    reduce (named and traced binop), combine_by_key, group_by_key, join,
    left_outer_join and sort_by_key give the reference's rows under that
    program (grouped values and join rows in arrival order)."""
    rng = np.random.RandomState(9)
    keys = rng.randint(0, 300, size=30_000).astype(np.int32)
    vals = rng.randint(0, 1000, size=30_000).astype(np.int32)
    fvals = rng.randn(30_000).astype(np.float32)
    tk = np.arange(0, 400, 2, dtype=np.int32)
    skeys = rng.permutation(30_000).astype(np.int32)
    c = _Ctxs()
    try:
        def run(ctx):
            src = ctx.dense_from_numpy(keys, vals)
            table = ctx.dense_from_numpy(tk, tk * 3)
            nodes = [
                src.reduce_by_key(op="add", exchange=mode),
                src.reduce_by_key(lambda a, b: a ^ b, exchange=mode),
                ctx.dense_from_numpy(keys, fvals).combine_by_key(
                    lambda x: x, lambda a, x: a + x, lambda a, b: a + b,
                    exchange=mode),
                src.group_by_key(exchange=mode),
                src.join(table, exchange=mode),
                src.left_outer_join(table, fill_value=-1, exchange=mode),
                ctx.dense_from_numpy(skeys, vals).sort_by_key(
                    exchange=mode),
            ]
            return nodes, [n.collect() for n in nodes]

        nodes, got = run(c.port)
        rnodes, exp = run(c.ref)
    finally:
        c.stop()
    for i, (g, e) in enumerate(zip(got, exp)):
        if i == 2:  # float sums
            gd, ed = dict(g), dict(e)
            assert gd.keys() == ed.keys()
            for k in ed:
                assert gd[k] == pytest.approx(ed[k], rel=1e-5)
        elif i in (0, 1):
            assert dict(g) == dict(e)
        else:
            assert sorted(g) == sorted(e)
    for node, rnode in zip(nodes, rnodes):
        assert _same_plan(node, rnode).program == mode
    # group_by_key: the reference's arrival order within each group
    assert got[3] == exp[3]


def test_elided_exchanges_plan_nothing(ctxs):
    """A reduce over a hash-placed parent elides its exchange and plans
    nothing, in both packages; one shard plans nothing either."""
    rng = np.random.RandomState(2)
    keys = rng.randint(0, 50, size=5_000).astype(np.int32)
    vals = np.ones(5_000, dtype=np.int32)
    red = ctxs.port.dense_from_numpy(keys, vals).reduce_by_key(op="add")
    rred = ctxs.ref.dense_from_numpy(keys, vals).reduce_by_key(op="add")
    again, ragain = red.reduce_by_key(op="max"), rred.reduce_by_key(op="max")
    assert dict(again.collect()) == dict(ragain.collect())
    assert again._exchange_plan is None and ragain._exchange_plan is None
    before = ctxs.port.exchange_plans()
    with vt.Context(device="cpu", n_shards=1) as one:
        node = one.dense_from_numpy(keys, vals).group_by_key()
        assert node.count() == 50 and node._exchange_plan is None
        assert one.exchange_plans() == exchange_plan.new_plan_summary()
    assert ctxs.port.exchange_plans() == before


def test_ring_log_line_when_even_ring_does_not_fit(caplog):
    """The reference's log line when no program fits the budget."""
    import logging

    with caplog.at_level(logging.INFO, logger="vega_tpu_torch"):
        plan = exchange_plan.plan_exchange(8, 32_768, 4_096, 32_768, 8, 10)
    assert plan.program == "ring" and not plan.fits
    assert any("even the ring program" in r.getMessage()
               for r in caplog.records)
