"""The DataFrame layer of vega_tpu_torch (vega_tpu_torch/frame) against
vega_tpu.frame's device tier, on the CPU.

The reference runs on its 8-device CPU mesh under hint(tier="device"),
pinned to its accelerator plans; the port with Context(device="cpu",
n_shards=8) on the same plans, which are what 'auto' resolves to on the
card. Both get the same seeded numpy columns (a few hundred rows) or the
same parquet files. Integers and strings must be exact, floats within
rtol 1e-6 (the reference's _rows_close), and column dtypes equal.

Covered: every verb of tests/test_frame.py, a torch-vectorized UDF,
string group / join / sort keys, reserved block names, collect_columns,
hint(exchange="ring"), a literal-only select, the parquet pruning and
pushdown tests, the fusion counter (dense_rdd.program_mints: one chain
for a fused stage, one per verb under hint(fuse=False)) and lazy
planning (explain() reads no data, builds no block, applies no chain).

Pinned differences: where the reference falls back to its host tier,
silently, the port raises VegaError with the reference's reason when the
plan compiles; tier="host" and to_rdd() raise; the port has no
fallback_count() / last_fallback(); a UDF is torch-vectorized where the
reference's is jnp-vectorized (Python operators run in both).
"""

import math
import types

import numpy as np
import pytest
import torch

import vega_tpu as v
import vega_tpu.frame as ref_frame
import vega_tpu_torch as vt
import vega_tpu_torch.frame as port_frame
from vega_tpu_torch import block as port_block
from vega_tpu_torch import dense_rdd
from vega_tpu_torch.errors import VegaError
from vega_tpu_torch.frame import parquet as port_parquet
from vega_tpu_torch.frame import planner as port_planner

N_SHARDS = 8
ACCEL_PLANS = {"dense_rbk_plan": "fused_sort", "dense_table_plan": "off",
               "dense_sort_impl": "xla"}


@pytest.fixture()
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


@pytest.fixture()
def port_ctx():
    with vt.Context(device="cpu", n_shards=N_SHARDS, **ACCEL_PLANS) as ctx:
        yield ctx


def _ns(frame_mod, xp):
    return types.SimpleNamespace(F=frame_mod.F, col=frame_mod.col,
                                 lit=frame_mod.lit, udf=frame_mod.udf, xp=xp)


def _namespaces():
    import jax.numpy as jnp

    return _ns(ref_frame, jnp), _ns(port_frame, torch)


def _data(seed=0, n=600):
    rng = np.random.RandomState(seed)
    return dict(
        k=rng.randint(0, 13, size=n),            # int64, fits int32
        x=rng.randint(0, 1000, size=n),
        y=rng.randint(-50, 50, size=n),
        d=rng.randint(1, 10, size=n),            # a divisor: never 0
        f=rng.rand(n) * 100.0,                   # float64 -> float32
        b=rng.rand(n) < 0.5,                     # bool -> int32
    )


def _rows(cols):
    names = list(cols)
    return list(zip(*[np.asarray(cols[nm]).tolist() for nm in names]))


def _rows_close(a, b):
    assert len(a) == len(b), (len(a), len(b))
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb), (ra, rb)
        for xa, xb in zip(ra, rb):
            if isinstance(xa, float) or isinstance(xb, float):
                assert math.isclose(xa, xb, rel_tol=1e-6, abs_tol=1e-6), \
                    (ra, rb)
            else:
                assert xa == xb, (ra, rb)


def _parity(ref_q, port_q, ordered=False):
    """Collect the same logical plan on the reference's device tier and
    on the port: columns, dtypes and rows (in order when the query sorts
    by a unique key, else as sets of rows). Returns the port's rows."""
    rc = ref_q.hint(tier="device").collect_columns()
    pc = port_q.collect_columns()
    assert list(rc) == list(pc) == port_q.columns
    for nm in rc:
        assert np.asarray(rc[nm]).dtype == pc[nm].dtype, nm
    rr, pr = _rows(rc), _rows(pc)
    if not ordered:
        rr, pr = sorted(rr), sorted(pr)
    _rows_close(pr, rr)
    assert port_q.count() == len(pr)
    return pr


def _both(ctxs, build, data=None, ordered=False):
    ref, port = ctxs
    rns, pns = _namespaces()
    data = _data() if data is None else data
    return _parity(build(ref.create_frame(**data), rns),
                   build(port.create_frame(**data), pns), ordered=ordered)


# ------------------------------------------------------------ verb parity

# name -> (build(df, ns) -> DataFrame, ordered)
VERBS = {
    "select": (lambda df, ns: df.select("k", "y"), False),
    "select_computed": (
        lambda df, ns: df.select("k", total=ns.col("x") + ns.col("y") * 2),
        False),
    "rename_select": (lambda df, ns: df.rename({"x": "ex"}).select("ex"),
                      False),
    "filter": (lambda df, ns: df.filter((ns.col("x") > 10)
                                        & (ns.col("y") != 3)), False),
    "with_column": (
        lambda df, ns: df.with_column("z", ns.col("x") * 2 - ns.col("y")),
        False),
    "with_column_int_literal": (
        lambda df, ns: df.with_column("one", ns.lit(1)).select("k", "one"),
        False),
    "with_column_float_literal": (
        lambda df, ns: df.with_column("h", ns.lit(0.5)).select("k", "h"),
        False),
    "with_column_true_division": (
        lambda df, ns: df.with_column("r", ns.col("x") / ns.col("d"))
        .select("r"), False),
    "floor_division_over_padding": (
        lambda df, ns: df.filter(ns.col("x") > 500)
        .with_column("q", ns.col("x") // ns.col("d")).select("k", "q"),
        False),
    "bool_column_and_comparison": (
        lambda df, ns: df.with_column("big", ns.col("x") > 500)
        .select("b", "big"), False),
    "agg_named_op": (
        lambda df, ns: df.group_by("k").agg(ns.F.sum("x"), ns.F.sum("y")),
        False),
    "agg_named_min": (
        lambda df, ns: df.group_by("k").agg(ns.F.min("x"), ns.F.min("f")),
        False),
    "agg_mixed_ops": (
        lambda df, ns: df.group_by("k").agg(
            ns.F.sum("x"), ns.F.min("y"), ns.F.max("y"), ns.F.count(),
            ns.F.mean("x")), False),
    "agg_expression_input": (
        lambda df, ns: df.group_by("k").agg(
            ns.F.sum(ns.col("x") * 2 + 1, "s2")), False),
    "agg_float": (
        lambda df, ns: df.group_by("k").agg(ns.F.sum("f", "sf"),
                                            ns.F.mean("f", "mf")), False),
    "grouped_count": (lambda df, ns: df.group_by("k").count(), False),
    "join_inner": (
        lambda df, ns: df.group_by("k").agg(ns.F.sum("x", "sx")).join(
            df.filter(ns.col("x") % 2 == 0).group_by("k")
            .agg(ns.F.sum("y", "sy")), on="k"), False),
    "join_left_outer_fill": (
        lambda df, ns: df.group_by("k").agg(ns.F.sum("x", "sx")).join(
            df.filter(ns.col("k") < 7).group_by("k").agg(ns.F.count("c")),
            on="k", how="left", fill_value=-1).sort("k"), True),
    "sort_desc_unique_key": (
        lambda df, ns: df.select("x", "k").with_column(
            "u", ns.col("x") * 1000 + ns.col("k")).sort("u",
                                                        ascending=False),
        True),
    "sort_float_key": (lambda df, ns: df.select("f", "k").sort("f"), True),
    "sort_single_column": (
        lambda df, ns: df.group_by("k").agg(ns.F.count("n")).select("k")
        .sort("k"), True),
    "multi_stage_pipeline": (
        lambda df, ns: df.filter(ns.col("x") < 800)
        .with_column("z", ns.col("x") + ns.col("y"))
        .group_by("k").agg(ns.F.sum("z", "sz"), ns.F.count("n"))
        .with_column("avgish", ns.col("sz") // ns.col("n"))
        .filter(ns.col("n") > 2).sort("k"), True),
    "udf_vectorized": (
        lambda df, ns: df.with_column("m", ns.udf(
            lambda c: ns.xp.abs(c - 500), ns.col("x"))).select("k", "m"),
        False),
    "udf_python_operators": (
        lambda df, ns: df.with_column("m", ns.udf(
            lambda a, b: a * 2 + b, ns.col("x"), ns.col("y"))), False),
    "exchange_hint_ring": (
        lambda df, ns: df.group_by("k").agg(ns.F.sum("x", "s"))
        .hint(exchange="ring").sort("k"), True),
    "unfused_unpruned": (
        lambda df, ns: df.filter(ns.col("x") < 600).group_by("k")
        .agg(ns.F.sum("x", "sx")).sort("k")
        .hint(fuse=False, pushdown=False), True),
}


@pytest.mark.parametrize("name", sorted(VERBS))
def test_verb_matches_reference(ctxs, name):
    build, ordered = VERBS[name]
    _both(ctxs, build, ordered=ordered)


def test_sort_limit_take_and_count_in_exact_order(ctxs):
    ref, port = ctxs
    data = _data(1)

    def q(ctx):
        return ctx.create_frame(**data).select("x", "k").with_column(
            "u", port_frame.col("x") * 1000 + port_frame.col("k")
            if ctx is port else ref_frame.col("x") * 1000
            + ref_frame.col("k")).sort("u", ascending=False)

    rq, pq_ = q(ref), q(port)
    dev = rq.hint(tier="device").collect()
    assert pq_.collect() == dev
    assert pq_.limit(7).collect() == rq.limit(7).hint(
        tier="device").collect() == dev[:7]
    assert pq_.limit(7).count() == 7
    assert pq_.take(3) == dev[:3]
    assert "limit 7" in pq_.limit(7).explain()


def test_literal_only_select_keeps_row_count(ctxs):
    ref, port = ctxs
    for ctx, fr in ((ref, ref_frame), (port, port_frame)):
        q = ctx.create_frame(k=np.arange(5)).select(c=fr.lit(7))
        rows = (q.hint(tier="device") if ctx is ref else q).collect()
        assert rows == [(7,)] * 5
        assert q.count() == 5
        assert q.hint(pushdown=False).collect() == [(7,)] * 5
    assert port.create_frame(k=np.arange(5)).select(
        c=port_frame.lit(7)).collect_columns()["c"].dtype == np.int32


def test_reserved_block_names_are_sanitized(ctxs):
    data = {"k": np.arange(8) % 3, "v.lo": np.arange(8)}
    ref, port = ctxs
    rq = ref.create_frame(data).filter(ref_frame.col("v.lo") > 2)
    pq_ = port.create_frame(data).filter(port_frame.col("v.lo") > 2)
    rows = _parity(rq, pq_)
    assert len(rows) == 5
    compiled = pq_._compiled()
    assert dict(compiled.out) == {"k": "c_k", "v.lo": "c_v_lo"}


def test_exchange_notes_match_reference_under_a_small_budget(ctxs):
    """_pick_exchange: under dense_exchange='auto' the planner's
    prediction at each exchange's estimated rows is noted in explain()
    when it is not all_to_all, in the reference's words."""
    from vega_tpu.env import Env

    ref, _ = ctxs
    budget = 20_000
    conf = Env.get().conf
    saved = conf.dense_hbm_budget
    conf.dense_hbm_budget = budget
    try:
        with vt.Context(device="cpu", n_shards=N_SHARDS,
                        dense_hbm_budget=budget, **ACCEL_PLANS) as port:
            data = _data(n=20_000)
            notes = []
            for ctx, fr in ((ref, ref_frame), (port, port_frame)):
                df = ctx.create_frame(**data)
                q = (df.group_by("k").agg(fr.F.sum("x", "s"))
                     .join(df.group_by("k").agg(fr.F.max("y", "m")),
                           on="k").sort("k"))
                notes.append([ln for ln in q.explain().splitlines()
                              if "planner predicts" in ln])
            assert notes[0] == notes[1] and len(notes[1]) == 4
            assert port.create_frame(**data).group_by("k").agg(
                port_frame.F.sum("x", "s")).hint(
                    exchange="ring").explain().count("planner") == 0
    finally:
        conf.dense_hbm_budget = saved


def test_collect_columns_shapes(port_ctx):
    df = port_ctx.create_frame(**_data())
    cols = df.group_by("k").agg(port_frame.F.count("n")).collect_columns()
    assert sorted(cols) == ["k", "n"]
    assert int(np.asarray(cols["n"]).sum()) == 600
    assert all(isinstance(c, np.ndarray) for c in cols.values())


# ------------------------------------------------------------ strings

NAMES = np.array(["ada", "bob", "ada", "cy", "bob", "ada"], dtype=object)


@pytest.mark.parametrize("case", ["group_sort", "join", "sort_ties",
                                  "agg_min_max", "left_join_key"])
def test_string_keys_match_reference(ctxs, case):
    ref, port = ctxs
    dims = dict(name=np.array(["ada", "cy", "dan"], dtype=object),
                w=np.array([10, 20, 30]))
    fruit = dict(name=np.array(["pear", "apple", "fig", "apple", "date"],
                               dtype=object), x=np.arange(5))

    def build(ctx, fr):
        df = ctx.create_frame(name=NAMES, x=np.arange(6))
        g = df.group_by("name").agg(fr.F.sum("x", "sx"),
                                    fr.F.count("n")).sort("name")
        if case == "group_sort":
            return g
        if case == "join":
            return g.select("name", "sx").join(ctx.create_frame(**dims),
                                               on="name").sort("name")
        if case == "left_join_key":
            return g.select("name", "sx").join(
                ctx.create_frame(**dims), on="name", how="left",
                fill_value=-1).sort("name")
        if case == "agg_min_max":
            return ctx.create_frame(k=np.arange(5) % 2, s=fruit["name"]) \
                .group_by("k").agg(fr.F.max("s", "hi"))
        return ctx.create_frame(**fruit).select("name", "x").sort("name")

    rows = _parity(build(ref, ref_frame), build(port, port_frame),
                   ordered=case not in ("sort_ties", "agg_min_max"))
    if case == "group_sort":
        assert rows == [("ada", 7, 3), ("bob", 5, 2), ("cy", 3, 1)]
    if case == "join":
        assert rows == [("ada", 7, 10), ("cy", 3, 20)]
    if case == "sort_ties":
        got = build(port, port_frame).collect()
        assert [r[0] for r in got] == sorted(fruit["name"].tolist())
    if case == "agg_min_max":
        assert sorted(rows) == [(0, "pear"), (1, "apple")]


# ------------------------------------------------------------ parquet


@pytest.fixture()
def parquet_dir(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    n = 1000
    table = pa.table({f"c{i}": np.arange(n) * (i + 1) for i in range(6)})
    pq.write_table(table, str(tmp_path / "part0.parquet"),
                   row_group_size=100)
    return str(tmp_path)


def _parquet_parity(ctxs, path, build, ordered=False):
    ref, port = ctxs
    rns, pns = _namespaces()
    return _parity(build(ref.read_parquet(path), rns),
                   build(port.read_parquet(path), pns), ordered=ordered)


def test_column_pruning_reaches_the_reader(ctxs, parquet_dir):
    q = ctxs[1].read_parquet(parquet_dir).select("c0", "c3")
    assert "cols=[c0,c3]" in q.explain()
    blocks = list(port_parquet.iter_parquet_batches(
        port_parquet.discover_parquet_files(parquet_dir), ["c0", "c3"]))
    assert blocks and all(sorted(b) == ["c0", "c3"] for b in blocks)
    assert len(q._compiled().rdd._schema()) == 2
    _parquet_parity(ctxs, parquet_dir, lambda df, ns: df.select("c0", "c3"))


def test_predicate_pushdown_into_scan_and_rowgroup_skip(ctxs, parquet_dir):
    def build(df, ns):
        return df.filter(ns.col("c0") < 100).select("c0", "c2")

    assert "c0<100" in build(ctxs[1].read_parquet(parquet_dir),
                             _namespaces()[1]).explain()
    rows = _parquet_parity(ctxs, parquet_dir, build)
    assert len(rows) == 100
    files = port_parquet.discover_parquet_files(parquet_dir)
    blocks = list(port_parquet.iter_parquet_batches(
        files, ["c0"], [("c0", "<", 100)]))
    assert sum(len(b["c0"]) for b in blocks) == 100
    import pyarrow.parquet as pq

    meta = pq.ParquetFile(files[0]).metadata
    kept = [g for g in range(meta.num_row_groups)
            if port_parquet._row_group_may_match(
                meta.row_group(g), {"c0": 0}, [("c0", "<", 100)])]
    assert kept == [0]  # statistics skip 9 of 10 row groups


@pytest.mark.parametrize("case", ["pruned_predicate_column",
                                  "pushdown_off", "group_join_sort"])
def test_parquet_queries_match_reference(ctxs, parquet_dir, case):
    builds = {
        "pruned_predicate_column": lambda df, ns: df.filter(
            ns.col("c5") > 4000).select("c1"),
        "pushdown_off": lambda df, ns: df.select("c0", "c3").hint(
            pushdown=False),
        "group_join_sort": lambda df, ns: df.with_column(
            "g", ns.col("c0") % 7).group_by("g").agg(ns.F.sum("c1", "s"))
        .join(df.with_column("g", ns.col("c0") % 5).group_by("g")
              .agg(ns.F.max("c2", "m")), on="g").sort("g"),
    }
    rows = _parquet_parity(ctxs, parquet_dir, builds[case],
                           ordered=case == "group_join_sort")
    if case == "pruned_predicate_column":
        assert len(rows) == sum(1 for i in range(1000) if i * 6 > 4000)
    if case == "pushdown_off":
        node = ctxs[1].read_parquet(parquet_dir).select("c0", "c3").hint(
            pushdown=False)._compiled().rdd
        while node._dense_parents:
            node = node._dense_parents[0]
        assert len(node._schema()) == 6  # every column reached the source


def test_read_parquet_columns_wrapper(port_ctx, parquet_dir):
    q = port_ctx.read_parquet(parquet_dir, columns=["c1", "c4"])
    assert q.columns == ["c1", "c4"]
    assert q.sort("c1").limit(3).collect() == [(0, 0), (2, 5), (4, 10)]
    with pytest.raises(VegaError, match="unknown column"):
        port_ctx.read_parquet(parquet_dir, columns=["nope"])


def test_float_predicates_stay_residual(ctxs, tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    edge = float(np.float32(0.15)) + 1e-12  # f64 > 0.15, f32 == 0.15
    p = str(tmp_path / "f.parquet")
    pq.write_table(pa.table({"i": np.arange(3),
                             "f": np.array([edge, 0.5, 0.9])}), p)
    port = ctxs[1]
    q = port.read_parquet(p).filter(port_frame.col("f") > 0.15).select("i")
    assert "f>" not in q.explain()
    assert q.collect() == q.hint(pushdown=False).collect()
    q2 = port.read_parquet(p).filter(port_frame.col("i") >= 1).select("i")
    assert "i>=1" in q2.explain()
    assert q2.collect() == q2.hint(pushdown=False).collect()
    _parquet_parity(ctxs, p, lambda df, ns: df.filter(
        ns.col("f") > 0.15).select("i"))


def test_parquet_string_group_join_sort(ctxs, tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    n = 300
    words = [f"w{i % 7:02d}" for i in range(n)]
    pq.write_table(pa.table({"w": words, "x": np.arange(n)}),
                   str(tmp_path / "p.parquet"), row_group_size=64)
    path = str(tmp_path)
    dims = dict(w=np.array([f"w{i:02d}" for i in range(3, 10)],
                           dtype=object), z=np.arange(7))
    rows = _parquet_parity(ctxs, path, lambda df, ns: df.group_by("w").agg(
        ns.F.sum("x", "sx"), ns.F.count("cnt")).sort("w"), ordered=True)
    assert [r[0] for r in rows] == sorted(set(words))
    ref, port = ctxs
    _parity(ref.read_parquet(path).group_by("w").agg(
        ref_frame.F.sum("x", "sx")).join(ref.create_frame(**dims), on="w")
        .sort("w"),
        port.read_parquet(path).group_by("w").agg(
            port_frame.F.sum("x", "sx")).join(port.create_frame(**dims),
                                              on="w").sort("w"),
        ordered=True)


def test_parquet_dir_without_parquet_files_raises_crisply(port_ctx,
                                                          tmp_path):
    d = tmp_path / "csvs"
    d.mkdir()
    for nm in ("a.csv", "b.csv"):
        (d / nm).write_text("x,y\n1,2\n")
    with pytest.raises(VegaError) as excinfo:
        port_ctx.read_parquet(str(d)).collect()
    assert str(d) in str(excinfo.value)
    assert "a.csv" in str(excinfo.value)
    with pytest.raises(VegaError, match="matches no files"):
        port_ctx.read_parquet(str(tmp_path / "nothing" / "*.parquet"))


def test_explicit_file_without_extension_still_reads(port_ctx, tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    p = str(tmp_path / "data_no_ext")
    pq.write_table(pa.table({"a": np.arange(5)}), p)
    assert port_ctx.read_parquet(p).count() == 5


# ------------------------------------------------------------ fusion


def _narrow_query(df, salt):
    col = port_frame.col
    return (df.select("k", "x").filter(col("x") < salt)
            .with_column("z", col("x") * salt + 1))


def test_fused_stage_applies_one_chain_and_unfused_one_per_verb(port_ctx):
    """The reference counts minted programs (one per fused stage, and none
    on a warm rerun, which its program cache serves). The port compiles
    and caches nothing, so program_mints() counts narrow-chain
    applications: one for the fused stage, one per verb under
    hint(fuse=False), with equal results; a rerun applies its chain
    again."""
    df = port_ctx.create_frame(**_data())
    q = _narrow_query(df, 700)
    before = dense_rdd.program_mints()
    fused = q.collect_columns()
    assert dense_rdd.program_mints() - before == 1
    before = dense_rdd.program_mints()
    unfused = q.hint(fuse=False).collect_columns()
    assert dense_rdd.program_mints() - before >= 3
    for nm in fused:
        np.testing.assert_array_equal(fused[nm], unfused[nm])
    before = dense_rdd.program_mints()
    _narrow_query(df, 700).collect_columns()
    assert dense_rdd.program_mints() - before == 1


def test_fused_stage_rides_the_exchange_chain(port_ctx):
    # filter -> group_by: the stage is one pipeline node inside the
    # reduce's chain (one application), its source the only block below
    col, F = port_frame.col, port_frame.F
    q = (port_ctx.create_frame(**_data()).filter(col("x") < 600)
         .group_by("k").agg(F.sum("x", "sx")))
    node = q._compiled().rdd
    pipes = [nd for nd in _lineage(node)
             if isinstance(nd, dense_rdd._ColsPipelineRDD)]
    assert len(pipes) == 1 and pipes[0]._chainable
    before = dense_rdd.program_mints()
    q.collect_columns()
    assert dense_rdd.program_mints() - before == 1
    assert pipes[0]._block is None  # applied inside the exchange
    unfused = q.hint(fuse=False)._compiled().rdd
    assert all(not nd._chainable for nd in _lineage(unfused)
               if isinstance(nd, dense_rdd._ColsPipelineRDD))


def _lineage(node):
    out, todo = [], [node]
    while todo:
        nd = todo.pop()
        if any(nd is o for o in out):
            continue
        out.append(nd)
        todo.extend(nd._dense_parents)
    return out


# ------------------------------------------------------------ lazy planning


def test_explain_reads_no_data_builds_no_block_applies_no_chain(
        port_ctx, parquet_dir, monkeypatch):
    """Planning stays lazy (the reference's lint rule VG013, held here
    by a test): explain() of frames over a parquet source and a columns
    source, through filter / group_by / join / sort, reads no batch,
    builds no block and applies no chain."""
    col, F = port_frame.col, port_frame.F

    def refuse(*a, **kw):
        raise AssertionError("planning touched data")

    monkeypatch.setattr(port_parquet, "iter_parquet_batches", refuse)
    monkeypatch.setattr(port_block, "from_numpy", refuse)
    ev = port_ctx.read_parquet(parquet_dir)
    dims = port_ctx.create_frame(c0=np.arange(50), y=np.arange(50) * 3)
    q = (ev.filter(col("c1") < 900).group_by("c0").agg(F.sum("c2", "s"))
         .join(dims.group_by("c0").agg(F.sum("y", "sy")), on="c0")
         .sort("c0"))
    before = dense_rdd.program_mints()
    text = q.explain()
    assert text.startswith("== physical: device tier ==")
    assert "c1<900" in text and "join: device sort-merge" in text
    assert q.hint(fuse=False, pushdown=False).explain()
    assert dense_rdd.program_mints() == before
    monkeypatch.undo()
    assert q.count() == 50


# ------------------------------------------------------------ pinned


def _lookup_udf(fr):
    table = {i: i * 100 for i in range(13)}

    def lookup(kk):  # a Python dict lookup: no trace can exist
        return table[int(kk)]

    return fr.udf(lookup, fr.col("k"))


def _scalar_first_arg_udf(fr):
    table = {i: i + 1 for i in range(1000)}

    def add_base(base, v):  # dict access on v: never vectorizes
        return base + table[int(v)]

    return fr.udf(add_base, fr.lit(10), fr.col("x"))


# name -> (build(ctx, fr) -> DataFrame, the reference's reason)
FALLBACKS = {
    "untraceable_udf": (
        lambda ctx, fr: ctx.create_frame(**_data()).with_column(
            "m", _lookup_udf(fr)).select("k", "m").sort("k"),
        "stage does not trace"),
    "udf_scalar_first_arg": (
        lambda ctx, fr: ctx.create_frame(x=np.arange(4)).with_column(
            "m", _scalar_first_arg_udf(fr)).sort("x"),
        "stage does not trace"),
    "numpy_udf": (
        lambda ctx, fr: ctx.create_frame(**_data()).with_column(
            "m", fr.udf(lambda c: np.asarray(c) + 1, fr.col("x"))),
        "stage does not trace"),
    "object_dtype_source": (
        lambda ctx, fr: ctx.create_frame(
            k=np.array([1, 2, 1]),
            s=np.array(["a", 2, None], dtype=object)).filter(
                fr.col("k") == 1).select("s"),
        "has no device column form"),
    "int64_beyond_int32_source": (
        lambda ctx, fr: ctx.create_frame(
            k=np.array([1, 2, 3]), big=np.array([2**40, 2, 3])).sort("k"),
        "beyond int32 range"),
    "wide_join": (
        lambda ctx, fr: ctx.create_frame(
            k=np.arange(6) % 3, x=np.arange(6), y=np.arange(6) * 2).join(
                ctx.create_frame(k=np.arange(3), z=np.arange(3) * 5),
                on="k").sort("k"),
        "exactly one value column per side"),
    "string_literal_filter": (
        lambda ctx, fr: ctx.create_frame(
            name=np.array(["pear", "apple", "fig"], dtype=object),
            x=np.arange(3)).filter(fr.col("name") == fr.lit("apple"))
        .select("x"),
        "compares dictionary codes"),
    "string_arithmetic": (
        lambda ctx, fr: ctx.create_frame(name=NAMES, x=np.arange(6))
        .group_by("name").agg(fr.F.sum("name", "s")),
        "folds dictionary codes"),
    "string_mixed_min_max": (
        lambda ctx, fr: ctx.create_frame(name=NAMES, x=np.arange(6))
        .group_by("x").agg(fr.F.min("name", "lo"), fr.F.max("name", "hi")),
        "mixed-op aggregation with a string column"),
    "float_group_key": (
        lambda ctx, fr: ctx.create_frame(f=np.array([0.5, 1.5, 0.5]),
                                         x=np.arange(3))
        .group_by("f").agg(fr.F.sum("x", "s")),
        "device exchange key must be"),
}


@pytest.mark.parametrize("name", sorted(FALLBACKS))
def test_fallback_raises_where_the_reference_falls_back(ctxs, name):
    """The reference compiles these plans on its host tier, silently; the
    port has none, so it raises VegaError with the reference's reason at
    explain(), collect() and count(), before any device work."""
    build, reason = FALLBACKS[name]
    ref, port = ctxs
    assert "host tier" in build(ref, ref_frame).explain()
    assert reason in ref_frame.planner.last_fallback()
    q = build(port, port_frame)
    before = dense_rdd.program_mints()
    for action in (q.explain, q.collect, q.count):
        with pytest.raises(VegaError, match="no device lowering") as ei:
            action()
        assert reason in str(ei.value)
    assert dense_rdd.program_mints() == before


def test_parquet_fallbacks_raise(ctxs, tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    nulls = str(tmp_path / "nulls.parquet")
    pq.write_table(pa.table({"w": ["a", None, "b", "a"],
                             "x": [1, 2, 3, 4]}), nulls)
    wide = str(tmp_path / "wide.parquet")
    pq.write_table(pa.table({"k": np.array([1, 2, 3]),
                             "big": np.array([2**40, 2, 3])}), wide)
    ref, port = ctxs
    for path, cols, reason in ((nulls, ("w", "x"), "has nulls"),
                               (wide, ("k", "big"), "no proof it fits")):
        assert "host tier" in ref.read_parquet(path).select(*cols) \
            .explain()
        assert reason in ref_frame.planner.last_fallback()
        with pytest.raises(VegaError, match=reason):
            port.read_parquet(path).select(*cols).collect()


def test_tier_host_to_rdd_and_fallback_counters_are_not_ported(port_ctx):
    df = port_ctx.create_frame(**_data())
    with pytest.raises(VegaError, match="no host tier"):
        df.hint(tier="host")
    with pytest.raises(VegaError, match="host tier"):
        df.select("k").to_rdd()
    # auto and device both mean the device tier; shuffle_plan changes
    # nothing on a device plan, as in the reference
    q = df.group_by("k").agg(port_frame.F.sum("x", "s")).sort("k")
    rows = q.collect()
    assert q.hint(tier="device").collect() == rows
    assert q.hint(shuffle_plan="push").collect() == rows
    assert not hasattr(port_planner, "fallback_count")
    assert not hasattr(port_planner, "last_fallback")
    with pytest.raises(VegaError, match="no device lowering"):
        FALLBACKS["untraceable_udf"][0](port_ctx, port_frame).hint(
            tier="device").collect()


def test_all_string_object_column_is_a_device_column(ctxs):
    ref, port = ctxs
    data = dict(k=np.array([1, 2, 1]),
                s=np.array(["a", "b", "c"], dtype=object))
    rows = _parity(ref.create_frame(**data).filter(
        ref_frame.col("k") == 1).select("s"),
        port.create_frame(**data).filter(
            port_frame.col("k") == 1).select("s"))
    assert rows == [("a",), ("c",)]


def test_api_errors(port_ctx):
    col, F = port_frame.col, port_frame.F
    df = port_ctx.create_frame(**_data())
    with pytest.raises(VegaError, match="unknown column"):
        df.select("nope")
    with pytest.raises(VegaError, match="filter"):
        df.select("k").filter(col("x") > 0)
    with pytest.raises(VegaError, match="group key"):
        df.group_by("nope")
    with pytest.raises(VegaError, match="terminal"):
        df.limit(3).select("k")
    with pytest.raises(VegaError, match="terminal"):
        df.group_by("k").agg(F.sum("x", "s")).join(
            df.group_by("k").agg(F.sum("y", "t")).limit(2), on="k")
    with pytest.raises(VegaError, match="unknown hint"):
        df.hint(warp_speed=True)
    with pytest.raises(VegaError, match="valid values"):
        df.hint(tier="Device")
    with pytest.raises(VegaError, match="valid values"):
        df.hint(exchange="rnig")
    with pytest.raises(VegaError, match="takes a bool"):
        df.hint(fuse="yes")
    with pytest.raises(VegaError, match="rename"):
        df.rename({"nope": "x2"})
    with pytest.raises(VegaError, match="duplicate"):
        df.group_by("k").agg(F.sum("x", "s"), F.sum("y", "s"))
    with pytest.raises(VegaError, match="collide"):
        df.join(port_ctx.create_frame(**_data()), on="k")
    with pytest.raises(VegaError, match="unequal lengths"):
        port_ctx.create_frame(a=np.arange(3), b=np.arange(4))
    with pytest.raises(VegaError, match="duplicate column"):
        port_ctx.create_frame({"a": np.arange(3)}, a=np.arange(3))
