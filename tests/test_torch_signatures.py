"""The positional parameters of vega_tpu_torch's user API against
vega_tpu's, on the CPU.

Every public method that the reference's DenseRDD, StreamedDenseRDD and
Context share with the port's takes the reference's positional
parameters as a prefix of its own, in the reference's order, with the
reference's defaults, and accepts the reference's keyword-only ones; the
port's own extras are keyword-only. Then one case per repaired method
runs the reference's positional call through both packages, with equal
results (integers bit-identical, floats within rtol 1e-5, rows
order-free by key where the reference hands the call to its host tier).

What the port does with each argument, as the reference does:
- accepted and ignored, as the reference's device path ignores it:
  reduce_by_key, combine_by_key, fold_by_key, aggregate_by_key,
  group_by_key and group_by (partitioner_or_num); sort_by_key and sort_by
  (num_partitions); distinct, intersection and subtract
  (num_partitions); partition_by_key (the reference's group_by_key
  ignores it there too); Context.dense_range, dense_from_numpy,
  create_frame and read_parquet (num_partitions);
- used as the reference uses it: sort_by_key's sample_size_hint feeds the
  sampler, so rows per shard equal the reference's;
- handed to the reference's host tier: join, left_outer_join,
  right_outer_join, full_outer_join, subtract_by_key, cogroup and
  group_with (partitioner_or_num). The port hands them to its host RDD
  layer (vega_tpu_torch/rdd/) the same way, for a partition count or a
  partitioner object, with the reference's rows (order-free: the
  reference merges numeric pairs in its native hash map), as it does a
  cogroup / group_with of two or more others or of none; one other with
  no partitioner is the device form. StreamedDenseRDD.join with a
  partition count joins the resident build, as the reference's does.
No repaired call raises TypeError.
"""

import inspect
import operator

import numpy as np
import pytest

import vega_tpu as v
import vega_tpu.context as ref_context
from vega_tpu.tpu import dense_rdd as ref_dense
from vega_tpu.tpu import stream as ref_stream
import vega_tpu_torch as vt
from vega_tpu_torch import context as port_context
from vega_tpu_torch import dense_rdd
from vega_tpu_torch import stream as port_stream
import vega_tpu.streaming.context as ref_streaming
import vega_tpu.streaming.dstream as ref_dstream
from vega_tpu_torch.streaming import context as port_streaming
from vega_tpu_torch.streaming import dstream as port_dstream

N_SHARDS = 8
ACCEL_PLANS = {"dense_rbk_plan": "fused_sort", "dense_table_plan": "off",
               "dense_sort_impl": "xla"}
RTOL = 1e-5

CLASSES = {
    "DenseRDD": (ref_dense.DenseRDD, dense_rdd.DenseRDD),
    "StreamedDenseRDD": (ref_stream.StreamedDenseRDD,
                         port_stream.StreamedDenseRDD),
    "Context": (ref_context.Context, port_context.Context),
    "StreamingContext": (ref_streaming.StreamingContext,
                         port_streaming.StreamingContext),
    "DStream": (ref_dstream.DStream, port_dstream.DStream),
}


def _shared(ref_cls, port_cls):
    """Public names both classes define (a name the port refuses is not
    defined: hasattr is False)."""
    return sorted(n for n in dir(ref_cls)
                  if not n.startswith("_") and hasattr(port_cls, n))


SHARED = [(cls, name) for cls, (r, p) in CLASSES.items()
          for name in _shared(r, p)]
POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
              inspect.Parameter.POSITIONAL_OR_KEYWORD,
              inspect.Parameter.VAR_POSITIONAL)
SIMPLE_DEFAULTS = (type(None), bool, int, float, str)


def test_shared_names_cover_the_repaired_api():
    names = {n for c, n in SHARED if c == "DenseRDD"}
    assert {"reduce_by_key", "group_by_key", "sort_by_key", "join",
            "left_outer_join", "right_outer_join", "combine_by_key",
            "distinct", "intersection", "subtract", "cogroup",
            "fold_by_key", "aggregate_by_key", "full_outer_join",
            "subtract_by_key", "group_with", "partition_by_key",
            "group_by", "sort_by"} <= names
    assert {"dense_range", "create_frame", "read_parquet",
            "dense_from_numpy"} <= {n for c, n in SHARED if c == "Context"}
    # the job server, the file sources and streaming
    assert {"active", "set_local_property", "get_local_property",
            "set_pool", "submit_job", "run_approximate_job",
            "metrics_summary", "storage_status", "broadcast",
            "read_source", "text_file", "whole_text_files", "parquet_file",
            "streaming", "stream_from_generator", "stream_from_file_tail",
            "stream_from_socket"} <= {n for c, n in SHARED
                                      if c == "Context"}
    ref_sctx, port_sctx = CLASSES["StreamingContext"]
    assert {n for n in dir(ref_sctx) if not n.startswith("_")} == \
        {n for c, n in SHARED if c == "StreamingContext"}
    ref_ds, _port_ds = CLASSES["DStream"]
    assert {n for n in dir(ref_ds) if not n.startswith("_")} == \
        {n for c, n in SHARED if c == "DStream"}


@pytest.mark.parametrize("cls,name", SHARED)
def test_reference_positionals_are_a_prefix(cls, name):
    """The reference's positional parameters (names, kinds, simple
    defaults) open the port's; the reference's keyword-only parameters
    are the port's keyword-only ones; the port's further parameters are
    keyword-only. Properties stay properties."""
    ref_cls, port_cls = CLASSES[cls]
    ra = inspect.getattr_static(ref_cls, name)
    pa = inspect.getattr_static(port_cls, name)
    if isinstance(ra, property) or isinstance(pa, property):
        assert isinstance(ra, property) and isinstance(pa, property), name
        return
    rp = list(inspect.signature(getattr(ref_cls, name)).parameters.values())
    pp = list(inspect.signature(getattr(port_cls, name)).parameters.values())
    r_pos = [p for p in rp if p.kind in POSITIONAL]
    p_pos = [p for p in pp if p.kind in POSITIONAL]
    assert [(p.name, p.kind) for p in p_pos[:len(r_pos)]] == \
        [(p.name, p.kind) for p in r_pos], name
    for r, p in zip(r_pos, p_pos):
        if isinstance(r.default, SIMPLE_DEFAULTS):
            assert p.default == r.default, (name, r.name)
    assert len(p_pos) == len(r_pos), (name, p_pos[len(r_pos):])
    r_kw = {p.name for p in rp if p.kind == inspect.Parameter.KEYWORD_ONLY}
    p_kw = {p.name for p in pp if p.kind == inspect.Parameter.KEYWORD_ONLY}
    assert r_kw <= p_kw, (name, r_kw - p_kw)


# ---------------------------------------------------------------------------
# the reference's positional calls through both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
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


def _data(seed=21, n=3000, keys=300):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, keys, n).astype(np.int32),
            rng.randint(-1000, 1000, n).astype(np.int32))


def _pairs(c):
    return c.dense_from_numpy(*_data())


def _table(c):
    """Keys [150, 450): half of _pairs' keys, and keys it lacks."""
    tk = np.arange(150, 450, dtype=np.int32)
    return c.dense_from_numpy(tk, tk.astype(np.float32) * 0.5)


def _values(c, lo=0):
    return c.dense_from_numpy(_data()[0][lo:lo + 1500])


def _grouped(res):
    return sorted((k, tuple(sorted(g) for g in gs)) for k, gs in res)


def _combiner():
    return (lambda x: x * 2, lambda a, x: a + x * 2, lambda a, b: a + b)


# name -> (call on a Context, how the results compare)
CASES = {
    "reduce_by_key(add, 8)": (
        lambda c: _pairs(c).reduce_by_key(operator.add, 8).collect(),
        "rows"),
    "reduce_by_key(traced, 8)": (
        lambda c: _pairs(c).reduce_by_key(lambda a, b: a ^ b, 8)
        .collect(), "rows"),
    "combine_by_key(c, mv, mc, 8)": (
        lambda c: _pairs(c).combine_by_key(*_combiner(), 8).collect(),
        "rows"),
    "fold_by_key(10, add, 8)": (
        lambda c: _pairs(c).fold_by_key(10, operator.add, 8).collect(),
        "rows"),
    "aggregate_by_key(100, add, add, 8)": (
        lambda c: _pairs(c).aggregate_by_key(
            100, operator.add, operator.add, 8).collect(), "rows"),
    "group_by_key(8)": (
        lambda c: _grouped((k, (vs,)) for k, vs in _pairs(c)
                           .group_by_key(8).collect()), "same"),
    "group_by(f, 8)": (
        lambda c: _grouped((k, (vs,)) for k, vs in c.dense_range(2000)
                           .group_by(lambda x: x % 31, 8).collect()),
        "same"),
    "sort_by_key(True, 8)": (
        lambda c: [k for k, _ in _pairs(c).sort_by_key(True, 8)
                   .collect()], "same"),
    "sort_by_key(False, 8, 64) rows per shard": (
        lambda c: _pairs(c).sort_by_key(False, 8, 64).block()
        .counts_np.tolist(), "same"),
    "sort_by_key(True, None, 16) rows per shard": (
        lambda c: _pairs(c).sort_by_key(True, None, 16).block()
        .counts_np.tolist(), "same"),
    "sort_by(f, False, 8)": (
        lambda c: [x % 97 for x in c.dense_range(3000).sort_by(
            lambda x: x % 97, False, 8).collect()], "same"),
    "join(table, 8)": (
        lambda c: _pairs(c).join(_table(c), 8).collect(), "rows"),
    "left_outer_join(table, 8)": (
        lambda c: _pairs(c).left_outer_join(_table(c), 8).collect(),
        "rows"),
    "left_outer_join(table, 8, -1)": (
        lambda c: _pairs(c).left_outer_join(_table(c), 8, -1).collect(),
        "rows"),
    "right_outer_join(table, 8)": (
        lambda c: _pairs(c).right_outer_join(_table(c), 8).collect(),
        "rows"),
    "full_outer_join(table, 8)": (
        lambda c: _pairs(c).full_outer_join(_table(c), 8).collect(),
        "rows"),
    "subtract_by_key(table, 8)": (
        lambda c: _pairs(c).subtract_by_key(_table(c), 8).collect(),
        "rows"),
    "cogroup(table, partitioner_or_num=8)": (
        lambda c: _grouped(_pairs(c).cogroup(
            _table(c), partitioner_or_num=8).collect()), "same"),
    "group_with(table, partitioner_or_num=8)": (
        lambda c: _grouped(_pairs(c).group_with(
            _table(c), partitioner_or_num=8).collect()), "same"),
    "partition_by_key(8)": (
        lambda c: _pairs(c).partition_by_key(8).collect(), "rows"),
    "distinct(8)": (lambda c: _values(c).distinct(8).collect(), "rows"),
    "intersection(other, 8)": (
        lambda c: _values(c).intersection(_values(c, 1500), 8).collect(),
        "rows"),
    "subtract(other, 8)": (
        lambda c: _values(c).subtract(_values(c, 1500), 8).collect(),
        "rows"),
    "dense_range(16, 8)": (lambda c: c.dense_range(16, 8).count(), "same"),
    "dense_range(1000, 8, None, 300)": (
        lambda c: c.dense_range(1000, 8, None, 300).map(
            lambda x: (x % 7, x)).reduce_by_key(operator.add).collect(),
        "rows"),
    "dense_from_numpy(k, v, num_partitions=8)": (
        lambda c: c.dense_from_numpy(*_data(), num_partitions=8).collect(),
        "same"),
    "create_frame(columns, 8)": (
        lambda c: c.create_frame({"k": _data()[0], "x": _data()[1]}, 8)
        .collect(), "rows"),
}


def _compare(got, exp, how):
    """Equal as _close says; "rows" compares order-free."""
    if how == "rows":
        got, exp = sorted(got, key=repr), sorted(exp, key=repr)
    _close(got, exp)


def _close(a, b):
    if isinstance(b, float) or isinstance(a, float):
        assert a == pytest.approx(b, rel=RTOL), (a, b)
    elif isinstance(b, (tuple, list)):
        assert len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _close(x, y)
    else:
        assert a == b, (a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_positional_call_equals_reference(ctxs, case):
    ref, port = ctxs
    call, how = CASES[case]
    _compare(call(port), call(ref), how)


def test_left_outer_join_partition_count_fills_zero(ctxs):
    """8 is the partition count, not the fill: unmatched rows fill 0 in
    both (the port's fill is cast to the right column's float32)."""
    for c in ctxs:
        a = c.dense_from_numpy(np.array([1, 1, 2, 3], np.int32),
                               np.array([10, 11, 20, 30], np.int32))
        b = c.dense_from_numpy(np.array([2, 4, 4], np.int32),
                               np.array([7.0, 8.0, 9.0], np.float32))
        assert sorted(a.left_outer_join(b, 8).collect()) == \
            [(1, (10, 0)), (1, (11, 0)), (2, (20, 7.0)), (3, (30, 0))]
        assert c.dense_range(16, 8).count() == 16


def test_read_parquet_num_partitions(ctxs, tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    k, x = _data()
    pq.write_table(pa.table({"k": k, "x": x}), str(tmp_path / "p.parquet"))
    ref, port = ctxs
    got = port.read_parquet(str(tmp_path), None, 8).collect()
    exp = ref.read_parquet(str(tmp_path), None, 8).collect()
    assert sorted(got) == sorted(exp)


def test_stream_positionals(ctxs):
    """A stream's reduce_by_key(f, 8) folds per chunk; its join(table, 8)
    joins the resident build, as the reference's does."""
    ref, port = ctxs

    def run(c):
        s = c.dense_range(2000, chunk_rows=600).map(lambda x: (x % 400, x))
        return (sorted(s.reduce_by_key(operator.add, 8).collect()),
                sorted(s.join(_table(c), 8).collect()))
    got, exp = run(port), run(ref)
    assert got[0] == exp[0]
    _compare(got[1], exp[1], "rows")


REFUSED = {
    "join(table, partitioner object)": lambda c, p: p.join(
        _table(c), object()),
    "cogroup(table, table)": lambda c, p: p.cogroup(_table(c), _table(c)),
    "group_with() of no other": lambda c, p: p.group_with(),
    "subtract_by_key(table, 0)": lambda c, p: p.subtract_by_key(
        _table(c), 0),
}


def _host_outcome(build):
    """("ok", rows sorted by repr) or ("raise", the exception's class;
    a reference task's TaskError as its cause)."""
    try:
        rows = build().collect()
    except Exception as e:  # noqa: BLE001 — the class is the outcome
        while type(e).__name__ == "TaskError" and e.__cause__ is not None:
            e = e.__cause__
        return ("raise", type(e).__name__)
    return ("ok", sorted(rows, key=repr))


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_host_partitioners_refuse_with_the_suffix(ctxs, case):
    """An explicit partitioner object or count, a cogroup of several
    sides or of none: the reference's host join, cogroup or
    subtract_by_key, and the port's host RDD layer gives the same rows
    (cogroups by their groups), or where the reference's raises (a
    partitioner that is no Partitioner, zero partitions), the same
    exception class."""
    ref, port = ctxs
    got = _host_outcome(lambda: REFUSED[case](port, _pairs(port)))
    exp = _host_outcome(lambda: REFUSED[case](ref, _pairs(ref)))
    if got[0] == exp[0] == "ok" and case.startswith(("cogroup", "group")):
        got, exp = _grouped(got[1]), _grouped(exp[1])
    assert got == exp
