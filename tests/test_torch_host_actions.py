"""The RDD API names the reference answers on its host tier, computed on the
device by vega_tpu_torch, against vega_tpu on the CPU.

The reference's DenseRDD inherits these from its host RDD
(vega_tpu/rdd/base.py): sample(True, ...), take_sample, random_split,
count_approx_distinct, count_approx, mean_approx, count_by_value_approx,
to_local_iterator, for_each, for_each_partition, save_as_text_file and the
async actions. The port computes the samplers, the estimates and the
async actions on the device (host_actions.py, random.py, hll.py,
partial/, scheduler/jobserver.py); take_sample and the four row
actions are its host RDD's (rdd/base.py) over those device forms
and the shards' rows, as the reference's DenseRDD inherits them. Each
lineage runs through a vega_tpu
Context("local") on the 8-device CPU mesh and through vega_tpu_torch's
Context(device="cpu", n_shards=8), both under the card's plans (xla sorts,
fused_sort, no table plan), on inputs made from a seed with numpy.

Integers, rows, sample rows (in the reference's shard order: both sides
place a source's rows alike), file bytes and count_approx_distinct are
compared bit for bit; a mean at rtol 1e-5 (the reference adds the rows as
Python floats in order, the port per shard in float64). The approximate
actions of a DenseRDD are its host RDD's on both sides, one task a
shard through the evaluators (partial/): final here where the deadline
is long, the estimate and then the final value where a straggling shard
outlasts it (test_approx_partial_then_final).
"""

import dataclasses
import operator
import os
import threading

import numpy as np
import pytest
import torch

import vega_tpu as v
from vega_tpu.partitioner import hash_key as ref_hash_key
from vega_tpu.utils.hll import HyperLogLog
import vega_tpu_torch as vt
from vega_tpu_torch import block as block_lib
from vega_tpu_torch import dense_rdd
from vega_tpu_torch import hll
from vega_tpu_torch import random as vrandom
from vega_tpu_torch.errors import CancelledError, TaskError, VegaError
from vega_tpu_torch.partial import BoundedDouble, PartialResult

N_SHARDS = 8
ACCEL_PLANS = {"dense_rbk_plan": "fused_sort", "dense_table_plan": "off",
               "dense_sort_impl": "xla"}


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


def _data(seed=5, n=4000, keys=300):
    rng = np.random.default_rng(seed)
    return dict(
        k=rng.integers(0, keys, n).astype(np.int32),
        v=rng.integers(-10_000, 10_000, n).astype(np.int32),
        x=rng.standard_normal(n).astype(np.float32),
        w=rng.integers(-2**40, 2**40, n),
        s=np.array([f"w{i:03d}" for i in range(120)])[
            rng.integers(0, 120, n)],
        b=rng.integers(0, 2, n).astype(bool))


D = _data()

# name -> build(ctx): the lineages the names run over
SOURCES = {
    "range": lambda c: c.dense_range(5000),
    "int_values": lambda c: c.dense_from_numpy(D["v"]),
    "float_values": lambda c: c.dense_from_numpy(D["x"]),
    "pairs": lambda c: c.dense_from_numpy(D["k"], D["v"]),
    "float_pairs": lambda c: c.dense_from_numpy(D["k"], D["x"]),
    "wide_pairs": lambda c: c.dense_from_numpy(D["k"], D["w"]),
    "string_keys": lambda c: c.dense_from_numpy(D["s"], D["v"]),
    "reduced": lambda c: c.dense_from_numpy(D["k"], D["v"]).reduce_by_key(
        operator.add),
    "filtered": lambda c: c.dense_range(6000).filter(lambda x: x % 3 != 0),
}
VALUE_SOURCES = ("range", "int_values", "float_values", "filtered")


# ---------------------------------------------------------------------------
# the samplers' streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dist,lam", [("poisson", 0.05), ("poisson", 0.7),
                                      ("poisson", 4.0), ("poisson", 25.0),
                                      ("uniform", None)])
def test_vectorised_draws_equal_scalar_draws(dist, lam):
    """numpy's vectorised PCG64 draw of size n equals n scalar draws, in
    order: the port draws a shard's stream in one call where the
    reference's host sampler draws one a row."""
    for split in (0, 3, 7):
        vec = vrandom.rng(11, split)
        one = np.random.Generator(np.random.PCG64([11, split]))
        if dist == "poisson":
            got = vec.poisson(lam, size=3000)
            want = [one.poisson(lam) for _ in range(3000)]
        else:
            got = vec.random(size=3000)
            want = [one.random() for _ in range(3000)]
        np.testing.assert_array_equal(got, np.array(want))


def test_sampler_seeds_are_the_reference_s():
    """seed None draws from 0xC0FFEE, seed 0 from 0, as the reference's
    RandomSampler._rng; the oversampling fraction is its."""
    from vega_tpu.utils import random as ref_random

    for seed in (None, 0, 9):
        a = vrandom.PoissonSampler(0.6, seed).counts(500, 2)
        r = ref_random.PoissonSampler(0.6, seed)
        b = [sum(1 for _ in r.sample(iter([0]), 2))]
        g = r._rng(2)
        want = np.array([g.poisson(0.6) for _ in range(500)])
        np.testing.assert_array_equal(a, want)
        assert b[0] == want[0]
    for size, total, wr in ((5, 1000, True), (50, 1000, True),
                            (50, 1000, False), (999, 1000, False)):
        assert vrandom.compute_fraction_for_sample_size(size, total, wr) \
            == ref_random.compute_fraction_for_sample_size(size, total, wr)


# ---------------------------------------------------------------------------
# sample(True), random_split, take_sample
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source", sorted(SOURCES))
@pytest.mark.parametrize("fraction,seed", [(0.3, 7), (2.5, None)])
def test_sample_with_replacement(ctxs, source, fraction, seed):
    """Each row repeated by the reference's PoissonSampler stream of its
    shard: the same rows in the same order, shard by shard."""
    ref, port = ctxs
    got = SOURCES[source](port).sample(True, fraction, seed)
    exp = SOURCES[source](ref).sample(True, fraction, seed)
    assert got.collect() == exp.collect()
    counts = got.block().counts_np
    assert counts.sum() == len(exp.collect())


@pytest.mark.parametrize("source", sorted(SOURCES))
@pytest.mark.parametrize("weights,seed", [([0.8, 0.2], 7),
                                          ([1, 2, 3], None)])
def test_random_split(ctxs, source, weights, seed):
    """Each band equals the reference's, row for row; the bands are
    disjoint and together hold every row once."""
    ref, port = ctxs
    got = SOURCES[source](port).random_split(weights, seed)
    exp = SOURCES[source](ref).random_split(weights, seed)
    assert all(isinstance(b, dense_rdd.DenseRDD) for b in got)
    bands = [b.collect() for b in got]
    assert bands == [b.collect() for b in exp]
    whole = SOURCES[source](port).collect()
    assert sum(len(b) for b in bands) == len(whole)
    assert sorted(sum(bands, []), key=repr) == sorted(whole, key=repr)


@pytest.mark.parametrize("source", sorted(SOURCES))
@pytest.mark.parametrize("with_replacement,num,seed", [
    (False, 100, 7), (True, 100, 7), (False, 10**6, 3), (True, 5, None),
    (False, 0, 1)])
def test_take_sample(ctxs, source, with_replacement, num, seed):
    """The reference's take_sample: the same rows in the same shuffled
    order."""
    ref, port = ctxs
    got = SOURCES[source](port).take_sample(with_replacement, num, seed)
    exp = SOURCES[source](ref).take_sample(with_replacement, num, seed)
    assert got == exp
    assert len(got) == min(num, len(SOURCES[source](port).collect())) \
        or with_replacement


def test_take_sample_retries_and_empty(ctxs):
    """A sample that comes short retries with seed + attempts, as the
    reference's; an empty RDD gives []."""
    ref, port = ctxs
    for c in (port, ref):
        assert c.dense_from_numpy(np.zeros(0, np.int32)).take_sample(
            True, 5, 1) == []
    # 30 rows, 29 asked without replacement: short draws retry
    got = port.dense_range(30).take_sample(False, 29, 4)
    assert got == ref.dense_range(30).take_sample(False, 29, 4)


# ---------------------------------------------------------------------------
# count_approx_distinct and hash_key
# ---------------------------------------------------------------------------

HLL_SOURCES = dict(SOURCES, **{
    "bool_values": lambda c: c.dense_from_numpy(D["b"]),
    "string_values": lambda c: c.dense_from_numpy(D["s"]),
    "uint32_values": lambda c: c.dense_from_numpy(
        (D["w"] & 0xFFFFFFFF).astype(np.uint32)),
    "int8_pairs": lambda c: c.dense_from_numpy(
        D["k"], (D["v"] % 100).astype(np.int8)),
    "float_specials": lambda c: c.dense_from_numpy(np.array(
        [0.0, -0.0, np.nan, -np.nan, 2.0, -3.0, 1.5, np.inf, -np.inf,
         2.0**40, 1e-40, 7.0] * 50, np.float32)),
    "joined": lambda c: c.dense_from_numpy(D["k"][:500], D["v"][:500])
    .join(c.dense_from_numpy(np.arange(300, dtype=np.int32),
                             np.arange(300, dtype=np.float32) * 0.5)),
    "named": lambda c: c.dense_from_columns(
        {"a": D["k"], "b": D["x"], "c": D["v"]}),
})


@pytest.mark.parametrize("source", sorted(HLL_SOURCES))
@pytest.mark.parametrize("relative_sd", [0.05, 0.01, 0.2])
def test_count_approx_distinct(ctxs, source, relative_sd):
    """The reference's HyperLogLog estimate, the same integer: the port's
    registers, built on the device from each row's hash_key, are the
    reference's."""
    ref, port = ctxs
    got = HLL_SOURCES[source](port).count_approx_distinct(relative_sd)
    exp = HLL_SOURCES[source](ref).count_approx_distinct(relative_sd)
    assert got == exp
    assert isinstance(got, int)


def test_vector_values(ctxs):
    """A value column with a trailing dim (a list a row on the host):
    sample(True) and random_split give the reference's rows;
    count_approx_distinct is the host RDD layer's, whose job fails on the
    unhashable list as the reference's does: TaskError raised from the
    task's TypeError."""
    ref, port = ctxs
    vec = np.stack([D["v"], D["k"]], axis=1)
    for build in (lambda c: c.dense_from_numpy(D["k"], vec).sample(
                      True, 0.7, 3),
                  lambda c: c.dense_from_numpy(D["k"], vec).random_split(
                      [1, 3], 3)[1]):
        assert build(port).collect() == build(ref).collect()
    with pytest.raises(Exception, match="unhashable type"):
        ref.dense_from_numpy(D["k"], vec).count_approx_distinct()
    with pytest.raises(TaskError, match="unhashable type") as info:
        port.dense_from_numpy(D["k"], vec).count_approx_distinct()
    assert isinstance(info.value.__cause__, TypeError)


def test_count_approx_distinct_refuses_grouped_rows(ctxs):
    """A group_by_key row holds a list, which the reference cannot hash
    (its job fails with TaskError raised from a TypeError); the port's
    host RDD layer fails the same way."""
    ref, port = ctxs
    with pytest.raises(Exception, match="unhashable type"):
        ref.dense_from_numpy(D["k"], D["v"]).group_by_key() \
            .count_approx_distinct()
    with pytest.raises(TaskError, match="unhashable type") as info:
        port.dense_from_numpy(D["k"], D["v"]).group_by_key() \
            .count_approx_distinct()
    assert isinstance(info.value.__cause__, TypeError)


HASH_FORMS = {
    "int32": np.array([0, 1, -1, 2**31 - 1, -2**31, 12345], np.int32),
    "wide": np.array([2**40, -2**62, 2**63 - 1, -2**63, 5], np.int64),
    "bool": np.array([True, False]),
    "float32": np.array([0.0, -0.0, np.nan, 2.0, -2.0, 1.5, np.inf,
                         -np.inf, 2.0**62, -(2.0**63), 3e38, 1e-45],
                        np.float32),
    "float64": np.array([0.0, -0.0, np.nan, 2.0**63, -(2.0**63), 0.1,
                         1e300, 9007199254740993.0], np.float64),
    "uint32": np.array([0, 1, 2**31, 2**32 - 1], np.uint32),
    "string": np.array(["", "a", "w123", "ünïcode", "日本"]),
}


def _port_hash(arr: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(arr) if arr.dtype.kind != "U" else None
    if arr.dtype.kind == "U":
        return hll.hash_column(torch.arange(len(arr)), "str",
                               torch.from_numpy(hll.hash_strings(arr)))
    if arr.dtype == np.uint32:
        t = torch.from_numpy(arr.astype(np.int64))
    kind = ("bool" if arr.dtype == bool else
            "float" if arr.dtype.kind == "f" else "int")
    return hll.hash_column(t, kind).numpy()


@pytest.mark.parametrize("form", sorted(HASH_FORMS))
def test_hash_key_forms(form):
    """The port's hash_key over a column equals the reference's
    partitioner.hash_key of each host value (a float's integral check,
    its float64 bits otherwise, -0.0 as 0; a string's FNV-1a), as
    unsigned 64-bit words."""
    arr = HASH_FORMS[form]
    got = np.asarray(_port_hash(arr)).astype(np.int64).view(np.uint64)
    want = [ref_hash_key(x) for x in arr.tolist()]
    assert got.tolist() == want


def test_hash_key_of_tuples():
    """A (k, v) row's and a nested (k, (lv, rv)) row's hash: the
    reference's tuple fold from 0x345678."""
    k = np.array([1, -7, 2**31 - 1], np.int32)
    x = np.array([0.5, -0.0, np.nan], np.float32)
    w = np.array([2**40, 3, -2**50], np.int64)
    hk = hll.hash_column(torch.from_numpy(k), "int")
    hx = hll.hash_column(torch.from_numpy(x), "float")
    hw = hll.hash_column(torch.from_numpy(w), "int")
    pair = hll.hash_tuple([hk, hx]).numpy().view(np.uint64).tolist()
    nested = hll.hash_tuple([hk, hll.hash_tuple([hw, hx])]).numpy() \
        .view(np.uint64).tolist()
    rows = list(zip(k.tolist(), x.tolist(), w.tolist()))
    assert pair == [ref_hash_key((a, b)) for a, b, _ in rows]
    assert nested == [ref_hash_key((a, (c, b))) for a, b, c in rows]


@pytest.mark.parametrize("p", [4, 9, 14, 18])
def test_hll_registers_and_estimate(p):
    """Registers of random 64-bit hashes equal the reference's
    HyperLogLog.add, and the estimate its estimate()."""
    rng = np.random.default_rng(p)
    words = rng.integers(-2**63, 2**63 - 1, 5000, dtype=np.int64)
    words[:3] = [0, -1, 1]
    reg = hll.registers(torch.from_numpy(words)[None, :],
                        torch.ones((1, len(words)), dtype=torch.bool),
                        p)[0].numpy()
    ref = HyperLogLog(p)
    for w in words.view(np.uint64).tolist():
        idx = w >> (64 - p)
        rest = (w << p) & 0xFFFFFFFFFFFFFFFF
        rank = (64 - p) + 1 if rest == 0 else 64 - rest.bit_length() + 1
        ref.registers[idx] = max(ref.registers[idx], rank)
    np.testing.assert_array_equal(reg, ref.registers.astype(np.int32))
    assert hll.estimate(reg.astype(np.uint8)) == ref.estimate()
    assert hll.precision_for(0.05) == HyperLogLog.precision_for(0.05)


# ---------------------------------------------------------------------------
# approximate actions: the evaluators', one task a shard
# ---------------------------------------------------------------------------


def _bd(x):
    return dataclasses.astuple(x)


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_count_approx(ctxs, source):
    ref, port = ctxs
    got = SOURCES[source](port).count_approx(60.0)
    exp = SOURCES[source](ref).count_approx(60.0)
    assert got.is_initial_value_final and exp.is_initial_value_final
    assert _bd(got.initial_value) == _bd(exp.initial_value)
    assert _bd(got.get_final_value()) == _bd(exp.get_final_value(60.0))


@pytest.mark.parametrize("source", VALUE_SOURCES + ("wide_values",))
def test_mean_approx(ctxs, source):
    ref, port = ctxs
    build = (SOURCES.get(source) or
             (lambda c: c.dense_from_numpy(D["w"])))
    got = build(port).mean_approx(60.0, 0.9)
    exp = build(ref).mean_approx(60.0, 0.9)
    assert got.is_initial_value_final and exp.is_initial_value_final
    g, e = _bd(got.get_final_value()), _bd(exp.get_final_value(60.0))
    np.testing.assert_allclose(g, e, rtol=1e-5)
    assert g[1] == e[1] == 1.0


def test_mean_approx_of_nothing(ctxs):
    ref, port = ctxs
    got = port.dense_from_numpy(np.zeros(0, np.float32)).mean_approx(1.0)
    exp = ref.dense_from_numpy(np.zeros(0, np.float32)).mean_approx(1.0)
    g, e = _bd(got.get_final_value()), _bd(exp.get_final_value(1.0))
    assert g[1] == e[1] == 0.0 and all(np.isnan([g[0], g[2], g[3]]))


@pytest.mark.parametrize("source", VALUE_SOURCES + ("string_values",))
def test_count_by_value_approx(ctxs, source):
    ref, port = ctxs
    build = (SOURCES.get(source) or
             (lambda c: c.dense_from_numpy(D["s"])))
    got = build(port).count_by_value_approx(60.0)
    exp = build(ref).count_by_value_approx(60.0)
    assert got.is_initial_value_final and exp.is_initial_value_final
    g = {k: _bd(b) for k, b in got.get_final_value().items()}
    e = {k: _bd(b) for k, b in exp.get_final_value(60.0).items()}
    assert g == e


@pytest.mark.parametrize("action", ["count", "mean", "count_by_value"])
def test_approx_partial_then_final(ctxs, action):
    """One straggling shard (faults.maybe_slow_task, armed alike on both
    sides) outlasts the deadline: the first value is the evaluator's
    estimate over the shards that finished, not final, and the final
    value is the exact one."""
    from vega_tpu import faults as ref_faults
    from vega_tpu_torch import faults as port_faults

    ref, port = ctxs
    call = {"count": lambda n: n.count_approx(0.5),
            "mean": lambda n: n.mean_approx(0.5, 0.9),
            "count_by_value": lambda n: n.count_by_value_approx(0.5)}[action]
    sides = []
    for faults, ctx in ((ref_faults, ref), (port_faults, port)):
        faults.configure(slow_tasks=1, slow_task_s=1.5)
        try:
            res = call(ctx.dense_from_numpy(D["v"] % 7))
            first_final = res.is_initial_value_final
            last = res.get_final_value(10.0)
        finally:
            faults.reset()
        if action == "count_by_value":
            last = {k: _bd(b) for k, b in sorted(last.items())}
        else:
            last = _bd(last)
        sides.append((first_final, last))
    assert sides[0][0] is sides[1][0] is False
    if action == "mean":
        np.testing.assert_allclose(sides[1][1], sides[0][1], rtol=1e-5)
    else:
        assert sides[1][1] == sides[0][1]


def test_partial_result_surface(ctxs):
    """The reference's PartialResult surface on a final result, both
    sides: the completion handler is called at once with the final value,
    a failure handler never, and get_final_value returns without
    waiting."""
    ref, port = ctxs
    sides = []
    for res in (port.dense_range(100).count_approx(60.0),
                ref.dense_range(100).count_approx(60.0)):
        seen, errs = [], []
        assert res.on_complete(seen.append) is res
        assert res.on_fail(errs.append) is res
        assert res.is_initial_value_final and errs == []
        assert seen == [res.initial_value] == [res.get_final_value(0)]
        assert "final" in repr(res)
        sides.append(_bd(seen[0]))
    assert sides[0] == sides[1] == (100.0, 1.0, 100.0, 100.0)


# ---------------------------------------------------------------------------
# host-row actions: one shard at a time
# ---------------------------------------------------------------------------

ROW_SOURCES = dict(SOURCES, **{
    "joined": HLL_SOURCES["joined"],
    "grouped": lambda c: c.dense_from_numpy(D["k"], D["v"]).group_by_key(),
})


def _canon(rows):
    """group_by_key rows with their value lists sorted: the order within
    a group is not defined."""
    return [(k, sorted(vs)) if isinstance(vs, list) else (k, vs)
            for k, vs in rows] if rows and isinstance(rows[0], tuple) \
        else rows


@pytest.mark.parametrize("source", sorted(ROW_SOURCES))
def test_to_local_iterator(ctxs, source):
    """The rows of collect(), in shard order; the reference's host shuffle
    places a grouped lineage's rows by its own hash, so that one is
    compared order-free."""
    ref, port = ctxs
    node = ROW_SOURCES[source](port)
    it = node.to_local_iterator()
    assert not isinstance(it, list)
    got = list(it)
    assert got == node.collect()
    exp = list(ROW_SOURCES[source](ref).to_local_iterator())
    if source == "grouped":
        assert sorted(_canon(got)) == sorted(_canon(exp))
    else:
        assert got == exp


def test_to_local_iterator_reads_one_shard_at_a_time(ctxs, monkeypatch):
    """Taking the first row reads one shard's rows, never the whole
    block: the host holds one shard at a time."""
    _ref, port = ctxs
    node = port.dense_range(8000)
    node.block()
    reads = []
    orig = block_lib.Block.shard_rows

    def counted(self, shard, limit=None):
        reads.append(shard)
        return orig(self, shard, limit)

    monkeypatch.setattr(block_lib.Block, "shard_rows", counted)
    monkeypatch.setattr(block_lib.Block, "to_numpy", None)
    it = node.to_local_iterator()
    assert next(it) == 0 and reads == [0]
    rest = list(it)
    assert len(rest) == 7999 and reads == list(range(8))


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_for_each_and_for_each_partition(ctxs, source):
    """for_each sees every row once and for_each_partition one iterator a
    shard, with the reference's partition sizes; both in the order the
    tasks run, as the reference's."""
    ref, port = ctxs
    rows, parts = [], []
    node = SOURCES[source](port)
    assert node.for_each(rows.append) is None
    node.for_each_partition(lambda it: parts.append(len(list(it))))
    assert sorted(rows, key=repr) == sorted(node.collect(), key=repr)
    lock = threading.Lock()
    ref_parts = {}

    def record(it):
        items = list(it)
        with lock:
            ref_parts[len(ref_parts)] = len(items)

    SOURCES[source](ref).for_each_partition(record)
    if source != "reduced":  # the reference's host shuffle places rows
        assert sorted(parts) == sorted(int(c)
                                       for c in node.block().counts_np)
    assert sorted(parts) == sorted(ref_parts.values())


@pytest.mark.parametrize("source", sorted(ROW_SOURCES))
def test_save_as_text_file(ctxs, source, tmp_path):
    """One part-NNNNN file a shard, one f"{row}\\n" a row, byte for byte
    the reference's files (order-free for a grouped lineage, whose host
    shuffle places rows by its own hash), and no temporary file left."""
    ref, port = ctxs
    out = {}
    for name, c in (("port", port), ("ref", ref)):
        path = tmp_path / name
        ROW_SOURCES[source](c).save_as_text_file(str(path))
        out[name] = {f: (path / f).read_bytes()
                     for f in sorted(os.listdir(path))}
    assert list(out["port"]) == [f"part-{s:05d}" for s in range(N_SHARDS)]
    if source in ("grouped", "reduced"):
        def lines(files):
            return sorted(b"".join(files.values()).splitlines())
        assert list(out["ref"]) == list(out["port"])
        if source == "reduced":
            assert lines(out["port"]) == lines(out["ref"])
        return
    assert out["port"] == out["ref"]


def test_save_as_text_file_formats_as_python(ctxs, tmp_path):
    """The bytes are Python's own formatting of the host rows: float32
    values as their float64 repr, wide ints exact, strings bare."""
    _ref, port = ctxs
    node = port.dense_from_numpy(np.array(["a", "b"]),
                                 np.array([0.1, 2**40], np.float32))
    node.save_as_text_file(str(tmp_path))
    text = b"".join((tmp_path / f).read_bytes()
                    for f in sorted(os.listdir(tmp_path)))
    assert text == b"('a', 0.10000000149011612)\n('b', 1099511627776.0)\n"


# ---------------------------------------------------------------------------
# asynchronous actions
# ---------------------------------------------------------------------------

ASYNC = {
    "collect_async": (lambda n: n.collect_async(), lambda n: n.collect()),
    "count_async": (lambda n: n.count_async(), lambda n: n.count()),
}


@pytest.mark.parametrize("source", sorted(ROW_SOURCES))
@pytest.mark.parametrize("action", sorted(ASYNC))
def test_async_equals_sync(ctxs, source, action):
    """result() equals the synchronous action's value (a group_by_key's
    count is its groups, as the port's count())."""
    _ref, port = ctxs
    submit, sync = ASYNC[action]
    fut = submit(ROW_SOURCES[source](port))
    assert fut.result(60) == sync(ROW_SOURCES[source](port))
    assert fut.done() and not fut.cancelled() and fut.exception() is None


@pytest.mark.parametrize("source", VALUE_SOURCES)
def test_reduce_async(ctxs, source):
    """result() is reduce()'s value, and the reference's (a float32 sum
    within rtol 1e-5: the reference's host tier adds Python floats)."""
    ref, port = ctxs
    got = SOURCES[source](port).reduce_async(operator.add).result(60)
    assert got == SOURCES[source](port).reduce(operator.add)
    exp = SOURCES[source](ref).reduce_async(operator.add).result(60)
    assert got == pytest.approx(exp, rel=1e-5)
    assert type(got) is type(exp)


def test_async_against_the_reference(ctxs):
    """The futures' results equal the reference's JobFutures'."""
    ref, port = ctxs
    for build in (SOURCES["pairs"], SOURCES["float_values"]):
        assert build(port).collect_async().result(60) == \
            build(ref).collect_async().result(60)
        assert build(port).count_async().result(60) == \
            build(ref).count_async().result(60)


def test_reduce_async_refuses_at_the_call(ctxs):
    """What reduce has no device form for (pairs, a binop with a Python
    int past int32) is the host RDD layer's reduce in the future, as the
    reference's reduce_async (a host job) gives it; an empty RDD raises
    through the future, as the reference's."""
    ref, port = ctxs
    for build in (lambda c: c.dense_from_numpy(D["k"][:40], D["v"][:40])
                  .reduce_async(operator.add),
                  lambda c: c.dense_from_numpy(D["v"]).reduce_async(
                      lambda a, b: a + b + 2**40)):
        assert build(port).result(60) == build(ref).result(60)
    fut = port.dense_from_numpy(np.zeros(0, np.int32)).reduce_async(
        operator.add)
    assert isinstance(fut.exception(60), VegaError)
    with pytest.raises(VegaError, match="empty"):
        fut.result()
    ref_fut = ref.dense_from_numpy(np.zeros(0, np.int32)).reduce_async(
        operator.add)
    with pytest.raises(Exception, match="empty"):
        ref_fut.result(60)


def test_async_fifo_order_and_cancellation():
    """Each job runs on a driver thread of its own (the reference's job
    server): a job submitted behind a held one finishes first; a job
    cancelled while it runs raises CancelledError; cancel() of a finished
    job returns False; stop() settles the jobs still in flight."""
    with vt.Context(device="cpu", n_shards=4) as ctx:
        gate = threading.Event()
        first = ctx._submit_call(lambda: gate.wait(30))
        node = ctx.dense_range(100)
        second = node.count_async()
        assert second.result(60) == 100 and not first.done()
        third = ctx.submit_job(node, lambda _tc, it: gate.wait(30))
        assert third.cancel("not needed")
        with pytest.raises(CancelledError, match="not needed"):
            third.result(30)
        assert third.cancelled()
        fourth = node.reduce_async(operator.add)
        assert fourth.result(60) == sum(range(100))
        assert not second.cancel()
        gate.set()
        assert first.result(30) is True
        held = threading.Event()
        late = ctx.submit_job(node, lambda _tc, it: held.wait(30))
    with pytest.raises(CancelledError):
        late.result(30)
    held.set()


def test_two_futures_back_to_back(ctxs):
    """Two submissions in a row on one lineage both settle with the
    synchronous values."""
    _ref, port = ctxs
    node = port.dense_from_numpy(D["k"], D["v"]).reduce_by_key(operator.add)
    a, b = node.count_async(), node.collect_async()
    assert b.result(60) == node.collect() and a.result(60) == node.count()


def test_async_stress_settles_each_future_once():
    """Many threads submit and cancel at once, with a short switch
    interval: every future settles exactly once (its value or
    CancelledError), each done-callback runs once, and every job that was
    not cancelled ran once."""
    import sys

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ctx = vt.Context(device="cpu", n_shards=4)
        ran, futures, calls = [], [], []
        lock = threading.Lock()

        def submit(t):
            for i in range(50):
                f = ctx._submit_call(lambda t=t, i=i: ran.append((t, i)) or i)
                f.add_done_callback(lambda f: calls.append(f))
                if i % 7 == 0:
                    f.cancel()
                with lock:
                    futures.append((t, i, f))

        threads = [threading.Thread(target=submit, args=(t,))
                   for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
        for _t, _i, f in futures:
            f.exception(60)
        ctx.stop()
        assert len(futures) == 16 * 50 and len(calls) == 16 * 50
        for t, i, f in futures:
            assert f.done()
            if f.cancelled():
                assert isinstance(f.exception(0), CancelledError)
            else:
                assert f.result(0) == i and (t, i) in ran
        assert len(set(ran)) == len(ran)
    finally:
        sys.setswitchinterval(old)
