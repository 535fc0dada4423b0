"""Streamed dense sources and .npz checkpoints of vega_tpu_torch against
vega_tpu, on the CPU.

One case for each test of tests/test_stream.py that applies to the port.
Each lineage runs through a vega_tpu Context("local") on the 8-device CPU
mesh and through vega_tpu_torch's Context(device="cpu", n_shards=8), under
the card's plans (xla sorts, fused_sort, no table plan) and both packages'
default dense_exchange="auto", so chunks are sized by the exchange planner
in both; the legacy 6x rule is held under a forced all_to_all. Integers
are bit-identical, floats within rtol 1e-5.

Recorded differences, pinned here: an untraceable closure on a stream
falls back to the reference's host tier and raises VegaError in the port
when the op is built (it has no host tier); a key function in
take_ordered / top likewise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vega_tpu as v
from vega_tpu.tpu import stream as ref_stream
import vega_tpu_torch as vt
from vega_tpu_torch import stream
from vega_tpu_torch.errors import VegaError
from vega_tpu_torch.stream import StreamedDenseRDD

N_SHARDS = 8
PLANS = {"dense_rbk_plan": "fused_sort", "dense_table_plan": "off",
         "dense_sort_impl": "xla"}


class _Ctxs:
    """A reference Context and a port Context of one budget and one
    dense_exchange."""

    def __init__(self, budget=4 << 30, exchange="auto"):
        from vega_tpu.env import Env

        self.ref = v.Context("local", num_workers=2)
        conf = Env.get().conf
        ref_conf = dict(PLANS, dense_hbm_budget=budget,
                        dense_exchange=exchange)
        self._restore = {k: getattr(conf, k) for k in ref_conf}
        for k, val in ref_conf.items():
            setattr(conf, k, val)
        self.port = vt.Context(device="cpu", n_shards=N_SHARDS,
                               dense_hbm_budget=budget,
                               dense_exchange=exchange, **PLANS)

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
        yield c.ref, c.port
    finally:
        c.stop()


def _approx_dict(got, exp):
    assert got.keys() == exp.keys()
    for k, val in exp.items():
        assert got[k] == pytest.approx(val, rel=1e-5)


# ---------------------------------------------------------------------------
# chunk sizing
# ---------------------------------------------------------------------------

GRID = [
    (1000, 4, 4 << 30, None), (1000, 4, 4 << 30, 100),
    (1_000_000_000, 4, 4 << 30, None), (1_000_000_000, 8, 4 << 30, None),
    (10_000_000, 1024, 1 << 30, None), (2_000_000, 4, 1 << 20, None),
    (60_000, 4, 1 << 19, None), (20_000_000, 8, 256 << 20, None),
    (5, 4, 0, None), (10**12, 8, 1 << 20, None), (100, 4, 1, None),
    (1_000_000, 12, 4 << 30, 7),
]
# the planner's cases (n_shards given, dense_exchange="auto", the
# reference at its default): the 1B north star, bench-main at phase 8e's
# 256 MiB, a source that fits, tiny budgets, a forced chunk_rows
AUTO_GRID = [
    (1_000_000_000, 4, 4 << 30, None, 8), (1_000_000_000, 8, 4 << 30, None, 8),
    (20_000_000, 4, 256 << 20, None, 8), (1000, 4, 4 << 30, None, 8),
    (2_000_000, 4, 1 << 20, None, 8), (60_000, 4, 1 << 19, None, 8),
    (10_000_000, 1024, 1 << 30, None, 8), (1_000_000, 12, 4 << 30, 7, 8),
    (5_000_000, 4, 1 << 24, None, 4), (300_000, 8, 1 << 22, None, 1),
]


@pytest.mark.parametrize(
    "n_rows,bpr,budget,chunk_rows,n_shards",
    [pytest.param(*g, None, id="-".join(map(str, g))) for g in GRID]
    + [pytest.param(*g, id="auto-" + "-".join(map(str, g)))
       for g in AUTO_GRID])
def test_planned_chunk_rows_matches_reference(n_rows, bpr, budget,
                                              chunk_rows, n_shards):
    """Without n_shards, the legacy rule: None when 6x the bytes fit,
    else 1M-row multiples rounded down, or a power of two of at least 128
    below 1M. With n_shards under "auto" (the reference at its default),
    the exchange planner's chunk, whose aggregate planned peak fits the
    budget."""
    from vega_tpu.env import Env
    from vega_tpu_torch import exchange_plan

    assert Env.get().conf.dense_exchange == "auto"
    got = stream.planned_chunk_rows(n_rows, bpr, budget, chunk_rows,
                                    n_shards=n_shards)
    assert got == ref_stream.planned_chunk_rows(n_rows, bpr, budget,
                                                chunk_rows,
                                                n_shards=n_shards)
    if got is None or chunk_rows is not None or got < 128:
        return
    if n_shards is None:
        assert got * bpr * 6 <= budget or got == 128
    else:
        plan = exchange_plan.predict_for_rows(got, bpr, n_shards, budget)
        assert n_shards * plan.est_peak_bytes <= budget or got == 128


def test_one_billion_rows_stream_in_six_chunks():
    """BASELINE's north star at the default budget under a forced
    all_to_all (the legacy 6x rule): 6 chunks of 170 * 2^20 rows in both
    packages, and nothing of the 1B rows built."""
    c = _Ctxs(exchange="all_to_all")
    ref, port = c.ref, c.port
    try:
        s = port.dense_range(1_000_000_000)
        r = ref.dense_range(1_000_000_000)
        assert isinstance(s, StreamedDenseRDD)
        assert isinstance(r, ref_stream.StreamedDenseRDD)
        assert s.n_chunks == r.n_chunks == 6
        assert stream.planned_chunk_rows(10**9, 4, 4 << 30) == 178_257_920
        assert s._resident_memo is None
        assert port.dense_hbm_in_use() == 0
        # a second source of the same size at the default budget of a
        # Context built with no arguments but the device and the program
        plain = vt.Context(device="cpu", dense_exchange="all_to_all")
        try:
            assert plain.dense_hbm_budget == 4 << 30
            assert plain.dense_range(1_000_000_000).n_chunks == 6
        finally:
            plain.stop()
    finally:
        c.stop()


def test_one_billion_rows_stream_in_five_chunks_under_auto(ctxs):
    """The same source under both packages' default dense_exchange="auto":
    the planner's 5 chunks of 221,249,536 rows (the reference's count)."""
    ref, port = ctxs
    s = port.dense_range(1_000_000_000)
    r = ref.dense_range(1_000_000_000)
    assert isinstance(s, StreamedDenseRDD)
    assert s.n_chunks == r.n_chunks == 5
    assert stream.planned_chunk_rows(10**9, 4, 4 << 30,
                                     n_shards=N_SHARDS) == 221_249_536
    assert s._resident_memo is None
    plain = vt.Context(device="cpu")
    try:
        assert plain.dense_exchange == "auto"
        assert plain.dense_range(1_000_000_000).n_chunks == 5
    finally:
        plain.stop()


def test_chunk_rows_and_budget_validation(ctxs):
    ref, port = ctxs
    for bad in (0, -5):
        with pytest.raises(VegaError, match="chunk_rows"):
            port.dense_range(1_000, chunk_rows=bad)
        with pytest.raises(v.VegaError, match="chunk_rows"):
            ref.dense_range(1_000, chunk_rows=bad)
    with pytest.raises(VegaError, match="dense_hbm_budget"):
        vt.Context(device="cpu", dense_hbm_budget=-1)
    # chunk_rows at or past n: a resident source in both
    assert not isinstance(port.dense_range(100, chunk_rows=100),
                          StreamedDenseRDD)
    assert not isinstance(ref.dense_range(100, chunk_rows=100),
                          ref_stream.StreamedDenseRDD)


def test_auto_stream_kicks_in_over_budget():
    """A 1 MiB budget flips dense_range into streaming, with the
    reference's chunk count."""
    c = _Ctxs(budget=1 << 20)
    try:
        s = c.port.dense_range(2_000_000)
        r = c.ref.dense_range(2_000_000)
        assert isinstance(s, StreamedDenseRDD)
        assert s.n_chunks == r.n_chunks
        assert s.count() == r.count() == 2_000_000
    finally:
        c.stop()


# ---------------------------------------------------------------------------
# the streamed ops
# ---------------------------------------------------------------------------


def test_streamed_reduce_by_key_parity(ctxs):
    ref, port = ctxs
    n, k, chunk = 200_000, 777, 30_000
    s = port.dense_range(n, chunk_rows=chunk)
    assert isinstance(s, StreamedDenseRDD)
    assert s.n_chunks == ref.dense_range(n, chunk_rows=chunk).n_chunks == 7
    got = dict(s.map(lambda x: (x % k, x)).reduce_by_key(op="add")
               .collect())
    exp = dict(ref.dense_range(n, chunk_rows=chunk)
               .map(lambda x: (x % k, x)).reduce_by_key(op="add").collect())
    assert got == exp
    assert got == dict(port.dense_range(n).map(lambda x: (x % k, x))
                       .reduce_by_key(op="add").collect())
    gotf = dict(port.dense_range(n, chunk_rows=chunk)
                .map(lambda x: (x % k, x * 0.5)).reduce_by_key(op="add")
                .collect())
    expf = dict(ref.dense_range(n, chunk_rows=chunk)
                .map(lambda x: (x % k, x * 0.5)).reduce_by_key(op="add")
                .collect())
    _approx_dict(gotf, expf)


def test_streamed_reduce_wraps_int32_like_the_reference(ctxs):
    """int32 sums wrap mod 2^32 in both packages, chunk by chunk and in
    the accumulator: the 1B check's closed form holds at small size."""
    ref, port = ctxs
    keys = np.array([0, 0, 1] * 4, np.int32)
    vals = np.array([2**31 - 1, 5, 3] * 4, np.int32)
    s = stream.streamed_npz(port, {"k": keys, "v": vals}, chunk_rows=3)
    r = ref_stream.streamed_npz(ref, {"k": keys, "v": vals}, chunk_rows=3)
    got = sorted(s.reduce_by_key(op="add").collect())
    assert got == sorted(r.reduce_by_key(op="add").collect())
    # key 0: 4 * (2^31 - 1 + 5) = 2^33 + 16, which is 16 mod 2^32
    assert got == [(0, 16), (1, 12)]


def test_streamed_groupby_join_pipeline(ctxs):
    """The north star's shape: streamed reduce, then a join against a
    resident table."""
    ref, port = ctxs
    n, k, chunk = 120_000, 500, 25_000
    tk, tv = np.arange(k, dtype=np.int32), np.arange(k, dtype=np.int32) * 2
    got = (port.dense_range(n, chunk_rows=chunk).map(lambda x: (x % k, x))
           .reduce_by_key(op="add").join(port.dense_from_numpy(tk, tv)))
    exp = (ref.dense_range(n, chunk_rows=chunk).map(lambda x: (x % k, x))
           .reduce_by_key(op="add").join(ref.dense_from_numpy(tk, tv)))
    assert got.count() == exp.count() == k
    assert sorted(got.collect()) == sorted(exp.collect())
    rows = dict(got.collect())
    for kk in (0, 7, k - 1):
        assert rows[kk] == (sum(range(kk, n, k)), kk * 2)


def test_streamed_narrow_ops_and_folds(ctxs):
    ref, port = ctxs
    s = port.dense_range(50_000, chunk_rows=8_000)
    r = ref.dense_range(50_000, chunk_rows=8_000)
    assert s.count() == r.count() == 50_000
    assert s.sum() == r.sum() == sum(range(50_000))
    assert s.map(lambda x: x * 2).max() == r.map(lambda x: x * 2).max()
    assert s.filter(lambda x: x % 10 == 0).count() == \
        r.filter(lambda x: x % 10 == 0).count() == 5_000
    assert s.min() == r.min() == 0
    mv = port.dense_range(20_000, chunk_rows=3_000).map(
        lambda x: (x % 9, x)).map_values(lambda w: w * 3)
    rv = ref.dense_range(20_000, chunk_rows=3_000).map(
        lambda x: (x % 9, x)).map_values(lambda w: w * 3)
    assert isinstance(mv, StreamedDenseRDD)
    assert dict(mv.reduce_by_key(op="max").collect()) == \
        dict(rv.reduce_by_key(op="max").collect())


def test_streamed_untraceable_map_raises_when_built(ctxs):
    """Pinned difference (tests/test_stream.py::
    test_streamed_untraceable_map_falls_back): the reference hands the
    closure to its host tier; the port raises at build, before any
    chunk runs."""
    ref, port = ctxs
    r = ref.dense_range(10_000, chunk_rows=2_000).map(
        lambda x: f"row-{int(x)}")
    assert not isinstance(r, ref_stream.StreamedDenseRDD)
    assert r.take(2) == ["row-0", "row-1"]
    s = port.dense_range(10_000, chunk_rows=2_000)
    with pytest.raises(VegaError):
        s.map(lambda x: f"row-{int(x)}")


def test_streamed_untraceable_reduce_raises_when_built(ctxs):
    """Pinned difference (::test_streamed_untraceable_reduce_falls_back):
    a combiner that branches on values reduces on the reference's host
    tier and raises VegaError in the port, before any chunk runs."""
    ref, port = ctxs
    exp = dict(ref.dense_range(5_000, chunk_rows=1_000)
               .map(lambda x: (x % 3, x))
               .reduce_by_key(lambda a, b: max(int(a), int(b))).collect())
    assert exp == {k: max(range(k, 5_000, 3)) for k in range(3)}
    s = port.dense_range(5_000, chunk_rows=1_000).map(lambda x: (x % 3, x))
    chunks_built = []
    orig = s._make_chunks
    s._make_chunks = lambda: (chunks_built.append(c) or c for c in orig())
    with pytest.raises(VegaError):
        s.reduce_by_key(lambda a, b: max(int(a), int(b)))
    assert chunks_built == []


def test_streamed_unsupported_op_delegates_to_resident(ctxs):
    ref, port = ctxs
    s = port.dense_range(10_000, chunk_rows=2_000)
    r = ref.dense_range(10_000, chunk_rows=2_000)
    got = dict(s.map(lambda x: (x % 5, x)).group_by_key().collect())
    exp = dict(r.map(lambda x: (x % 5, x)).group_by_key().collect())
    assert {k: sorted(g) for k, g in got.items()} == \
        {k: sorted(g) for k, g in exp.items()}
    assert sorted(got[3]) == list(range(3, 10_000, 5))
    assert sorted(s.collect()) == sorted(r.collect()) == list(range(10_000))


def test_resident_fallback_memoized(ctxs):
    _, port = ctxs
    s = port.dense_range(10_000, chunk_rows=2_000)
    first = s.resident()
    assert s.resident() is first
    s.collect()
    assert s.resident() is first


def test_streamed_map_filter_chain(ctxs):
    ref, port = ctxs
    s = (port.dense_range(60_000, chunk_rows=9_000)
         .map(lambda x: x * 2).filter(lambda x: x % 6 == 0))
    r = (ref.dense_range(60_000, chunk_rows=9_000)
         .map(lambda x: x * 2).filter(lambda x: x % 6 == 0))
    resident = (port.dense_range(60_000).map(lambda x: x * 2)
                .filter(lambda x: x % 6 == 0))
    assert s.count() == r.count() == resident.count()
    assert s.max() == r.max() == resident.max()


def test_streamed_as_resident_operand(ctxs):
    """resident.join(streamed) and union(streamed) take the stream's
    resident build, with the reference's rows."""
    ref, port = ctxs
    tk, tv = np.arange(5, dtype=np.int32), np.arange(5, dtype=np.int32) * 10
    got = port.dense_from_numpy(tk, tv).join(
        port.dense_range(10_000, chunk_rows=2_000).map(lambda x: (x % 5, x)))
    exp = ref.dense_from_numpy(tk, tv).join(
        ref.dense_range(10_000, chunk_rows=2_000).map(lambda x: (x % 5, x)))
    assert got.count() == exp.count() == 10_000
    assert sorted(got.collect()) == sorted(exp.collect())
    assert dict(got.collect())[2][0] == 20
    lo = port.dense_from_numpy(tk, tv).left_outer_join(
        port.dense_range(100, chunk_rows=30).map(lambda x: (x % 7, x)),
        fill_value=-1)
    rlo = ref.dense_from_numpy(tk, tv).left_outer_join(
        ref.dense_range(100, chunk_rows=30).map(lambda x: (x % 7, x)),
        fill_value=-1)
    assert sorted(lo.collect()) == sorted(rlo.collect())
    u = port.dense_range(100).union(port.dense_range(100, chunk_rows=30))
    ru = ref.dense_range(100).union(ref.dense_range(100, chunk_rows=30))
    assert u.count() == ru.count() == 200
    assert sorted(u.collect()) == sorted(ru.collect())


def test_streamed_join_and_expansions(ctxs):
    """join / map_expand / flat_map_ragged compose per chunk and stay
    streamed, with the reference's rows; a streamed right side joins as
    its resident build."""
    ref, port = ctxs
    n, k, chunk = 90_000, 1_000, 20_000
    tk, tv = np.arange(k, dtype=np.int32), np.arange(k, dtype=np.int32) * 3
    s = (port.dense_range(n, chunk_rows=chunk).map(lambda x: (x % k, x))
         .join(port.dense_from_numpy(tk, tv)))
    r = (ref.dense_range(n, chunk_rows=chunk).map(lambda x: (x % k, x))
         .join(ref.dense_from_numpy(tk, tv)))
    assert isinstance(s, StreamedDenseRDD)
    assert s.count() == r.count() == n
    assert sorted(s.collect()) == sorted(r.collect())

    s2 = (port.dense_range(n, chunk_rows=chunk).map(lambda x: (x % k, x))
          .join(port.dense_range(k, chunk_rows=300).map(lambda x: (x, x * 3))))
    assert isinstance(s2, StreamedDenseRDD)
    assert s2.count() == n

    se = port.dense_range(30_000, chunk_rows=7_000).flat_map_ragged(
        lambda x: (torch.stack([x, x + 1_000_000], dim=-1), 2), 2)
    re = ref.dense_range(30_000, chunk_rows=7_000).flat_map_ragged(
        lambda x: (jnp.stack([x, x + 1_000_000]), jnp.int32(2)), 2)
    assert isinstance(se, StreamedDenseRDD)
    assert se.count() == re.count() == 60_000
    assert se.max() == re.max() == 29_999 + 1_000_000
    me = port.dense_range(10_000, chunk_rows=3_000).map_expand(
        lambda x: torch.stack([x, x], dim=-1), 2)
    rme = ref.dense_range(10_000, chunk_rows=3_000).map_expand(
        lambda x: jnp.stack([x, x]), 2)
    assert isinstance(me, StreamedDenseRDD)
    assert me.count() == rme.count() == 20_000
    assert me.sum() == rme.sum()


def test_streamed_join_places_the_table_once(ctxs, monkeypatch):
    """The table is re-placed by one group_by_key exchange up front: its
    node materializes once however many chunks join against it."""
    from vega_tpu_torch import dense_rdd

    _, port = ctxs
    built = []
    orig = dense_rdd._GroupByKeyRDD._materialize

    def counting(self):
        built.append(self)
        return orig(self)

    monkeypatch.setattr(dense_rdd._GroupByKeyRDD, "_materialize", counting)
    k = 300
    table = port.dense_from_numpy(np.arange(k, dtype=np.int32),
                                  np.arange(k, dtype=np.int32) * 2)
    s = port.dense_range(40_000, chunk_rows=5_000).map(
        lambda x: (x % k, x)).join(table)
    assert s.n_chunks == 8
    assert s.count() == 40_000
    assert len(built) == 1


def test_streamed_take_ordered_and_top(ctxs):
    ref, port = ctxs
    rng = np.random.RandomState(8)
    vals = rng.randint(-10**6, 10**6, size=9_137).astype(np.int32)
    s = stream.streamed_npz(port, {"v": vals}, chunk_rows=1_000)
    r = ref_stream.streamed_npz(ref, {"v": vals}, chunk_rows=1_000)
    assert s.take_ordered(7) == r.take_ordered(7) == sorted(vals.tolist())[:7]
    assert s.top(7) == r.top(7) == sorted(vals.tolist(), reverse=True)[:7]

    keys = rng.randint(0, 500, size=4_096).astype(np.int32)
    pvals = rng.randint(0, 100, size=4_096).astype(np.int32)
    sp = stream.streamed_npz(port, {"k": keys, "v": pvals}, chunk_rows=512)
    rp = ref_stream.streamed_npz(ref, {"k": keys, "v": pvals},
                                 chunk_rows=512)
    exp = sorted(zip(keys.tolist(), pvals.tolist()))
    assert sp.take_ordered(9) == rp.take_ordered(9) == exp[:9]
    assert sp.top(9) == rp.top(9) == sorted(exp, reverse=True)[:9]

    # pinned difference: a key function is the reference's host tier's
    assert r.take_ordered(3, key=lambda x: -x) == \
        sorted(vals.tolist(), reverse=True)[:3]
    with pytest.raises(VegaError, match="host tier"):
        s.take_ordered(3, key=lambda x: -x)
    with pytest.raises(VegaError, match="host tier"):
        s.top(3, key=lambda x: -x)


def test_streamed_range_order_statistics_under_small_budget():
    """dense_range over a 512 KiB budget streams; take_ordered / top
    equal the reference's."""
    c = _Ctxs(budget=1 << 19)
    try:
        big = c.port.dense_range(60_000)
        rbig = c.ref.dense_range(60_000)
        assert isinstance(big, StreamedDenseRDD)
        assert big.n_chunks == rbig.n_chunks
        assert big.take_ordered(5) == rbig.take_ordered(5) == [0, 1, 2, 3, 4]
        assert big.top(3) == rbig.top(3) == [59_999, 59_998, 59_997]
    finally:
        c.stop()


def test_streamed_accumulator_capacity_bounded(ctxs):
    """The merge reduce sizes its union from known counts: the
    accumulator's capacity stays at the key-bounded bucket (the
    reference's, too) however many chunks fold in."""
    ref, port = ctxs
    s = stream.streamed_range(port, 80_000, chunk_rows=10_000)
    r = ref_stream.streamed_range(ref, 80_000, chunk_rows=10_000)
    assert s.n_chunks == 8
    red = s.map(lambda x: (x % 1_000, x)).reduce_by_key(op="add")
    rred = r.map(lambda x: (x % 1_000, x)).reduce_by_key(op="add")
    assert red._block.capacity <= 2048
    assert red._block.capacity == rred._block.capacity
    assert red.hash_placed
    got = dict(red.collect())
    assert got == dict(rred.collect())
    assert got[0] == sum(range(0, 80_000, 1_000))


def test_streamed_empty_source_raises(ctxs):
    _, port = ctxs
    empty = stream.StreamedDenseRDD(port, lambda: iter(()), lambda: None, 0,
                                    make_probe=lambda: None)
    with pytest.raises(VegaError, match="empty source"):
        empty.reduce_by_key(op="add")
    with pytest.raises(VegaError, match="empty streamed source"):
        empty.sum()
    assert empty.map(lambda x: x + 1).map(lambda x: x * 2).count() == 0
    # an empty file streams as one empty chunk
    s = stream.streamed_npz(port, {"v": np.zeros(0, np.int32)}, 4)
    assert s.n_chunks == 1 and s.map(lambda x: x + 1).count() == 0


def test_streamed_traced_binop_reduce(ctxs):
    """A binop _infer_named_op does not name (xor) folds through the
    segmented scan chunk by chunk; integers exact."""
    ref, port = ctxs
    got = dict(port.dense_range(30_000, chunk_rows=4_000)
               .map(lambda x: (x % 13, x)).reduce_by_key(lambda a, b: a ^ b)
               .collect())
    exp = dict(ref.dense_range(30_000, chunk_rows=4_000)
               .map(lambda x: (x % 13, x)).reduce_by_key(lambda a, b: a ^ b)
               .collect())
    assert got == exp


# ---------------------------------------------------------------------------
# npz checkpoints
# ---------------------------------------------------------------------------


def test_streamed_npz_roundtrip(ctxs, tmp_path):
    ref, port = ctxs
    n = 40_000
    keys = (np.arange(n) % 101).astype(np.int32)
    vals = np.arange(n, dtype=np.int32)
    resident = port.dense_from_numpy(keys, vals)
    path = str(tmp_path / "blk.npz")
    assert resident.save_npz(path) == path
    assert not (tmp_path / "blk.npz.tmp").exists()
    streamed = port.dense_load_npz(path, chunk_rows=7_000)
    assert isinstance(streamed, StreamedDenseRDD)
    rstreamed = ref.dense_load_npz(path, chunk_rows=7_000)
    assert streamed.n_chunks == rstreamed.n_chunks == 6
    got = dict(streamed.reduce_by_key(op="add").collect())
    assert got == dict(resident.reduce_by_key(op="add").collect())
    assert got == dict(rstreamed.reduce_by_key(op="add").collect())
    again = port.dense_load_npz(path)
    assert not isinstance(again, StreamedDenseRDD)
    assert again.collect() == resident.collect()


def _checkpoint_columns():
    """Columns of every kind a checkpoint carries: an int64 key beyond
    int32, an int64 value beyond it, float32 and int32 values."""
    rng = np.random.RandomState(3)
    n = 5_000
    return {"k": (1 << 40) + rng.randint(0, 300, size=n).astype(np.int64),
            "v": rng.randint(-2**50, 2**50, size=n, dtype=np.int64),
            "w": rng.randn(n).astype(np.float32),
            "c": rng.randint(-1000, 1000, size=n).astype(np.int32)}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_npz_files_cross_between_packages(ctxs, tmp_path, writer):
    """A file either package writes loads in the other with equal rows,
    resident and streamed: both are plain .npz files of column arrays."""
    ref, port = ctxs
    cols = _checkpoint_columns()
    path = str(tmp_path / "x.npz")
    if writer == "reference":
        ref.dense_from_columns(cols, key="k").save_npz(path)
    else:
        port.dense_from_columns(cols, key="k").save_npz(path)
    with np.load(path) as z:
        assert z["k"].dtype == np.int64 and z["v"].dtype == np.int64
        on_disk = {n: z[n] for n in z.files}
    got = port.dense_load_npz(path).collect_arrays()
    exp = ref.dense_load_npz(path).collect()
    assert list(got) == list(on_disk)
    for nm, col in on_disk.items():
        np.testing.assert_array_equal(got[nm], col)
    assert port.dense_load_npz(path).collect() == exp
    sg = port.dense_load_npz(path, chunk_rows=1_250)
    sr = ref.dense_load_npz(path, chunk_rows=1_250)
    assert sg.n_chunks == sr.n_chunks == 4
    assert sg.count() == sr.count() == 5_000
    red = dict(sg.select("k", "v").reduce_by_key(op="add").collect())
    assert red == dict(sr.select("k", "v").reduce_by_key(op="add")
                       .collect())


def test_save_npz_refuses_derived_nodes(ctxs, tmp_path):
    ref, port = ctxs
    kv = port.dense_from_numpy(np.arange(10, dtype=np.int32) % 3,
                               np.arange(10, dtype=np.int32))
    rkv = ref.dense_from_numpy(np.arange(10, dtype=np.int32) % 3,
                               np.arange(10, dtype=np.int32))
    for node, rnode in ((kv.group_by_key(), rkv.group_by_key()),
                        (kv.join(kv), rkv.join(rkv))):
        with pytest.raises(VegaError, match="derived"):
            node.save_npz(str(tmp_path / "g.npz"))
        with pytest.raises(v.VegaError, match="derived"):
            rnode.save_npz(str(tmp_path / "g.npz"))
    # a reduce output is raw columns: saved and reloaded equal
    path = kv.reduce_by_key(op="add").save_npz(str(tmp_path / "d" / "r.npz"))
    assert sorted(port.dense_load_npz(path).collect()) == \
        sorted(rkv.reduce_by_key(op="add").collect())


def test_streamed_npz_int64_keys_consistent_chunks(ctxs):
    """int64 keys encode once over the whole column: chunks whose keys
    fit int32 keep the (k, k.lo) schema of those that do not."""
    ref, port = ctxs
    keys = np.concatenate([np.arange(0, 500, dtype=np.int64) % 7,
                           (np.arange(0, 500, dtype=np.int64) % 7) + 2**40])
    vals = np.ones(1000, dtype=np.int32)
    s = stream.streamed_npz(port, {"k": keys, "v": vals}, chunk_rows=250)
    r = ref_stream.streamed_npz(ref, {"k": keys, "v": vals}, chunk_rows=250)
    got = dict(s.reduce_by_key(op="add").collect())
    assert got == dict(r.reduce_by_key(op="add").collect())
    exp = {}
    for k in keys.tolist():
        exp[k] = exp.get(k, 0) + 1
    assert got == exp


def test_streamed_wide_value_reduce_equals_resident(ctxs):
    """Wide int64 values fold exactly across chunks (two exact addends
    per pair, no host refold): equal to the resident reduce and to the
    reference's streamed one; min / max too."""
    ref, port = ctxs
    rng = np.random.RandomState(5)
    keys = rng.randint(0, 48, size=2_000).astype(np.int64)
    vals = (rng.randint(1, 2**20, size=2_000).astype(np.int64)
            + np.int64(2**41))
    vals[::5] = -vals[::5] * 3
    for op in ("add", "min", "max"):
        s = stream.streamed_npz(port, {"k": keys, "v": vals}, chunk_rows=300)
        r = ref_stream.streamed_npz(ref, {"k": keys, "v": vals},
                                    chunk_rows=300)
        got = dict(s.reduce_by_key(op=op).collect())
        assert got == dict(r.reduce_by_key(op=op).collect())
        assert got == dict(port.dense_from_numpy(keys, vals)
                           .reduce_by_key(op=op).collect())


def test_streamed_npz_string_column_raises(ctxs, tmp_path):
    """A string column raises only under dense_dict_enabled=False, as the
    reference's encoding does. Otherwise it is dictionary-encoded once
    over the file, so every chunk shares one dictionary and the fold
    merges without a unification; the streamed reduce equals the
    reference's, and a save_npz / dense_load_npz round trip (either
    package's file, resident and streamed) keeps the strings."""
    ref, port = ctxs
    words = np.array(["a", "bb", "a", "c"] * 10)
    cols = {"k": words, "v": np.arange(40, dtype=np.int32)}
    r = ref_stream.streamed_npz(ref, cols, chunk_rows=7)
    s = stream.streamed_npz(port, cols, chunk_rows=7)
    assert s.n_chunks == r.n_chunks == 6
    chunks = list(s._make_chunks())
    assert all(c._dicts()["k"] is chunks[0]._dicts()["k"] for c in chunks)
    got = dict(s.reduce_by_key(op="add").collect())
    assert got == dict(r.reduce_by_key(op="add").collect())
    assert got["a"] == sum(range(0, 40, 4)) + sum(range(2, 40, 4))
    for writer in (port, ref):
        path = str(tmp_path / f"s_{writer is port}.npz")
        writer.dense_from_numpy(words, cols["v"]).save_npz(path)
        with np.load(path) as z:
            assert z["k"].dtype.kind == "U"
            np.testing.assert_array_equal(z["k"], words)
        assert port.dense_load_npz(path).collect() == \
            ref.dense_load_npz(path).collect()
        sp = port.dense_load_npz(path, chunk_rows=10)
        sr = ref.dense_load_npz(path, chunk_rows=10)
        assert sp.n_chunks == sr.n_chunks == 4
        assert dict(sp.reduce_by_key(op="max").collect()) == \
            dict(sr.reduce_by_key(op="max").collect())
    with vt.Context(device="cpu", n_shards=N_SHARDS,
                    dense_dict_enabled=False) as off:
        with pytest.raises(VegaError, match="dense_dict_enabled"):
            stream.streamed_npz(off, cols, chunk_rows=7)
        with pytest.raises(VegaError, match="dense_dict_enabled"):
            off.dense_load_npz(path)
