"""The push plan (shuffle_plan="push") of vega_tpu_torch against
vega_tpu's, on the CPU: the pre-merge tier (shuffle/premerge.py), the
map side's push (dependency._push_row), the fetcher's pre-merged read,
and jobs over a fleet of each package.

The tier is fed the same seeded VN01 frames in both packages and its
frozen frames compared byte for byte; the one-process round trip runs
the port's map tasks into a real ShuffleServer and reads the frozen
blob back (the reference's counterpart is tests/test_fetch.py:627-843).
Over the fleets, rows are compared sorted (a reduce partition merges in
arrival order there) and the port's own counters are asserted: every
bucket of a named monoid's shuffle is read pre-merged. The reference's
pre-merge counters are not asserted: they read 0 in a process where its
native library did not load.
"""

import operator
import socket
import struct
import time
import types

import numpy as np
import pytest

import vega_tpu as v
from vega_tpu import native as ref_native
from vega_tpu.shuffle.premerge import PreMergeTier as RefTier
from vega_tpu.shuffle.store import ShuffleStore as RefStore
import vega_tpu_torch as vt
from vega_tpu_torch import dependency, native
from vega_tpu_torch.aggregator import Aggregator
from vega_tpu_torch.distributed.shuffle_server import (ShuffleServer,
                                                       check_status)
from vega_tpu_torch.env import Configuration
from vega_tpu_torch.map_output_tracker import MapOutputTracker
from vega_tpu_torch.partitioner import HashPartitioner
from vega_tpu_torch.scheduler.events import (ShuffleFetchCompleted,
                                             ShufflePushCompleted)
from vega_tpu_torch.shuffle import fetcher as fetcher_mod
from vega_tpu_torch.shuffle import premerge
from vega_tpu_torch.shuffle.fetcher import ShuffleFetcher
from vega_tpu_torch.shuffle.premerge import PreMergeTier
from vega_tpu_torch.shuffle.store import ShuffleStore
from vega_tpu_torch.split import Split


def _native_blob(pairs, is_int=True):
    fmt = "<qq" if is_int else "<qd"
    return (premerge.NATIVE_MAGIC + (b"\x01" if is_int else b"\x00")
            + b"".join(struct.pack(fmt, k, v) for k, v in pairs))


# --- the pre-merge tier (tests/test_fetch.py:467-625) ------------------------


def test_premerge_magics_match_dependency():
    assert premerge.NATIVE_MAGIC == dependency.NATIVE_MAGIC
    assert premerge.NATIVE_GROUP_MAGIC == dependency.NATIVE_GROUP_MAGIC


def test_premerge_duplicate_feed_merged_once():
    tier = PreMergeTier(ShuffleStore())
    bucket = _native_blob([(1, 2), (2, 3)])
    assert tier.feed_row(0, 0, 0, "add", [(0, bucket)]) == \
        {"merged": 1, "stored": 0, "duplicate": 0}
    assert tier.feed_row(0, 0, 1, "add", [(0, bucket)]) == \
        {"merged": 0, "stored": 0, "duplicate": 1}
    assert tier.feed_row(0, 1, 0, "add", [(0, _native_blob([(1, 5)]))]) == \
        {"merged": 1, "stored": 0, "duplicate": 0}
    assert tier.freeze(0, 0) == ([0, 1], [])
    blob = tier.merged_blob(0, 0)
    assert blob[:4] == b"VN01"
    assert sorted(native.decode(blob[5:], blob[4] == 1)) == [(1, 7), (2, 3)]
    assert tier.freeze(0, 0) == ([0, 1], [])
    assert tier.feed_row(0, 2, 0, "add", [(0, _native_blob([(9, 9)]))]) == \
        {"merged": 0, "stored": 1, "duplicate": 0}
    assert tier.freeze(0, 0) == ([0, 1], [2])
    assert tier.status()["duplicates"] == 1


@pytest.mark.parametrize("use_native", [True, False])
def test_premerge_int64_overflow_voids_merged_set_redo_exact(monkeypatch,
                                                             use_native):
    """An overflowed merge voids the merged set (no blob): the reducer
    pulls the origin buckets and merges them exactly; on the native
    accumulator (finish() None) and on the exact Python one (a value
    that no longer encodes as int64) alike."""
    big = (1 << 62) + 3
    buckets = [_native_blob([(7, big)]), _native_blob([(7, big)])]
    if not use_native:
        real = native.StreamingMerge
        monkeypatch.setattr(native, "StreamingMerge",
                            lambda op: real(op, native=False))
    tier = PreMergeTier(ShuffleStore())
    for m, b in enumerate(buckets):
        assert tier.feed_row(0, m, 0, "add", [(0, b)])["merged"] == 1
    assert tier.freeze(0, 0) == ([], [])
    assert tier.merged_blob(0, 0) is None
    if use_native:
        assert tier.status()["overflow_freezes"] == 1
        assert tier.status()["merged_buckets"] == 0
    assert native.merge_encoded_py([(b[5:], 1) for b in buckets], "add") == \
        [(7, 2 * big)]


def test_premerge_malformed_frame_rejected_never_served():
    tier = PreMergeTier(ShuffleStore())
    assert tier.feed_row(0, 0, 0, "add",
                         [(0, _native_blob([(1, 2)]))])["merged"] == 1
    bad = premerge.NATIVE_MAGIC + b"\x01" + b"\x00" * 7
    assert tier.feed_row(0, 1, 0, "add", [(0, bad)]) == \
        {"merged": 0, "stored": 0, "duplicate": 0}
    assert tier.status()["rejected"] == 1
    assert tier.freeze(0, 0) == ([0], [])
    blob = tier.merged_blob(0, 0)
    assert sorted(native.decode(blob[5:], blob[4] == 1)) == [(1, 2)]
    assert tier.status()["fed_bytes"] == 0


def test_premerge_mixed_value_flags_store_and_forward():
    tier = PreMergeTier(ShuffleStore())
    assert tier.feed_row(0, 0, 0, "add",
                         [(0, _native_blob([(1, 2)]))])["merged"] == 1
    out = tier.feed_row(0, 1, 0, "add",
                        [(0, _native_blob([(1, 0.5)], is_int=False))])
    assert out == {"merged": 0, "stored": 1, "duplicate": 0}
    assert tier.freeze(0, 0) == ([0], [1])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_frozen_blob_equals_the_references_bytes(seed, op):
    """The same seeded buckets, a duplicate and a late push, through both
    packages' tiers: equal counts, equal raw ids, and the frozen VN01
    frame equal byte for byte."""
    rng = np.random.default_rng(seed)
    feeds = []
    for m in range(6):
        keys = rng.integers(0, 40, 50).tolist()
        vals = rng.integers(-1000, 1000, 50).tolist()
        feeds.append((m, _native_blob(sorted(dict(zip(keys, vals))
                                             .items()))))
    feeds.append((2, feeds[2][1]))  # a replayed map task
    got = []
    for tier in (RefTier(RefStore()), PreMergeTier(ShuffleStore())):
        counts = [tier.feed_row(3, m, 0, op, [(1, b)]) for m, b in feeds]
        frozen = tier.freeze(3, 1)
        late = tier.feed_row(3, 9, 0, op, [(1, feeds[0][1])])
        blob = tier.merged_blob(3, 1)
        got.append((counts, frozen, blob, late, tier.freeze(3, 1),
                    sorted(native.decode_pairs_py(blob[5:], True))))
    if ref_native.get() is None:
        # the reference merged in a Python dict: its frame holds the same
        # pairs in another order
        got = [g[:2] + g[3:] for g in got]
    assert got[0] == got[1]


def test_premerge_concurrent_feeds_merge_each_map_once():
    """Sixteen threads push 64 map outputs, each twice, into four reduce
    partitions at once, the switch interval shortened: every map id is
    merged once (the sums exact) and every replay counted a duplicate."""
    import sys
    import threading

    tier = PreMergeTier(ShuffleStore())
    rows = {m: [(k, m * 100 + k) for k in range(m % 5, 40, 3)]
            for m in range(64)}
    order = [m for m in range(64)] * 2
    np.random.default_rng(7).shuffle(order)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        chunks = [order[i::16] for i in range(16)]
        threads = [threading.Thread(target=lambda ms=ms: [
            tier.feed_row(5, m, 0, "add",
                          [(r, _native_blob(rows[m])) for r in range(4)])
            for m in ms]) for ms in chunks]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    want = {}
    for m in range(64):
        for k, x in rows[m]:
            want[k] = want.get(k, 0) + x
    for r in range(4):
        assert tier.freeze(5, r) == (list(range(64)), [])
        blob = tier.merged_blob(5, r)
        assert dict(native.decode(blob[5:], True)) == want
    st = tier.status()
    assert (st["duplicates"], st["merged_buckets"], st["fed_bytes"]) == \
        (64 * 4, 64 * 4, 0)


# --- the push round trip in one process (tests/test_fetch.py:627-843) -------


class _StubRDD:
    def __init__(self, rows, env):
        self.rows = rows
        self.context = types.SimpleNamespace(env=env)

    def iterator(self, split, task_context=None):
        return iter(self.rows)


def _push_env(server_uri_fn, n_maps, slow_s=0.0):
    """An executor's Env in this process: its store and server, a tracker
    listing the peers server_uri_fn names, shuffle_plan="push"."""
    store = ShuffleStore()
    server = ShuffleServer(store)
    tracker = MapOutputTracker()
    tracker.list_shuffle_peers = lambda: {"w0": server_uri_fn(server)}
    tracker.register_shuffle(0, n_maps)
    conf = Configuration(shuffle_plan="push", fetch_slow_server_s=slow_s)
    events = []
    env = types.SimpleNamespace(conf=conf, map_output_tracker=tracker,
                                shuffle_server=server, shuffle_store=store,
                                fetch_event_sink=events.append)
    dependency._invalidate_peer_cache()
    dependency.reset_push_stats()
    fetcher_mod.reset_stats()
    return env, events


def _add_agg():
    return Aggregator(lambda v: v, lambda c, v: c + v, lambda a, b: a + b,
                      op_name="add")


def _merge_all(env, n_red):
    merged = {}
    for r in range(n_red):
        sm = native.StreamingMerge("add")
        for blob in ShuffleFetcher.fetch_stream(env, 0, r, mergeable=True):
            assert blob[:4] == b"VN01"
            sm.feed(memoryview(blob)[5:], blob[4] == 1)
        merged.update(dict(sm.finish()))
    return merged


def _close(env):
    dependency._invalidate_peer_cache()
    env.shuffle_server.stop()
    env.shuffle_store.close()


def test_push_plan_round_trip_premerged_and_counted():
    n_maps, n_red = 5, 3
    env, events = _push_env(lambda s: s.uri, n_maps)
    try:
        locs, deps = [], []
        for m in range(n_maps):
            dep = dependency.ShuffleDependency(
                0, _StubRDD([(k, 1) for k in range(m, m + 30)], env),
                _add_agg(), HashPartitioner(n_red))
            deps.append(dep)
            locs.append(dep.do_shuffle_task(Split(m))[0])
        deps[0].do_shuffle_task(Split(0))  # a retried map task
        env.map_output_tracker.register_map_outputs(0, locs)
        push = dependency.push_stats_snapshot()
        assert (push["pushes"], push["duplicates"], push["failed"]) == \
            (n_maps + 1, n_red, 0)
        expected = {}
        for m in range(n_maps):
            for k in range(m, m + 30):
                expected[k] = expected.get(k, 0) + 1
        assert _merge_all(env, n_red) == expected
        stats = fetcher_mod.stats_snapshot()
        assert stats["premerged"] == n_maps * n_red
        assert stats["local_blob_reads"] == n_red
        assert (stats["duplicates"], stats["round_trips"],
                stats["merged_rtts"]) == (0, 0, 0)
        pushes = [e for e in events if isinstance(e, ShufflePushCompleted)]
        assert sum(e.merged for e in pushes) == n_maps * n_red
        assert sum(e.duplicates for e in pushes) == n_red
        fetches = [e for e in events if isinstance(e, ShuffleFetchCompleted)]
        assert sum(e.premerged_buckets for e in fetches) == n_maps * n_red
        assert all(e.premerged_buckets == e.buckets for e in fetches)
    finally:
        _close(env)


def _dead_uri():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    uri = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    return uri


def test_push_plan_dead_owner_degrades_to_pull():
    n_maps, n_red = 4, 2
    dead = _dead_uri()
    env, _events = _push_env(lambda s: dead, n_maps)
    try:
        locs = [dependency.ShuffleDependency(
                    0, _StubRDD([(k, 1) for k in range(10)], env),
                    _add_agg(), HashPartitioner(n_red))
                .do_shuffle_task(Split(m))[0] for m in range(n_maps)]
        env.map_output_tracker.register_map_outputs(0, locs)
        assert dependency.push_stats_snapshot()["failed"] == n_maps * n_red
        fetcher_mod.reset_stats()
        assert _merge_all(env, n_red) == {k: n_maps for k in range(10)}
        stats = fetcher_mod.stats_snapshot()
        assert (stats["premerged"], stats["buckets"]) == (0, n_maps * n_red)
    finally:
        _close(env)


def test_push_plan_hung_owner_bounded_by_slow_server_deadline():
    hole = socket.socket()
    hole.bind(("127.0.0.1", 0))
    hole.listen(8)
    hole_uri = f"127.0.0.1:{hole.getsockname()[1]}"
    n_maps, n_red = 4, 2
    env, _events = _push_env(lambda s: hole_uri, n_maps, slow_s=0.5)
    try:
        locs = [dependency.ShuffleDependency(
                    0, _StubRDD([(k, 1) for k in range(10)], env),
                    _add_agg(), HashPartitioner(n_red))
                .do_shuffle_task(Split(m))[0] for m in range(n_maps)]
        env.map_output_tracker.register_map_outputs(0, locs)
        fetcher_mod.reset_stats()
        t0 = time.monotonic()
        assert _merge_all(env, n_red) == {k: n_maps for k in range(10)}
        assert time.monotonic() - t0 < 20.0
        assert fetcher_mod.stats_snapshot()["premerged"] == 0
    finally:
        _close(env)
        hole.close()


def test_push_is_only_for_a_named_monoids_native_row():
    """A group's VG01 row and a pickled row are never pushed (they would
    cross the wire twice for nothing)."""
    n_maps = 2
    env, events = _push_env(lambda s: s.uri, n_maps)
    try:
        group = Aggregator.default()
        dependency.ShuffleDependency(
            0, _StubRDD([(k, 1) for k in range(10)], env), group,
            HashPartitioner(2)).do_shuffle_task(Split(0))
        dependency.ShuffleDependency(
            0, _StubRDD([("a", 1), ("b", 2)], env), _add_agg(),
            HashPartitioner(2)).do_shuffle_task(Split(1))
        assert dependency.push_stats_snapshot()["pushes"] == 0
        assert not [e for e in events
                    if isinstance(e, ShufflePushCompleted)]
    finally:
        _close(env)


def test_push_owner_rotation_is_one_rule():
    peers = ["c:3", "a:1", "b:2"]
    tracker = MapOutputTracker()
    tracker.list_shuffle_peers = lambda: {str(i): u
                                          for i, u in enumerate(peers)}
    dependency._invalidate_peer_cache()
    try:
        owners = [dependency.push_owner_uri(tracker, r) for r in range(6)]
        assert owners == [dependency.push_owner_for_peers(peers, r)
                          for r in range(6)] == \
            ["a:1", "b:2", "c:3", "a:1", "b:2", "c:3"]
    finally:
        dependency._invalidate_peer_cache()


# --- jobs over a fleet of each package (tests/test_fetch.py:843) -------------


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    prev = v.Context.active()
    if prev is not None:
        prev.stop()
    fleet = dict(shuffle_plan="push", executor_max_restarts=0,
                 executor_reap_interval_s=0.5)
    ref = v.Context("distributed", num_workers=2, **fleet)
    try:
        port = vt.Context(mode="distributed", device="cpu", n_shards=2,
                          num_executors=2, num_workers=2, **fleet)
    except BaseException:
        ref.stop()
        raise
    yield ref, port
    port.stop()
    ref.stop()


def _port_totals(ctx):
    stats = ctx._backend.worker_stats()
    fetch = {k: sum(s["fetch"][k] for s in stats.values())
             for k in ("buckets", "premerged", "local_blob_reads",
                       "merged_rtts")}
    push = {k: sum(s["push"][k] for s in stats.values())
            for k in ("pushes", "merged", "duplicates", "failed")}
    return fetch, push


def test_push_plan_full_distributed_job(fleets):
    ref, port = fleets
    before = _port_totals(port)
    got = []
    for ctx in fleets:
        pairs = ctx.parallelize([(i % 7, i) for i in range(200)], 8)
        reduced = sorted(pairs.reduce_by_key(lambda a, b: a + b, 4)
                         .collect())
        grouped = sorted((k, sorted(vs)) for k, vs in
                         pairs.group_by_key(3).collect())
        got.append((reduced, grouped))
    assert got[0] == got[1]
    assert dict(got[1][0]) == {k: sum(range(k, 200, 7)) for k in range(7)}
    after = _port_totals(port)
    fetch = {k: after[0][k] - before[0][k] for k in after[0]}
    push = {k: after[1][k] - before[1][k] for k in after[1]}
    # the reduce: 8 maps x 4 reducers, every bucket read pre-merged; the
    # group is neither pushed nor read pre-merged
    assert fetch["premerged"] == 8 * 4
    assert fetch["buckets"] == 8 * 4 + 8 * 3
    assert push == {"pushes": 8, "merged": 8 * 4, "duplicates": 0,
                    "failed": 0}
    merged = raw = 0
    for info in port._backend.service.workers.values():
        status = check_status(info["shuffle_uri"])
        merged += status["premerge"]["merged_buckets"]
        raw += status["premerge"]["raw_buckets"]
    assert raw == 0 and merged >= 8 * 4


@pytest.mark.parametrize("seed", [0, 1])
def test_push_gives_the_pull_plans_rows(fleets, seed):
    """Seeded int and float pairs through add / min / max under both
    packages' push plans give the rows of an exact fold in Python (the
    pull plan's answer; float max is exact)."""
    rng = np.random.default_rng(seed)
    ints = list(zip(rng.integers(0, 500, 4000).tolist(),
                    rng.integers(-10**9, 10**9, 4000).tolist()))
    floats = list(zip(rng.integers(0, 50, 2000).tolist(),
                      rng.random(2000).tolist()))

    def fold(rows, op):
        out = {}
        for k, x in rows:
            out[k] = op(out[k], x) if k in out else x
        return sorted(out.items())

    want = [fold(ints, operator.add), fold(ints, min), fold(floats, max)]
    for ctx in fleets:
        got = [sorted(ctx.parallelize(ints, 6).reduce_by_key(
                   operator.add, 5).collect()),
               sorted(ctx.parallelize(ints, 6).reduce_by_key(min, 3)
                      .collect()),
               sorted(ctx.parallelize(floats, 4).reduce_by_key(max, 2)
                      .collect())]
        assert got == want


def test_push_plan_places_reducers_on_their_owners(fleets):
    """Under the push plan (locality_wait_s > 0) each reduce task of a
    named monoid runs on its owner and reads the frozen blob in process:
    local_blob_reads grows by the reducers, merged_rtts not at all."""
    _ref, port = fleets
    before = _port_totals(port)[0]
    port.parallelize([(i % 11, i) for i in range(300)], 6) \
        .reduce_by_key(operator.add, 4).collect()
    after = _port_totals(port)[0]
    assert after["local_blob_reads"] - before["local_blob_reads"] == 4
    assert after["merged_rtts"] - before["merged_rtts"] == 0


def test_frame_host_group_by_rides_the_push_plan(fleets):
    """A frame's host-tier group-by over each package's push fleet: equal
    rows; the port's shuffle read pre-merged. hint(shuffle_plan="pull")
    on a fleet spawned under push is ignored, as the reference's."""
    import vega_tpu.frame as ref_frame
    import vega_tpu_torch.frame as port_frame

    rng = np.random.default_rng(3)
    data = dict(k=rng.integers(0, 13, 3000), v=rng.integers(-50, 50, 3000))
    port = fleets[1]
    before = _port_totals(port)[0]["premerged"]
    got = []
    for ctx, fr in zip(fleets, (ref_frame, port_frame)):
        q = ctx.create_frame(**data).hint(tier="host").group_by("k") \
            .agg(fr.F.sum("v", "s"))
        got.append((sorted(q.collect()),
                    sorted(q.hint(shuffle_plan="pull").collect())))
    assert got[0] == got[1]
    assert got[1][0] == got[1][1]
    assert _port_totals(port)[0]["premerged"] > before
