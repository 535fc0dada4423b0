"""The remote fetch plane against the reference's: the get_many stream
grammar against an in-process ShuffleServer of each package, the bounded
pipeline, ordered replica lists, the put_many push, mid-stream failover,
the slow-server deadline; then replicated shuffles over a fleet of each
package (shuffle_replication=2), and the per-bucket protocol end to end.
Counterparts of tests/test_fetch.py:49-422 and :881 and
tests/test_distributed.py:336-410.

A stream is cut part-way in the reference by its fault hooks
(faults.configure(fetch_stream_drop_n=...)), which the port does not have
yet (ROADMAP queue 1 item 11); here the port's server is cut by wrapping
protocol.send_bucket, at the same bucket.
"""

import socket
import threading
import time
import types

import pytest

import vega_tpu as v
from vega_tpu import faults as ref_faults
from vega_tpu.distributed import shuffle_server as ref_ss
from vega_tpu.env import Env as RefEnv
from vega_tpu.errors import FetchFailedError as RefFetchFailed
from vega_tpu.map_output_tracker import MapOutputTracker as RefTracker
from vega_tpu.shuffle import fetcher as ref_fetcher
from vega_tpu.shuffle.store import ShuffleStore as RefStore

import vega_tpu_torch as vt
from vega_tpu_torch.distributed import protocol as port_protocol
from vega_tpu_torch.distributed import shuffle_server as port_ss
from vega_tpu_torch.env import Configuration
from vega_tpu_torch.errors import FetchFailedError, MapOutputError, \
    NetworkError
from vega_tpu_torch.map_output_tracker import MapOutputTracker
from vega_tpu_torch.shuffle import fetcher as port_fetcher
from vega_tpu_torch.shuffle.store import ShuffleStore


@pytest.fixture(autouse=True)
def _fresh_counters():
    ref_faults.reset()
    ref_fetcher.reset_stats()
    port_fetcher.reset_stats()
    yield
    ref_faults.reset()


class _Side:
    """One package's in-process shuffle server over a populated store,
    and the fetch entry points over it."""

    def __init__(self, pkg, tmp_path, blobs):
        self.pkg = pkg
        store_cls = RefStore if pkg == "ref" else ShuffleStore
        self.store = store_cls(spill_dir=str(tmp_path / f"{pkg}-spill"))
        for (m, r), data in blobs.items():
            self.store.put(0, m, r, data)
        self.ss = ref_ss if pkg == "ref" else port_ss
        self.server = self.ss.ShuffleServer(self.store)
        self.fetcher = ref_fetcher if pkg == "ref" else port_fetcher
        self._old = None
        if pkg == "port":
            self.env = types.SimpleNamespace(
                conf=Configuration(), map_output_tracker=None,
                shuffle_server=None, shuffle_store=ShuffleStore(),
                fetch_event_sink=None)
        else:
            self.env = RefEnv.get()

    def register(self, lists):
        tracker = (RefTracker if self.pkg == "ref" else MapOutputTracker)()
        tracker.register_shuffle(0, len(lists))
        tracker.register_map_outputs(0, lists)
        if self.pkg == "ref":
            self._old = (self.env.map_output_tracker,
                         self.env.shuffle_server)
            self.env.shuffle_server = None
        self.env.map_output_tracker = tracker

    def stream(self, reduce_id=0):
        if self.pkg == "ref":
            return self.fetcher.ShuffleFetcher.fetch_stream(0, reduce_id)
        return self.fetcher.ShuffleFetcher.fetch_stream(self.env, 0,
                                                        reduce_id)

    def fetch_many(self, map_ids, deliver, **kw):
        return self.ss.fetch_many_remote(self.server.uri, 0, map_ids, 0,
                                         deliver, **kw)

    @property
    def stats(self):
        return self.fetcher.stats_snapshot()

    def close(self):
        if self._old is not None:
            self.env.map_output_tracker, self.env.shuffle_server = self._old
        self.server.stop()
        self.store.close()


@pytest.fixture()
def sides(tmp_path):
    made = []

    def make(blobs):
        pair = [_Side(pkg, tmp_path, blobs) for pkg in ("ref", "port")]
        made.extend(pair)
        return pair

    yield make
    for s in made:
        s.close()


def _blobs16():
    return {(m, 0): bytes([m % 251]) * (512 + m) for m in range(16)}


def _cut_port_stream(monkeypatch, after):
    """The port server's first get_many stream cut after `after`
    buckets (the connection closes, as the reference's fault hook does)."""
    real = port_protocol.send_bucket
    state = {"sent": 0, "cut": False}

    def send_bucket(sock, map_id, data):
        if not state["cut"] and state["sent"] == after:
            state["cut"] = True
            raise NetworkError("stream cut")
        state["sent"] += 1
        real(sock, map_id, data)

    monkeypatch.setattr(port_protocol, "send_bucket", send_bucket)


def test_get_many_one_round_trip_parity(sides):
    blobs = {m: d for (m, _r), d in _blobs16().items()}
    for side in sides(_blobs16()):
        got = {}
        rts = side.fetch_many(list(blobs), got.__setitem__)
        per_bucket = {m: side.ss.fetch_remote(side.server.uri, 0, m, 0)
                      for m in blobs}
        assert rts == 1
        assert got == per_bucket == blobs


def test_get_many_missing_bucket_escalates(sides):
    for side, err in zip(sides(_blobs16()), (RefFetchFailed,
                                             FetchFailedError)):
        with pytest.raises(err) as info:
            side.fetch_many([0, 1, 99], lambda m, d: None)
        assert (info.value.map_id, info.value.shuffle_id) == (99, 0)


def test_get_many_mid_stream_drop_retries_tail_exactly_once(sides,
                                                             monkeypatch):
    blobs = {m: d for (m, _r), d in _blobs16().items()}
    ref, port = sides(_blobs16())
    ref_faults.configure(fetch_stream_drop_n=1, fetch_drop_after_buckets=3)
    _cut_port_stream(monkeypatch, 3)
    out = []
    for side in (ref, port):
        deliveries = []
        rts = side.fetch_many(list(blobs),
                              lambda m, d: deliveries.append((m, d)))
        out.append((rts, len(deliveries), dict(deliveries)))
    assert out[0] == out[1] == (2, len(blobs), blobs)


def test_get_many_serves_disk_tier(sides):
    blobs = {m: d for (m, _r), d in _blobs16().items()}
    for side in sides(_blobs16()):
        assert side.store.spill_all() > 0
        got = {}
        side.fetch_many(list(blobs), got.__setitem__)
        assert got == blobs


def test_fetch_stream_peak_memory_bounded_by_queue(sides):
    n = 48
    out = []
    for side in sides({(m, 0): bytes([m % 251]) * 1024 for m in range(n)}):
        side.register([side.server.uri] * n)
        old_q = side.env.conf.fetch_queue_buckets
        side.env.conf.fetch_queue_buckets = 4
        try:
            seen = sum(1 for blob in side.stream() if blob)
        finally:
            side.env.conf.fetch_queue_buckets = old_q
        st = side.stats
        assert 0 < st["peak_queued"] <= 4 + 1
        out.append((seen, st["buckets"], st["duplicates"],
                    st["round_trips"]))
    assert out[0] == out[1] == (n, n, 0, 1)


def test_fetch_stream_legacy_per_bucket_path_stays_live(sides):
    n = 12
    blobs = {(m, 0): bytes([m + 1]) * 256 for m in range(n)}
    out = []
    for side in sides(blobs):
        side.register([side.server.uri] * n)
        side.env.conf.fetch_batch_enabled = False
        try:
            got = sorted(side.stream())
        finally:
            side.env.conf.fetch_batch_enabled = True
        out.append((got, side.stats["round_trips"]))
    assert out[0] == out[1] == (sorted(blobs.values()), n)


def test_fetch_stream_mid_stream_drop_no_duplicates(sides, monkeypatch):
    n = 16
    blobs = {(m, 0): bytes([m + 7]) * 300 for m in range(n)}
    ref, port = sides(blobs)
    ref_faults.configure(fetch_stream_drop_n=1, fetch_drop_after_buckets=5)
    _cut_port_stream(monkeypatch, 5)
    out = []
    for side in (ref, port):
        side.register([side.server.uri] * n)
        got = sorted(side.stream())
        st = side.stats
        out.append((got, st["buckets"], st["duplicates"],
                    st["round_trips"]))
    assert out[0] == out[1] == (sorted(blobs.values()), n, 0, 2)


def test_fetch_stream_overlaps_merge_with_network(sides, monkeypatch):
    n = 24
    ref, port = sides({(m, 0): bytes(8192) for m in range(n)})
    ref_faults.configure(fetch_delay_s=0.005)
    real_get = port.store.get

    def slow_get(*key):
        time.sleep(0.005)  # the same per-bucket serve latency
        return real_get(*key)

    monkeypatch.setattr(port.store, "get", slow_get)
    for side in (ref, port):
        side.register([side.server.uri] * n)
        for _blob in side.stream():
            time.sleep(0.003)  # the merge
        assert side.stats["overlap_s"] > 0.0


def test_fetch_stream_concurrent_reducers(sides):
    n_red, n_map = 3, 8
    blobs = {(m, r): bytes([r * 50 + m]) * 128
             for r in range(n_red) for m in range(n_map)}
    out = []
    for side in sides(blobs):
        side.register([side.server.uri] * n_map)
        results, errors = {}, []

        def run(reduce_id, side=side, results=results, errors=errors):
            try:
                results[reduce_id] = sorted(side.stream(reduce_id))
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(r,))
                   for r in range(n_red)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errors
        out.append(results)
    assert out[0] == out[1] == {
        r: sorted(bytes([r * 50 + m]) * 128 for m in range(n_map))
        for r in range(n_red)}


def _dead_uri() -> str:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"127.0.0.1:{port}"


def test_tracker_keeps_ordered_location_lists():
    from vega_tpu.errors import MapOutputError as RefMapOutputError

    out = []
    for cls, err in ((RefTracker, RefMapOutputError),
                     (MapOutputTracker, MapOutputError)):
        t = cls()
        t.register_shuffle(7, 3)
        t.register_map_outputs(7, [["a:1", "b:1"], "b:1", ["c:1", "a:1"]])
        row = [t.get_server_uris(7, timeout=1),
               t.get_server_uri_lists(7, timeout=1)]
        gen0 = t.generation
        t.unregister_map_output(7, 0, "a:1")
        row += [t.generation > gen0, t.has_outputs(7),
                t.get_server_uris(7, timeout=1)[0]]
        row.append(t.unregister_server_outputs("b:1"))
        row.append(t.has_outputs(7))
        with pytest.raises(err):
            t.get_server_uris(7, timeout=0.1)
        t.register_map_sizes(7, {2: [5, 9]})
        row.append(t.top_reduce_locations(7, 1))
        row.append(t.outputs_on_server("c:1"))
        out.append(row)
    assert out[0] == out[1]
    assert out[1][:2] == [["a:1", "b:1", "c:1"],
                          [["a:1", "b:1"], ["b:1"], ["c:1", "a:1"]]]


def test_put_many_replica_push_roundtrip(tmp_path):
    row = [bytes([r]) * (64 + r) for r in range(5)]
    out = []
    for ss, store_cls in ((ref_ss, RefStore), (port_ss, ShuffleStore)):
        store = store_cls(spill_dir=str(tmp_path / ss.__name__))
        server = ss.ShuffleServer(store)
        try:
            ss.push_buckets_remote(server.uri, 3, 2, row)
            out.append([ss.fetch_remote(server.uri, 3, 2, r)
                        for r in range(5)])
        finally:
            server.stop()
            store.close()
    assert out[0] == out[1] == row


def test_fetch_stream_fails_over_to_replica_mid_stream(sides):
    n = 16
    blobs = {(m, 0): bytes([m % 251]) * (256 + m) for m in range(n)}
    out = []
    for side in sides(blobs):
        dead = _dead_uri()
        side.register([[dead, side.server.uri] if m < 8
                       else [side.server.uri] for m in range(n)])
        old = side.env.conf.fetch_retries
        side.env.conf.fetch_retries = 1
        try:
            got = sorted(side.stream())
        finally:
            side.env.conf.fetch_retries = old
        st = side.stats
        assert st["failovers"] >= 1
        out.append((got, st["failover_buckets"], st["duplicates"]))
    assert out[0] == out[1] == (sorted(blobs.values()), 8, 0)


def test_fetch_slow_server_deadline_fails_over(sides):
    n = 8
    blobs = {(m, 0): bytes([m % 251]) * 128 for m in range(n)}
    out = []
    for side in sides(blobs):
        hole = socket.socket()  # accepts, never answers
        hole.bind(("127.0.0.1", 0))
        hole.listen(8)
        hole_uri = f"127.0.0.1:{hole.getsockname()[1]}"
        side.register([[hole_uri, side.server.uri] if m < 4
                       else [side.server.uri] for m in range(n)])
        conf = side.env.conf
        old = conf.fetch_slow_server_s, conf.fetch_batch_enabled
        conf.fetch_slow_server_s, conf.fetch_batch_enabled = 0.5, True
        try:
            t0 = time.monotonic()
            got = sorted(side.stream())
            wall = time.monotonic() - t0
        finally:
            conf.fetch_slow_server_s, conf.fetch_batch_enabled = old
            hole.close()
        assert wall < 20.0
        st = side.stats
        assert st["failovers"] >= 1
        out.append((got, st["failover_buckets"]))
    assert out[0] == out[1] == (sorted(blobs.values()), 4)


def test_fetch_events_reach_driver_bus():
    rows = [(i % 5, i) for i in range(100)]
    out = []
    for make in (lambda: v.Context("local", num_workers=2),
                 lambda: vt.Context(device="cpu", n_shards=4)):
        prev = v.Context.active()
        if prev is not None:
            prev.stop()
        ctx = make()
        try:
            assert len(ctx.parallelize(rows, 4).reduce_by_key(
                lambda a, b: a + b, 3).collect()) == 5
            fetch = ctx.metrics_summary()["fetch"]
        finally:
            ctx.stop()
        out.append((fetch["streams"], fetch["buckets"] >= 3,
                    fetch["bytes"] > 0, fetch["round_trips"]))
    assert out[0] == out[1] == (3, True, True, 0)


# --- replicated shuffles over a fleet of each package -----------------------


def _port(**kw):
    return vt.Context(mode="distributed", device="cpu", n_shards=4,
                      num_executors=2, num_workers=2, **kw)


REPLICATED = dict(shuffle_replication=2, fetch_retries=2,
                  fetch_retry_interval_s=0.05, executor_max_restarts=0)


@pytest.fixture(scope="module")
def fleets():
    prev = v.Context.active()
    if prev is not None:
        prev.stop()
    ref = v.Context("distributed", num_workers=2, **REPLICATED)
    try:
        port = _port(**REPLICATED)
    except BaseException:
        ref.stop()
        raise
    yield ref, port
    port.stop()
    if not ref._stopped:
        ref.stop()


def _tracker(ctx):
    return RefEnv.get().map_output_tracker if isinstance(ctx, v.Context) \
        else ctx.env.map_output_tracker


def test_shuffle_replication_parity_and_locations(fleets):
    out = []
    for ctx in fleets:
        pairs = ctx.parallelize([(i % 5, i) for i in range(100)], 4)
        shuffled = pairs.reduce_by_key(lambda a, b: a + b, 3)
        got = sorted(shuffled.collect())
        lists = _tracker(ctx).get_server_uri_lists(shuffled.shuffle_id)
        assert len(lists) == 4
        assert all(len(lst) == 2 and lst[0] != lst[1] for lst in lists)
        out.append(got)
    assert out[0] == out[1] == sorted(
        (k, sum(range(k, 100, 5))) for k in range(5))


def test_reduce_job_int64_overflow_stays_exact(fleets):
    big = (1 << 62) + 3
    got = [dict(ctx.parallelize([(0, big), (0, big), (1, 1)], 3)
                .reduce_by_key(lambda a, b: a + b, 2).collect())
           for ctx in fleets]
    assert got[0] == got[1] == {0: 2 * big, 1: 1}


def test_replicated_fetch_fails_over_after_executor_kill(fleets):
    """The primary holder killed after the map stage: the reduce reads
    every bucket from the surviving replicas, no stage resubmitted, and
    the rows are equal."""
    expected = sorted((k, sum(range(k, 200, 5))) for k in range(5))
    out = []
    for ctx in fleets:
        shuffled = ctx.parallelize([(i % 5, i) for i in range(200)], 8) \
            .reduce_by_key(lambda a, b: a + b, 4)
        first = sorted(shuffled.collect())
        before = ctx.metrics_summary()["stages_resubmitted"]
        victim = next(iter(ctx._backend._executors.values()))
        victim.process.kill()
        victim.process.wait()
        second = sorted(shuffled.collect())
        resubmitted = ctx.metrics_summary()["stages_resubmitted"] - before
        out.append((first, second, resubmitted))
    assert out[0] == out[1] == (expected, expected, 0)


def test_legacy_fetch_full_job():
    """fetch_batch_enabled=False reaches the executors: a job over the
    per-bucket protocol gives the same rows."""
    prev = v.Context.active()
    if prev is not None:
        prev.stop()
    out = []
    for make in (lambda: v.Context("distributed", num_workers=2,
                                   fetch_batch_enabled=False),
                 lambda: _port(fetch_batch_enabled=False)):
        ctx = make()
        try:
            assert ctx._backend.conf.fetch_batch_enabled is False
            pairs = ctx.parallelize([(i % 5, i) for i in range(100)], 4)
            out.append(sorted(pairs.reduce_by_key(lambda a, b: a + b,
                                                  3).collect()))
            stats = ctx._backend.worker_stats()
            if isinstance(ctx, vt.Context):
                gets = sum(s["wire"]["gets"] for s in stats.values())
                many = sum(s["wire"]["get_many"] for s in stats.values())
                assert gets > 0 and many == 0, stats
        finally:
            ctx.stop()
    assert out[0] == out[1] == sorted(
        (k, sum(range(k, 100, 5))) for k in range(5))
