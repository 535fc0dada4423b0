"""The port's streaming plane (vega_tpu_torch/streaming/) against
vega_tpu's, on the CPU.

Each case of tests/test_streaming.py but the SIGKILL and elastic ones,
run through both packages on the same seeded sources. A stream's batch
boundaries depend on timing, so the cases compare what is determined:
the final committed state (integers exact), the records in offset
order, the offsets, and the commit and replay counts. Intervals are
0.05 s and every wait is bounded (10 s at most), so a receiver that
never stops fails its case instead of hanging the run.

Two cases of the port's own: dense jobs on the caller's thread while a
stream folds on the device (the Context's dense lock), and a fold whose
kernel fails (KernelError): the batch replays, then the stream fails,
and nothing folds on the host in its place.
"""

import json
import os
import socketserver
import threading
import time

import numpy as np
import pytest

import vega_tpu as v
from vega_tpu.scheduler import events as ref_events
from vega_tpu.streaming.source import FileTailReplay as RefFileTailReplay
import vega_tpu_torch as vt
from vega_tpu_torch import state_fold
from vega_tpu_torch.errors import KernelError, VegaError
from vega_tpu_torch.scheduler import events as port_events
from vega_tpu_torch.streaming import context as port_sctx
from vega_tpu_torch.streaming.controller import RateController
from vega_tpu_torch.streaming.source import (FileTailReplay,
                                             GeneratorSource)

N_SHARDS = 4
WAIT_S = 10.0


def _ref(**overrides):
    kw = dict(stream_batch_interval_s=0.05, stream_block_max_records=4)
    kw.update(overrides)
    return v.Context("local", **kw)


def _port(**overrides):
    kw = dict(stream_batch_interval_s=0.05, stream_block_max_records=4)
    kw.update(overrides)
    return vt.Context(device="cpu", n_shards=N_SHARDS, **kw)


BOTH = [("ref", _ref), ("port", _port)]


def _bounded_gen(n):
    """Offsets 0..n-1 yield their offset, then the source is dry."""
    def fn(offset):
        return offset if offset < n else None
    return fn


def _seeded_pairs_gen(n, seed=22, keys=7):
    rng = np.random.RandomState(seed)
    ks = rng.randint(0, keys, n).tolist()
    xs = rng.randint(-1000, 1000, n).tolist()

    def fn(offset):
        return (ks[offset], xs[offset]) if offset < n else None
    return fn, ks, xs


def _expected_sums(records, nkeys=3):
    out = {}
    for x in records:
        out[x % nkeys] = out.get(x % nkeys, 0) + x
    return out


def _drained(sctx, end, stream=0, settled=True):
    """Wait until the receiver read up to end, no block is pending and
    no batch is in flight; settled: and the batches that completed
    reached end (the receiver reads before it lands, so the first three
    alone can hold while blocks are still being cut)."""
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline:
        st = sctx.status()
        if st["failed"] is not None:
            return False
        if st["receivers"][stream]["next_offset"] >= end \
                and st["controller"]["pending_blocks"] == 0 \
                and not st["inflight"] \
                and (not settled or sctx._offsets.get(stream, 0) >= end):
            return True
        time.sleep(0.02)
    return False


# --- basic flow -------------------------------------------------------------


def test_generator_stream_end_to_end(tmp_path):
    got = {}
    for name, make in BOTH:
        seen = []
        with make() as ctx:
            stream = ctx.stream_from_generator(
                _bounded_gen(40), checkpoint_dir=str(tmp_path / name))
            stream.map(lambda x: x * 2).filter(lambda x: x % 4 == 0) \
                  .foreach_rdd(lambda rdd, bid: seen.extend(rdd.collect()))
            sctx = ctx.streaming()
            sctx.start()
            assert sctx.await_batches(1, WAIT_S)
            assert _drained(sctx, 40)
            sctx.stop()
            st = sctx.status()
            streaming = ctx.metrics_summary()["streaming"]
        got[name] = (sorted(seen), st["failed"],
                     st["receivers"][0]["next_offset"],
                     streaming["records"], streaming["duplicate_commits"])
    assert got["port"] == got["ref"] == (
        sorted(x * 2 for x in range(40) if (x * 2) % 4 == 0), None, 40,
        40, 0)


def test_empty_intervals_do_not_commit_batches(tmp_path):
    for name, make in BOTH:
        with make() as ctx:
            stream = ctx.stream_from_generator(
                _bounded_gen(4), checkpoint_dir=str(tmp_path / name))
            stream.foreach_rdd(lambda rdd, bid: rdd.collect())
            sctx = ctx.streaming()
            sctx.start()
            assert sctx.await_batches(1, WAIT_S)
            time.sleep(0.4)  # many empty intervals after the source is dry
            sctx.stop()
            assert sctx.status()["batches_committed"] == 1, name
            assert ctx.metrics_summary()["streaming"][
                "batches_submitted"] == 1


def test_file_tail_follows_appends_with_byte_offsets(tmp_path):
    for name, make in BOTH:
        path = tmp_path / f"events-{name}.log"
        path.write_text("alpha\nbeta\n")
        seen = []
        with make() as ctx:
            stream = ctx.stream_from_file_tail(
                str(path), checkpoint_dir=str(tmp_path / f"ckpt-{name}"))
            stream.foreach_rdd(lambda rdd, bid: seen.extend(rdd.collect()))
            sctx = ctx.streaming()
            sctx.start()
            assert sctx.await_batches(1, WAIT_S)
            # an empty line is a record too: every byte is in one block
            with open(path, "a") as f:
                f.write("gamma\n\ndelta\n")
                f.write("half a li")  # no newline yet: not a record
            deadline = time.monotonic() + WAIT_S
            while len(seen) < 5 and time.monotonic() < deadline:
                time.sleep(0.02)
            time.sleep(0.15)
            sctx.stop()
            assert seen == ["alpha", "beta", "gamma", "", "delta"], name
            assert sctx.status()["receivers"][0]["next_offset"] == \
                os.path.getsize(path) - len("half a li")


def test_file_tail_replay_handle_is_bit_identical(tmp_path):
    path = tmp_path / "r.log"
    data = "one\ntwo\n\nthree\nq\xe9\n"
    path.write_bytes(data.encode("latin-1"))
    raw = data.encode("latin-1")
    for start, end in ((0, len(raw)), (4, 8), (8, 9), (15, len(raw))):
        assert FileTailReplay(str(path), start, end).records() == \
            RefFileTailReplay(str(path), start, end).records()
    assert FileTailReplay(str(path), 0, 15).records() == \
        ["one", "two", "", "three"]


def _line_server(lines, hold_s=1.0):
    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            for line in lines:
                self.wfile.write(line)
                self.wfile.flush()
            time.sleep(hold_s)  # the connection outlives the first batches

    server = socketserver.ThreadingTCPServer(("127.0.0.1", 0), Handler)
    server.daemon_threads = True
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server


def test_socket_stream_receives_lines(tmp_path):
    lines = [f"line-{i}\n".encode() for i in range(30)]
    for name, make in BOTH:
        received = []
        server = _line_server(lines)
        try:
            with make(stream_socket_timeout_s=1.0) as ctx:
                stream = ctx.stream_from_socket(
                    "127.0.0.1", server.server_address[1],
                    checkpoint_dir=str(tmp_path / name))
                stream.foreach_rdd(
                    lambda rdd, bid: received.extend(rdd.collect()))
                sctx = ctx.streaming()
                sctx.start()
                deadline = time.monotonic() + WAIT_S
                while len(received) < 30 and time.monotonic() < deadline:
                    time.sleep(0.02)
                sctx.stop()
                assert sctx.status()["receivers"][0]["next_offset"] == 30
        finally:
            server.shutdown()
            server.server_close()
        assert received == [f"line-{i}" for i in range(30)], name


def test_socket_read_timeout_restarts_the_receiver(tmp_path):
    """A read that times out leaves the socket's reader refusing further
    reads ("cannot read from timed out object"), so the receiver crashes
    on its next poll and the batch loop restarts it on a new connection:
    the reference's behavior, which the port keeps."""
    for name, make in BOTH:
        server = _line_server([b"a\n", b"b\n"], hold_s=2.0)
        try:
            with make(stream_socket_timeout_s=0.2) as ctx:
                received = []
                ctx.stream_from_socket(
                    "127.0.0.1", server.server_address[1],
                    checkpoint_dir=str(tmp_path / name)).foreach_rdd(
                        lambda rdd, bid: received.extend(rdd.collect()))
                sctx = ctx.streaming()
                sctx.start()
                deadline = time.monotonic() + WAIT_S
                while sctx.status()["receivers"][0]["attempt"] < 1 \
                        and time.monotonic() < deadline:
                    time.sleep(0.02)
                sctx.stop()
                assert sctx.status()["receivers"][0]["attempt"] >= 1, name
                assert ctx.metrics_summary()["streaming"][
                    "receiver_restarts"] >= 1
                assert received[:2] == ["a", "b"]
        finally:
            server.shutdown()
            server.server_close()


# --- stateful, exactly once -------------------------------------------------


def _recover_run(make, ckpt, n, after=None):
    with make() as ctx:
        stream = ctx.stream_from_generator(_bounded_gen(n),
                                           checkpoint_dir=ckpt)
        handle = stream.map(lambda x: (x % 3, x)) \
                       .update_state_by_key(op="add")
        sctx = ctx.streaming()
        sctx.start()
        assert sctx.await_batches(1 if after is None else after + 2, WAIT_S)
        assert _drained(sctx, n)
        sctx.stop()
        return (handle.snapshot(), handle.store.last_committed_batch,
                handle.store.duplicate_commits, sctx.status())


def test_update_state_by_key_and_recovery_across_contexts(tmp_path):
    """Stop after half the source, restart a new Context on the same
    checkpoint directory with a longer source: the state recovers from
    the commit record and ingest resumes at the committed offsets, so the
    final sums equal one uninterrupted run."""
    got = {}
    for name, make in BOTH:
        ckpt = str(tmp_path / name / "ckpt")
        first, committed, _d, _st = _recover_run(make, ckpt, 50)
        assert first == _expected_sums(range(50)) and committed >= 0
        final, last, dups, st = _recover_run(make, ckpt, 80, committed)
        rec = json.loads(open(os.path.join(
            ckpt, "stateful-0", "commits", "latest.commit")).read())
        assert rec["batch_id"] == last
        assert rec["offsets"] == {"0": 80}
        assert st["receivers"][0]["blocks_landed"] == (80 - 50 + 3) // 4
        got[name] = (first, final, dups, {type(k) for k in final},
                     {type(x) for x in final.values()})
    assert got["port"] == got["ref"]
    assert got["port"][1] == _expected_sums(range(80))
    assert got["port"][2] == 0 and got["port"][3:] == ({int}, {int})


def test_stateful_func_and_device_op_paths_agree(tmp_path, monkeypatch):
    """The named op (a device reduce per batch) and the host func fold to
    the same state, equal to the reference's; every port batch folded on
    the device (no None from fold_pairs_device)."""
    fn, ks, xs = _seeded_pairs_gen(60)
    calls = []
    real = state_fold.fold_pairs_device

    def counted(ctx, pairs, op):
        out = real(ctx, pairs, op)
        calls.append(out is not None)
        return out

    got = {}
    for name, make in BOTH:
        if name == "port":
            monkeypatch.setattr(state_fold, "fold_pairs_device", counted)
        with make() as ctx:
            s1 = ctx.stream_from_generator(
                fn, checkpoint_dir=str(tmp_path / name))
            h_op = s1.update_state_by_key(op="add")
            h_max = s1.update_state_by_key(op="max")
            h_fn = s1.update_state_by_key(
                lambda values, old: (old or 0) + sum(values))
            sctx = ctx.streaming()
            sctx.start()
            assert sctx.await_batches(1, WAIT_S)
            assert _drained(sctx, 60)
            sctx.stop()
            got[name] = (h_op.snapshot(), h_fn.snapshot(), h_max.snapshot())
    want = {}
    for k, x in zip(ks, xs):
        want[k] = want.get(k, 0) + x
    assert got["port"] == got["ref"]
    assert got["port"][0] == got["port"][1] == want
    assert calls and all(calls)


def test_batch_failure_replays_from_stored_blocks(tmp_path):
    """A failing output fails the whole batch; the next tick replays the
    same batch_id over the same blocks, and the state commits once."""
    for name, make in BOTH:
        attempts = []

        def flaky(rdd, batch_id, attempts=attempts):
            attempts.append(batch_id)
            if len(attempts) == 1:
                raise RuntimeError("transient sink outage")
            rdd.collect()

        with make() as ctx:
            stream = ctx.stream_from_generator(
                _bounded_gen(20), checkpoint_dir=str(tmp_path / name))
            stream.foreach_rdd(flaky)
            handle = stream.map(lambda x: (x % 3, x)) \
                           .update_state_by_key(op="add")
            sctx = ctx.streaming()
            sctx.start()
            assert sctx.await_batches(1, WAIT_S)
            assert _drained(sctx, 20)
            sctx.stop()
            assert len(attempts) >= 2 and attempts[0] == attempts[1], name
            assert handle.snapshot() == _expected_sums(range(20))
            assert handle.store.duplicate_commits == 0
            assert ctx.metrics_summary()["streaming"]["batch_replays"] >= 1


def test_stream_fails_after_max_replays(tmp_path):
    for name, make in BOTH:
        def always_broken(rdd, batch_id):
            raise RuntimeError("permanent sink outage")

        with make() as ctx:
            stream = ctx.stream_from_generator(
                _bounded_gen(8), checkpoint_dir=str(tmp_path / name))
            stream.foreach_rdd(always_broken)
            sctx = ctx.streaming()
            sctx.start()
            assert not sctx.await_batches(1, WAIT_S)
            st = sctx.status()
            assert st["failed"] == "batch 0 failed after 5 replays", name
            assert ctx.metrics_summary()["streaming"]["batch_replays"] == 5
            sctx.stop()


# --- backpressure -----------------------------------------------------------


def test_backpressure_block_mode_bounds_queue_without_loss(tmp_path):
    for name, make in BOTH:
        with make(stream_block_max_records=2, stream_queue_max_blocks=3,
                  stream_backpressure_mode="block") as ctx:
            seen = []
            stream = ctx.stream_from_generator(
                _bounded_gen(40), checkpoint_dir=str(tmp_path / name))
            stream.foreach_rdd(
                lambda rdd, bid: (time.sleep(0.05),
                                  seen.extend(rdd.collect())))
            sctx = ctx.streaming()
            sctx.start()
            deadline = time.monotonic() + WAIT_S
            while len(seen) < 40 and time.monotonic() < deadline:
                time.sleep(0.02)
            sctx.stop()
            # parked at the bound: nothing lost, nothing twice
            assert sorted(seen) == list(range(40)), name
            st = sctx.status()["controller"]
            assert st["max_depth_seen"] <= 3
            assert st["throttled_offers"] > 0 and st["shed_blocks"] == 0


def test_backpressure_shed_mode_drops_by_policy(tmp_path):
    for name, make in BOTH:
        with make(stream_block_max_records=2, stream_queue_max_blocks=2,
                  stream_backpressure_mode="shed") as ctx:
            seen = []
            stream = ctx.stream_from_generator(
                _bounded_gen(60), checkpoint_dir=str(tmp_path / name))
            stream.foreach_rdd(
                lambda rdd, bid: (time.sleep(0.1),
                                  seen.extend(rdd.collect())))
            sctx = ctx.streaming()
            sctx.start()
            assert _drained(sctx, 60, settled=False)
            sctx.stop()
            st = sctx.status()
            recv = st["receivers"][0]
            # the queue stays bounded by dropping whole blocks: what is
            # left is processed once, and the drops are counted
            assert st["controller"]["max_depth_seen"] <= 2, name
            assert recv["shed_blocks"] > 0
            assert len(seen) == len(set(seen))
            assert len(seen) + recv["shed_records"] == 60


def test_rate_controller_bound_halves_when_behind(tmp_path):
    """The effective bound halves while the pool's p95 wall exceeds the
    interval, as the reference's; load_signal is pending blocks."""
    from vega_tpu.streaming.controller import RateController as RefRC

    class Conf:
        stream_backpressure_mode = "block"
        stream_queue_max_blocks = 8

    out = []
    for mod, rc in ((ref_events, RefRC), (port_events, RateController)):
        m = mod.MetricsListener()
        ctl = rc(Conf, m, "streaming", 0.5)
        before = ctl._effective_bound()
        for i in range(5):
            m.on_event(mod.JobStart(job_id=i, pool="streaming"))
            m.on_event(mod.JobEnd(job_id=i, succeeded=True, duration_s=0.9))
        ctl.block_landed()
        out.append((before, ctl._effective_bound(), ctl.behind(),
                    ctl.load_signal(), ctl.status()["behind"]))
    assert out[0] == out[1] == (8, 4, True, 1, True)
    bad = Conf()
    bad.stream_backpressure_mode = "drop"
    with pytest.raises(VegaError, match="'block' or 'shed'"):
        RateController(bad, port_events.MetricsListener(), "s", 0.5)


def test_rate_controller_load_signal_and_pool_latency(tmp_path):
    for name, make in BOTH:
        with make() as ctx:
            stream = ctx.stream_from_generator(
                _bounded_gen(12), checkpoint_dir=str(tmp_path / name))
            stream.foreach_rdd(lambda rdd, bid: rdd.collect())
            sctx = ctx.streaming()
            assert sctx.controller.load_signal() >= 0
            sctx.start()
            assert sctx.await_batches(1, WAIT_S)
            sctx.stop()
            lat = ctx.metrics.pool_latency()
            assert lat["streaming"]["count"] >= 1, name
            assert sctx.status()["controller"]["pool_latency"] == \
                lat["streaming"]


# --- windows ----------------------------------------------------------------


def test_windowed_aggregate_spans_intervals(tmp_path):
    got = {}
    for name, make in BOTH:
        items = list(range(5))

        def gen(offset, items=items):
            return items[offset] if offset < len(items) else None

        windows = []
        with make(stream_block_max_records=3) as ctx:
            stream = ctx.stream_from_generator(
                gen, checkpoint_dir=str(tmp_path / name))
            stream.window(2).map(lambda x: ("n", 1)) \
                  .reduce_by_key(lambda a, b: a + b, 1) \
                  .foreach_rdd(lambda rdd, bid: windows.append(
                      (bid, dict(rdd.collect()))))
            sctx = ctx.streaming()
            sctx.start()
            assert sctx.await_batches(1, WAIT_S)
            items.extend(range(5, 9))  # the second interval's records
            assert sctx.await_batches(2, WAIT_S)
            sctx.stop()
            # window(2) keeps the last two batches' blocks, no more
            assert name == "ref" or len(ctx._stream_blocks) == 0
        got[name] = (dict(windows)[0], dict(windows)[1])
    assert got["port"] == got["ref"] == ({"n": 5}, {"n": 9})
    with _port() as ctx:
        with pytest.raises(ValueError, match="window length"):
            ctx.stream_from_generator(
                _bounded_gen(1), checkpoint_dir=str(tmp_path / "w")).window(0)


def test_declare_after_start_is_rejected(tmp_path):
    for name, make in BOTH:
        with make() as ctx:
            stream = ctx.stream_from_generator(
                _bounded_gen(4), checkpoint_dir=str(tmp_path / name))
            with pytest.raises(RuntimeError, match="no output"):
                ctx.streaming().start()
            stream.foreach_rdd(lambda rdd, bid: rdd.collect())
            sctx = ctx.streaming()
            sctx.start()
            with pytest.raises(RuntimeError):
                stream.foreach_rdd(lambda rdd, bid: None)
            with pytest.raises(RuntimeError):
                sctx.generator_stream(_bounded_gen(1))
            with pytest.raises(RuntimeError, match="already started"):
                sctx.start()
            with pytest.raises(ValueError, match="exactly one"):
                stream.update_state_by_key()
            sctx.stop()


def test_unknown_named_op_is_refused(tmp_path):
    for name, make in BOTH:
        with make() as ctx:
            stream = ctx.stream_from_generator(
                _bounded_gen(4), checkpoint_dir=str(tmp_path / name))
            with pytest.raises(ValueError, match="unknown named op"):
                stream.map(lambda x: (x, x)).update_state_by_key(op="mean")


# --- a receiver crash -------------------------------------------------------


def test_receiver_crash_midingest_replays_bit_identical(tmp_path,
                                                        monkeypatch):
    """The receiver's source raises once, after some records were polled
    into its buffer and some blocks landed; the batch loop restarts it
    from the landed frontier. The final state equals a run without the
    crash and the reference's, with no duplicate commit."""
    polls = []
    real_poll = GeneratorSource._poll

    def slow_crashing_poll(self):
        """At most three records a poll; the fourth poll raises, with
        one record buffered and two blocks landed."""
        polls.append(self.next_offset)
        if len(polls) == 4:
            raise OSError("receiver lost its source")
        records, _ = real_poll(self)
        records = records[:3]
        return records, self.next_offset + len(records)

    with _ref(stream_block_max_records=4) as ctx:
        stream = ctx.stream_from_generator(
            _bounded_gen(50), checkpoint_dir=str(tmp_path / "ref"))
        h = stream.map(lambda x: (x % 3, x)).update_state_by_key(op="add")
        sctx = ctx.streaming()
        sctx.start()
        assert _drained(sctx, 50)
        sctx.stop()
        want = h.snapshot()
    monkeypatch.setattr(GeneratorSource, "_poll", slow_crashing_poll)
    with _port(stream_block_max_records=4) as ctx:
        stream = ctx.stream_from_generator(
            _bounded_gen(50), checkpoint_dir=str(tmp_path / "port"))
        handle = stream.map(lambda x: (x % 3, x)) \
                       .update_state_by_key(op="add")
        sctx = ctx.streaming()
        sctx.start()
        assert _drained(sctx, 50)
        sctx.stop()
        st = sctx.status()
        assert st["receivers"][0]["attempt"] == 1 and len(polls) >= 4
        assert polls[4] == 8  # resumed at the landed frontier
        assert handle.snapshot() == want == _expected_sums(range(50))
        assert handle.store.duplicate_commits == 0
        assert ctx.metrics_summary()["streaming"]["receiver_restarts"] >= 1


def test_injected_receiver_crash_replays_bit_identical(tmp_path):
    """The fault seam faults.maybe_crash_receiver, armed alike in both
    packages, crashes the receiver once after its second block; the
    restart resumes from the landed frontier, and the final state equals
    the reference's under the same injection, with no duplicate
    commit."""
    from vega_tpu import faults as ref_faults
    from vega_tpu_torch import faults as port_faults

    got = {}
    for (name, make), faults in zip(BOTH, (ref_faults, port_faults)):
        faults.configure(receiver_crash_after_blocks=2)
        try:
            with make() as ctx:
                stream = ctx.stream_from_generator(
                    _bounded_gen(50), checkpoint_dir=str(tmp_path / name))
                handle = stream.map(lambda x: (x % 3, x)) \
                               .update_state_by_key(op="add")
                sctx = ctx.streaming()
                sctx.start()
                assert _drained(sctx, 50), name
                sctx.stop()
                summary = ctx.metrics_summary()["streaming"]
                got[name] = (handle.snapshot(),
                             summary["receiver_restarts"] >= 1,
                             summary["duplicate_commits"])
        finally:
            faults.reset()
    assert got["port"] == got["ref"] == (_expected_sums(range(50)), True, 0)


def test_a_crash_with_records_buffered_rereads_them(tmp_path, monkeypatch):
    """Records polled but not landed when the source raises are read
    again from the landed frontier, never skipped nor counted twice."""
    calls = []
    real_poll = GeneratorSource._poll

    def poll(self):
        calls.append(1)
        if len(calls) == 2:  # 256 records buffered, 100 of them landed
            raise OSError("lost")
        return real_poll(self)

    monkeypatch.setattr(GeneratorSource, "_poll", poll)
    with _port(stream_block_max_records=100) as ctx:
        stream = ctx.stream_from_generator(
            _bounded_gen(1000), checkpoint_dir=str(tmp_path))
        handle = stream.map(lambda x: (x % 3, x)) \
                       .update_state_by_key(op="add")
        sctx = ctx.streaming()
        sctx.start()
        assert _drained(sctx, 1000)
        sctx.stop()
        assert handle.snapshot() == _expected_sums(range(1000))
        assert sctx.status()["receivers"][0]["attempt"] == 1


# --- the port's own cases ---------------------------------------------------


def test_caller_thread_dense_jobs_while_a_stream_folds(tmp_path):
    """The stream's loop folds on the device (fold_pairs_device: a dense
    reduce per batch) while the caller's thread runs dense reduce and
    join jobs on the same Context: both results equal the reference's."""
    fn, ks, xs = _seeded_pairs_gen(3000, keys=50)
    rng = np.random.RandomState(5)
    keys = rng.randint(0, 300, 4000).astype(np.int32)
    vals = rng.randint(-100, 100, 4000).astype(np.int32)
    tk = np.arange(0, 300, 3, dtype=np.int32)
    with _ref(stream_block_max_records=50) as ref:
        stream = ref.stream_from_generator(
            fn, checkpoint_dir=str(tmp_path / "ref"))
        h = stream.update_state_by_key(op="add")
        sctx = ref.streaming()
        sctx.start()
        assert _drained(sctx, 3000)
        sctx.stop()
        want_state = h.snapshot()
        pairs = list(zip(keys.tolist(), vals.tolist()))
        table = [(int(k), int(k) * 2) for k in tk]
        red = ref.parallelize(pairs, 4).reduce_by_key(lambda a, b: a + b)
        want_red = sorted(red.collect())
        want_join = sorted(red.join(ref.parallelize(table, 2)).collect())
    with _port(stream_block_max_records=50) as ctx:
        stream = ctx.stream_from_generator(
            fn, checkpoint_dir=str(tmp_path / "port"))
        h = stream.update_state_by_key(op="add")
        sctx = ctx.streaming()
        sctx.start()
        results = []
        while sctx.status()["receivers"][0]["next_offset"] < 3000 \
                or len(results) < 3:
            red = ctx.dense_from_numpy(keys, vals).reduce_by_key(op="add")
            joined = red.join(ctx.dense_from_numpy(tk, tk * 2))
            results.append((sorted(red.collect()),
                            sorted(joined.collect())))
            assert len(results) < 500
        assert _drained(sctx, 3000)
        sctx.stop()
        assert h.snapshot() == want_state
        assert ctx.metrics_summary()["streaming"]["batches_completed"] >= 1
    for got_red, got_join in results:
        assert got_red == want_red and got_join == want_join


def test_kernel_error_in_the_fold_fails_the_batch(tmp_path, monkeypatch):
    """A KernelError from the device fold fails the batch, which replays
    MAX_BATCH_REPLAYS times; then the stream fails. The state never
    takes a host fold in the fold's place."""
    calls = []

    def broken(ctx, pairs, op):
        calls.append(len(pairs))
        raise KernelError("hash_bucket failed to launch")

    monkeypatch.setattr(state_fold, "fold_pairs_device", broken)
    with _port() as ctx:
        stream = ctx.stream_from_generator(
            _bounded_gen(12), checkpoint_dir=str(tmp_path))
        handle = stream.map(lambda x: (x % 3, x)) \
                       .update_state_by_key(op="add")
        sctx = ctx.streaming()
        sctx.start()
        assert not sctx.await_batches(1, WAIT_S)
        st = sctx.status()
        sctx.stop()
        assert st["failed"] == (f"batch 0 failed after "
                                f"{port_sctx.MAX_BATCH_REPLAYS} replays")
        assert len(calls) == port_sctx.MAX_BATCH_REPLAYS + 1
        assert handle.snapshot() == {} and handle.store.commits == 0
        summary = ctx.metrics_summary()["streaming"]
        assert summary["batch_failures"] == port_sctx.MAX_BATCH_REPLAYS + 1
        assert summary["state_checkpoints"] == 0


def test_a_refusing_fold_folds_on_the_host(tmp_path, monkeypatch):
    """fold_pairs_device's None (pairs with no dense form: string keys)
    folds on the host with the same result."""
    words = ["a", "bb", "a", "c"] * 5

    def gen(i):
        return (words[i], i) if i < len(words) else None

    with _port() as ctx:
        stream = ctx.stream_from_generator(gen,
                                           checkpoint_dir=str(tmp_path))
        handle = stream.update_state_by_key(op="add")
        sctx = ctx.streaming()
        sctx.start()
        assert _drained(sctx, len(words))
        sctx.stop()
    want = {}
    for i, w in enumerate(words):
        want[w] = want.get(w, 0) + i
    assert handle.snapshot() == want


def test_streaming_refuses_a_multi_process_context(monkeypatch):
    """Recorded difference: the batch loop's timer thread cannot run
    collectives in one order on every process."""
    with _port() as ctx:
        monkeypatch.setattr(type(ctx.mesh), "collective",
                            property(lambda self: True))
        with pytest.raises(VegaError, match="across processes"):
            ctx.streaming()
        with pytest.raises(VegaError, match="across processes"):
            ctx.stream_from_generator(_bounded_gen(1))
        monkeypatch.undo()


def test_stop_stops_streaming_first_and_keeps_state(tmp_path):
    """Context.stop() stops the receivers and the loop and removes the
    blocks; the committed state stays in the checkpoint directory, and
    the default directory outlives the Context."""
    with _port(stream_block_max_records=1000) as ctx:
        stream = ctx.stream_from_generator(
            _bounded_gen(10 ** 9), checkpoint_dir=str(tmp_path))
        stream.map(lambda x: (x % 3, 1)).update_state_by_key(op="add")
        sctx = ctx.streaming()
        sctx.start()
        assert sctx.await_batches(1, WAIT_S)
    assert not sctx._thread.is_alive()
    assert not any(s.receiver._thread.is_alive() for s in sctx._inputs)
    assert len(ctx._stream_blocks) == 0
    assert os.path.exists(os.path.join(str(tmp_path), "stateful-0",
                                       "commits", "latest.commit"))
    with _port() as ctx:
        default = ctx.streaming().checkpoint_dir
        assert ctx.streaming() is ctx.streaming()
    assert default.startswith(os.path.dirname(port_sctx._SESSION_DIR))
    assert default != ctx._work_dir()


@pytest.mark.parametrize("level", ["memory_only", "memory_and_disk",
                                   "disk_only"])
def test_blocks_at_each_storage_level(tmp_path, level):
    """The blocks land at stream_storage_level (disk_only in the disk
    store) and give the same records; the stream's end removes them."""
    seen = []
    with _port(stream_storage_level=level) as ctx:
        stream = ctx.stream_from_generator(_bounded_gen(30),
                                           checkpoint_dir=str(tmp_path))
        stream.foreach_rdd(lambda rdd, bid: seen.extend(rdd.collect()))
        sctx = ctx.streaming()
        sctx.start()
        assert _drained(sctx, 30)
        on_disk = ctx.spill_status()["disk_entries"]
        sctx.stop()
        assert len(ctx._stream_blocks) == 0
        assert ctx.spill_status()["disk_entries"] == 0
    assert sorted(seen) == list(range(30))
    assert (on_disk > 0) == (level == "disk_only")
