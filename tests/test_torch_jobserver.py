"""The port's job-server names and broadcast against vega_tpu's, on the
CPU.

submit_job (with and without transform, a partition subset), the
thread scoping of set_local_property, admission under max_queued
(reject: JobRejectedError with the reference's fields; block: the
submitter parks until a job of the pool settles), cancel,
run_approximate_job (final, and an estimate that becomes final),
active(), storage_status, metrics_summary's keys, the task arbiter's
pick order by pool weight, the settings' checks and broadcast's value,
unpersist and pickling. Each holds the port (device="cpu") against the
reference on the same seeded inputs.

Every job, blocking or not, runs its event loop on a driver thread of its
own behind the job server's admission, as the reference's; a job started
inside another (on its driver thread or a task's) is part of it.

Recorded differences, pinned here:
- metrics_summary() holds the reference's keys for what the local
  runtime runs (no executor, elastic, locality, push or dispatch
  sections: those are the distributed backend's), with equal meanings;
- several port Contexts may live at once, each with its own Env;
  active() is the newest.
"""

import pickle
import threading
import time

import numpy as np
import pytest

import vega_tpu as v
from vega_tpu.errors import JobRejectedError as RefJobRejectedError
from vega_tpu.scheduler import events as ref_events
import vega_tpu_torch as vt
from vega_tpu_torch import broadcast as port_broadcast
from vega_tpu_torch.errors import (JobRejectedError,
                                   PartialJobError, TaskError, VegaError)
from vega_tpu_torch.scheduler import events as port_events
from vega_tpu_torch.scheduler import jobserver as port_jobserver

N_SHARDS = 4


def _rows(seed=22, n=400):
    rng = np.random.RandomState(seed)
    return [(int(k), int(x)) for k, x in zip(rng.randint(0, 20, n),
                                             rng.randint(-500, 500, n))]


def _port(**kw):
    return vt.Context(device="cpu", n_shards=N_SHARDS, **kw)


def _ref(**kw):
    return v.Context("local", **{"num_workers": 2, **kw})


def _sum_values(_tc, it):
    return sum(x for _k, x in it)


@pytest.mark.parametrize("partitions", [None, [0, 2]])
@pytest.mark.parametrize("transform", [None, sum])
def test_submit_job_equals_reference(partitions, transform):
    rows = _rows()
    with _ref() as ref:
        want = ref.submit_job(ref.parallelize(rows, 4), _sum_values,
                              partitions, transform=transform).result(30)
    with _port() as ctx:
        fut = ctx.submit_job(ctx.parallelize(rows, 4), _sum_values,
                             partitions, transform=transform)
        assert fut.result(30) == want
        assert fut.pool == "default" and fut.done()


def test_submit_job_over_a_dense_lineage():
    """The device work runs at submission, the rows on the worker."""
    rows = _rows()
    with _ref() as ref:
        want = sorted(ref.submit_job(
            ref.parallelize(rows, 4).reduce_by_key(lambda a, b: a + b, 2),
            lambda _tc, it: list(it), transform=lambda ps: [
                r for p in ps for r in p]).result(30))
    with _port() as ctx:
        node = ctx.parallelize(rows, 4).dense().reduce_by_key(op="add")
        got = ctx.submit_job(node, lambda _tc, it: list(it),
                             transform=lambda ps: [r for p in ps for r in p])
        assert sorted(got.result(30)) == want


def test_local_property_is_thread_scoped_and_picks_the_pool():
    for make in (_ref, _port):
        with make() as ctx:
            ctx.set_local_property("pool", "etl")
            seen = []
            t = threading.Thread(
                target=lambda: seen.append(ctx.get_local_property("pool")))
            t.start()
            t.join(10)
            assert seen == [None]
            assert ctx.get_local_property("pool") == "etl"
            assert ctx.get_local_property("missing", 7) == 7
            fut = ctx.submit_job(ctx.parallelize([1, 2, 3], 1),
                                 lambda _tc, it: sum(it))
            assert fut.result(30) == [6] and fut.pool == "etl"
            assert ctx.submit_job(ctx.parallelize([1], 1),
                                  lambda _tc, it: 0, pool="x").pool == "x"
            ctx.set_local_property("pool", None)
            assert ctx.get_local_property("pool") is None
            ctx.metrics_summary()
            assert ctx.metrics.job_summary(fut.job_id)["pool"] == "etl"


def _hold_pool(ctx, pool):
    """One job of pool that runs until the returned event is set."""
    gate = threading.Event()
    fut = ctx.submit_job(ctx.parallelize([0], 1),
                         lambda _tc, it: gate.wait(30), pool=pool)
    return gate, fut


@pytest.mark.parametrize("where", ["pool", "context"])
def test_reject_past_max_queued(where):
    """A pool at its bound rejects with the reference's error fields and
    posts JobRejected; the slot frees when the job settles."""
    got = {}
    for name, make in (("ref", _ref), ("port", _port)):
        kw = {"pool_max_queued": 1} if where == "context" else {}
        with make(**kw) as ctx:
            if where == "pool":
                ctx.set_pool("tenant", weight=2, max_queued=1)
            gate, first = _hold_pool(ctx, "tenant")
            time.sleep(0.05)
            with pytest.raises((JobRejectedError,
                                RefJobRejectedError)) as info:
                ctx.submit_job(ctx.parallelize([1], 1),
                               lambda _tc, it: 1, pool="tenant")
            e = info.value
            got[name] = (e.pool, e.queued, e.bound, str(e))
            gate.set()
            first.result(30)
            assert ctx.submit_job(ctx.parallelize([1], 1),
                                  lambda _tc, it: 1,
                                  pool="tenant").result(30) == [1]
            assert ctx.metrics_summary()["jobs_rejected"] == 1
    assert got["port"] == got["ref"] == (
        "tenant", 1, 1, got["ref"][3])
    assert isinstance(JobRejectedError("p", 1, 1), VegaError)


def test_block_mode_parks_the_submitter():
    """admission_mode="block": the second submission waits until the
    first job of its pool settles, then runs; nothing is rejected."""
    for make in (_ref, _port):
        with make(admission_mode="block") as ctx:
            ctx.set_pool("tenant", max_queued=1)
            gate, first = _hold_pool(ctx, "tenant")
            returned = []

            def submit():
                fut = ctx.submit_job(ctx.parallelize([2], 1),
                                     lambda _tc, it: sum(it), pool="tenant")
                returned.append(time.monotonic())
                returned.append(fut.result(30))

            t = threading.Thread(target=submit)
            t.start()
            time.sleep(0.3)
            assert returned == []  # parked at admission
            released = time.monotonic()
            gate.set()
            t.join(30)
            assert returned[0] >= released and returned[1] == [2]
            assert first.result(30) == [True]
            assert ctx.metrics_summary()["jobs_rejected"] == 0


def test_blocking_jobs_are_admitted():
    """A blocking action is one job of the thread's pool: rejected at
    its pool's bound, as the reference's (whose blocking actions are
    submitted jobs); its own nested jobs are part of it."""
    for make in (_ref, _port):
        with make() as ctx:
            ctx.set_pool("tenant", max_queued=1)
            gate, first = _hold_pool(ctx, "tenant")
            time.sleep(0.05)
            ctx.set_local_property("pool", "tenant")
            with pytest.raises(Exception, match="is full") as info:
                ctx.parallelize([1, 2], 2).count()
            assert info.value.pool == "tenant"
            ctx.set_local_property("pool", None)
            assert ctx.parallelize([1, 2], 2).count() == 2
            gate.set()
            first.result(30)
            ctx.set_local_property("pool", "tenant")
            node = ctx.parallelize([(1, 2), (1, 3)], 2).reduce_by_key(
                lambda a, b: a + b)
            assert node.collect() == [(1, 5)]


def test_unknown_admission_mode_raises():
    with pytest.raises(VegaError, match="'reject' or 'block'"):
        _port(admission_mode="drop")
    with _ref(admission_mode="drop") as ref:
        with pytest.raises(Exception, match="'reject' or 'block'"):
            ref.submit_job(ref.parallelize([1], 1), lambda _tc, it: 1)
    with pytest.raises(VegaError, match="unknown admission_mode"):
        port_jobserver.check_admission_mode("drop")


def test_admission_status_and_pool_settings():
    got = []
    for make in (_ref, _port):
        with make(pool_max_queued=3) as ctx:
            cfg = ctx.set_pool("a", weight=0, max_concurrent_tasks=2,
                               max_queued=5)
            gate, fut = _hold_pool(ctx, "a")
            st = ctx.job_server.admission_status()
            gate.set()
            fut.result(30)
            deadline = time.monotonic() + 10
            while ctx.job_server.admission_status()["pools"] and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
            got.append(((cfg.name, cfg.weight, cfg.max_concurrent_tasks,
                         cfg.max_queued), st,
                        ctx.job_server.admission_status()["pools"]))
    assert got[1] == got[0]
    assert got[1] == (("a", 1, 2, 5),
                      {"mode": "reject", "default_max_queued": 3,
                       "pools": {"a": {"in_flight": 1, "max_queued": 5}}},
                      {})


class _HeldBackend:
    """A backend that records what the arbiter dispatches and completes
    a task only when told (its callbacks kept)."""

    def __init__(self):
        self.parallelism = 1
        self.order = []
        self.callbacks = []

    def submit(self, task, callback):
        self.order.append(task.name)
        self.callbacks.append((task, callback))


class _Task:
    def __init__(self, name):
        self.name = name


class _JobOf:
    def __init__(self, job_id, pool):
        self.job_id = job_id
        self.pool = pool


def test_pool_weight_does_not_reorder_the_fifo_worker():
    """The arbiter's pick order, the reference's in both modes: four
    tasks of a weight-1 pool, then four of a weight-3 pool, wait behind
    one slot; when four slots free, "fifo" dispatches in submission order
    whatever the weights, and "fair" gives each slot to the pool of the
    smallest running / weight share, so the weight-3 pool takes three."""
    from vega_tpu.scheduler.jobserver import TaskArbiter as RefArbiter

    orders = {}
    for name, arbiter_cls in (("ref", RefArbiter),
                              ("port", port_jobserver.TaskArbiter)):
        for mode in ("fifo", "fair"):
            backend = _HeldBackend()
            arbiter = arbiter_cls(backend, mode)
            arbiter.set_pool("light", weight=1)
            arbiter.set_pool("heavy", weight=3)
            for i in range(4):
                arbiter.submit(_Task(f"L{i}"), lambda e: None,
                               _JobOf(1, "light"))
            for i in range(4):
                arbiter.submit(_Task(f"H{i}"), lambda e: None,
                               _JobOf(2, "heavy"))
            first = list(backend.order)
            backend.parallelism = 4
            task, done = backend.callbacks[0]
            done(type("E", (), {"task": task})())
            orders[(name, mode)] = (first, backend.order[1:])
    assert orders[("port", "fifo")] == orders[("ref", "fifo")] == (
        ["L0"], ["L1", "L2", "L3", "H0"])
    assert orders[("port", "fair")] == orders[("ref", "fair")] == (
        ["L0"], ["L1", "H0", "H1", "H2"])


def test_cancel_before_it_runs():
    """A job whose tasks wait in the arbiter behind another job's (one
    task slot) is cancelled before any of them runs: its result raises
    CancelledError, the first job finishes, the summary counts both."""
    got = []
    for make in (_ref, _port):
        with make(num_workers=1) as ctx:
            gate = threading.Event()
            first = ctx.submit_job(ctx.parallelize([0, 1], 2),
                                   lambda _tc, it: gate.wait(30))
            ran = []
            second = ctx.submit_job(ctx.parallelize([1, 2], 2),
                                    lambda _tc, it: ran.append(1))
            time.sleep(0.1)
            assert second.cancel("not needed")
            with pytest.raises(Exception, match="not needed"):
                second.result(30)
            gate.set()
            out = (first.result(30), second.cancelled(), ran,
                   first.cancel())
            summary = ctx.metrics_summary()
            got.append(out + (summary["jobs_cancelled"], summary["jobs"]))
    assert got[1] == got[0] == ([True, True], True, [], False, 1, 2)


class _SumEvaluator:
    """merge(index, partial sum) / current_result(): the reference's
    evaluator surface."""

    def __init__(self):
        self.total = 0
        self.merged = []

    def merge(self, index, result):
        self.merged.append(index)
        self.total += result

    def current_result(self):
        return self.total


def test_run_approximate_job_final():
    rows = _rows()
    got = []
    for make in (_ref, _port):
        with make() as ctx:
            ev = _SumEvaluator()
            res = ctx.run_approximate_job(ctx.parallelize(rows, 4),
                                          _sum_values, ev, 30.0)
            assert res.is_initial_value_final
            assert sorted(ev.merged) == [0, 1, 2, 3]
            got.append(res.get_final_value())
    assert got[0] == got[1] == sum(x for _k, x in rows)


def test_run_approximate_job_deadline_then_final():
    """The deadline passes first: the current estimate, not final; the
    final value comes when the job ends, and on_complete sees it."""
    rows = _rows()
    for make in (_ref, _port):
        with make() as ctx:
            ev = _SumEvaluator()

            def slow(tc, it):
                if tc.split_index == 3:
                    time.sleep(0.6)
                return _sum_values(tc, it)

            res = ctx.run_approximate_job(ctx.parallelize(rows, 4), slow,
                                          ev, 0.1)
            assert not res.is_initial_value_final
            assert res.initial_value != sum(x for _k, x in rows)
            finals = []
            res.on_complete(finals.append)
            assert res.get_final_value(30) == sum(x for _k, x in rows)
            assert finals == [sum(x for _k, x in rows)]


def test_run_approximate_job_failure():
    """A failed job gives a failed result: TaskError raised from the
    task's error, in both packages."""
    for make in (_ref, _port):
        with make() as ctx:
            def boom(_tc, _it):
                raise ValueError("bad partition")

            res = ctx.run_approximate_job(ctx.parallelize([1, 2], 2), boom,
                                          _SumEvaluator(), 30.0)
            assert not res.is_initial_value_final
            assert res.initial_value is None
            with pytest.raises(Exception, match="bad partition") as info:
                res.get_final_value(1)
            assert type(info.value).__name__ == "TaskError"
            assert isinstance(info.value.__cause__, ValueError)
            assert make is _ref or isinstance(info.value, TaskError)
            failures = []
            res.on_fail(failures.append)
            assert len(failures) == 1


def test_partial_result_wait_times_out():
    from vega_tpu_torch.partial import PartialResult

    res = PartialResult(3, is_final=False)
    with pytest.raises(PartialJobError):
        res.get_final_value(0.01)
    res.set_final_value(4)
    assert res.get_final_value(0.01) == 4 and res.is_initial_value_final


def test_active():
    assert vt.Context.active() is None
    with _port() as a:
        assert vt.Context.active() is a
        with _port() as b:  # the port allows several at once
            assert vt.Context.active() is b
        assert vt.Context.active() is a
    assert vt.Context.active() is None
    with _ref() as ref:
        assert type(ref).active() is ref
    assert v.Context.active() is None


def test_storage_status_keys_are_the_references():
    with _ref() as ref:
        ref_keys = {k: set(v) for k, v in ref.storage_status().items()}
    with _port() as ctx:
        st = ctx.storage_status()
        assert set(st) == set(ref_keys) == {"cache", "shuffle"}
        for k in st:
            assert set(st[k]) <= ref_keys[k], k
        spill = ctx.spill_status()
        assert {k: st["cache"][k] for k in spill} == spill


def test_metrics_summary_keys_are_the_references():
    """The port's summary keys are the reference's for what runs here,
    and the jobs, stages and tasks of the same jobs count equal."""
    rows = _rows()
    got = []
    for make in (_ref, _port):
        with make() as ctx:
            ctx.submit_job(ctx.parallelize(rows, 2), _sum_values).result(30)
            ctx.parallelize(rows, 2).reduce_by_key(lambda a, b: a + b,
                                                   3).collect()
            got.append(ctx.metrics_summary())
    want, port = got
    assert set(port) - {"exchange_plans"} <= set(want)
    assert set(port["exchange_plans"]) == set(want["exchange_plans"])
    assert set(port["streaming"]) == set(want["streaming"])
    assert set(port["fetch"]) <= set(want["fetch"])
    assert set(port["speculation"]) == set(want["speculation"])
    for key in ("jobs", "stages", "tasks", "task_failures",
                "stages_resubmitted", "jobs_rejected", "jobs_cancelled"):
        assert port[key] == want[key], key
    assert port["fetch"]["streams"] == want["fetch"]["streams"] == 3
    assert set(port["pool_latency"]) == {"default"}


def test_metrics_listener_pool_latency_equals_reference():
    walls = [0.1] * 18 + [0.9, 1.0]
    out = []
    for mod in (ref_events, port_events):
        m = mod.MetricsListener()
        for i, d in enumerate(walls):
            m.on_event(mod.JobStart(job_id=i, pool="streaming"))
            m.on_event(mod.JobEnd(job_id=i, succeeded=True, duration_s=d))
        m.on_event(mod.JobStart(job_id=99, pool="batch"))
        m.on_event(mod.JobEnd(job_id=99, succeeded=True, duration_s=0.5))
        m.on_event(mod.JobStart(job_id=100, pool="batch"))
        m.on_event(mod.JobEnd(job_id=100, succeeded=False, cancelled=True))
        js = m.job_summary(3)
        out.append((m.pool_latency(), m.summary()["pool_latency"],
                    m.jobs_cancelled, js["pool"], js["pool_p95_s"]))
    assert out[0] == out[1]
    assert out[1][0]["streaming"]["count"] == 20


def test_listener_bus_survives_a_raising_listener():
    bus = port_events.LiveListenerBus()
    seen = []

    class Bad(port_events.Listener):
        def on_event(self, event):
            raise RuntimeError("listener bug")

    class Good(port_events.Listener):
        def on_event(self, event):
            seen.append(event)

    bus.add_listener(Bad())
    bus.add_listener(Good())
    bus.post(port_events.JobRejected(pool="p"))  # not started: dropped
    bus.start()
    bus.post(port_events.JobRejected(pool="p"))
    assert bus.flush() and len(seen) == 1
    bus.stop()
    bus.post(port_events.JobRejected(pool="p"))  # stopped: dropped
    assert bus.flush() and len(seen) == 1


BAD_SETTINGS = [
    ("admission_mode", "drop", "'reject' or 'block'"),
    ("pool_max_queued", -1, "int >= 0"),
    ("stream_batch_interval_s", 0, "seconds > 0"),
    ("stream_block_max_records", 0, "int >= 1"),
    ("stream_queue_max_blocks", 0, "int >= 1"),
    ("stream_backpressure_mode", "drop", "'block' or 'shed'"),
    ("stream_pool", "", "a pool name"),
    ("stream_pool_weight", 0, "int >= 1"),
    ("stream_storage_level", "memory", "memory_and_disk"),
    ("stream_socket_timeout_s", -1.0, "seconds > 0"),
    ("stream_checkpoint_dir", None, "a path"),
]


# the local runtime's settings (env.py), held in ctx.conf
RUNTIME_BAD = [
    ("num_workers", 0, "an int >= 1"),
    ("serialize_tasks_locally", 1, "a bool"),
    ("cache_capacity_bytes", 0, "bytes >= 1"),
    ("shuffle_memory_budget", -1, "bytes >= 1"),
    ("shuffle_spill_threshold", 0, "bytes >= 1"),
    ("resubmit_timeout_s", -1, "seconds >= 0"),
    ("poll_timeout_s", 0, "seconds > 0"),
    ("max_failures", 0, "an int >= 1"),
    ("scheduler_mode", "lifo", "'fifo' or 'fair'"),
    ("task_binary_cache_entries", 0, "an int >= 1"),
    ("speculation_enabled", 1, "a bool"),
    ("speculation_multiplier", 0, "a number > 0"),
    ("speculation_min_s", -1, "seconds >= 0"),
    ("speculation_quorum", 2, "a fraction"),
    # the distributed backend's
    ("num_executors", 0, "an int >= 1 or None"),
    ("locality_wait_s", -1, "seconds >= 0"),
    ("heartbeat_interval_s", 0, "seconds > 0"),
    ("executor_liveness_timeout_s", 0, "seconds > 0"),
    ("executor_reap_interval_s", 0, "seconds > 0"),
    ("executor_max_restarts", -1, "an int >= 0"),
    ("executor_restart_backoff_s", -1, "seconds >= 0"),
    ("executor_blacklist_threshold", 0, "an int >= 1"),
    ("fetch_retries", 0, "an int >= 1"),
    ("fetch_retry_interval_s", -1, "seconds >= 0"),
    ("fetch_batch_enabled", 1, "a bool"),
    ("fetch_queue_buckets", 0, "an int >= 1"),
    ("task_binary_dedup", 1, "a bool"),
    ("shuffle_replication", 0, "an int >= 1"),
    ("fetch_slow_server_s", -1, "seconds >= 0"),
    ("decommission_timeout_s", -1, "seconds >= 0"),
    ("blacklist_decay_s", -1, "seconds >= 0"),
    ("local_dir", "", "a path"),
    ("log_level", None, "a logging level"),
    ("log_cleanup", 1, "a bool"),
]


@pytest.mark.parametrize("name,value,allowed", BAD_SETTINGS + RUNTIME_BAD,
                         ids=[b[0] for b in BAD_SETTINGS + RUNTIME_BAD])
def test_settings_are_checked(name, value, allowed):
    with pytest.raises(VegaError, match=allowed) as info:
        _port(**{name: value})
    assert name in str(info.value)


def test_distributed_backend_settings_are_not_taken():
    """task_binary_dedup, the reference's distributed backend's setting,
    is taken (checked like the rest) and reaches the executors' dispatch:
    both values give the reference's rows (the reference's
    test_task_binary_dedup_legacy_parity)."""
    with pytest.raises(VegaError, match="a bool"):
        _port(task_binary_dedup=1)
    rows = [(i % 7, i) for i in range(140)]
    want = None
    for dedup in (True, False):
        ctx = vt.Context(mode="distributed", device="cpu", n_shards=4,
                         num_executors=1, num_workers=2,
                         task_binary_dedup=dedup)
        try:
            assert ctx._backend._worker_knobs(ctx.conf)[
                "VEGA_TPU_TASK_BINARY_DEDUP"] == ("1" if dedup else "0")
            got = sorted(ctx.parallelize(rows, 8).reduce_by_key(
                lambda a, b: a + b, 4).collect())
            dispatch = ctx.metrics_summary()["dispatch"]
        finally:
            ctx.stop()
        assert dispatch["tasks_v2" if dedup else "tasks_legacy"] == 12
        assert dispatch["tasks_legacy" if dedup else "tasks_v2"] == 0
        want = want or got
        assert got == want
    ref = v.Context("local", num_workers=1, task_binary_dedup=False)
    try:
        assert sorted(ref.parallelize(rows, 8).reduce_by_key(
            lambda a, b: a + b, 4).collect()) == want
    finally:
        ref.stop()


def test_settings_defaults_are_the_references():
    from vega_tpu.env import Configuration

    conf = Configuration()
    with _port() as ctx:
        for name, _v, _a in BAD_SETTINGS:
            want = getattr(conf, name)
            assert getattr(ctx, name) == want, name
        for name, _v, _a in RUNTIME_BAD:
            if name != "num_workers":  # the reference's: the host's cores
                assert getattr(ctx.conf, name) == getattr(conf, name), name


# --- broadcast --------------------------------------------------------------


def test_broadcast_value_in_a_closure():
    got = []
    for make in (_ref, _port):
        with make() as ctx:
            table = ctx.broadcast({i: i * i for i in range(100)})
            got.append(ctx.make_rdd(list(range(10)), 2).map(
                lambda x, t=table: t.value[x]).collect())
    assert got[0] == got[1] == [i * i for i in range(10)]


def test_broadcast_survives_pickle():
    import vega_tpu.broadcast as ref_broadcast
    from vega_tpu import serialization

    for make, mod, dumps in ((_ref, ref_broadcast, serialization.dumps),
                             (_port, port_broadcast, pickle.dumps)):
        with make() as ctx:
            table = ctx.broadcast([1, 2, 3])
            clone = pickle.loads(dumps(table))
            assert clone.id == table.id
            mod._local_values.pop(table.id, None)  # as in another process
            assert clone.value == [1, 2, 3]
            assert table.value == [1, 2, 3]  # its payload, once pickled


def test_broadcast_unpersist_matches_reference():
    """Never pickled: .value after unpersist() raises TypeError in both
    (no payload); pickled first: the payload's value."""
    import vega_tpu.broadcast as ref_broadcast

    for make in (_ref, _port):
        with make() as ctx:
            b = ctx.broadcast([1, 2, 3])
            assert b.value == [1, 2, 3]
            b.unpersist()
            with pytest.raises(TypeError):
                b.value
            c = ctx.broadcast(5)
            pickle.dumps(c)
            c.unpersist()
            assert c.value == 5
            d = ctx.broadcast({"a": 1})
            e = pickle.loads(pickle.dumps(d))
            d.unpersist()
            assert e.value == {"a": 1}
    assert not hasattr(port_broadcast, "Env") and ref_broadcast is not None


def test_broadcast_ids_are_distinct():
    with _port() as ctx:
        ids = {ctx.broadcast(i).id for i in range(5)}
    assert len(ids) == 5
