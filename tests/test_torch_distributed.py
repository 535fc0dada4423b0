"""The distributed backend against the reference's: executor processes
over TCP, the shuffle servers and the remote fetch.

One fleet of each package at module scope (two executors each): every
job crosses process boundaries through the task protocol, the shuffle
servers and the driver service. Integer results are bit-identical; a
shuffle's output is compared as a sorted list, since a reduce partition
merges its buckets in arrival order in both packages' distributed modes.
Counterparts of tests/test_distributed.py:25-281 and
tests/test_distributed_config.py:29, :79, :119, :143.
"""

import glob
import operator
import os
import time

import numpy as np
import pytest

import vega_tpu as v
import vega_tpu_torch as vt
from vega_tpu.env import Env as RefEnv
from vega_tpu.errors import TaskError as RefTaskError
from vega_tpu_torch.errors import TaskError, VegaError

BUDGET = (1 << 30) + 12345


def _port(**kw):
    return vt.Context(mode="distributed", device="cpu", n_shards=8,
                      num_executors=2, num_workers=2, **kw)


def _retire_reference():
    prev = v.Context.active()
    if prev is not None:
        prev.stop()


@pytest.fixture(scope="module")
def session_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sessions")
    return str(root / "ref"), str(root / "port")


@pytest.fixture(scope="module")
def fleets(session_dirs):
    ref_dir, port_dir = session_dirs
    _retire_reference()
    # no respawns (a lost executor's slot stays empty) and a fast reaper:
    # fewer processes started beside the rest of the suite
    fleet = dict(shuffle_memory_budget=BUDGET, log_level="INFO",
                 log_cleanup=False, executor_max_restarts=0,
                 executor_reap_interval_s=0.5)
    ref = v.Context("distributed", num_workers=2, local_dir=ref_dir,
                    **fleet)
    try:
        port = _port(local_dir=port_dir, **fleet)
    except BaseException:
        ref.stop()
        raise
    yield ref, port
    port.stop()
    ref.stop()


def _both(fleets, run):
    ref, port = fleets
    return run(ref), run(port)


def test_narrow_job(fleets):
    got = _both(fleets, lambda c: c.parallelize(list(range(100)), 4)
                .map(lambda x: x * 2).collect())
    assert got[0] == got[1] and sum(got[1]) == 9900


def test_shuffle_job(fleets):
    got = _both(fleets, lambda c: sorted(
        c.parallelize([(i % 5, i) for i in range(100)], 4)
        .reduce_by_key(lambda a, b: a + b, 3).collect()))
    assert got[0] == got[1]
    assert dict(got[1]) == {k: sum(range(k, 100, 5)) for k in range(5)}


def test_join_across_processes(fleets):
    def run(c):
        a = c.parallelize([(1, "a"), (2, "b"), (3, "c")], 2)
        b = c.parallelize([(1, "x"), (2, "y")], 2)
        return sorted(a.join(b).collect())

    got = _both(fleets, run)
    assert got[0] == got[1] == [(1, ("a", "x")), (2, ("b", "y"))]


def test_remote_task_error_carries_traceback(fleets):
    def boom(x):
        raise ValueError(f"bad item {x}")

    ref, port = fleets
    with pytest.raises(RefTaskError) as rinfo:
        ref.parallelize([1, 2, 3], 2).map(boom).collect()
    with pytest.raises(TaskError) as pinfo:
        port.parallelize([1, 2, 3], 2).map(boom).collect()
    for info in (rinfo, pinfo):
        assert "bad item" in str(info.value.__cause__ or info.value)
    err = pinfo.value
    assert isinstance(err.__cause__, ValueError)
    # the executor's own traceback, naming the function that raised
    assert "boom" in err.remote_traceback
    assert "Traceback" in err.remote_traceback


def test_broadcast_across_processes(fleets):
    def run(c):
        table = c.broadcast({i: i * i for i in range(50)})
        return c.parallelize(list(range(10)), 2).map(
            lambda x: table.value[x]).collect()

    got = _both(fleets, run)
    assert got[0] == got[1] == [i * i for i in range(10)]


def test_chatty_worker_stdout_does_not_wedge(fleets):
    def noisy(x):
        print("x" * 1024)  # about 200 KB over the job
        return x

    got = _both(fleets, lambda c: sorted(
        c.parallelize(list(range(200)), 4).map(noisy).collect()))
    assert got[0] == got[1] == list(range(200))


def test_dense_rdd_crosses_process_boundary(fleets):
    """A DenseRDD read by executor tasks ships as its rows on the host (a
    _HostDenseView there); the port's dense tier here is on the CPU."""
    def run(c):
        dense = c.dense_range(1_000).map(lambda x: (x % 7, x))
        red = sorted(dense.to_rdd().map_values(lambda x: x * 2)
                     .reduce_by_key(lambda a, b: a + b, 3).collect())
        host_side = c.parallelize([(i, f"h{i}") for i in range(7)], 2)
        cg = dict(dense.cogroup(host_side).collect())
        return red, sorted(cg[2][0]), list(cg[2][1])

    got = _both(fleets, run)
    assert got[0] == got[1]
    assert dict(got[1][0]) == {
        k: sum(2 * x for x in range(k, 1_000, 7)) for k in range(7)}
    assert got[1][1] == list(range(2, 1_000, 7)) and got[1][2] == ["h2"]


def test_dense_string_ops_cross_process_boundary(fleets):
    keys = np.array([f"w{i % 11:02d}" for i in range(400)])
    vals = np.arange(400).astype(np.int32)
    dk = np.array([f"w{i:02d}" for i in range(5, 16)])
    dv = np.arange(11).astype(np.int32)

    def run(c):
        red = c.dense_from_numpy(keys, vals).reduce_by_key(
            lambda a, b: a + b)
        direct = sorted(red.collect())
        host = sorted(red.to_rdd().map_values(lambda x: x * 2)
                      .reduce_by_key(lambda a, b: a + b, 3).collect())
        joined = sorted(red.join(c.dense_from_numpy(dk, dv)).collect())
        hostj = sorted(
            c.parallelize(direct, 3)
            .join(c.parallelize(list(zip(dk.tolist(), dv.tolist())), 2))
            .collect())
        return direct, host, joined, hostj

    got = _both(fleets, run)
    assert got[0] == got[1]
    direct, host, joined, hostj = got[1]
    assert host == [(k, 2 * s) for k, s in direct]
    assert joined == hostj


def test_batched_vs_per_bucket_fetch_parity(fleets):
    """The batched get_many and the per-bucket get return the same
    buckets over real cross-process sockets: one round trip per
    (reducer, server) against one per bucket."""
    from vega_tpu.shuffle import fetcher as ref_fetcher
    from vega_tpu_torch.shuffle import fetcher as port_fetcher

    out = []
    for ctx, mod, env in ((fleets[0], ref_fetcher, RefEnv.get()),
                          (fleets[1], port_fetcher, fleets[1].env)):
        shuffled = ctx.parallelize([(i % 6, i) for i in range(120)], 6) \
            .reduce_by_key(lambda a, b: a + b, 3)
        rows = sorted(shuffled.collect())
        uris = env.map_output_tracker.get_server_uris(shuffled.shuffle_id)

        def blobs():
            if mod is ref_fetcher:
                return sorted(mod.ShuffleFetcher.fetch_blobs(
                    shuffled.shuffle_id, 0))
            return sorted(mod.ShuffleFetcher.fetch_blobs(
                env, shuffled.shuffle_id, 0))

        assert env.conf.fetch_batch_enabled
        mod.reset_stats()
        batched = blobs()
        batched_rts = mod.stats_snapshot()["round_trips"]
        env.conf.fetch_batch_enabled = False
        try:
            mod.reset_stats()
            legacy = blobs()
            legacy_rts = mod.stats_snapshot()["round_trips"]
        finally:
            env.conf.fetch_batch_enabled = True
        assert batched == legacy
        assert batched_rts == len(set(uris))
        assert legacy_rts == len(uris)
        out.append((rows, [len(b) for b in batched] != []))
    assert out[0] == out[1]


def test_task_binary_dedup_legacy_parity(fleets):
    """task_binary_dedup reaches the executors' dispatch: the task_v2
    protocol and the legacy one-envelope-per-task protocol give equal
    results; task_v2 ships the lineage fewer times than it runs tasks."""
    results, deltas = [], []
    for ctx in fleets:
        conf = ctx.conf

        def job(ctx=ctx):
            pairs = ctx.parallelize([(i % 7, i) for i in range(140)], 8)
            return sorted(pairs.reduce_by_key(lambda a, b: a + b,
                                              4).collect())

        def delta(run, ctx=ctx):
            before = ctx.metrics_summary()["dispatch"]
            got = run()
            after = ctx.metrics_summary()["dispatch"]
            return got, {k: after[k] - before.get(k, 0) for k in after}

        assert conf.task_binary_dedup
        dedup_result, dedup = delta(job)
        conf.task_binary_dedup = False
        try:
            legacy_result, legacy = delta(job)
        finally:
            conf.task_binary_dedup = True
        assert dedup_result == legacy_result
        assert dedup["tasks_v2"] == 12 and dedup["tasks_legacy"] == 0
        assert legacy["tasks_legacy"] == 12 and legacy["tasks_v2"] == 0
        assert 1 <= dedup["binaries_shipped"] < dedup["tasks_v2"]
        assert dedup["binary_cache_hits"] >= 1
        assert legacy["legacy_task_bytes"] > 0
        assert legacy["binaries_shipped"] == 0
        assert dedup["driver_serialized_bytes"] < \
            legacy["driver_serialized_bytes"]
        results.append(dedup_result)
        deltas.append(sorted(dedup))
    assert results[0] == results[1]
    assert deltas[0] == deltas[1]  # the same dispatch counters


def test_oob_result_buffers_cross_process_writable(fleets):
    def to_array(idx, it):
        return [np.asarray(list(it), dtype=np.int64) * (idx + 1)]

    for ctx in fleets:
        got = (ctx.parallelize(list(range(40)), 4)
               .map_partitions_with_index(to_array).collect())
        arrays = sorted(got, key=lambda a: a[0])
        assert len(arrays) == 4
        expected = np.arange(10, dtype=np.int64)
        for idx, arr in enumerate(arrays):
            np.testing.assert_array_equal(
                arr, (expected + 10 * idx) * (idx + 1))
        arrays[0][0] = 123  # writable
        assert arrays[0][0] == 123


def test_disk_resident_shuffle_bucket_served(fleets):
    from vega_tpu.distributed import shuffle_server as ref_ss
    from vega_tpu_torch.distributed import shuffle_server as port_ss

    out = []
    for ctx, mod, env in ((fleets[0], ref_ss, RefEnv.get()),
                          (fleets[1], port_ss, fleets[1].env)):
        shuffled = ctx.parallelize([(i % 4, i) for i in range(40)], 4) \
            .reduce_by_key(lambda a, b: a + b, 4)
        first = sorted(shuffled.collect())
        uris = env.map_output_tracker.get_server_uris(shuffled.shuffle_id)
        spilled = sum(mod.request_spill(u)["spilled"] for u in set(uris))
        assert spilled > 0
        statuses = [mod.check_status(u) for u in set(uris)]
        assert all(s["mem_entries"] == 0 for s in statuses)
        assert sum(s["disk_entries"] for s in statuses) >= spilled
        assert mod.fetch_remote(uris[0], shuffled.shuffle_id, 0, 0)
        assert sorted(shuffled.collect()) == first
        out.append(first)
    assert out[0] == out[1]


def test_cache_locality_lands_tasks_on_cached_executor(fleets):
    """A cached partition's next task runs on the executor holding it,
    scored PROCESS_LOCAL."""
    from vega_tpu.scheduler import events as ref_ev
    from vega_tpu_torch.scheduler import events as port_ev

    for ctx, ev, tracker in (
            (fleets[0], ref_ev, RefEnv.get().cache_tracker),
            (fleets[1], port_ev, fleets[1].env.cache_tracker)):
        rdd = ctx.parallelize(list(range(64)), 4).map(lambda x: x * 3)
        rdd.cache()
        expected = sorted(3 * x for x in range(64))
        assert sorted(rdd.collect()) == expected
        cache_locs = {p: tracker.get_cache_locs(rdd.rdd_id, p)
                      for p in range(4)}
        assert all(cache_locs[p] for p in range(4)), cache_locs
        ctx.bus.flush()
        ends = []

        class _Cap(ev.Listener):
            def on_event(self, event):
                if isinstance(event, ev.TaskEnd) and event.success:
                    ends.append(event)

        ctx.bus.add_listener(_Cap())
        assert sorted(rdd.collect()) == expected
        ctx.bus.flush()
        by_partition = {e.partition: e for e in ends}
        assert set(by_partition) == {0, 1, 2, 3}
        for p, event in by_partition.items():
            assert event.executor in cache_locs[p]
            assert event.locality == "process"


def test_metrics_summary_executor_locality_dispatch_keys(fleets):
    """metrics_summary() holds the reference's executor, locality and
    dispatch keys, with the same counts for the same distributed job."""
    got = []
    for ctx in fleets:
        before = ctx.metrics_summary()
        ctx.parallelize([(i % 3, i) for i in range(60)], 4) \
            .reduce_by_key(operator.add, 2).collect()
        after = ctx.metrics_summary()
        got.append((before, after))
    (rb, ra), (pb, pa) = got
    for key in ("executors_lost", "executors_restarted"):
        assert key in pa and isinstance(pa[key], int)
        assert pa[key] - pb[key] == ra[key] - rb[key] == 0
    assert set(pa["locality"]) == set(ra["locality"])
    assert set(pa["dispatch"]) == set(ra["dispatch"])
    for key in ("tasks_v2", "tasks_legacy"):
        assert pa["dispatch"][key] - pb["dispatch"][key] == \
            ra["dispatch"][key] - rb["dispatch"][key]
    assert sum(pa["locality"].values()) - sum(pb["locality"].values()) == \
        sum(ra["locality"].values()) - sum(rb["locality"].values()) == 6


def test_executor_session_logs(fleets, session_dirs):
    """Executors write session log files at the driver's level, under
    local_dir, kept with log_cleanup False."""
    for d in session_dirs:
        assert len(glob.glob(os.path.join(d, "session-*",
                                          "executor-*.log"))) >= 2
        assert glob.glob(os.path.join(d, "session-*", "driver.log"))


def test_fault_tolerance_knobs_from_environ():
    from vega_tpu.env import Configuration as RefConfiguration
    from vega_tpu_torch.env import Configuration

    environ = {
        "VEGA_TPU_HEARTBEAT_INTERVAL_S": "0.5",
        "VEGA_TPU_EXECUTOR_LIVENESS_TIMEOUT_S": "7.5",
        "VEGA_TPU_EXECUTOR_REAP_INTERVAL_S": "1.25",
        "VEGA_TPU_EXECUTOR_MAX_RESTARTS": "9",
        "VEGA_TPU_EXECUTOR_RESTART_BACKOFF_S": "0.75",
        "VEGA_TPU_EXECUTOR_BLACKLIST_THRESHOLD": "11",
        "VEGA_TPU_FETCH_RETRIES": "6",
        "VEGA_TPU_FETCH_RETRY_INTERVAL_S": "0.125",
    }
    names = [k[len("VEGA_TPU_"):].lower() for k in environ]
    ref = RefConfiguration.from_environ(environ)
    port = Configuration.from_environ(environ)
    assert [getattr(port, n) for n in names] == \
        [getattr(ref, n) for n in names] == \
        [0.5, 7.5, 1.25, 9, 0.75, 11, 6, 0.125]
    default = Configuration()
    assert default.heartbeat_interval_s * 3 <= \
        default.executor_liveness_timeout_s
    for n in names:
        assert getattr(default, n) == getattr(RefConfiguration(), n), n


def test_worker_knob_propagation_single_source():
    from vega_tpu_torch.distributed.backend import DistributedBackend
    from vega_tpu_torch.env import Configuration

    cfg = Configuration(shuffle_memory_budget=123456789,
                        fetch_slow_server_s=2.5, task_binary_dedup=False)
    knobs = DistributedBackend._worker_knobs(cfg)
    assert knobs["VEGA_TPU_SHUFFLE_MEMORY_BUDGET"] == "123456789"
    assert knobs["VEGA_TPU_FETCH_SLOW_SERVER_S"] == "2.5"
    assert knobs["VEGA_TPU_TASK_BINARY_DEDUP"] == "0"
    for name in knobs:
        assert hasattr(cfg, name[len("VEGA_TPU_"):].lower()), name
    # and every knob round-trips through the executor's from_environ
    back = Configuration.from_environ(knobs)
    for name in knobs:
        field = name[len("VEGA_TPU_"):].lower()
        if field != "deployment_mode":
            assert getattr(back, field) == getattr(cfg, field), field


def test_worker_ping_and_budget_override_reach_executor(fleets):
    from vega_tpu.distributed import protocol as ref_protocol
    from vega_tpu_torch.distributed import protocol as port_protocol

    def read_budget_ref(_):
        from vega_tpu.env import Env

        return Env.get().conf.shuffle_memory_budget

    def read_budget_port(_):
        from vega_tpu_torch.context import _stub_context

        return _stub_context.env.conf.shuffle_memory_budget

    for ctx, protocol, read in ((fleets[0], ref_protocol, read_budget_ref),
                                (fleets[1], port_protocol,
                                 read_budget_port)):
        ex = next(iter(ctx._backend._executors.values()))
        host, port = protocol.parse_uri(ex.task_uri)
        assert protocol.request(host, port, "ping") == ex.executor_id
        # two partitions: a one-partition job would run on the driver
        assert ctx.parallelize([0, 1], 2).map(read).collect() == \
            [BUDGET, BUDGET]


def test_executor_fleet_holds_no_card_and_no_jax(fleets):
    """An executor imports neither jax nor vega_tpu nor cloudpickle, and
    never initializes CUDA."""
    def report(_it):
        import sys

        import torch

        mods = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "vega_tpu",
                                             "cloudpickle"))
        return [(mods, torch.cuda.is_initialized(),
                 os.environ.get("CUDA_VISIBLE_DEVICES"))]

    got = fleets[1].parallelize(list(range(4)), 4) \
        .map_partitions(report).collect()
    assert got == [([], False, "")] * 4


def test_fleet_shape_methods_equal_the_references(fleets):
    """The backend's fleet methods (for the elastic plane, ROADMAP queue
    1 item 10): claim_decommission's answers, a slot added (ExecutorAdded,
    the fleet one larger) and removed, declare_lost (ExecutorLost)."""
    out = []
    for ctx in fleets:
        backend = ctx._backend
        ids = sorted(backend._executors)
        answers = [backend.claim_decommission("exec-99"),
                   backend.claim_decommission(ids[0], min_live=2),
                   backend.claim_decommission(ids[0]),
                   backend.claim_decommission(ids[0])]
        backend.release_decommission(ids[0])
        before = ctx.metrics_summary()
        wid = backend.add_executor()
        grown = len([r for r in backend.fleet_snapshot() if r["alive"]])
        assert ctx.parallelize(list(range(40)), 8).map(
            lambda x: x + 1).count() == 40
        backend.remove_executor(wid)
        backend.declare_lost(wid, "already removed")
        ctx.bus.flush()
        after = ctx.metrics_summary()
        lost = after["executors_lost"] - before["executors_lost"]
        out.append((answers, grown, wid not in backend._executors, lost,
                    sorted(backend._executors) == ids))
    assert out[0] == out[1] == (["unknown", "floor", "ok", "claimed"], 3,
                                True, 0, True)


def test_executor_loss_recovery(fleets):
    """Kill an executor whose map outputs are registered: once the reaper
    declares it lost (ExecutorLost), the next job over the shuffle
    resubmits the map stage and gives the same rows; new work still runs.
    (Declared during the job instead, in both packages a reduce task can
    wait out get_server_uri_lists' 60 s for outputs whose map tasks queue
    behind it.)"""
    out = []
    for ctx in fleets:
        shuffled = ctx.parallelize([(i % 4, 1) for i in range(40)], 4) \
            .reduce_by_key(lambda a, b: a + b, 4)
        first = sorted(shuffled.collect())
        before = ctx.metrics_summary()
        lost = before["executors_lost"]
        victim = next(iter(ctx._backend._executors.values()))
        victim.process.kill()
        victim.process.wait()
        deadline = time.time() + 30.0
        while ctx.metrics_summary()["executors_lost"] == lost and \
                time.time() < deadline:
            time.sleep(0.1)
        second = sorted(shuffled.collect())
        n = ctx.parallelize(list(range(20)), 4).map(lambda x: x + 1).count()
        after = ctx.metrics_summary()
        out.append((first, second, n,
                    after["executors_lost"] - before["executors_lost"],
                    after["stages_resubmitted"]
                    - before["stages_resubmitted"]))
    assert out[0] == out[1]
    assert out[1][:4] == ([(k, 10) for k in range(4)],
                          [(k, 10) for k in range(4)], 20, 1)


def test_distributed_settings_refused_until_their_item(monkeypatch):
    """Queue 1 items 7-11 have landed: their settings are taken and
    checked (a bad value raises VegaError naming what it takes), the
    fault fields arm; mode is checked, and multihost with
    mode="distributed" still raises naming item 12."""
    from vega_tpu_torch import faults

    try:
        assert faults.configure(kill_after_tasks=1).kill_after_tasks == 1
        monkeypatch.setenv("VEGA_TPU_FAULT_KILL_AFTER_TASKS", "3")
        faults.reset()
        assert faults.get().kill_after_tasks == 3
    finally:
        monkeypatch.delenv("VEGA_TPU_FAULT_KILL_AFTER_TASKS")
        faults.reset()
    cases = [("shuffle_plan", "sideways", "'pull' or 'push'"),
             ("shuffle_coding", "lrc", "shuffle_coding"),
             ("hosts_file", "", "a path or None"),
             ("elastic_enabled", 1, "a bool")]
    for name, value, takes in cases:
        with pytest.raises(VegaError, match=takes):
            vt.Context(device="cpu", mode="distributed", **{name: value})
    with pytest.raises(VegaError, match="'local' or 'distributed'"):
        vt.Context(device="cpu", mode="cluster")
    with pytest.raises(VegaError, match="multihost.*item 12"):
        vt.Context(device="cpu", mode="distributed",
                   multihost=dict(coordinator="127.0.0.1:1",
                                  num_processes=2, process_id=0))
    with vt.Context(device="cpu", n_shards=2, shuffle_plan="push",
                    shuffle_coding="rs(4,2)", elastic_enabled=True) as ctx:
        assert (ctx.conf.shuffle_plan, ctx.conf.shuffle_coding) == \
            ("push", "rs(4,2)")
        assert ctx.fleet_status()["fleet"] == []


def test_hash_key_fall_through_is_per_process_as_the_references():
    """partitioner.hash_key is stable across processes for ints, floats,
    strings, bytes and tuples of them; any other key (a frozenset of
    strings here) falls through to Python's salted hash(), in both
    packages alike: its partition differs between executor processes of
    different hash seeds (pinned, not fixed: the reference's behavior)."""
    import subprocess
    import sys

    script = ("from vega_tpu_torch.partitioner import hash_key as p; "
              "from vega_tpu.partitioner import hash_key as r; "
              "k = frozenset({'a', 'b', 'c'}); "
              "print(p(k), r(k), p('abc') == r('abc'), p((1, 'x', 2.5)) "
              "== r((1, 'x', 2.5)))")
    out = []
    for seed in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=seed, JAX_PLATFORMS="cpu")
        res = subprocess.run([sys.executable, "-c", script], env=env,
                             capture_output=True, text=True, timeout=120,
                             check=False)
        assert res.returncode == 0, res.stderr[-2000:]
        out.append(res.stdout.split())
    for port_h, ref_h, str_eq, tup_eq in out:
        assert port_h == ref_h and str_eq == tup_eq == "True"
    assert out[0][0] != out[1][0]


def test_apply_decommission_rebinds_and_resubmits():
    """A drained executor's server leaves every map stage's outputs: a
    rebound output takes the survivor's uri in place, the others are
    removed, and a running job reading a lost shuffle marks its stage
    failed (the reference's apply_decommission)."""
    from vega_tpu_torch.scheduler.dag import _Job

    with vt.Context(device="cpu", n_shards=2, num_workers=1) as ctx:
        node = ctx.parallelize([(i % 3, i) for i in range(12)], 3) \
            .reduce_by_key(operator.add, 2)
        node.collect()
        sched = ctx.scheduler
        stage = sched._shuffle_to_map_stage[node.shuffle_id]
        stage.output_locs = [["a:1", "b:1"], ["a:1"], ["c:1"]]
        job = _Job(node, None, [0, 1])
        sched._running_jobs[job.job_id] = job
        try:
            sched.apply_decommission("a:1", {(node.shuffle_id, 0): "d:1"},
                                     {(node.shuffle_id, 1)})
        finally:
            sched._running_jobs.pop(job.job_id)
        assert stage.output_locs == [["d:1", "b:1"], [], ["c:1"]]
        assert stage in job.failed and node.shuffle_id in \
            job.lineage_shuffle_ids
