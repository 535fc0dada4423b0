"""The executors' fault hooks of vega_tpu_torch (faults.py, the
VEGA_TPU_FAULT_* variables) and the recoveries they drive, against
vega_tpu's, on the CPU.

The injector reads the variables as the reference's does (each field,
the executor filter, the incarnation that disarms a respawned executor,
read_stats). The server hooks run against an in-process ShuffleServer.
Then each scenario spawns a fleet of the port with its variables set
(they reach the executors through the backend's environment) and runs a
job whose rows must equal the reference's (its local runtime's rows of
the same job): a SIGKILLed executor, a wedged one, dropped fetches, a
get_many stream cut part-way, corrupt spilled buckets, a dropped cached
binary, a push cut before its ack, a parity server killed mid-stream, a
corrupt parity frame, and a decommission whose drain hangs.
Counterparts of tests/test_chaos.py (29 tests); the reference's
counters read by the tests are the port's own (worker_stats,
metrics_summary).
"""

import operator
import os
import threading
import time

import pytest

import vega_tpu as v
from vega_tpu import faults as ref_faults
import vega_tpu_torch as vt
from vega_tpu_torch import faults
from vega_tpu_torch.distributed.shuffle_server import (
    ShuffleServer, check_status, fetch_many_remote, fetch_remote,
    push_merged_remote)
from vega_tpu_torch.errors import (FetchFailedError, NetworkError,
                                   TaskCancelledError)
from vega_tpu_torch.shuffle.store import ShuffleStore

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _fresh_injector():
    faults.reset()
    ref_faults.reset()
    yield
    faults.reset()
    ref_faults.reset()
    faults.set_executor_id(None)


def _reduce_rows(ctx, n=200, keys=5, parts=8, reducers=4):
    return sorted(ctx.parallelize([(i % keys, i) for i in range(n)], parts)
                  .reduce_by_key(operator.add, reducers).collect())


@pytest.fixture(scope="module")
def ref_rows():
    """The reference's rows of each job of this file (its local
    runtime)."""
    prev = v.Context.active()
    if prev is not None:
        prev.stop()
    with v.Context("local", num_workers=2) as ref:
        return {"reduce": _reduce_rows(ref),
                "reduce4": _reduce_rows(ref, n=120, keys=4, parts=4),
                "map": ref.parallelize(list(range(80)), 4)
                .map(lambda x: x + 1).collect()}


def _chaos(monkeypatch, tmp_path, variables, **overrides):
    """A port fleet with fault-tolerance settings tight enough that reap,
    respawn and retry land in seconds, spawned with variables set."""
    for name, value in variables.items():
        monkeypatch.setenv("VEGA_TPU_FAULT_" + name, str(value))
    if variables:
        monkeypatch.setenv("VEGA_TPU_FAULT_STATS_DIR",
                           str(tmp_path / "stats"))
    faults.reset()
    kw = dict(num_workers=2, num_executors=2, heartbeat_interval_s=0.2,
              executor_liveness_timeout_s=1.5, executor_reap_interval_s=0.3,
              executor_restart_backoff_s=0.1, executor_max_restarts=2,
              resubmit_timeout_s=0.2, fetch_retries=4,
              fetch_retry_interval_s=0.05)
    kw.update(overrides)
    return vt.Context(mode="distributed", device="cpu", n_shards=2, **kw)


def _fired(tmp_path, kind):
    return [s for s in faults.read_stats(str(tmp_path / "stats"))
            if s["fault"] == kind]


def _wait_metric(ctx, key, minimum, timeout_s=20.0):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if ctx.metrics_summary().get(key, 0) >= minimum:
            return True
        time.sleep(0.2)
    return False


# --- the injector (tests/test_chaos.py:500 and faults.py) --------------------

ENVIRON = {
    "VEGA_TPU_FAULT_EXECUTOR": "exec-3",
    "VEGA_TPU_FAULT_KILL_AFTER_TASKS": "4",
    "VEGA_TPU_FAULT_HANG_TASKS": "1",
    "VEGA_TPU_FAULT_SLOW_TASKS": "2",
    "VEGA_TPU_FAULT_SLOW_TASK_S": "0.5",
    "VEGA_TPU_FAULT_SUPPRESS_HEARTBEATS": "true",
    "VEGA_TPU_FAULT_FETCH_DROP_N": "3",
    "VEGA_TPU_FAULT_FETCH_DELAY_S": "0.25",
    "VEGA_TPU_FAULT_FETCH_STREAM_DROP_N": "2",
    "VEGA_TPU_FAULT_FETCH_DROP_AFTER_BUCKETS": "5",
    "VEGA_TPU_FAULT_MERGED_DELAY_S": "0.1",
    "VEGA_TPU_FAULT_PUSH_DROP_N": "1",
    "VEGA_TPU_FAULT_DECOMMISSION_HANG_S": "7",
    "VEGA_TPU_FAULT_RECEIVER_CRASH_AFTER_BLOCKS": "9",
    "VEGA_TPU_FAULT_CORRUPT_SPILL_N": "1",
    "VEGA_TPU_FAULT_PARITY_CORRUPT_N": "2",
    "VEGA_TPU_FAULT_DROP_BINARY_N": "6",
    "VEGA_TPU_FAULT_STATS_DIR": "/nonexistent/stats",
}
FIELDS = ("executor_filter", "kill_after_tasks", "hang_tasks", "slow_tasks",
          "slow_task_s", "suppress_heartbeats", "fetch_drop_n",
          "fetch_delay_s", "fetch_stream_drop_n", "fetch_drop_after_buckets",
          "push_drop_n", "merged_delay_s", "corrupt_spill_n",
          "parity_corrupt_n", "receiver_crash_after_blocks", "drop_binary_n",
          "decommission_hang_s", "stats_dir", "active")


@pytest.mark.parametrize("incarnation,all_incarnations",
                         [(None, None), ("0", None), ("1", None),
                          ("2", "1"), ("1", "0")])
def test_environ_parsing_equals_the_references(incarnation,
                                               all_incarnations):
    environ = dict(ENVIRON)
    if incarnation is not None:
        environ["VEGA_TPU_FAULT_INCARNATION"] = incarnation
    if all_incarnations is not None:
        environ["VEGA_TPU_FAULT_ALL_INCARNATIONS"] = all_incarnations
    port = faults.FaultInjector(environ)
    ref = ref_faults.FaultInjector(environ)
    got = [getattr(port, f) for f in FIELDS]
    assert got == [getattr(ref, f) for f in FIELDS]
    armed = incarnation in (None, "0") or all_incarnations == "1"
    assert port.kill_after_tasks == (4 if armed else 0)


def test_bad_values_read_as_unset():
    environ = {"VEGA_TPU_FAULT_KILL_AFTER_TASKS": "many",
               "VEGA_TPU_FAULT_FETCH_DELAY_S": "soon"}
    port = faults.FaultInjector(environ)
    assert (port.kill_after_tasks, port.fetch_delay_s, port.active) == \
        (0, 0.0, False)


def test_executor_filter_targets_one_executor():
    inj = faults.configure(fetch_drop_n=1, executor_filter="exec-1")
    faults.set_executor_id("exec-0")
    assert inj.serve_fetch() is False
    faults.set_executor_id("exec-1")
    assert inj.serve_fetch() is True
    assert inj.serve_fetch() is False  # counted down


def test_slow_task_fault_deterministic_and_cancel_aware(tmp_path):
    inj = faults.configure(slow_tasks=1, slow_task_s=5.0,
                           stats_dir=str(tmp_path / "stats"))
    cancel = threading.Event()
    threading.Timer(0.2, cancel.set).start()
    t0 = time.monotonic()
    with pytest.raises(TaskCancelledError):
        inj.maybe_slow_task(cancel)
    assert time.monotonic() - t0 < 2.0
    assert inj.slow_tasks == 0
    t0 = time.monotonic()
    inj.maybe_slow_task(threading.Event())  # budget spent: no sleep
    assert time.monotonic() - t0 < 0.5
    assert [s["fault"] for s in faults.read_stats(str(tmp_path / "stats"))] \
        == ["slow_task"]


def test_read_stats_across_processes(tmp_path):
    d = str(tmp_path / "stats")
    for pid, kind in ((11, "kill_worker"), (12, "fetch_drop")):
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"faults-{pid}.jsonl"), "a") as f:
            f.write('{"fault": "%s", "pid": %d}\n' % (kind, pid))
    with open(os.path.join(d, "other.txt"), "w") as f:
        f.write("not a stats file\n")
    got = faults.read_stats(d)
    assert got == ref_faults.read_stats(d) == [
        {"fault": "kill_worker", "pid": 11}, {"fault": "fetch_drop",
                                              "pid": 12}]
    assert faults.read_stats(str(tmp_path / "absent")) == []


def test_decommission_hang_targets_the_victim():
    inj = faults.configure(decommission_hang_s=3.0, executor_filter="exec-2")
    assert inj.decommission_hang("exec-1") == 0.0
    assert inj.decommission_hang("exec-2") == 3.0


# --- the server hooks, in process --------------------------------------------


@pytest.fixture()
def server(tmp_path):
    store = ShuffleStore(spill_dir=str(tmp_path / "spill"))
    for m in range(6):
        store.put(0, m, 0, bytes([m]) * (100 + m))
    srv = ShuffleServer(store)
    yield srv, store
    srv.stop()
    store.close()


def test_served_get_drop_retries_in_place(server, tmp_path):
    srv, _store = server
    faults.configure(fetch_drop_n=2, stats_dir=str(tmp_path / "stats"))
    assert fetch_remote(srv.uri, 0, 3, 0) == bytes([3]) * 103
    assert len(_fired(tmp_path, "fetch_drop")) == 2


def test_get_many_cut_mid_stream_delivers_each_bucket_once(server,
                                                           tmp_path):
    srv, _store = server
    faults.configure(fetch_stream_drop_n=1, fetch_drop_after_buckets=2,
                     stats_dir=str(tmp_path / "stats"))
    got = []
    rts = fetch_many_remote(srv.uri, 0, list(range(6)), 0,
                            lambda m, d: got.append((m, d)))
    assert [m for m, _ in got] == list(range(6)) and rts == 2
    assert [c["bucket_index"] for c in _fired(tmp_path,
                                              "fetch_stream_drop")] == [2]


def test_push_cut_before_its_ack_fails_the_push(server, tmp_path):
    srv, _store = server
    faults.configure(push_drop_n=1, stats_dir=str(tmp_path / "stats"))
    blob = b"VN01\x01" + (5).to_bytes(8, "little") * 2
    with pytest.raises(NetworkError):
        push_merged_remote(srv.uri, 1, 0, 0, "add", [(0, blob)],
                           deadline_s=2.0)
    # the payload was consumed but never fed: a replay merges once
    assert push_merged_remote(srv.uri, 1, 0, 0, "add", [(0, blob)]) == \
        {"merged": 1, "stored": 0, "duplicate": 0}
    assert push_merged_remote(srv.uri, 1, 0, 1, "add", [(0, blob)]) == \
        {"merged": 0, "stored": 0, "duplicate": 1}
    assert _fired(tmp_path, "push_drop")


def test_missing_bucket_escalates_without_retries(server):
    srv, _store = server
    with pytest.raises(FetchFailedError, match="no such bucket"):
        fetch_remote(srv.uri, 0, 99, 0)
    status = check_status(srv.uri)
    assert status["entries"] == 6 and "premerge" in status


# --- scenarios over a fleet of the port --------------------------------------


def test_sigkill_worker_mid_job_results_identical(monkeypatch, tmp_path,
                                                  ref_rows):
    ctx = _chaos(monkeypatch, tmp_path,
                 {"KILL_AFTER_TASKS": 2, "EXECUTOR": "exec-0"})
    try:
        assert _reduce_rows(ctx) == ref_rows["reduce"]
        assert _fired(tmp_path, "kill_worker")
        assert _wait_metric(ctx, "executors_lost", 1)
        assert _wait_metric(ctx, "executors_restarted", 1)
        # the respawned incarnation is disarmed and takes work again
        assert _reduce_rows(ctx) == ref_rows["reduce"]
        assert len(_fired(tmp_path, "kill_worker")) == 1
    finally:
        ctx.stop()


def test_wedged_worker_is_reaped_and_tasks_redispatched(monkeypatch,
                                                        tmp_path, ref_rows):
    ctx = _chaos(monkeypatch, tmp_path,
                 {"SUPPRESS_HEARTBEATS": 1, "HANG_TASKS": 1,
                  "EXECUTOR": "exec-0"}, executor_max_restarts=0)
    try:
        t0 = time.time()
        got = ctx.parallelize(list(range(80)), 4).map(lambda x: x + 1) \
            .collect()
        assert got == ref_rows["map"]
        assert time.time() - t0 < 30.0
        assert ctx.metrics_summary()["executors_lost"] >= 1
        assert _fired(tmp_path, "hang_task")
        assert ctx.parallelize(list(range(20)), 4).count() == 20
    finally:
        ctx.stop()


def test_dropped_fetches_and_cut_streams_recover_in_place(monkeypatch,
                                                          tmp_path,
                                                          ref_rows):
    ctx = _chaos(monkeypatch, tmp_path,
                 {"FETCH_DROP_N": 2, "FETCH_STREAM_DROP_N": 2,
                  "FETCH_DROP_AFTER_BUCKETS": 1})
    try:
        assert _reduce_rows(ctx) == ref_rows["reduce"]
        assert _fired(tmp_path, "fetch_drop")
        cuts = _fired(tmp_path, "fetch_stream_drop")
        assert cuts and all(c["bucket_index"] >= 1 for c in cuts)
        summary = ctx.metrics_summary()
        assert (summary["stages_resubmitted"], summary["executors_lost"]) \
            == (0, 0)
    finally:
        ctx.stop()


def test_corrupt_disk_bucket_reads_as_missing_then_stage_retry(
        monkeypatch, tmp_path, ref_rows):
    monkeypatch.setenv("VEGA_TPU_SHUFFLE_SPILL_THRESHOLD", "1")
    ctx = _chaos(monkeypatch, tmp_path, {"CORRUPT_SPILL_N": 1},
                 shuffle_spill_threshold=1)
    try:
        assert _reduce_rows(ctx, n=120, keys=4, parts=4) == \
            ref_rows["reduce4"]
        assert _fired(tmp_path, "corrupt_spill")
        assert ctx.metrics_summary()["stages_resubmitted"] >= 1
        statuses = [check_status(info["shuffle_uri"]) for info in
                    ctx._backend.service.workers.values()]
        assert sum(s["read_errors"] for s in statuses if s) >= 1
    finally:
        ctx.stop()


def test_drop_binary_fault_recovers_in_place(monkeypatch, tmp_path,
                                             ref_rows):
    ctx = _chaos(monkeypatch, tmp_path, {"DROP_BINARY_N": 2})
    try:
        assert _reduce_rows(ctx) == ref_rows["reduce"]
        assert _fired(tmp_path, "drop_binary")
        summary = ctx.metrics_summary()
        assert summary["dispatch"]["need_binary"] >= 1
        assert summary["stages_resubmitted"] == 0
    finally:
        ctx.stop()


def test_push_plan_server_drop_mid_push_recovers(monkeypatch, tmp_path,
                                                 ref_rows):
    ctx = _chaos(monkeypatch, tmp_path, {"PUSH_DROP_N": 2},
                 shuffle_plan="push")
    try:
        assert _reduce_rows(ctx) == ref_rows["reduce"]
        assert _fired(tmp_path, "push_drop")
        stats = ctx._backend.worker_stats().values()
        assert sum(s["push"]["failed"] for s in stats) >= 1
        assert sum(s["fetch"]["premerged"] for s in stats) >= 1
        summary = ctx.metrics_summary()
        assert (summary["stages_resubmitted"], summary["executors_lost"]) \
            == (0, 0)
    finally:
        ctx.stop()


def test_parity_server_sigkilled_midstream_reconstructs(monkeypatch,
                                                        tmp_path, ref_rows):
    """The reducers are parked on exec-0's slowed serves when it is
    SIGKILLed: its buckets come back decoded from parity with no stage
    resubmitted and no replica read."""
    ctx = _chaos(monkeypatch, tmp_path,
                 {"FETCH_DELAY_S": 0.8, "EXECUTOR": "exec-0"},
                 num_executors=3, shuffle_coding="xor",
                 executor_max_restarts=0)
    try:
        pairs = ctx.parallelize([(i % 5, i) for i in range(200)], 8)
        future = pairs.reduce_by_key(operator.add, 4).collect_async()
        tracker = ctx.env.map_output_tracker
        deadline = time.time() + 30.0
        while time.time() < deadline:
            sids = list(tracker._outputs)
            if sids and any(tracker.has_outputs(s) for s in sids):
                break
            time.sleep(0.05)
        else:
            pytest.fail("map outputs never registered")
        time.sleep(0.4)
        ctx._backend._executors["exec-0"].process.kill()
        assert sorted(future.result(60.0)) == ref_rows["reduce"]
        assert _wait_metric(ctx, "executors_lost", 1)
        stats = list(ctx._backend.worker_stats().values())
        assert sum(s["fetch"]["coded_failovers"] for s in stats) >= 1
        assert sum(s["fetch"]["parity_decodes"] for s in stats) >= 1
        assert all(s["fetch"]["failovers"] == 0 for s in stats)
        assert ctx.metrics_summary()["stages_resubmitted"] == 0
    finally:
        ctx.stop()


def test_corrupt_parity_degrades_ladder_bit_identical(monkeypatch,
                                                      tmp_path, ref_rows):
    ctx = _chaos(monkeypatch, tmp_path, {"PARITY_CORRUPT_N": 1},
                 shuffle_coding="xor", executor_max_restarts=0)
    try:
        shuffled = ctx.parallelize([(i % 4, i) for i in range(120)], 4) \
            .reduce_by_key(operator.add, 4)
        assert sorted(shuffled.collect()) == ref_rows["reduce4"]
        ctx._backend._executors["exec-0"].process.kill()
        assert _wait_metric(ctx, "executors_lost", 1)
        assert sorted(shuffled.collect()) == ref_rows["reduce4"]
        assert _fired(tmp_path, "parity_corrupt")
        assert ctx.metrics_summary()["stages_resubmitted"] >= 1
    finally:
        ctx.stop()


def test_decommission_hang_escalates_to_executor_lost(monkeypatch,
                                                      tmp_path, ref_rows):
    """The driver-side hook wedges exec-0's drain past
    decommission_timeout_s: the decommission escalates to the
    executor-lost path in seconds, and the replicas keep the shuffle
    whole."""
    ctx = _chaos(monkeypatch, tmp_path,
                 {"DECOMMISSION_HANG_S": 30, "EXECUTOR": "exec-0"},
                 shuffle_replication=2, decommission_timeout_s=1.0)
    try:
        shuffled = ctx.parallelize([(i % 4, i) for i in range(120)], 4) \
            .reduce_by_key(operator.add, 4)
        assert sorted(shuffled.collect()) == ref_rows["reduce4"]
        t0 = time.time()
        result = ctx.elastic.decommission("exec-0", reason="chaos")
        assert result["forced"] and time.time() - t0 < 15.0
        assert _fired(tmp_path, "decommission_hang")
        summary = ctx.metrics_summary()
        assert summary["executors_lost"] >= 1
        assert summary["elastic"]["decommissions_forced"] == 1
        assert sorted(shuffled.collect()) == ref_rows["reduce4"]
        time.sleep(1.0)
        assert "exec-0" not in ctx._backend._executors
    finally:
        ctx.stop()


def test_decommission_parity_covered_zero_recompute(monkeypatch, tmp_path,
                                                    ref_rows):
    ctx = _chaos(monkeypatch, tmp_path, {}, shuffle_coding="xor",
                 decommission_timeout_s=8.0)
    try:
        shuffled = ctx.parallelize([(i % 4, i) for i in range(120)], 4) \
            .reduce_by_key(operator.add, 4)
        assert sorted(shuffled.collect()) == ref_rows["reduce4"]
        result = ctx.elastic.decommission("exec-0", reason="chaos")
        assert not result["forced"]
        assert result["replica_covered"] >= 1
        assert (result["migrated_outputs"], result["recomputed_outputs"]) \
            == (0, 0)
        assert sorted(shuffled.collect()) == ref_rows["reduce4"]
        stats = ctx._backend.worker_stats().values()
        assert sum(s["fetch"]["coded_failovers"] for s in stats) >= 1
        summary = ctx.metrics_summary()
        assert (summary["stages_resubmitted"], summary["executors_lost"],
                summary["elastic"]["recomputed_outputs"]) == (0, 0, 0)
    finally:
        ctx.stop()
