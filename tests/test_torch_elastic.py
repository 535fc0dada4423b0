"""The elastic fleet of vega_tpu_torch (scheduler/elastic.py,
Context.fleet_status, the metrics' elastic section) against vega_tpu's,
on the CPU.

Admission runs in local mode in both packages. Then one fleet of each
package (three executors, one task thread each): fleet_status's shape,
the load signals, a decommission that migrates sole-copy shuffle
outputs (a second read of the shuffle gives the same rows with no stage
resubmitted), a blacklisted executor forgiven and its state gone with
its decommission, and the control loop: a queued backlog scales the
fleet up, idle time scales it back down, and the job's rows equal the
reference's. Counterparts of tests/test_elastic.py's eight tests and
tests/test_chaos.py:870.
"""

import operator
import threading
import time
import types

import pytest

import vega_tpu as v
from vega_tpu.errors import JobRejectedError as RefJobRejectedError
import vega_tpu_torch as vt
from vega_tpu_torch.errors import JobRejectedError, VegaError


def _retire_reference():
    prev = v.Context.active()
    if prev is not None:
        prev.stop()


def _local(pkg, **kw):
    if pkg == "ref":
        _retire_reference()
        return v.Context("local", **kw)
    return vt.Context(device="cpu", n_shards=2, **kw)


def _hold_job(ctx, release, partitions=4):
    def holdup(x):
        release.wait(15.0)
        return x

    return ctx.submit_job(ctx.parallelize(range(partitions), partitions)
                          .map(holdup), lambda tc, it: sum(it))


# --- admission, local mode (tests/test_elastic.py:51-153) --------------------


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_pool_bounded_rejection_typed_and_bounded(pkg):
    ctx = _local(pkg, pool_max_queued=1)
    try:
        release = threading.Event()
        f1 = _hold_job(ctx, release)
        try:
            with pytest.raises((JobRejectedError, RefJobRejectedError)) as e:
                ctx.submit_job(ctx.parallelize(range(2), 2),
                               lambda tc, it: sum(it))
            assert (e.value.pool, e.value.bound) == ("default", 1)
            status = ctx.fleet_status()["admission"]
            assert status["mode"] == "reject"
            assert status["pools"]["default"]["in_flight"] == 1
        finally:
            release.set()
        assert sum(f1.result(10.0)) == sum(range(4))
        f3 = ctx.submit_job(ctx.parallelize(range(3), 3),
                            lambda tc, it: sum(it))
        assert sum(f3.result(10.0)) == sum(range(3))
        assert ctx.metrics_summary()["jobs_rejected"] == 1
    finally:
        ctx.stop()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_bounds_are_per_pool(pkg):
    ctx = _local(pkg, pool_max_queued=2, num_workers=8)
    try:
        ctx.set_pool("tight", weight=1, max_queued=1)
        release = threading.Event()
        ctx.set_local_property("pool", "tight")
        f1 = _hold_job(ctx, release)
        try:
            with pytest.raises((JobRejectedError, RefJobRejectedError)):
                _hold_job(ctx, release)
            ctx.set_local_property("pool", None)
            f2 = ctx.submit_job(ctx.parallelize(range(2), 2),
                                lambda tc, it: sum(it))
            assert sum(f2.result(10.0)) == 1
        finally:
            ctx.set_local_property("pool", None)
            release.set()
        assert f1.result(10.0)
    finally:
        ctx.stop()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_admission_block_backpressure_unblocks_on_drain(pkg):
    ctx = _local(pkg, pool_max_queued=1, admission_mode="block")
    try:
        release = threading.Event()
        f1 = _hold_job(ctx, release)
        admitted = {}
        done = threading.Event()

        def submitter():
            f2 = ctx.submit_job(ctx.parallelize(range(3), 3),
                                lambda tc, it: sum(it))
            admitted["t"] = time.monotonic()
            admitted["result"] = sum(f2.result(10.0))
            done.set()

        threading.Thread(target=submitter, daemon=True).start()
        time.sleep(0.8)
        assert not done.is_set()
        t_release = time.monotonic()
        release.set()
        assert done.wait(10.0)
        assert admitted["result"] == sum(range(3))
        assert admitted["t"] >= t_release
        assert sum(f1.result(10.0)) == sum(range(4))
        assert ctx.metrics_summary()["jobs_rejected"] == 0
    finally:
        ctx.stop()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_unbounded_by_default(pkg):
    ctx = _local(pkg)
    try:
        release = threading.Event()
        futures = [_hold_job(ctx, release, partitions=2) for _ in range(6)]
        status = ctx.fleet_status()
        assert status["admission"]["pools"]["default"]["in_flight"] == 6
        assert status["admission"]["pools"]["default"]["max_queued"] is None
        assert status["fleet"] == [] and \
            status["elastic"] == {"enabled": False}
        release.set()
        assert all(f.result(10.0) is not None for f in futures)
    finally:
        ctx.stop()


# --- a fleet of each package --------------------------------------------------

FLEET = dict(num_workers=1, num_executors=3, blacklist_decay_s=0.5,
             locality_wait_s=0.0, decommission_timeout_s=5.0,
             executor_max_restarts=0, executor_reap_interval_s=0.5)


@pytest.fixture(scope="module")
def fleets():
    _retire_reference()
    ref = v.Context("distributed", **FLEET)
    try:
        port = vt.Context(mode="distributed", device="cpu", n_shards=2,
                          **FLEET)
    except BaseException:
        ref.stop()
        raise
    yield ref, port
    port.stop()
    ref.stop()


def _live(ctx):
    return sorted(r["executor_id"] for r in ctx._backend.fleet_snapshot()
                  if r["alive"] and not r["draining"])


def test_fleet_status_shape_distributed(fleets):
    shapes = []
    for ctx in fleets:
        status = ctx.fleet_status()
        assert {r["executor_id"] for r in status["fleet"]} == \
            {"exec-0", "exec-1", "exec-2"}
        assert all(r["alive"] and not r["draining"]
                   for r in status["fleet"])
        assert status["scheduler"]["running"] == 0
        assert status["elastic"]["executor_seconds"] >= 0.0
        shapes.append((sorted(status), sorted(status["elastic"]),
                       sorted(status["fleet"][0]), sorted(status["scheduler"]),
                       status["elastic"]["enabled"],
                       status["elastic"]["live_executors"]))
    assert shapes[0] == shapes[1]
    assert shapes[1][-2:] == (False, 3)


def test_elastic_demand_includes_registered_load_signals(fleets):
    for ctx in fleets:
        n = len(ctx.elastic._load_signals)
        ctx.elastic.add_load_signal(lambda: 3)
        ctx.elastic.add_load_signal(lambda: (_ for _ in ()).throw(
            RuntimeError("a broken signal reads as 0")))
        try:
            ctx.elastic._decide(interval=10.0)
            sig = ctx.elastic._last_signal
            assert sig["extra"] == 3
            assert sig["load"] >= 3 / sig["slots"]
        finally:
            del ctx.elastic._load_signals[n:]


def test_unreplicated_scale_down_migrates_bucket_rows(fleets):
    """A decommission moves the victim's sole-copy bucket rows to a
    survivor: the shuffle reads again to the same rows, no stage is
    resubmitted and nothing is recomputed (tests/test_chaos.py:870)."""
    out = []
    for ctx in fleets:
        before = ctx.metrics_summary()
        shuffled = ctx.parallelize([(i % 4, i) for i in range(120)], 6) \
            .reduce_by_key(lambda a, b: a + b, 4)
        first = sorted(shuffled.collect())
        result = ctx.elastic.decommission("exec-2", reason="test")
        second = sorted(shuffled.collect())
        after = ctx.metrics_summary()
        out.append((first, second, result["forced"],
                    result["migrated_outputs"] >= 1,
                    result["migrated_bytes"] > 0,
                    result["recomputed_outputs"],
                    after["stages_resubmitted"] - before["stages_resubmitted"],
                    after["executors_lost"] - before["executors_lost"],
                    after["elastic"]["executors_decommissioned"]
                    - before["elastic"]["executors_decommissioned"],
                    _live(ctx)))
    assert out[0] == out[1]
    assert out[1][2:] == (False, True, True, 0, 0, 0, 1,
                          ["exec-0", "exec-1"])


def _task_stub():
    return types.SimpleNamespace(speculative=False,
                                 exclude_executors=frozenset(),
                                 preferred_locs=())


def test_blacklist_decays_and_clears_on_decommission(fleets):
    for ctx in fleets:
        backend = ctx._backend
        flaky = backend._executors["exec-0"]
        flaky.failures = ctx.conf.executor_blacklist_threshold
        flaky.last_failure_at = time.time()
        picks = {backend._pick_executor(_task_stub()).executor_id
                 for _ in range(8)}
        assert picks == {"exec-1"}
        flaky.last_failure_at = time.time() - 1.0
        picks = {backend._pick_executor(_task_stub()).executor_id
                 for _ in range(8)}
        assert picks == {"exec-0", "exec-1"}
        assert flaky.failures == 0
        backend._known_hashes.setdefault("exec-0", set()).add("sha")
        ctx.elastic.decommission("exec-0", reason="test")
        assert "exec-0" not in backend._executors
        assert "exec-0" not in backend._known_hashes
        assert "exec-0" not in backend.service.workers
        assert ctx.parallelize(list(range(10)), 2).count() == 10
        # the floor holds: the last executor is not decommissioned
        with pytest.raises(Exception, match="elastic_min_executors"):
            ctx.elastic.decommission("exec-1", reason="test")


def test_backlog_scales_up_and_idle_scales_down(fleets):
    """The control loop over a one-executor fleet: 24 slow tasks queued
    hold the load above the threshold, so the fleet grows to
    elastic_max_executors while the job runs; once the job is done it
    shrinks back to elastic_min_executors by decommissions. The rows
    equal the reference's; fleet_status shows the fleet before and
    after."""
    out = []
    for ctx in fleets:
        conf = ctx.conf
        conf.elastic_min_executors = 1
        conf.elastic_max_executors = 3
        conf.elastic_scale_up_threshold = 2.0
        conf.elastic_scale_down_threshold = 0.25
        conf.elastic_decision_interval_s = 0.2
        before = ctx.fleet_status()
        peak = [0]
        running = threading.Event()
        running.set()

        def sample():
            while running.is_set():
                peak[0] = max(peak[0], len(_live(ctx)))
                time.sleep(0.05)

        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        ctx.elastic.start()
        try:
            slow = lambda x: (time.sleep(0.4), (x % 5, x))[1]  # noqa: E731
            rows = sorted(ctx.parallelize(list(range(24)), 24).map(slow)
                          .reduce_by_key(operator.add, 3).collect())
            # until the last decommission has reaped its slot
            deadline = time.time() + 60.0
            while len(ctx._backend.fleet_snapshot()) > 1 \
                    and time.time() < deadline:
                time.sleep(0.1)
        finally:
            ctx.elastic.stop()  # joins the loop: its last step is counted
            running.clear()
            sampler.join(timeout=10)
        after = ctx.fleet_status()
        summary = ctx.metrics_summary()["elastic"]
        out.append((rows, len(before["fleet"]), peak[0],
                    after["elastic"]["scale_ups"],
                    after["elastic"]["scale_downs"],
                    summary["executors_added"],
                    summary["executors_decommissioned"],
                    len(after["fleet"]), len(_live(ctx))))
        assert ctx.parallelize(list(range(10)), 2).count() == 10
    assert out[0] == out[1]
    # 2 added, then 2 decommissioned by the loop (2 more by the tests
    # before this one)
    assert out[1] == (sorted({k: sum(range(k, 24, 5))
                              for k in range(5)}.items()),
                      1, 3, 2, 2, 2, 4, 1, 1)


def test_elastic_settings_are_checked():
    for name, bad in (("elastic_enabled", "yes"),
                      ("elastic_max_executors", 0),
                      ("elastic_scale_up_threshold", 0),
                      ("elastic_decision_interval_s", -1.0)):
        with pytest.raises(VegaError, match=name):
            vt.Context(device="cpu", n_shards=2, **{name: bad})
