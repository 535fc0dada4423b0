"""The port's local runtime (vega_tpu_torch/scheduler/, env.py,
serialization.py) against vega_tpu's, on the CPU.

Each test is a counterpart of a local test of tests/test_scheduler.py:
stage cutting, map-stage reuse across jobs, retry then success, TaskError,
fetch-failure recovery, the approximate actions (final, and partial then
final), the event bus's metrics, the stage binaries (serialized once per
stage, never on the plain local pool), the TaskBinaryCache, speculation
(a straggler of the test's own, and one made by faults.maybe_slow_task)
and the preferred-locations memo. The same seeded inputs go through the
reference (vega_tpu.Context("local")) and the port (device="cpu"); rows
compare exactly for integer data, float sums within rtol 1e-5, and stage,
attempt and serialization counts equal. A DenseRDD hand-off lineage
(to_rdd, two host shuffles, dense(), a join) is held to the reference's
too.

Recorded difference, pinned here: the port serializes tasks with the
standard library's pickle, so under serialize_tasks_locally a lambda or
a local closure fails the round trip with a VegaError naming it (the
reference's cloudpickle carries it); module-level functions and
functools.partial pass.

Every wait (a deadline, a straggler) is on an Event with a timeout of a
few seconds.
"""

import functools
import operator
import threading
import time

import numpy as np
import pytest

import vega_tpu as v
from vega_tpu.env import Env as RefEnv
import vega_tpu_torch as vt
from vega_tpu_torch.errors import TaskError, VegaError

N_SHARDS = 8


def _port(**kw):
    return vt.Context(device="cpu", n_shards=N_SHARDS, num_workers=4, **kw)


def _ref(**kw):
    return v.Context("local", num_workers=4, **kw)


def _both(run, **kw):
    """[run(reference Context, its shuffle store), run(port Context,
    its shuffle store)], each Context stopped after."""
    out = []
    ctx = _ref(**kw)
    try:
        out.append(run(ctx, RefEnv.get().shuffle_store))
    finally:
        ctx.stop()
    with _port(**kw) as ctx:
        out.append(run(ctx, ctx.env.shuffle_store))
    return out


def _rows(seed=23, n=300, keys=17):
    rng = np.random.default_rng(seed)
    return [(int(k), int(x)) for k, x in zip(rng.integers(0, keys, n),
                                             rng.integers(-999, 999, n))]


def _add(a, b):
    return a + b


def _key_mod3(x):
    return (x % 3, x)


def _collect(_tc, it):
    return list(it)


def test_stage_cutting():
    """A two-shuffle lineage builds three stages."""
    def run(ctx, _store):
        rdd = (ctx.parallelize([(i % 3, i) for i in range(30)], 4)
               .reduce_by_key(lambda a, b: a + b, 3)
               .map(lambda kv: (kv[1] % 2, kv[0]))
               .reduce_by_key(lambda a, b: a + b, 2))
        got = sorted(rdd.collect())
        return got, ctx.metrics_summary()["stages"]

    ref, port = _both(run)
    assert port == ref and port[1] == 3


def test_map_stage_reuse_across_jobs():
    """The second action over one shuffle skips its map stage."""
    def run(ctx, _store):
        calls = []
        lock = threading.Lock()

        def probe(x):
            with lock:
                calls.append(x)
            return (x % 3, x)

        shuffled = ctx.parallelize(list(range(30)), 3).map(probe) \
            .reduce_by_key(lambda a, b: a + b, 2)
        first = sorted(shuffled.collect())
        n1 = len(calls)
        second = sorted(shuffled.collect())
        return first, second, n1, len(calls), \
            ctx.metrics_summary()["stages"]

    ref, port = _both(run)
    assert port == ref
    assert port[2] == port[3] == 30 and port[4] == 3


def test_task_retry_then_success():
    """A task that fails twice succeeds on its third attempt."""
    def run(ctx, _store):
        attempts = {}
        lock = threading.Lock()

        def flaky(idx, it):
            with lock:
                attempts[idx] = attempts.get(idx, 0) + 1
                if idx == 1 and attempts[idx] < 3:
                    raise RuntimeError("transient")
            return it

        rdd = ctx.parallelize(list(range(10)), 2) \
            .map_partitions_with_index(flaky)
        got = sorted(rdd.collect())
        summary = ctx.metrics_summary()
        return got, attempts[1], summary["task_failures"]

    ref, port = _both(run)
    assert port == ref == (list(range(10)), 3, 2)


def test_task_failure_aborts_job():
    """A task failing max_failures times aborts the job with TaskError
    raised from its exception."""
    def run(ctx, _store):
        calls = []

        def always_fails(x):
            calls.append(x)
            raise ValueError("boom")

        with pytest.raises(Exception) as info:
            ctx.parallelize([1, 2, 3], 2).map(always_fails).collect()
        err = info.value
        return (type(err).__name__, type(err.__cause__).__name__,
                ctx.metrics_summary()["task_failures"])

    ref, port = _both(run, max_failures=3)
    assert port == ref and port[:2] == ("TaskError", "ValueError")
    with _port(max_failures=1) as ctx:
        with pytest.raises(TaskError):
            ctx.parallelize([1, 2], 2).map(lambda x: 1 // 0).count()


def test_fetch_failure_recovery():
    """A bucket dropped from the store between two collects: the reduce
    task's fetch fails, the map output is unregistered, the map stage
    resubmitted, and the job still completes with the same result."""
    def run(ctx, store):
        rdd = ctx.parallelize([(i % 4, 1) for i in range(40)], 4) \
            .reduce_by_key(lambda a, b: a + b, 4)
        first = dict(rdd.collect())
        assert store._mem.pop((rdd.shuffle_id, 2, 1), None) is not None
        second = dict(rdd.collect())
        summary = ctx.metrics_summary()
        return first, second, summary["stages_resubmitted"] >= 1

    ref, port = _both(run, resubmit_timeout_s=0.2)
    assert port == ref
    assert port[0] == port[1] == {0: 10, 1: 10, 2: 10, 3: 10} and port[2]


def test_count_approx_complete():
    def run(ctx, _store):
        res = ctx.parallelize(list(range(1000)), 4).count_approx(30.0)
        empty = ctx.parallelize([], 2).count_approx(30.0)
        iv = res.initial_value
        return (res.is_initial_value_final, iv.mean, iv.low, iv.high,
                empty.initial_value.mean)

    ref, port = _both(run)
    assert port == ref == (True, 1000.0, 1000.0, 1000.0, 0.0)


def test_count_approx_partial():
    """The deadline passes with two of four partitions merged: a partial
    estimate, then the final count."""
    def run(ctx, _store):
        gate = threading.Event()

        def slow(idx, it):
            if idx >= 2:
                gate.wait(5.0)
            return it

        rdd = ctx.parallelize(list(range(400)), 4) \
            .map_partitions_with_index(slow)
        res = rdd.count_approx(timeout_s=0.3, confidence=0.9)
        partial = res.initial_value
        out = (res.is_initial_value_final,
               0.0 <= partial.low <= partial.mean <= partial.high)
        gate.set()
        final = res.get_final_value(timeout=10.0)
        return out + (final.mean, final.confidence)

    ref, port = _both(run)
    assert port == ref == (False, True, 400.0, 1.0)


def test_count_by_value_approx():
    def run(ctx, _store):
        res = ctx.parallelize(["a"] * 60 + ["b"] * 40, 4) \
            .count_by_value_approx(30.0)
        return {k: (b.mean, b.low, b.high)
                for k, b in res.initial_value.items()}

    ref, port = _both(run)
    assert port == ref == {"a": (60.0, 60.0, 60.0), "b": (40.0, 40.0, 40.0)}


def test_mean_approx_final():
    rng = np.random.default_rng(3)
    xs = [float(x) for x in rng.standard_normal(500)]

    def run(ctx, _store):
        res = ctx.parallelize(xs, 5).mean_approx(30.0)
        return res.is_initial_value_final, res.initial_value.mean

    ref, port = _both(run)
    assert port[0] and ref[0]
    assert port[1] == pytest.approx(ref[1], rel=1e-5)
    assert port[1] == pytest.approx(float(np.mean(xs)), rel=1e-5)


def test_event_bus_metrics():
    def run(ctx, _store):
        ctx.parallelize(list(range(10)), 2).count()
        s = ctx.metrics_summary()
        return s["jobs"], s["tasks"], s["stages"], s["task_failures"]

    ref, port = _both(run)
    assert port == ref == (1, 2, 1, 0)


def test_stage_binary_serialized_once_per_stage():
    """Under serialize_tasks_locally a 6-partition map stage and a
    4-partition reduce stage serialize their lineage twice, not ten
    times (module-level functions: the port's pickle is the standard
    library's)."""
    from vega_tpu.scheduler.task import StageBinary as RefBinary
    from vega_tpu_torch.scheduler.task import StageBinary as PortBinary

    def run(ctx, _store):
        binary = PortBinary if isinstance(ctx, vt.Context) else RefBinary
        before = binary.total_serializations
        pairs = ctx.parallelize([(i % 3, i) for i in range(60)], 6)
        got = dict(pairs.reduce_by_key(_add, 4).collect())
        return got, binary.total_serializations - before

    ref, port = _both(run, serialize_tasks_locally=True)
    exp = {}
    for i in range(60):
        exp[i % 3] = exp.get(i % 3, 0) + i
    assert port == ref == (exp, 2)


def test_stage_binary_not_serialized_on_plain_local():
    from vega_tpu.scheduler.task import StageBinary as RefBinary
    from vega_tpu_torch.scheduler.task import StageBinary as PortBinary

    def run(ctx, _store):
        binary = PortBinary if isinstance(ctx, vt.Context) else RefBinary
        before = binary.total_serializations
        n = ctx.parallelize(list(range(40)), 4).map(lambda x: x + 1).count()
        return n, binary.total_serializations - before

    ref, port = _both(run)
    assert port == ref == (40, 0)


def test_serialized_tasks_with_module_functions_and_partials():
    """Module-level functions and functools.partial make the round trip
    on both sides, through a shuffle."""
    def run(ctx, _store):
        rdd = ctx.parallelize(list(range(20)), 3) \
            .map(functools.partial(operator.add, 7)).map(_key_mod3)
        return sorted(rdd.reduce_by_key(operator.add, 2).collect())

    ref, port = _both(run, serialize_tasks_locally=True)
    assert port == ref


def test_serialized_lambda_is_refused_naming_it():
    """A lambda and a local closure make the serialize_tasks_locally round
    trip by value (serialization.py, no cloudpickle), with the
    reference's rows; a class defined in a function is still refused,
    naming it (a recorded difference: cloudpickle sends it by value)."""
    base = 7

    def local_closure(x):
        return x + base

    class Local:
        pass

    got = []
    for make in (_ref, _port):
        ctx = make(serialize_tasks_locally=True)
        try:
            rdd = ctx.parallelize(list(range(20)), 3)
            got.append((rdd.map(lambda x: x + base).collect(),
                        rdd.map(local_closure).collect(),
                        rdd.map(functools.partial(operator.add, base))
                        .collect()))
            if make is _port:
                with pytest.raises(VegaError, match="Local"):
                    rdd.map(lambda x, c=Local: (x, c)).collect()
        finally:
            ctx.stop()
    assert got[0] == got[1] == (list(range(7, 27)),) * 3


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_task_binary_cache_lru_and_pending(pkg):
    """The bounded LRU: the oldest evicted, a hit moves to the front, a
    drop removes."""
    if pkg == "ref":
        from vega_tpu import serialization
        from vega_tpu.scheduler.task import TaskBinaryCache
    else:
        from vega_tpu_torch import serialization
        from vega_tpu_torch.scheduler.task import TaskBinaryCache

    cache = TaskBinaryCache(2)
    raw = {k: serialization.dumps(("result", k, None)) for k in "abc"}
    assert cache.load("a", raw["a"])[1] == "a"
    assert cache.load("b", raw["b"])[1] == "b"
    assert cache.get("a")[1] == "a"
    assert cache.load("c", raw["c"])[1] == "c"
    assert cache.get("b") is None
    assert cache.get("a") is not None and cache.get("c") is not None
    assert len(cache) == 2
    assert cache.wait_for("b", timeout=0.05) is None
    cache.drop("a")
    assert cache.get("a") is None


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_binary_cache_claim_parks_siblings(pkg):
    if pkg == "ref":
        from vega_tpu import serialization
        from vega_tpu.scheduler.task import TaskBinaryCache
    else:
        from vega_tpu_torch import serialization
        from vega_tpu_torch.scheduler.task import TaskBinaryCache

    cache = TaskBinaryCache(4)
    token = cache.claim("s")
    assert token is not None and cache.claim("s") is None
    got = []
    parked = threading.Event()

    def waiter():
        parked.set()
        got.append(cache.wait_for("s", 5.0))

    t = threading.Thread(target=waiter)
    t.start()
    parked.wait(5.0)
    time.sleep(0.05)
    assert not got
    obj = cache.load("s", serialization.dumps(("result", "s", None)), token)
    t.join(5.0)
    assert got and got[0] is obj
    assert cache.claim("s") is None


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_binary_cache_abandon_releases_waiters(pkg):
    if pkg == "ref":
        from vega_tpu.scheduler.task import TaskBinaryCache
    else:
        from vega_tpu_torch.scheduler.task import TaskBinaryCache

    cache = TaskBinaryCache(4)
    token = cache.claim("s")
    got = []
    t = threading.Thread(target=lambda: got.append(cache.wait_for("s", 10)))
    t.start()
    time.sleep(0.05)
    t0 = time.time()
    cache.abandon("s", token)
    t.join(5.0)
    assert got == [None] and time.time() - t0 < 2.0
    cache.abandon("s", None)
    assert cache.claim("s") is not None


class _FakeRDD:
    rdd_id = -1

    def iterator(self, split, tc):
        return iter(())


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_legacy_task_envelope_excludes_stage_binary(pkg):
    """A task pickled whole does not drag its attached StageBinary."""
    if pkg == "ref":
        from vega_tpu import serialization
        from vega_tpu.scheduler.task import ResultTask, StageBinary
        from vega_tpu.split import Split
    else:
        from vega_tpu_torch import serialization
        from vega_tpu_torch.scheduler.task import ResultTask, StageBinary
        from vega_tpu_torch.split import Split

    rdd = _FakeRDD()
    task = ResultTask(0, rdd, _collect, 0, Split(0), 0)
    task.stage_binary = StageBinary("result", rdd, task.func)
    clone = serialization.loads(serialization.dumps(task))
    assert clone.stage_binary is None
    assert clone.partition == task.partition


def _double_value(kv):
    return (kv[0], kv[1] * 2)


def test_stage_binary_rebuilt_on_lineage_mutation():
    """A cached map stage's binary is reused by a resubmission over an
    unchanged lineage and rebuilt after a persist flip."""
    from vega_tpu.scheduler.dag import _lineage_token as ref_token
    from vega_tpu_torch.scheduler.dag import _lineage_token as port_token

    def run(ctx, _store):
        token = port_token if isinstance(ctx, vt.Context) else ref_token
        src = ctx.parallelize([(i % 3, i) for i in range(30)], 3)
        pairs = src.map(_double_value)
        reduced = pairs.reduce_by_key(_add, 2)
        first = dict(reduced.collect())
        sched = ctx.scheduler
        map_stage = next(iter(sched._shuffle_to_map_stage.values()))
        before = map_stage.task_binary
        token_before = token(pairs)

        def scrub_outputs():
            for p in range(map_stage.num_partitions):
                map_stage.output_locs[p] = []

        scrub_outputs()
        same = dict(reduced.collect()) == first
        reused = map_stage.task_binary is before
        pairs.cache()
        changed = token(pairs) != token_before
        scrub_outputs()
        again = dict(reduced.collect()) == first
        rebuilt = map_stage.task_binary is not before \
            and map_stage.task_binary_token == token(pairs)
        return sorted(first.items()), same, reused, changed, again, rebuilt

    ref, port = _both(run, serialize_tasks_locally=True)
    assert port == ref and all(port[1:])


def test_speculative_execution():
    """A straggling task gets a duplicate; the job finishes on the
    duplicate's result long before the straggler would."""
    def run(ctx, _store):
        release = threading.Event()
        first_run = {}
        lock = threading.Lock()

        def slow_once(idx, it):
            with lock:
                calls = first_run.get(idx, 0)
                first_run[idx] = calls + 1
            if idx == 3 and calls == 0:
                release.wait(6.0)  # the straggler: first attempt only
            return it

        rdd = ctx.parallelize(list(range(40)), 4) \
            .map_partitions_with_index(slow_once)
        t0 = time.time()
        got = sorted(rdd.collect())
        elapsed = time.time() - t0
        release.set()
        s = ctx.metrics_summary()["speculation"]
        return got, elapsed < 4.0, first_run[3] >= 2, s["launched"] >= 1

    ref, port = _both(run, speculation_enabled=True, speculation_min_s=0.3,
                      speculation_multiplier=2.0)
    assert port == ref == (list(range(40)), True, True, True)


def test_injected_straggler_is_speculated():
    """faults.maybe_slow_task, armed alike in both packages, makes the
    first task to run a straggler; its duplicate, which the injection no
    longer slows, finishes the job long before the straggler would."""
    from vega_tpu import faults as ref_faults
    from vega_tpu_torch import faults as port_faults

    out = []
    for faults, make in ((ref_faults, _ref), (port_faults, _port)):
        faults.configure(slow_tasks=1, slow_task_s=3.0)
        ctx = make(speculation_enabled=True, speculation_min_s=0.3,
                   speculation_multiplier=2.0)
        try:
            t0 = time.time()
            got = sorted(ctx.parallelize(list(range(40)), 4).collect())
            elapsed = time.time() - t0
            s = ctx.metrics_summary()["speculation"]
            out.append((got, elapsed < 2.5, faults.get().slow_tasks,
                        s["launched"] >= 1))
        finally:
            ctx.stop()
            faults.reset()
    assert out[1] == out[0] == (list(range(40)), True, 0, True)


def test_speculation_duplicate_completion_on_shuffle_stage():
    """Both copies of a speculated map task complete; the duplicate does
    not register the stage twice, and a second job over the shuffle
    works."""
    def run(ctx, _store):
        runs = {}
        lock = threading.Lock()
        hold = threading.Event()

        def slow_once(idx, it):
            with lock:
                c = runs.get(idx, 0)
                runs[idx] = c + 1
            if idx == 0 and c == 0:
                hold.wait(1.0)  # a short straggle: the original finishes
            return it

        pairs = (ctx.parallelize(list(range(40)), 4)
                 .map_partitions_with_index(slow_once)
                 .map(lambda x: (x % 4, 1)))
        result = dict(pairs.reduce_by_key(lambda a, b: a + b, 4).collect())
        again = dict(pairs.reduce_by_key(lambda a, b: a + b, 4).collect())
        return result, again

    ref, port = _both(run, speculation_enabled=True, speculation_min_s=0.2,
                      speculation_multiplier=2.0)
    assert port == ref
    assert port[0] == port[1] == {0: 10, 1: 10, 2: 10, 3: 10}


def test_speculative_failure_does_not_burn_max_failures():
    """With max_failures=1 a failed duplicate would abort the job if it
    counted; it does not, and the original commits."""
    def run(ctx, _store):
        runs = {}
        lock = threading.Lock()
        hold = threading.Event()

        def straggle_then_crash(idx, it):
            with lock:
                calls = runs.get(idx, 0)
                runs[idx] = calls + 1
            if idx == 3:
                if calls == 0:
                    hold.wait(2.0)  # the original straggles
                else:
                    raise RuntimeError("speculative duplicate crashes")
            return it

        rdd = ctx.parallelize(list(range(40)), 4) \
            .map_partitions_with_index(straggle_then_crash)
        got = sorted(rdd.collect())
        s = ctx.metrics_summary()["speculation"]
        return got, runs[3] >= 2, s["launched"] >= 1, s["lost"] >= 1

    ref, port = _both(run, speculation_enabled=True, speculation_min_s=0.3,
                      speculation_multiplier=2.0, max_failures=1)
    assert port == ref == (list(range(40)), True, True, True)


def test_preferred_locs_memoized_per_submit():
    """One memo per submission: a stage whose partitions fan into one
    parent partition walks it once."""
    from vega_tpu.dependency import ManyToOneDependency as RefManyToOne
    from vega_tpu.split import Split as RefSplit
    from vega_tpu_torch.dependency import ManyToOneDependency
    from vega_tpu_torch.split import Split

    def run(ctx, _store):
        port = isinstance(ctx, vt.Context)
        split_cls = Split if port else RefSplit
        dep_cls = ManyToOneDependency if port else RefManyToOne

        class _CountingSource:
            rdd_id = 990001
            should_cache = False

            def __init__(self):
                self.calls = 0
                self._splits = [split_cls(0)]

            def cached_splits(self):
                return self._splits

            def preferred_locations(self, split):
                self.calls += 1
                return ["hostA"]

            def get_dependencies(self):
                return []

        class _FanIn:
            rdd_id = 990002
            should_cache = False

            def __init__(self, parent, n):
                self._splits = [split_cls(i) for i in range(n)]
                self._dep = dep_cls(parent, [[0]] * n)

            def cached_splits(self):
                return self._splits

            def preferred_locations(self, split):
                return []

            def get_dependencies(self):
                return [self._dep]

        source = _CountingSource()
        fan_in = _FanIn(source, 4)
        memo = {}
        locs = [ctx.scheduler._get_preferred_locs(fan_in, p, memo=memo)
                for p in range(4)]
        memo_calls = source.calls
        source.calls = 0
        for p in range(4):
            ctx.scheduler._get_preferred_locs(fan_in, p)
        return locs, memo_calls, source.calls

    ref, port = _both(run)
    assert port == ref == ([["hostA"]] * 4, 1, 4)


def test_dense_handoff_lineage_through_stages():
    """A DenseRDD's rows handed to the host layer (to_rdd), two host
    shuffles, lifted back (dense()) and joined on the device: equal to
    the reference's, and the host part ran as stages."""
    n, keys = 4000, 300
    table_k = np.arange(0, 100, dtype=np.int32)
    table_v = (np.arange(100) * 0.25).astype(np.float32)

    def run(ctx, _store):
        port = isinstance(ctx, vt.Context)
        kv = ctx.dense_range(n).map(lambda x: (x % keys, x * 0.5)) \
            .reduce_by_key(op="add")
        host = kv.to_rdd() if port else kv
        s1 = host.map(lambda kv: (kv[0] % 100, kv[1])) \
            .reduce_by_key(operator.add, 8)
        s2 = s1.map(lambda kv: (kv[0] % 50, kv[1])) \
            .reduce_by_key(operator.add, 4)
        before = ctx.metrics_summary()["stages"]
        lifted = s2.dense()
        stages = ctx.metrics_summary()["stages"] - before
        table = ctx.dense_from_numpy(table_k, table_v)
        joined = sorted(lifted.join(table).collect())
        return joined, stages

    ref, port = _both(run)
    # the port's host part ran as three stages or more (the reference
    # keeps this lineage on its device tier)
    assert port[1] >= 3
    assert [k for k, _ in port[0]] == [k for k, _ in ref[0]]
    got = np.array([[a, b] for _, (a, b) in port[0]], dtype=np.float64)
    exp = np.array([[a, b] for _, (a, b) in ref[0]], dtype=np.float64)
    np.testing.assert_allclose(got, exp, rtol=1e-5)
    sums = np.zeros(50)
    for k in range(keys):
        sums[k % 100 % 50] += sum(x * 0.5 for x in range(k, n, keys))
    np.testing.assert_allclose(got[:, 0], sums[[k for k, _ in port[0]]],
                               rtol=1e-5)
