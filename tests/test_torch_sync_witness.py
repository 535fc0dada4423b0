"""The port's runtime lock-order witness (vega_tpu_torch.lint.sync_witness)
held against vega_tpu's.

The witness's own cases are tests/test_lint.py's, run on the port's copy:
named_lock is a plain lock unless VEGA_TPU_DEBUG_SYNC=1; an inversion
raises and is recorded even when the raise is swallowed; an RLock's
re-entry is legal; roles are checked against the declared map.

Then one small lineage runs under VEGA_TPU_DEBUG_SYNC=1 in two fresh
processes, one per package (the port on device="cpu", the reference
under JAX_PLATFORMS=cpu): a local-runtime job on 4 task threads, jobs in
two pools, a short stream, and a job on 2 executors. Both end clean,
with equal results and equal roles observed, and the port's named locks
cover the reference's but for the differences listed in
NAME_DIFFERENCES, each with its reason.
"""

import ast
import json
import os
import subprocess
import sys
import threading

import pytest

from vega_tpu.lint import sync_witness as ref_sync_witness
from vega_tpu_torch.lint import sync_witness
from vega_tpu_torch.lint.sync_witness import (
    LockOrderError,
    RoleError,
    WitnessLock,
    WitnessRLock,
    check_clean,
    named_lock,
    witness,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# vega_tpu's lock names with no lock of that name in the port, and why.
NAME_DIFFERENCES = {
    "tpu.block._host_cache_lock":
        "the port's blocks read to the host inside Context._dense_lock "
        "(context.Context._dense_lock), which stands in its place",
    "tpu.mesh._lock":
        "the port keeps no default mesh to guard: each Context holds its "
        "own ShardMesh",
    "tpu.mesh._device_door":
        "device reads and collectives run inside Context._dense_lock",
    "env.Env._lock":
        "the port has one Env per Context, no process singleton to guard",
    "cache_tracker._loading_guard":
        "CacheTracker._lock guards the per-partition loading locks",
}
# named in the reference's workload but built in the port only off it
RUN_DIFFERENCES = {
    "shuffle.fetcher.stream_counters":
        "the port reads an all-local shuffle through _local_stream, which "
        "builds no stream counters; executors build them (distributed)",
}


@pytest.fixture()
def fresh_witness():
    w = witness()
    saved = (dict(w._edges), list(w.inversions), dict(w.roles_observed),
             list(w.role_violations), set(w.names))
    for part in (w._edges, w.inversions, w.roles_observed,
                 w.role_violations, w.names):
        part.clear()
    yield w
    for part in (w._edges, w.inversions, w.roles_observed,
                 w.role_violations, w.names):
        part.clear()
    w._edges.update(saved[0])
    w.inversions.extend(saved[1])
    w.roles_observed.update(saved[2])
    w.role_violations.extend(saved[3])
    w.names.update(saved[4])


def test_witness_records_order_and_raises_on_inversion(fresh_witness):
    a = WitnessLock("test.a")
    b = WitnessLock("test.b")
    with a:
        with b:
            pass
    with pytest.raises(LockOrderError, match="inversion"):
        with b:
            with a:
                pass
    assert fresh_witness.inversions  # the swallowed-raise backstop
    with pytest.raises(LockOrderError):
        check_clean()
    st = fresh_witness.stats()
    assert st["names"] == ["test.a", "test.b"]
    assert st["locks"] == 2 and st["edges"] == 1


def test_witness_inversion_seen_across_threads(fresh_witness):
    a = WitnessLock("test.a")
    b = WitnessLock("test.b")

    def forward():
        with a:
            with b:
                pass

    t = threading.Thread(target=forward)
    t.start()
    t.join()
    caught = []

    def backward():
        try:
            with b:
                with a:
                    pass
        except LockOrderError as exc:
            caught.append(exc)

    t2 = threading.Thread(target=backward)
    t2.start()
    t2.join()
    assert caught, "inversion across threads must raise"


def test_witness_self_deadlock_and_reentrant(fresh_witness):
    lk = WitnessLock("test.plain")
    with lk:
        with pytest.raises(LockOrderError, match="self-deadlock"):
            lk.acquire()
    rl = WitnessRLock("test.re")
    with rl:
        with rl:
            pass  # recursive acquisition of an RLock is legal
    assert not rl._inner._is_owned()


def test_named_lock_plain_unless_enabled(monkeypatch):
    monkeypatch.delenv("VEGA_TPU_DEBUG_SYNC", raising=False)
    assert not sync_witness.enabled()
    assert isinstance(named_lock("test.x"), type(threading.Lock()))
    assert isinstance(named_lock("test.x", reentrant=True),
                      type(threading.RLock()))
    monkeypatch.setenv("VEGA_TPU_DEBUG_SYNC", "1")
    assert sync_witness.enabled()
    assert isinstance(named_lock("test.x"), WitnessLock)
    assert isinstance(named_lock("test.x", reentrant=True), WitnessRLock)


def test_role_witness_confined_violation(fresh_witness):
    outcome = []

    def body():
        fresh_witness.note_role("stream-receiver")
        try:
            fresh_witness.check_role(())
        except RoleError as exc:
            outcome.append(str(exc))

    t = threading.Thread(target=body, name="stream-recv-99")
    t.start()
    t.join()
    assert outcome and "stream-receiver" in outcome[0]
    assert fresh_witness.stats()["role_violations"]
    with pytest.raises(RoleError):
        check_clean()


def test_role_witness_allowed_and_unconfined_pass(fresh_witness):
    def elastic_body():
        fresh_witness.note_role("elastic")
        fresh_witness.check_role(("elastic",))
        fresh_witness.check_role(())

    t = threading.Thread(target=elastic_body, name="elastic-controller")
    t.start()
    t.join()
    fresh_witness.check_role(())  # an un-noted thread always passes
    assert not fresh_witness.stats()["role_violations"]


def test_role_witness_thread_name_cross_check(fresh_witness):
    outcome = []

    def body():
        try:
            fresh_witness.note_role("reaper")
        except RoleError as exc:
            outcome.append(str(exc))

    t = threading.Thread(target=body, name="not-the-reaper")
    t.start()
    t.join()
    assert outcome and "disagree" in outcome[0]
    assert fresh_witness.stats()["role_violations"]


def test_role_witness_unknown_role_rejected(fresh_witness):
    with pytest.raises(RoleError, match="not in the declared role map"):
        fresh_witness.note_role("no-such-role")


def test_role_witness_noop_when_disabled(monkeypatch):
    monkeypatch.delenv("VEGA_TPU_DEBUG_SYNC", raising=False)
    sync_witness.note_thread_role("no-such-role")  # no-op, no raise
    assert sync_witness.current_role() is None
    sync_witness.assert_role()


def test_witness_api_matches_the_reference():
    for name in ("named_lock", "WitnessLock", "WitnessRLock",
                 "LockOrderError", "RoleError", "note_thread_role",
                 "assert_role", "current_role", "check_clean", "witness",
                 "enabled"):
        assert hasattr(sync_witness, name), name
    ref_keys = set(ref_sync_witness.witness().stats())
    assert set(witness().stats()) == ref_keys | {"names"}


def _witness_calls(package):
    """(lock names, noted roles, asserted roles) of every named_lock /
    note_thread_role / assert_role call with literal arguments."""
    names, noted, asserted = set(), set(), set()
    for d, _dirs, files in os.walk(os.path.join(ROOT, package)):
        if os.sep + "lint" in d[len(ROOT):]:
            continue
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(d, f), encoding="utf-8") as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call) or not isinstance(
                        node.func, ast.Name):
                    continue
                lits = [a.value for a in node.args
                        if isinstance(a, ast.Constant)]
                if node.func.id == "named_lock":
                    names.update(lits)
                elif node.func.id == "note_thread_role":
                    noted.update(lits)
                elif node.func.id == "assert_role":
                    asserted.add(tuple(lits))
    return names, noted, asserted


def test_every_reference_site_has_its_counterpart():
    ref_names, ref_noted, ref_asserted = _witness_calls("vega_tpu")
    names, noted, asserted = _witness_calls("vega_tpu_torch")
    assert ref_names - names == set(NAME_DIFFERENCES)
    assert noted == ref_noted
    assert asserted == ref_asserted


_WORKLOAD = r'''
import importlib.util, json, operator, os, sys, tempfile, time
which, tmp = sys.argv[1], sys.argv[2]
if which == "ref":
    # the reference's witness, loaded before its package builds a lock,
    # so every name it builds is seen
    spec = importlib.util.find_spec("vega_tpu")
    path = os.path.join(os.path.dirname(spec.origin), "lint",
                        "sync_witness.py")
    wspec = importlib.util.spec_from_file_location(
        "vega_tpu.lint.sync_witness", path)
    sw = importlib.util.module_from_spec(wspec)
    sys.modules[wspec.name] = sw
    wspec.loader.exec_module(sw)
    names = set()
    _init = sw.WitnessLock.__init__

    def _named(self, name):
        names.add(name)
        _init(self, name)

    sw.WitnessLock.__init__ = _named
    import vega_tpu as pkg

    def local(**kw):
        return pkg.Context("local", num_workers=4, **kw)

    def dist(**kw):
        return pkg.Context("distributed", num_workers=2, **kw)
else:
    import vega_tpu_torch as pkg
    from vega_tpu_torch.lint import sync_witness as sw

    def local(**kw):
        return pkg.Context(device="cpu", n_shards=4, num_workers=4, **kw)

    def dist(**kw):
        return pkg.Context(mode="distributed", device="cpu", n_shards=4,
                           num_executors=2, num_workers=2, **kw)

rows = [(i % 7, i) for i in range(2000)]
out = {}
with local(stream_batch_interval_s=0.05, stream_block_max_records=4,
           local_dir=os.path.join(tmp, "local")) as ctx:
    out["local"] = sorted(ctx.parallelize(rows, 8)
                          .reduce_by_key(operator.add, 4).collect())
    ctx.set_pool("a", weight=1)
    ctx.set_pool("b", weight=2)
    futs = [ctx.submit_job(ctx.parallelize(rows, 4).map(lambda kv: kv[1]),
                           lambda _tc, it: sum(it), pool=p)
            for p in ("a", "b")]
    out["pools"] = [sum(f.result(60)) for f in futs]
    seen = []
    stream = ctx.stream_from_generator(
        lambda offset: offset if offset < 30 else None,
        checkpoint_dir=os.path.join(tmp, "ckpt"))
    stream.foreach_rdd(lambda rdd, bid: seen.extend(rdd.collect()))
    sctx = ctx.streaming()
    sctx.start()
    t0 = time.time()
    while len(seen) < 30 and time.time() - t0 < 30:
        time.sleep(0.05)
    sctx.stop()
    out["stream"] = sorted(seen)
with dist(local_dir=os.path.join(tmp, "fleet")) as ctx:
    out["fleet"] = sorted(ctx.parallelize(rows, 4)
                          .reduce_by_key(operator.add, 3).collect())
st = sw.witness().stats()
if which == "ref":
    st["names"] = sorted(names)
sw.check_clean()
if which == "port":
    # a constructed inversion between two of the port's own locks
    with local(local_dir=os.path.join(tmp, "inv")) as ctx:
        a, b = ctx.job_server._lock, ctx.env.shuffle_store._lock
        st["witness_types"] = [type(a).__name__, type(b).__name__,
                               type(ctx._dense_lock).__name__]
        with a:
            with b:
                pass
        try:
            with b:
                with a:
                    pass
            st["inversion_raised"] = False
        except sw.LockOrderError:
            st["inversion_raised"] = True
print("WITNESS " + json.dumps({"out": out, "stats": st}))
'''


@pytest.fixture(scope="module")
def witness_runs(tmp_path_factory):
    """Both packages' runs of the workload, in two fresh processes at
    once, each under VEGA_TPU_DEBUG_SYNC=1."""
    env = dict(os.environ, VEGA_TPU_DEBUG_SYNC="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    procs = {}
    for which in ("ref", "port"):
        tmp = str(tmp_path_factory.mktemp(f"witness-{which}"))
        procs[which] = subprocess.Popen(
            [sys.executable, "-c", _WORKLOAD, which, tmp], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    runs = {}
    for which, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{which} failed:\n{err[-4000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("WITNESS ")]
        runs[which] = json.loads(line[-1][len("WITNESS "):])
    return runs


def test_both_runs_are_clean_and_agree(witness_runs):
    ref, port = witness_runs["ref"], witness_runs["port"]
    for run in (ref, port):
        assert run["stats"]["inversions"] == []
        assert run["stats"]["role_violations"] == []
    assert port["out"] == ref["out"]
    assert len(port["out"]["stream"]) == 30


def test_port_observes_the_reference_roles(witness_runs):
    ref = witness_runs["ref"]["stats"]["roles"]
    port = witness_runs["port"]["stats"]["roles"]
    assert set(port) == set(ref)
    assert {"dag-loop", "listener-bus", "stream-receiver", "batch-driver",
            "reaper"} <= set(port)
    for role, threads in ref.items():
        assert sorted(threads) == sorted(port[role]), role


def test_port_names_cover_the_reference(witness_runs):
    ref = set(witness_runs["ref"]["stats"]["names"])
    port = set(witness_runs["port"]["stats"]["names"])
    assert ref - port == (set(NAME_DIFFERENCES) | set(RUN_DIFFERENCES)) & ref
    assert "context.Context._dense_lock" in port


def test_port_locks_are_witness_locks_and_catch_an_inversion(witness_runs):
    st = witness_runs["port"]["stats"]
    assert st["witness_types"] == ["WitnessLock", "WitnessLock",
                                   "WitnessRLock"]
    assert st["inversion_raised"] is True
