"""The DAG scheduler: the port's copy of vega_tpu/scheduler/dag.py for the
local runtime.

A job's final RDD is cut into stages at its shuffle dependencies: a
shuffle-map stage per ShuffleDependency (cached per shuffle id, so a
later job over the same shuffle reuses its map outputs), and the result
stage. Each job runs its own event loop on its driver thread (the job
server's, jobserver.py): submit the stages whose parents are available,
their missing tasks through the task router (the job server's arbiter)
to the backend, then fold each task's completion:

- a map task's output location is recorded on its stage; a finished map
  stage registers its outputs with the map-output tracker and wakes the
  stages waiting on it;
- a failed task is retried up to max_failures attempts, after which the
  job aborts with TaskError raised from the task's exception;
- a FetchFailedError unregisters the missing output, marks the reading
  stage and the map stage failed, and resubmits them resubmit_timeout_s
  later (StageResubmitted);
- with speculation_enabled, a task running far past its stage's median
  gets one duplicate attempt, the first result wins and a failed
  duplicate costs no attempt of the budget;
- a cancelled job raises CancelledError out of its loop.

Concurrent jobs share map stages under per-stage ownership: one running
job drives a shared stage's missing tasks, the others wait for it.

Before its stages are cut, a job writes its lineage's checkpoints and
runs the prepare hook (the Context's: every DenseRDD of the lineage
materialized on the device), both on the job's driver thread, so task
threads touch no device work of their own making; the cyclic garbage
collector is paused for the job's run (paused_gc).

Placement (distributed/backend.py): a task's preferred locations are its
partition's cached locations, else its RDD's own, else its narrow
parents', else, past a shuffle, the servers holding most of its reduce
partition's input bytes (with locality_wait_s > 0). A lost executor
(_on_executor_lost, the backend's listener) has its server scrubbed from
every map stage's outputs and its cached partitions dropped, and every
running job whose lineage reads a stage that lost outputs resubmits it
at once; apply_decommission is the gentle form for a drained executor.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import logging
import queue
import time
from typing import Any, Callable, Dict, List, Optional, Set

from vega_tpu_torch.dependency import NarrowDependency, ShuffleDependency
from vega_tpu_torch.errors import CancelledError, FetchFailedError, \
    TaskError, VegaError
from vega_tpu_torch.lint.sync_witness import named_lock
from vega_tpu_torch.scheduler import events as ev
from vega_tpu_torch.scheduler.stage import Stage
from vega_tpu_torch.scheduler.task import (ResultTask, ShuffleMapTask,
                                           StageBinary, Task, TaskContext,
                                           TaskEndEvent)

log = logging.getLogger(__name__)

# pushed into a job's event queue to wake its loop at once (cancellation,
# scheduler stop)
_WAKE = object()

_gc_lock = named_lock("scheduler.dag._gc_lock")
_gc_holders = 0
_gc_was_enabled = False


@contextlib.contextmanager
def paused_gc():
    """The cyclic garbage collector off while any job runs: the host
    layer's rows, buckets and groups hold no cycles, and at millions of
    rows the collector's passes over them cost more than the job. The
    pause counts its holders, so one job's end does not turn the
    collector back on under another."""
    global _gc_holders, _gc_was_enabled
    with _gc_lock:
        if _gc_holders == 0:
            _gc_was_enabled = gc.isenabled()
            gc.disable()
        _gc_holders += 1
    try:
        yield
    finally:
        with _gc_lock:
            _gc_holders -= 1
            if _gc_holders == 0 and _gc_was_enabled:
                gc.enable()


def _lineage_token(rdd) -> tuple:
    """A fingerprint of the mutable lineage state a stage binary
    snapshots (persist flags, checkpoints): a change rebuilds it."""
    token = []
    seen = set()
    stack = [rdd]
    while stack:
        r = stack.pop()
        if r.rdd_id in seen:
            continue
        seen.add(r.rdd_id)
        checkpointed = getattr(r, "_checkpointed_rdd", None)
        token.append((
            r.rdd_id, bool(getattr(r, "should_cache", False)),
            str(getattr(r, "storage_level", None)),
            checkpointed.rdd_id if checkpointed is not None else -1))
        for dep in r.get_dependencies():
            stack.append(dep.rdd)
    return tuple(sorted(token))


def _lineage_shuffle_ids(rdd) -> Set[int]:
    out: Set[int] = set()
    seen: Set[int] = set()
    stack = [rdd]
    while stack:
        r = stack.pop()
        if r.rdd_id in seen:
            continue
        seen.add(r.rdd_id)
        for dep in r.get_dependencies():
            if isinstance(dep, ShuffleDependency):
                out.add(dep.shuffle_id)
            stack.append(dep.rdd)
    return out


class TaskBackend:
    """Runs tasks and reports each one's TaskEndEvent to its callback."""

    @property
    def preserialize_stage_binaries(self) -> bool:
        return False

    def submit(self, task: Task,
               callback: Callable[[TaskEndEvent], None]) -> None:
        raise NotImplementedError

    def cancel_task(self, task_id: int) -> None:
        """Best effort; completions are deduplicated driver-side."""

    def stop(self) -> None:
        pass

    @property
    def parallelism(self) -> int:
        return 1


class _Job:
    """One job's state, touched by its event loop's thread (cancel flips
    cancel_requested and wakes the queue from another)."""

    _ids = itertools.count(1)

    def __init__(self, final_rdd, func, partitions: List[int],
                 on_task_success: Optional[Callable[[int, Any], None]] = None,
                 pool: str = "default"):
        self.job_id = next(_Job._ids)
        self.final_rdd = final_rdd
        self.func = func
        self.partitions = partitions
        self.pool = pool or "default"
        self.results: List[Any] = [None] * len(partitions)
        self.finished: List[bool] = [False] * len(partitions)
        self.num_finished = 0
        self.on_task_success = on_task_success
        self.waiting: Set[Stage] = set()
        self.running: Set[Stage] = set()
        self.failed: Set[Stage] = set()
        self.pending_tasks: Dict[int, Set[int]] = {}
        self.task_attempts: Dict[tuple, int] = {}
        self.last_fetch_failure: float = 0.0
        # (stage, partition) -> {task_id: (task, submit time)}
        self.inflight: Dict[tuple, Dict[int, tuple]] = {}
        self.durations: Dict[int, List[float]] = {}
        self.stage_task_counts: Dict[int, int] = {}
        self.speculated: Set[tuple] = set()
        self.spec_task_ids: Dict[tuple, int] = {}
        self.last_speculation_sweep: float = 0.0
        self.event_queue: Optional["queue.Queue"] = None
        self.cancel_requested = False
        self.cancel_reason: Optional[str] = None
        self.submitted_stages: Set[Stage] = set()
        self.stage_starts: Dict[int, float] = {}
        # every shuffle the final RDD's lineage reads (an executor loss
        # resubmits their stages in this job)
        self.lineage_shuffle_ids: Set[int] = (
            _lineage_shuffle_ids(final_rdd) if final_rdd is not None
            else set())

    def live_copies(self, key: tuple) -> int:
        return len(self.inflight.get(key, ()))


class DAGScheduler:
    def __init__(self, backend: TaskBackend, env,
                 bus: Optional[ev.LiveListenerBus] = None):
        self.backend = backend
        self.env = env
        self.bus = bus or ev.LiveListenerBus()
        self._next_stage_id = itertools.count(0)
        self._shuffle_to_map_stage: Dict[int, Stage] = {}
        self._stages_lock = named_lock(
            "scheduler.dag.DAGScheduler._stages_lock", reentrant=True)
        self._running_jobs: Dict[int, _Job] = {}
        self._stage_owners: Dict[int, int] = {}
        self._stage_users: Dict[int, int] = {}
        # set by the job server: tasks go through its arbiter
        self.task_router = None
        # set by the Context: prepare(rdd) runs on the job's driver thread
        # before its stages are cut (the lineage's device work)
        self.prepare: Optional[Callable[[Any], None]] = None

    # --- public -------------------------------------------------------------
    def run_job(self, rdd, func, partitions: Optional[List[int]] = None
                ) -> list:
        """The job's event loop on the calling thread."""
        if partitions is None:
            partitions = list(range(rdd.num_partitions))
        if not partitions:
            return []
        return self._run_job_inner(rdd, func, partitions, None)

    def run_job_with_listener(self, rdd, func, partitions,
                              on_task_success) -> list:
        return self._run_job_inner(rdd, func, partitions, on_task_success)

    def stop(self) -> None:
        """Cancel every running job (each raises CancelledError), then
        stop the backend and the bus."""
        with self._stages_lock:
            jobs = list(self._running_jobs.values())
        for job in jobs:
            job.cancel_reason = job.cancel_reason or \
                "scheduler stopped with the job in flight"
            job.cancel_requested = True
            q = job.event_queue
            if q is not None:
                q.put(_WAKE)
        self.backend.stop()
        self.bus.stop()

    # --- stages -------------------------------------------------------------
    def _new_stage(self, rdd, shuffle_dep: Optional[ShuffleDependency]
                   ) -> Stage:
        self.env.cache_tracker.register_rdd(rdd.rdd_id, rdd.num_partitions)
        if shuffle_dep is not None:
            self.env.map_output_tracker.register_shuffle(
                shuffle_dep.shuffle_id, rdd.num_partitions)
        return Stage(next(self._next_stage_id), rdd, shuffle_dep,
                     self._get_parent_stages(rdd))

    def _get_shuffle_map_stage(self, dep: ShuffleDependency) -> Stage:
        """One Stage per shuffle id, made at first need and reused by
        every later job."""
        with self._stages_lock:
            stage = self._shuffle_to_map_stage.get(dep.shuffle_id)
            if stage is None:
                stage = self._new_stage(dep.rdd, dep)
                self._shuffle_to_map_stage[dep.shuffle_id] = stage
            return stage

    def _get_parent_stages(self, rdd) -> List[Stage]:
        """The map stages of the shuffle edges reached through narrow
        edges."""
        parents: List[Stage] = []
        seen_rdds: Set[int] = set()
        seen_stage_ids: Set[int] = set()

        def visit(r):
            if r.rdd_id in seen_rdds:
                return
            seen_rdds.add(r.rdd_id)
            for dep in r.get_dependencies():
                if isinstance(dep, ShuffleDependency):
                    stage = self._get_shuffle_map_stage(dep)
                    if stage.id not in seen_stage_ids:
                        seen_stage_ids.add(stage.id)
                        parents.append(stage)
                else:
                    visit(dep.rdd)

        visit(rdd)
        return parents

    def _get_missing_parent_stages(self, stage: Stage) -> List[Stage]:
        missing: List[Stage] = []
        seen: Set[int] = set()
        tracker = self.env.map_output_tracker

        def visit(r):
            if r.rdd_id in seen:
                return
            seen.add(r.rdd_id)
            for dep in r.get_dependencies():
                if isinstance(dep, ShuffleDependency):
                    parent = self._get_shuffle_map_stage(dep)
                    available = parent.is_available and tracker.has_outputs(
                        dep.shuffle_id)
                    if not available and parent not in missing:
                        missing.append(parent)
                else:
                    visit(dep.rdd)

        visit(stage.rdd)
        return missing

    def _get_preferred_locs(self, rdd, partition: int, depth: int = 0,
                            memo: Optional[Dict] = None) -> List[str]:
        """Cached locations, else the RDD's own preference, else its
        narrow parents' (memo: one per submit_missing_tasks call)."""
        if depth > 20:
            return []
        key = (rdd.rdd_id, partition)
        if memo is not None and key in memo:
            return memo[key]
        locs = self._compute_preferred_locs(rdd, partition, depth, memo)
        if memo is not None:
            memo[key] = locs
        return locs

    def _compute_preferred_locs(self, rdd, partition: int, depth: int,
                                memo: Optional[Dict]) -> List[str]:
        if rdd.should_cache:
            cached = self.env.cache_tracker.get_cache_locs(rdd.rdd_id,
                                                           partition)
            if cached:
                return cached
        splits = rdd.cached_splits()
        if partition < len(splits):
            prefs = rdd.preferred_locations(splits[partition])
            if prefs:
                return prefs
        for dep in rdd.get_dependencies():
            if isinstance(dep, NarrowDependency):
                for parent_part in dep.get_parents(partition):
                    locs = self._get_preferred_locs(dep.rdd, parent_part,
                                                    depth + 1, memo)
                    if locs:
                        return locs
            elif isinstance(dep, ShuffleDependency):
                locs = self._reduce_side_prefs(dep, partition)
                if locs:
                    return locs
        return []

    def _reduce_side_prefs(self, dep: ShuffleDependency,
                           reduce_id: int) -> List[str]:
        """Where a reduce task prefers to run: under shuffle_plan="push"
        a named monoid's reduce partition on its pre-merge owner (the
        mappers' rotation over the backend's live peers, so the fetcher
        reads the frozen blob in process), else the shuffle servers
        holding most of reduce_id's input bytes (the tracker's per-bucket
        sizes). Hints: empty with locality_wait_s 0 or no sizes, never
        "local"."""
        conf = self.env.conf
        if float(conf.locality_wait_s or 0.0) <= 0:
            return []
        from vega_tpu_torch.dependency import (is_mergeable, is_push_plan,
                                               push_owner_for_peers)

        if is_push_plan(conf) and is_mergeable(dep.aggregator):
            peers_fn = getattr(self.backend, "shuffle_peer_uris", None)
            if peers_fn is not None:
                owner = push_owner_for_peers(peers_fn(), reduce_id)
                if owner:
                    return [owner]
        return [u for u in self.env.map_output_tracker.top_reduce_locations(
                    dep.shuffle_id, reduce_id) if u and u != "local"]

    # --- stage ownership between concurrent jobs ----------------------------
    def _try_claim_stage(self, stage: Stage, job: _Job) -> bool:
        with self._stages_lock:
            owner = self._stage_owners.get(stage.id)
            if owner is None or owner == job.job_id \
                    or owner not in self._running_jobs:
                self._stage_owners[stage.id] = job.job_id
                return True
            return False

    def _stage_foreign_owned(self, stage: Stage, job: _Job) -> bool:
        with self._stages_lock:
            owner = self._stage_owners.get(stage.id)
            return owner is not None and owner != job.job_id \
                and owner in self._running_jobs

    def _release_stage_ownership(self, stage: Stage, job: _Job) -> None:
        with self._stages_lock:
            if self._stage_owners.get(stage.id) == job.job_id:
                del self._stage_owners[stage.id]

    def _externally_satisfied(self, stage: Stage) -> bool:
        """A map stage another job completed while this one waited."""
        if not stage.is_shuffle_map or not stage.is_available:
            return False
        return self.env.map_output_tracker.has_outputs(
            stage.shuffle_dep.shuffle_id)

    def _register_job(self, job: _Job) -> None:
        with self._stages_lock:
            self._running_jobs[job.job_id] = job

    def _release_job(self, job: _Job) -> None:
        """The job's end: its queued tasks purged, its stage ownerships
        released, and the serialized binaries of stages no running job
        uses dropped."""
        router = self.task_router
        if router is not None:
            router.purge(job.job_id)
        release: List[Stage] = []
        with self._stages_lock:
            self._running_jobs.pop(job.job_id, None)
            for sid, owner in list(self._stage_owners.items()):
                if owner == job.job_id:
                    del self._stage_owners[sid]
            for stage in job.submitted_stages:
                left = self._stage_users.get(stage.id, 1) - 1
                if left <= 0:
                    self._stage_users.pop(stage.id, None)
                    release.append(stage)
                else:
                    self._stage_users[stage.id] = left
        for stage in release:
            if stage.task_binary is not None:
                stage.task_binary.release_payload()

    def _cancel_inflight(self, job: _Job) -> None:
        for copies in list(job.inflight.values()):
            for task_id in list(copies):
                self.backend.cancel_task(task_id)

    # --- the event loop -----------------------------------------------------
    def _run_job_inner(self, rdd, func, partitions: List[int],
                       on_task_success, job: Optional[_Job] = None) -> list:
        t_start = time.time()
        released = self.env.drain_released_shuffles()
        if released:
            with self._stages_lock:
                for sid in released:
                    self._shuffle_to_map_stage.pop(sid, None)
        if job is None:
            job = _Job(rdd, func, partitions, on_task_success)
        event_queue: "queue.Queue[TaskEndEvent]" = queue.Queue()
        job.event_queue = event_queue
        self._register_job(job)
        try:
            with paused_gc():
                return self._drive_job(job, rdd, func, partitions,
                                       event_queue, self.env.conf, t_start)
        finally:
            self._release_job(job)

    def _check_cancel(self, job: _Job) -> None:
        if job.cancel_requested:
            raise CancelledError(
                job.cancel_reason or f"job {job.job_id} cancelled")

    def _drive_job(self, job: _Job, rdd, func, partitions: List[int],
                   event_queue: "queue.Queue", conf, t_start: float) -> list:
        self._check_cancel(job)
        rdd._do_checkpoint()
        if self.prepare is not None:
            self.prepare(rdd)
        on_task_success = job.on_task_success
        final_stage = self._new_stage(rdd, None)

        self.bus.post(ev.JobStart(job_id=job.job_id, pool=job.pool,
                                  num_stages=1 + len(final_stage.parents)))

        # one partition and no parent stage: the task runs inline on the
        # driver thread
        if not final_stage.parents and len(partitions) == 1:
            try:
                split = rdd.cached_splits()[partitions[0]]
                tc = TaskContext(final_stage.id, split.index, 0)
                result = func(tc, rdd.iterator(split, tc))
            except BaseException:
                self.bus.post(ev.JobEnd(job_id=job.job_id, succeeded=False,
                                        duration_s=time.time() - t_start))
                raise
            if on_task_success is not None:
                on_task_success(0, result)
            self.bus.post(ev.JobEnd(job_id=job.job_id, succeeded=True,
                                    duration_s=time.time() - t_start))
            return [result]

        stage_starts = job.stage_starts

        def submit_stage(stage: Stage):
            """Submit the stage once its parents are available, else its
            missing parents first (a parent another running job drives
            is waited on)."""
            if stage in job.waiting or stage in job.running:
                return
            missing = self._get_missing_parent_stages(stage)
            if not missing:
                if self._try_claim_stage(stage, job):
                    submit_missing_tasks(stage)
                    job.running.add(stage)
                else:
                    job.waiting.add(stage)
            else:
                job.waiting.add(stage)
                for parent in missing:
                    if self._stage_foreign_owned(parent, job):
                        job.waiting.add(parent)
                    else:
                        submit_stage(parent)

        def submit_missing_tasks(stage: Stage):
            stage_starts.setdefault(stage.id, time.time())
            if stage not in job.submitted_stages:
                job.submitted_stages.add(stage)
                with self._stages_lock:
                    self._stage_users[stage.id] = \
                        self._stage_users.get(stage.id, 0) + 1
            pending = job.pending_tasks.setdefault(stage.id, set())
            tasks: List[Task] = []
            locs_memo: Dict = {}
            if stage is final_stage:
                splits = rdd.cached_splits()
                for out_id, p in enumerate(partitions):
                    if not job.finished[out_id]:
                        tasks.append(ResultTask(
                            stage.id, rdd, func, p, splits[p], out_id,
                            self._get_preferred_locs(rdd, p, memo=locs_memo),
                            pinned=rdd.is_pinned))
            else:
                splits = stage.rdd.cached_splits()
                for p in range(stage.num_partitions):
                    if not stage.output_locs[p]:
                        tasks.append(ShuffleMapTask(
                            stage.id, stage.rdd, stage.shuffle_dep, p,
                            splits[p],
                            self._get_preferred_locs(stage.rdd, p,
                                                     memo=locs_memo),
                            pinned=stage.rdd.is_pinned))
            # one binary for every task of the stage, rebuilt only when
            # the lineage state it snapshotted changed
            token = _lineage_token(stage.rdd)
            if stage.task_binary is None or stage.task_binary_token != token:
                if stage is final_stage:
                    stage.task_binary = StageBinary("result", rdd, func)
                else:
                    stage.task_binary = StageBinary(
                        "shuffle", stage.rdd, stage.shuffle_dep)
                stage.task_binary_token = token
            if self.backend.preserialize_stage_binaries:
                stage.task_binary.ensure_serialized()
            for task in tasks:
                task.stage_binary = stage.task_binary
            self.bus.post(ev.StageSubmitted(
                stage_id=stage.id, num_tasks=len(tasks),
                is_shuffle_map=stage.is_shuffle_map, job_id=job.job_id))
            job.stage_task_counts[stage.id] = (
                job.stage_task_counts.get(stage.id, 0) + len(tasks))
            for task in tasks:
                pending.add(task.partition)
            for task in tasks:
                tkey = (task.stage_id, task.partition)
                job.inflight.setdefault(tkey, {})[task.task_id] = (
                    task, time.time())
                self._submit_task(task, event_queue, job)

        def wake_waiting():
            """Submit the waiting stages whose parents became available
            (completed by this job or by another it waited on)."""
            for s in list(job.waiting):
                if s in job.running:
                    job.waiting.discard(s)
                    continue
                missing = self._get_missing_parent_stages(s)
                if not missing:
                    if self._externally_satisfied(s):
                        job.waiting.discard(s)
                    elif self._try_claim_stage(s, job):
                        job.waiting.discard(s)
                        job.running.add(s)
                        submit_missing_tasks(s)
                else:
                    for parent in missing:
                        if parent in job.running or parent in job.waiting:
                            continue
                        if not self._stage_foreign_owned(parent, job):
                            submit_stage(parent)
                        else:
                            job.waiting.add(parent)

        def stage_of(task: Task) -> Optional[Stage]:
            if task.stage_id == final_stage.id:
                return final_stage
            for s in itertools.chain(list(job.running), list(job.waiting),
                                     list(job.failed)):
                if s.id == task.stage_id:
                    return s
            return self._stage_by_id(task.stage_id)

        def committed(task: Task) -> bool:
            if isinstance(task, ResultTask):
                return job.finished[task.output_id]
            pending = job.pending_tasks.get(task.stage_id)
            return pending is not None and task.partition not in pending

        def settle_speculation(winner: Task):
            """First commit of a partition: which copy won, and the
            losers cancelled."""
            key = (winner.stage_id, winner.partition)
            if key in job.speculated:
                spec_id = job.spec_task_ids.get(key)
                if winner.task_id == spec_id:
                    self.bus.post(ev.SpeculativeWon(
                        stage_id=key[0], partition=key[1],
                        job_id=job.job_id))
                else:
                    self.bus.post(ev.SpeculativeLost(
                        stage_id=key[0], partition=key[1],
                        job_id=job.job_id))
            for task_id in list(job.inflight.get(key, ())):
                self.backend.cancel_task(task_id)

        def on_success(event: TaskEndEvent):
            task = event.task
            stage = stage_of(task)
            if isinstance(task, ResultTask):
                out_id = task.output_id
                if not job.finished[out_id]:
                    job.results[out_id] = event.result
                    job.finished[out_id] = True
                    job.num_finished += 1
                    settle_speculation(task)
                    if job.on_task_success is not None:
                        job.on_task_success(out_id, event.result)
            else:
                if stage is None:
                    return
                pending = job.pending_tasks.get(stage.id)
                if pending is not None and task.partition not in pending:
                    return  # a duplicate completion
                stage.add_output_loc(task.partition, event.result)
                if pending is not None:
                    pending.discard(task.partition)
                settle_speculation(task)
                if pending is not None and not pending:
                    self._finish_map_stage(job, stage, wake_waiting,
                                           submit_missing_tasks,
                                           stage_starts)

        def on_failure(event: TaskEndEvent):
            task = event.task
            err = event.error
            # a failure of a partition already committed is no failure
            if isinstance(task, ResultTask) and job.finished[task.output_id]:
                return
            if isinstance(task, ShuffleMapTask):
                stage = stage_of(task)
                pending = job.pending_tasks.get(task.stage_id)
                if (stage is not None and pending is not None
                        and task.partition not in pending):
                    return
            if isinstance(err, FetchFailedError):
                log.info("fetch failure: %s", err)
                with self._stages_lock:
                    map_stage = self._shuffle_to_map_stage.get(
                        err.shuffle_id)
                if map_stage is not None and err.map_id is not None:
                    map_stage.remove_output_loc(err.map_id, err.server_uri)
                    try:
                        self.env.map_output_tracker.unregister_map_output(
                            err.shuffle_id, err.map_id, err.server_uri)
                    except VegaError:
                        pass
                this_stage = stage_of(task)
                if this_stage is not None:
                    job.running.discard(this_stage)
                    job.failed.add(this_stage)
                if map_stage is not None:
                    job.running.discard(map_stage)
                    job.failed.add(map_stage)
                job.last_fetch_failure = time.time()
                return
            key = (task.stage_id, task.partition)
            if job.live_copies(key) > 0:
                # another copy still runs and decides the partition; a
                # failed duplicate costs no attempt
                if task.speculative:
                    if key in job.speculated:
                        self.bus.post(ev.SpeculativeLost(
                            stage_id=key[0], partition=key[1],
                            job_id=job.job_id))
                    job.speculated.discard(key)
                    job.spec_task_ids.pop(key, None)
                    copies = job.inflight.get(key)
                    if copies:
                        now = time.time()
                        for tid, (t, _t0) in list(copies.items()):
                            copies[tid] = (t, now)
                return
            if task.speculative:
                task.speculative = False
                task.exclude_executors = frozenset()
                job.speculated.discard(key)
                job.spec_task_ids.pop(key, None)
            tries = job.task_attempts.get(key, 0) + 1
            job.task_attempts[key] = tries
            if tries < conf.max_failures:
                log.warning("task %s failed (attempt %d/%d): %s",
                            task, tries, conf.max_failures, err)
                task.attempt = tries
                job.inflight.setdefault(key, {})[task.task_id] = (
                    task, time.time())
                job.speculated.discard(key)
                job.spec_task_ids.pop(key, None)
                self._submit_task(task, event_queue, job)
            else:
                raise TaskError(
                    f"task {task} failed {tries} times; aborting job: "
                    f"{err!r}",
                    remote_traceback=getattr(err, "remote_traceback", None),
                ) from err

        try:
            submit_stage(final_stage)
            while job.num_finished < len(partitions):
                self._check_cancel(job)
                try:
                    event = event_queue.get(timeout=conf.poll_timeout_s)
                except queue.Empty:
                    self._maybe_resubmit_failed(job, submit_stage, conf)
                    self._maybe_speculate(job, conf, event_queue)
                    wake_waiting()
                    continue
                if event is _WAKE:
                    continue
                self.bus.post(ev.TaskEnd(
                    task_id=event.task.task_id, stage_id=event.task.stage_id,
                    partition=event.task.partition, success=event.success,
                    duration_s=event.duration_s, dispatch=event.dispatch,
                    speculative=event.task.speculative,
                    duplicate=bool(event.success and committed(event.task)),
                    job_id=job.job_id, executor=event.executor or "local",
                    locality=event.locality))
                key = (event.task.stage_id, event.task.partition)
                copies = job.inflight.get(key)
                if copies is not None:
                    copies.pop(event.task.task_id, None)
                    if not copies:
                        job.inflight.pop(key, None)
                if event.success:
                    job.durations.setdefault(
                        event.task.stage_id, []).append(event.duration_s)
                    on_success(event)
                else:
                    on_failure(event)
                self._maybe_resubmit_failed(job, submit_stage, conf)
                self._maybe_speculate(job, conf, event_queue)
                wake_waiting()
            self.bus.post(ev.JobEnd(job_id=job.job_id, succeeded=True,
                                    duration_s=time.time() - t_start))
            return job.results
        except BaseException:
            self.bus.post(ev.JobEnd(job_id=job.job_id, succeeded=False,
                                    cancelled=job.cancel_requested,
                                    duration_s=time.time() - t_start))
            if job.cancel_requested:
                self._cancel_inflight(job)
            raise

    # --- internals ----------------------------------------------------------
    def _on_executor_lost(self, executor_id: str, host: str,
                          shuffle_uri: Optional[str], reason: str) -> None:
        """The backend's listener (its reaper's thread): the executor's
        cached partitions dropped from the cache tracker, its server from
        every map stage's outputs (the tracker was swept already), and
        every stage that lost outputs marked failed in each running job
        whose lineage reads it, so its event loop resubmits it at once
        instead of waiting for a reduce task's fetch to fail."""
        from vega_tpu_torch import dependency

        dependency._invalidate_peer_cache()
        dropped = self.env.cache_tracker.drop_executor(executor_id)
        if dropped:
            log.info("dropped %d cached-partition locations of lost "
                     "executor %s", dropped, executor_id)
        if not shuffle_uri:
            return
        with self._stages_lock:
            stages = list(self._shuffle_to_map_stage.values())
            jobs = list(self._running_jobs.values())
        # the tracker's sweep ran first and put coded: locations where a
        # surviving parity group decodes an output; the stages take them
        # in, so those outputs stay available, and drop the coded:
        # locations whose parity died with the server
        tracker = self.env.map_output_tracker
        dead_prefix = f"coded:{shuffle_uri}/"
        lost_stages = []
        for stage in stages:
            before = stage.num_available_outputs
            stage.remove_outputs_on_server(shuffle_uri)
            for p in range(stage.num_partitions):
                if any(u.startswith(dead_prefix)
                       for u in stage.output_locs[p]):
                    stage.output_locs[p] = [
                        u for u in stage.output_locs[p]
                        if not u.startswith(dead_prefix)]
            for p, pseudo in tracker.coded_locations(
                    stage.shuffle_dep.shuffle_id).items():
                if 0 <= p < stage.num_partitions \
                        and not stage.output_locs[p]:
                    stage.output_locs[p] = [pseudo]
            if stage.num_available_outputs < before:
                lost_stages.append(stage)
        for job in jobs:
            for stage in lost_stages:
                if stage.shuffle_dep.shuffle_id in job.lineage_shuffle_ids:
                    job.running.discard(stage)
                    job.failed.add(stage)
                    job.last_fetch_failure = time.time()
            q = job.event_queue
            if lost_stages and q is not None:
                q.put(_WAKE)

    def apply_decommission(self, shuffle_uri: str, rebind: Dict[tuple, str],
                           lost: Set[tuple]) -> None:
        """A drained executor's server leaves every map stage's outputs:
        the (shuffle_id, map_id) entries in rebind (copied to a survivor)
        take the survivor's uri in place, the rest are removed, and the
        running jobs whose lineage reads a lost shuffle resubmit its
        stage."""
        with self._stages_lock:
            stages = list(self._shuffle_to_map_stage.values())
            jobs = list(self._running_jobs.values())
        lost_shuffles = {shuffle_id for shuffle_id, _ in lost}
        for stage in stages:
            shuffle_id = stage.shuffle_dep.shuffle_id
            for p in range(stage.num_partitions):
                new_uri = rebind.get((shuffle_id, p))
                locs = stage.output_locs[p]
                if new_uri and shuffle_uri in locs:
                    swapped = [new_uri if u == shuffle_uri else u
                               for u in locs]
                    stage.output_locs[p] = list(dict.fromkeys(swapped))
            stage.remove_outputs_on_server(shuffle_uri)
        if not lost_shuffles:
            return
        for job in jobs:
            for stage in stages:
                if stage.shuffle_dep.shuffle_id in lost_shuffles \
                        and stage.shuffle_dep.shuffle_id \
                        in job.lineage_shuffle_ids \
                        and not stage.is_available:
                    job.running.discard(stage)
                    job.failed.add(stage)
                    job.last_fetch_failure = time.time()

    def _stage_by_id(self, stage_id: int) -> Optional[Stage]:
        with self._stages_lock:
            stages = list(self._shuffle_to_map_stage.values())
        for stage in stages:
            if stage.id == stage_id:
                return stage
        return None

    def _finish_map_stage(self, job: _Job, stage: Stage, wake_waiting,
                          submit_missing_tasks, stage_starts) -> None:
        """Every pending task of a map stage drained: register its
        outputs and wake its waiters, or resubmit its holes."""
        if stage.is_available:
            job.running.discard(stage)
            job.failed.discard(stage)
            tracker = self.env.map_output_tracker
            tracker.register_map_outputs(
                stage.shuffle_dep.shuffle_id,
                [list(locs) if locs else None for locs in stage.output_locs])
            if stage.bucket_sizes:
                tracker.register_map_sizes(stage.shuffle_dep.shuffle_id,
                                           stage.bucket_sizes)
            self._release_stage_ownership(stage, job)
            self.bus.post(ev.StageCompleted(
                stage_id=stage.id, job_id=job.job_id,
                duration_s=time.time() - stage_starts.get(stage.id,
                                                          time.time())))
            wake_waiting()
        else:
            self.bus.post(ev.StageResubmitted(stage_id=stage.id,
                                              job_id=job.job_id))
            submit_missing_tasks(stage)
            job.running.add(stage)

    def _maybe_resubmit_failed(self, job: _Job, submit_stage, conf) -> None:
        """Stages failed by a fetch failure, resubmitted
        resubmit_timeout_s after the last one."""
        if not job.failed:
            return
        if time.time() - job.last_fetch_failure < conf.resubmit_timeout_s:
            return
        to_retry = list(job.failed)
        job.failed.difference_update(to_retry)
        log.info("resubmitting failed stages: %s", to_retry)
        for stage in to_retry:
            self.bus.post(ev.StageResubmitted(stage_id=stage.id,
                                              job_id=job.job_id))
            submit_stage(stage)

    def _maybe_speculate(self, job: _Job, conf, event_queue) -> None:
        """Once speculation_quorum of a stage's tasks finished, a task
        running past max(speculation_min_s, speculation_multiplier x the
        stage's median) gets one duplicate attempt."""
        if not conf.speculation_enabled:
            return
        now = time.time()
        if now - job.last_speculation_sweep < 0.1:
            return
        job.last_speculation_sweep = now
        quorum = max(0.0, min(1.0, conf.speculation_quorum))
        medians: Dict[int, float] = {}
        for stage_id, durs in job.durations.items():
            total = job.stage_task_counts.get(stage_id, 0)
            if durs and total and len(durs) >= max(1, int(quorum * total)):
                medians[stage_id] = sorted(durs)[len(durs) // 2]
        for key, copies in list(job.inflight.items()):
            if key in job.speculated or key[0] not in medians \
                    or len(copies) != 1:
                continue
            (task, t0), = copies.values()
            threshold = max(conf.speculation_min_s,
                            conf.speculation_multiplier * medians[key[0]])
            if now - t0 <= threshold:
                continue
            clone = task.speculative_copy()
            job.speculated.add(key)
            job.spec_task_ids[key] = clone.task_id
            copies[clone.task_id] = (clone, now)
            log.info("speculating a duplicate of %s (%.2fs > %.2fs)", task,
                     now - t0, threshold)
            self.bus.post(ev.SpeculativeLaunched(
                stage_id=key[0], partition=key[1], task_id=clone.task_id,
                job_id=job.job_id))
            self._submit_task(clone, event_queue, job)

    def _submit_task(self, task: Task,
                     event_queue: "queue.Queue[TaskEndEvent]",
                     job: _Job) -> None:
        task.job_id = job.job_id
        router = self.task_router
        if router is not None:
            router.submit(task, event_queue.put, job)
        else:
            self.backend.submit(task, event_queue.put)
