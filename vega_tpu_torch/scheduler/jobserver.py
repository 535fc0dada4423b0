"""The job server, front door of the DAG scheduler: the port's copy of
vega_tpu/scheduler/jobserver.py.

- JobFuture: what submit_job and the *_async actions return
  (result, exception, done, running, cancelled, cancel,
  add_done_callback); cancel() stops a running job too: no more of its
  tasks launch and result() raises CancelledError.
- TaskArbiter: between every job's event loop and the backend. Ready
  tasks queue per pool, at most backend.parallelism run at once. "fifo"
  dispatches in submission order across pools; "fair" picks the pool
  with the smallest running / weight share, then the job with the fewest
  running tasks. A pool's max_concurrent_tasks binds in both modes.
- JobServer: admission (at most max_queued jobs of a pool in flight, the
  pool's own bound or the Context's pool_max_queued; past it "reject"
  raises JobRejectedError and posts JobRejected, "block" parks the
  submitter until a job of the pool settles), one driver thread per job
  running its event loop (dag.py), and stop(), which cancels every job in
  flight and settles its future.

Two additions of the port: submit(..., inline=True) runs the job's event
loop on the calling thread (the Context does so across processes, where
every process must run its host jobs one at a time in one order), and
submit_call(finish) runs a callable as a job of a pool on a thread of its
own (the dense tier's asynchronous actions, whose device work ran at
submission and which run no tasks).
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from vega_tpu_torch.errors import CancelledError, JobRejectedError, VegaError
from vega_tpu_torch.lint.sync_witness import named_lock, note_thread_role
from vega_tpu_torch.scheduler import events as ev
from vega_tpu_torch.scheduler.dag import _WAKE, DAGScheduler, _Job
from vega_tpu_torch.scheduler.task import Task, TaskEndEvent

log = logging.getLogger(__name__)

ADMISSION_MODES = ("reject", "block")

_local = threading.local()


def in_job() -> bool:
    """Whether the calling thread is a job's driver thread."""
    return getattr(_local, "in_job", False)


def check_admission_mode(mode: str) -> str:
    if mode not in ADMISSION_MODES:
        raise VegaError(f"unknown admission_mode {mode!r} (expected "
                        "'reject' or 'block')")
    return mode


@dataclasses.dataclass
class PoolConfig:
    """A pool: weight skews the fair share, max_concurrent_tasks caps its
    running tasks, max_queued bounds its jobs in flight (None: the
    Context's pool_max_queued; 0: no bound)."""

    name: str = "default"
    weight: int = 1
    max_concurrent_tasks: Optional[int] = None
    max_queued: Optional[int] = None


_DEFAULT_POOL = PoolConfig()


@dataclasses.dataclass
class _PendingTask:
    seq: int
    job_id: int
    pool: str
    task: Task
    callback: Callable[[TaskEndEvent], None]


class TaskArbiter:
    def __init__(self, backend, mode: str = "fifo"):
        self.backend = backend
        self._mode = mode if mode in ("fifo", "fair") else "fifo"
        self._seq = itertools.count(0)
        self._pools: Dict[str, PoolConfig] = {"default": _DEFAULT_POOL}
        self._pending: Dict[str, deque] = {}
        self._running_total = 0
        self._running_by_pool: Dict[str, int] = {}
        self._running_by_job: Dict[int, int] = {}
        self._lock = named_lock("scheduler.jobserver.TaskArbiter._lock")

    def set_pool(self, name: str, weight: int = 1,
                 max_concurrent_tasks: Optional[int] = None,
                 max_queued: Optional[int] = None) -> PoolConfig:
        cfg = PoolConfig(name, max(1, int(weight)), max_concurrent_tasks,
                         max_queued)
        with self._lock:
            self._pools[name] = cfg
        self._pump()
        return cfg

    def pool_config(self, name: str) -> Optional[PoolConfig]:
        with self._lock:
            return self._pools.get(name)

    def submit(self, task: Task, callback: Callable[[TaskEndEvent], None],
               job) -> None:
        entry = _PendingTask(next(self._seq), job.job_id,
                             getattr(job, "pool", "default") or "default",
                             task, callback)
        with self._lock:
            self._pending.setdefault(entry.pool, deque()).append(entry)
        self._pump()

    def stats(self) -> Dict[str, Any]:
        """Running and queued tasks, in all and per pool (the elastic
        fleet's load signal, and fleet_status's scheduler section)."""
        with self._lock:
            return {
                "mode": self._mode,
                "running": self._running_total,
                "queued": sum(len(dq) for dq in self._pending.values()),
                "running_by_pool": dict(self._running_by_pool),
                "queued_by_pool": {name: len(dq)
                                   for name, dq in self._pending.items()
                                   if dq},
            }

    def purge(self, job_id: int) -> int:
        """Drop a finished or cancelled job's queued tasks (their
        callbacks are not called); returns how many."""
        dropped = 0
        with self._lock:
            for dq in self._pending.values():
                keep = [e for e in dq if e.job_id != job_id]
                dropped += len(dq) - len(keep)
                dq.clear()
                dq.extend(keep)
        return dropped

    def _pick_locked(self) -> Optional[_PendingTask]:
        candidates: List[deque] = []
        for name, dq in self._pending.items():
            if not dq:
                continue
            cfg = self._pools.get(name, _DEFAULT_POOL)
            if cfg.max_concurrent_tasks is not None and \
                    self._running_by_pool.get(name, 0) >= \
                    cfg.max_concurrent_tasks:
                continue
            candidates.append(dq)
        if not candidates:
            return None
        if self._mode != "fair":
            dq = min(candidates, key=lambda d: d[0].seq)
            return dq.popleft()

        def pool_key(d: deque):
            cfg = self._pools.get(d[0].pool, _DEFAULT_POOL)
            share = self._running_by_pool.get(d[0].pool, 0) / max(
                1, cfg.weight)
            return (share, d[0].seq)

        dq = min(candidates, key=pool_key)
        best_i = 0
        best_key = None
        for i, e in enumerate(dq):
            key = (self._running_by_job.get(e.job_id, 0), e.seq)
            if best_key is None or key < best_key:
                best_key, best_i = key, i
        entry = dq[best_i]
        del dq[best_i]
        return entry

    def _pump(self) -> None:
        batch: List[_PendingTask] = []
        with self._lock:
            while self._running_total < max(1, self.backend.parallelism):
                entry = self._pick_locked()
                if entry is None:
                    break
                self._running_total += 1
                self._running_by_pool[entry.pool] = \
                    self._running_by_pool.get(entry.pool, 0) + 1
                self._running_by_job[entry.job_id] = \
                    self._running_by_job.get(entry.job_id, 0) + 1
                batch.append(entry)
        for entry in batch:
            try:
                self.backend.submit(entry.task, self._wrap(entry))
            except BaseException as exc:  # noqa: BLE001 — delivered
                log.exception("arbiter dispatch of %s failed", entry.task)
                self._release(entry)
                entry.callback(TaskEndEvent(task=entry.task, success=False,
                                            error=exc))

    def _release(self, entry: _PendingTask) -> None:
        with self._lock:
            self._running_total = max(0, self._running_total - 1)
            self._running_by_pool[entry.pool] = max(
                0, self._running_by_pool.get(entry.pool, 1) - 1)
            left = self._running_by_job.get(entry.job_id, 1) - 1
            if left <= 0:
                self._running_by_job.pop(entry.job_id, None)
            else:
                self._running_by_job[entry.job_id] = left

    def _wrap(self, entry: _PendingTask):
        def done(event: TaskEndEvent) -> None:
            self._release(entry)
            try:
                entry.callback(event)
            finally:
                self._pump()

        return done


class JobFuture:
    def __init__(self, job: _Job, server: "JobServer",
                 transform: Optional[Callable[[list], Any]] = None):
        self._job = job
        self._server = server
        self._transform = transform
        self._done = threading.Event()
        self._result: Any = None
        self._exception: Optional[BaseException] = None
        self._was_cancelled = False
        self._callbacks: List[Callable[["JobFuture"], None]] = []
        self._lock = named_lock("scheduler.jobserver.JobFuture._lock")

    @property
    def job_id(self) -> int:
        return self._job.job_id

    @property
    def pool(self) -> str:
        return self._job.pool

    def done(self) -> bool:
        return self._done.is_set()

    def running(self) -> bool:
        return not self._done.is_set()

    def cancelled(self) -> bool:
        return self._done.is_set() and self._was_cancelled

    def result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"job {self.job_id} did not complete within {timeout}s")
        if self._exception is not None:
            raise self._exception
        return self._result

    def exception(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"job {self.job_id} did not complete within {timeout}s")
        return self._exception

    def cancel(self, reason: Optional[str] = None) -> bool:
        """Stop the job; result() then raises CancelledError. False if it
        already finished."""
        with self._lock:
            if self._done.is_set():
                return False
        self._server._cancel_job(self._job, reason)
        return True

    def add_done_callback(self, fn: Callable[["JobFuture"], None]) -> None:
        with self._lock:
            if not self._done.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def _complete(self, partition_results: list) -> None:
        if self._transform is not None:
            try:
                value = self._transform(partition_results)
            except BaseException as exc:  # noqa: BLE001 — via result()
                log.debug("job %d result transform failed", self.job_id,
                          exc_info=True)
                self._fail(exc)
                return
        else:
            value = partition_results
        self._settle(result=value)

    def _fail(self, exc: BaseException) -> None:
        self._settle(exception=exc)

    def _settle(self, result=None, exception=None) -> None:
        with self._lock:
            if self._done.is_set():
                return  # the first settle wins
            self._result = result
            self._exception = exception
            self._was_cancelled = isinstance(exception, CancelledError)
            callbacks, self._callbacks = self._callbacks, []
            self._done.set()
        for fn in callbacks:
            try:
                fn(self)
            except Exception:  # noqa: BLE001 — a callback's bug is its own
                log.exception("JobFuture done-callback raised")

    def __repr__(self):
        state = "done" if self.done() else "running"
        return f"JobFuture(job={self.job_id}, pool={self.pool}, {state})"


class JobServer:
    def __init__(self, scheduler: DAGScheduler, conf,
                 admission_mode: str = "reject", pool_max_queued: int = 0):
        self.scheduler = scheduler
        self.conf = conf
        self.admission_mode = admission_mode
        self.pool_max_queued = int(pool_max_queued)
        self.arbiter = TaskArbiter(scheduler.backend, conf.scheduler_mode)
        scheduler.task_router = self.arbiter
        self._live: Dict[int, JobFuture] = {}
        self._stopped = False
        self._lock = named_lock("scheduler.jobserver.JobServer._lock")
        # in-flight jobs per pool, under a condition the parked
        # submitters (admission_mode="block") wait on; a Condition stays
        # a plain lock (the witness does not wrap one: wait() releases
        # and re-acquires it behind the wrapper's back)
        self._admission = threading.Condition()
        self._pool_live: Dict[str, int] = {}

    # --- pools --------------------------------------------------------------
    def set_pool(self, name: str, weight: int = 1,
                 max_concurrent_tasks: Optional[int] = None,
                 max_queued: Optional[int] = None) -> PoolConfig:
        cfg = self.arbiter.set_pool(name, weight, max_concurrent_tasks,
                                    max_queued)
        with self._admission:
            self._admission.notify_all()  # a raised bound unparks
        return cfg

    # --- admission ----------------------------------------------------------
    def _pool_bound(self, pool: str) -> Optional[int]:
        cfg = self.arbiter.pool_config(pool)
        if cfg is not None and cfg.max_queued is not None:
            return cfg.max_queued or None
        return self.pool_max_queued or None

    def _admit(self, pool: str) -> None:
        """Count one more job of pool in flight, or reject it / park until
        a job of the pool settles; the bound is read on every pass."""
        mode = check_admission_mode(self.admission_mode)
        with self._admission:
            while True:
                if self._stopped:
                    raise VegaError("job server is stopped")
                bound = self._pool_bound(pool)
                in_flight = self._pool_live.get(pool, 0)
                if bound is None or in_flight < bound:
                    self._pool_live[pool] = in_flight + 1
                    return
                if mode != "block":
                    self.scheduler.bus.post(ev.JobRejected(
                        pool=pool, queued=in_flight, bound=bound))
                    raise JobRejectedError(pool, in_flight, bound)
                self._admission.wait(timeout=0.5)

    def _release_admission(self, pool: str) -> None:
        with self._admission:
            left = self._pool_live.get(pool, 1) - 1
            if left <= 0:
                self._pool_live.pop(pool, None)
            else:
                self._pool_live[pool] = left
            self._admission.notify_all()

    def admission_status(self) -> Dict[str, Any]:
        with self._admission:
            live = dict(self._pool_live)
        return {"mode": self.admission_mode,
                "default_max_queued": self.pool_max_queued,
                "pools": {pool: {"in_flight": n,
                                 "max_queued": self._pool_bound(pool)}
                          for pool, n in sorted(live.items())}}

    # --- submission ---------------------------------------------------------
    def _new_future(self, job: _Job, transform) -> JobFuture:
        """A future holding one admission slot of job's pool, released
        once, when it settles."""
        future = JobFuture(job, self, transform)
        released: List[bool] = []

        def release_once(_f=None) -> None:
            with self._admission:
                if released:
                    return
                released.append(True)
            self._release_admission(job.pool)

        future.add_done_callback(release_once)
        future._release_once = release_once
        return future

    def submit(self, rdd, func, partitions: Optional[List[int]] = None,
               pool: Optional[str] = None, on_task_success=None,
               transform: Optional[Callable[[list], Any]] = None,
               inline: bool = False) -> JobFuture:
        """A job of pool, admitted; its event loop runs on a driver thread
        of its own, or on the calling thread when inline (the future is
        then settled when this returns)."""
        pool_name = pool or "default"
        if partitions is None:
            partitions = list(range(rdd.num_partitions))
        self._admit(pool_name)
        job = None
        future = None
        try:
            job = _Job(rdd, func, list(partitions), on_task_success,
                       pool=pool_name)
            future = self._new_future(job, transform)
            with self._lock:
                if self._stopped:
                    raise VegaError("job server is stopped")
                if partitions:
                    self._live[job.job_id] = future
            if partitions and not inline:
                threading.Thread(target=self._drive_thread,
                                 args=(job, future),
                                 name=f"vega-job-{job.job_id}",
                                 daemon=True).start()
        except BaseException:
            if job is not None:
                with self._lock:
                    self._live.pop(job.job_id, None)
            if future is not None:
                future._release_once()
            else:
                self._release_admission(pool_name)
            raise
        if not partitions:
            future._complete([])
        elif inline:
            self._drive(job, future)
        return future

    def _drive_thread(self, job: _Job, future: JobFuture) -> None:
        note_thread_role("dag-loop")
        self._drive(job, future)

    def _drive(self, job: _Job, future: JobFuture) -> None:
        was = in_job()
        _local.in_job = True
        try:
            results = self.scheduler._run_job_inner(
                job.final_rdd, job.func, job.partitions, job.on_task_success,
                job=job)
        except BaseException as exc:  # noqa: BLE001 — via the future
            log.debug("job %d failed", job.job_id, exc_info=True)
            future._fail(exc)
        else:
            future._complete(results)
        finally:
            _local.in_job = was
            with self._lock:
                self._live.pop(job.job_id, None)

    def submit_call(self, finish: Callable[[], Any],
                    pool: Optional[str] = None) -> JobFuture:
        """finish() as a job of pool on a thread of its own: admitted,
        posted as JobStart / JobEnd, its value or exception the future's;
        cancel() settles it at once (a running finish() runs on, its value
        discarded)."""
        pool_name = pool or "default"
        self._admit(pool_name)
        job = _Job(None, None, [], pool=pool_name)
        future = self._new_future(job, None)
        bus = self.scheduler.bus
        start = time.time()
        bus.post(ev.JobStart(job_id=job.job_id, pool=pool_name))
        future.add_done_callback(lambda f: bus.post(ev.JobEnd(
            job_id=job.job_id, succeeded=f._exception is None,
            duration_s=time.time() - start, cancelled=f._was_cancelled)))
        with self._lock:
            self._live[job.job_id] = future

        def run():
            _local.in_job = True
            try:
                if job.cancel_requested:
                    future._fail(CancelledError(job.cancel_reason))
                else:
                    future._settle(result=finish())
            except BaseException as exc:  # noqa: BLE001 — via the future
                log.debug("job %d failed", job.job_id, exc_info=True)
                future._fail(exc)
            finally:
                with self._lock:
                    self._live.pop(job.job_id, None)

        threading.Thread(target=run, name=f"vega-job-{job.job_id}",
                         daemon=True).start()
        return future

    # --- cancellation and shutdown ------------------------------------------
    def _cancel_job(self, job: _Job, reason: Optional[str] = None) -> None:
        job.cancel_reason = reason or f"job {job.job_id} cancelled"
        job.cancel_requested = True
        self.arbiter.purge(job.job_id)
        q = job.event_queue
        if q is not None:
            q.put(_WAKE)
        if job.final_rdd is None or q is None:
            # a job whose loop has not started (or a call job) settles now
            with self._lock:
                future = self._live.get(job.job_id)
            if future is not None:
                future._fail(CancelledError(job.cancel_reason))

    def stop(self, timeout_s: float = 5.0) -> None:
        """Cancel every job in flight and settle its future; later
        submissions raise."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            futures = list(self._live.values())
        with self._admission:
            self._admission.notify_all()
        for future in futures:
            future.cancel("job server stopped with the job in flight")
        deadline = time.monotonic() + timeout_s
        for future in futures:
            future._done.wait(max(0.0, deadline - time.monotonic()))
        for future in futures:
            if not future.done():
                future._fail(CancelledError(
                    f"job {future.job_id} did not wind down within "
                    f"{timeout_s}s of job-server stop"))
