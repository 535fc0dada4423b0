"""Asynchronous actions: collect_async, count_async and reduce_async.

The action's device work (its lineage's materialization and any reduce
launch) runs on the calling thread when the action is submitted, so every
process of a multi-process mesh dispatches its collectives in one order;
across processes the host read happens there too. What is left (the
device-to-host read on one process, and the transform into the action's
result on the host) runs on one FIFO worker thread per Context, in
submission order. Context.stop() drains the worker.

Jobs are submitted into named pools (Context.set_pool, the reference's
job-server pools) with the reference's admission check at the front door
(vega_tpu/scheduler/jobserver.py JobServer._admit): at most max_queued
jobs of a pool in flight (submitted, not yet settled; the pool's own
bound, else the Context's pool_max_queued; 0 is no bound), past which
admission_mode "reject" raises errors.JobRejectedError and posts
JobRejected, and "block" parks the submitting thread until a job of the
pool settles. Every job posts JobStart when admitted and JobEnd when it
settles (its wall from admission, its pool), which feed the metrics'
pool_latency. A blocking host job (Context.run_job, on the calling
thread) is admitted and posted the same way, as the reference's
blocking actions are submitted jobs; a job run inside another (on the
worker, or in a job's device work) is part of that one. The worker
stays one FIFO queue: a pool's weight is
recorded and reorders nothing, and max_concurrent_tasks binds trivially
(one job runs at a time).

JobFuture has the reference's JobFuture surface (result, exception, done,
running, cancelled, cancel, add_done_callback). cancel() on a job that has
not finished makes result() raise errors.CancelledError, as the
reference's; the worker skips a job cancelled before it starts."""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from vega_tpu_torch import events
from vega_tpu_torch.errors import CancelledError, JobRejectedError, VegaError

log = logging.getLogger(__name__)


ADMISSION_MODES = ("reject", "block")


def check_admission_mode(mode: str) -> str:
    if mode not in ADMISSION_MODES:
        raise VegaError(f"unknown admission_mode {mode!r} (expected "
                        "'reject' or 'block')")
    return mode


@dataclasses.dataclass
class PoolConfig:
    """A job pool: the reference's fields. weight and
    max_concurrent_tasks are recorded (one FIFO worker has nothing to
    share out); max_queued bounds admission (None: the Context's
    pool_max_queued; 0: no bound)."""

    name: str = "default"
    weight: int = 1
    max_concurrent_tasks: Optional[int] = None
    max_queued: Optional[int] = None


class JobFuture:
    def __init__(self, job_id: int, pool: str = "default"):
        self.job_id = job_id
        self.pool = pool
        self._done = threading.Event()
        self._result: Any = None
        self._exception: Optional[BaseException] = None
        self._was_cancelled = False
        self._callbacks: List[Callable[["JobFuture"], None]] = []
        self._lock = threading.Lock()

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
        """Settle the job as cancelled; False if it already finished."""
        with self._lock:
            if self._done.is_set():
                return False
        self._settle(exception=CancelledError(
            f"job {self.job_id} cancelled"
            + (f": {reason}" if reason else "")))
        return True

    def add_done_callback(self, fn: Callable[["JobFuture"], None]) -> None:
        with self._lock:
            if not self._done.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def _settle(self, result=None, exception=None) -> None:
        with self._lock:
            if self._done.is_set():
                return  # the first settle wins (a cancel beats the worker)
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
        return f"JobFuture(job {self.job_id}, {state})"


class JobRunner:
    """One FIFO worker thread, started at the first submission, behind
    the pools' admission check. bus gets the job events; default_pool()
    names the pool of a submission that names none (the Context's
    thread-local "pool" property)."""

    def __init__(self, bus: Optional[events.LiveListenerBus] = None,
                 admission_mode: str = "reject", pool_max_queued: int = 0,
                 default_pool: Optional[Callable[[], Optional[str]]] = None):
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._ids = 0
        self._lock = threading.Lock()
        self.bus = bus
        self.admission_mode = admission_mode
        self.pool_max_queued = int(pool_max_queued)
        self._default_pool = default_pool
        self._pools: Dict[str, PoolConfig] = {"default": PoolConfig()}
        # in-flight jobs per pool, under their own condition, which
        # parked submitters (admission_mode="block") wait on
        self._admission = threading.Condition()
        self._pool_live: Dict[str, int] = {}
        self._closed = False
        # set on a thread while it runs a job: a job it starts then is
        # part of that one (run_blocking runs it as it is)
        self._local = threading.local()

    # --- pools and admission ------------------------------------------------
    def set_pool(self, name: str, weight: int = 1,
                 max_concurrent_tasks: Optional[int] = None,
                 max_queued: Optional[int] = None) -> PoolConfig:
        cfg = PoolConfig(name, max(1, int(weight)), max_concurrent_tasks,
                         max_queued)
        with self._admission:
            self._pools[name] = cfg
            # a raised bound unparks the submitters already waiting
            self._admission.notify_all()
        return cfg

    def _pool_bound(self, pool: str) -> Optional[int]:
        """The pool's own max_queued, else pool_max_queued; 0 or unset is
        no bound (None)."""
        cfg = self._pools.get(pool)
        if cfg is not None and cfg.max_queued is not None:
            return cfg.max_queued or None
        return self.pool_max_queued or None

    def _admit(self, pool: str) -> None:
        """Count one more job of pool in flight, or reject it / park until
        a job of the pool settles, by admission_mode; the bound is read
        again on every pass."""
        mode = check_admission_mode(self.admission_mode)
        with self._admission:
            while True:
                if self._closed:
                    raise VegaError("job server is stopped")
                bound = self._pool_bound(pool)
                in_flight = self._pool_live.get(pool, 0)
                if bound is None or in_flight < bound:
                    self._pool_live[pool] = in_flight + 1
                    return
                if mode != "block":
                    self._post(events.JobRejected(pool=pool,
                                                  queued=in_flight,
                                                  bound=bound))
                    raise JobRejectedError(pool, in_flight, bound)
                # a settle notifies; the tick also sees a stop
                self._admission.wait(timeout=0.5)

    def _release(self, pool: str) -> None:
        with self._admission:
            left = self._pool_live.get(pool, 1) - 1
            if left <= 0:
                self._pool_live.pop(pool, None)
            else:
                self._pool_live[pool] = left
            self._admission.notify_all()

    def admission_status(self) -> Dict[str, Any]:
        """Per-pool in-flight jobs against their bounds."""
        with self._admission:
            live = dict(self._pool_live)
            pools = {pool: {"in_flight": n,
                            "max_queued": self._pool_bound(pool)}
                     for pool, n in sorted(live.items())}
        return {"mode": self.admission_mode,
                "default_max_queued": self.pool_max_queued,
                "pools": pools}

    def _post(self, event) -> None:
        if self.bus is not None:
            self.bus.post(event)

    # --- submission ---------------------------------------------------------
    def submit(self, finish: Callable[[], Any], pool: Optional[str] = None,
               prepare: Optional[Callable[[], None]] = None) -> JobFuture:
        """A future settled with finish()'s value (or its exception) on
        the worker thread, after every job submitted before it. The job
        is admitted into pool (default: default_pool(), else "default")
        first; prepare(), if given, then runs on the calling thread (the
        job's device work), and its exception settles the future and
        raises here."""
        pool = self._pool_of(pool)
        self._admit(pool)
        with self._lock:
            self._ids += 1
            fut = JobFuture(self._ids, pool)
        start = time.time()
        self._post(events.JobStart(job_id=fut.job_id, pool=pool))
        fut.add_done_callback(lambda f: self._settled(f, start))
        if prepare is not None:
            try:
                self._in_job(prepare)
            except BaseException as e:
                fut._settle(exception=e)
                raise
        with self._lock:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="vega-tpu-torch-jobs",
                    daemon=True)
                self._thread.start()
            self._queue.put((fut, finish))
        return fut

    def run_blocking(self, fn: Callable[[], Any],
                     pool: Optional[str] = None) -> Any:
        """fn() on the calling thread as one job of pool: admitted,
        posted as JobStart / JobEnd; inside a job, fn() as it is."""
        if getattr(self._local, "in_job", False):
            return fn()
        pool = self._pool_of(pool)
        self._admit(pool)
        with self._lock:
            self._ids += 1
            job_id = self._ids
        start = time.time()
        self._post(events.JobStart(job_id=job_id, pool=pool))
        ok = False
        try:
            out = self._in_job(fn)
            ok = True
            return out
        finally:
            self._release(pool)
            self._post(events.JobEnd(job_id=job_id, succeeded=ok,
                                     duration_s=time.time() - start))

    def _in_job(self, fn: Callable[[], Any]) -> Any:
        was = getattr(self._local, "in_job", False)
        self._local.in_job = True
        try:
            return fn()
        finally:
            self._local.in_job = was

    def _pool_of(self, pool: Optional[str]) -> str:
        if pool is None and self._default_pool is not None:
            pool = self._default_pool()
        return pool or "default"

    def _settled(self, fut: JobFuture, start: float) -> None:
        """A job's admission slot freed and its JobEnd posted, once: on
        the first settle (the worker's, or a cancel's)."""
        self._release(fut.pool)
        self._post(events.JobEnd(job_id=fut.job_id,
                                 succeeded=fut._exception is None,
                                 duration_s=time.time() - start,
                                 cancelled=fut._was_cancelled))

    def _run(self) -> None:
        self._local.in_job = True  # the worker runs nothing but jobs
        while True:
            item = self._queue.get()
            if item is None:
                return
            fut, finish = item
            if fut.done():  # cancelled before it started
                continue
            try:
                value = finish()
            except BaseException as e:  # noqa: BLE001 — surfaces via result()
                fut._settle(exception=e)
            else:
                fut._settle(result=value)

    def drain(self, close: bool = False) -> None:
        """Run every submitted job to its end and stop the thread; close
        also refuses later submissions, and a parked one raises."""
        if close:
            with self._admission:
                self._closed = True
                self._admission.notify_all()
        with self._lock:
            thread, self._thread = self._thread, None
            if thread is not None:
                self._queue.put(None)
        if thread is not None:
            thread.join()
