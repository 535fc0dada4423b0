"""Asynchronous actions: collect_async, count_async and reduce_async.

The action's device work (its lineage's materialization and any reduce
launch) runs on the calling thread when the action is submitted, so every
process of a multi-process mesh dispatches its collectives in one order;
across processes the host read happens there too. What is left (the
device-to-host read on one process, and the transform into the action's
result on the host) runs on one FIFO worker thread per Context, in
submission order. Context.stop() drains the worker.

JobFuture has the reference's JobFuture surface (result, exception, done,
running, cancelled, cancel, add_done_callback). cancel() on a job that has
not finished makes result() raise errors.CancelledError, as the
reference's; the worker skips a job cancelled before it starts."""

from __future__ import annotations

import logging
import queue
import threading
from typing import Any, Callable, List, Optional

from vega_tpu_torch.errors import CancelledError

log = logging.getLogger(__name__)


class JobFuture:
    def __init__(self, job_id: int):
        self.job_id = job_id
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
    """One FIFO worker thread, started at the first submission."""

    def __init__(self):
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._ids = 0
        self._lock = threading.Lock()

    def submit(self, finish: Callable[[], Any]) -> JobFuture:
        """A future settled with finish()'s value (or its exception) on
        the worker thread, after every job submitted before it."""
        with self._lock:
            self._ids += 1
            fut = JobFuture(self._ids)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="vega-tpu-torch-jobs",
                    daemon=True)
                self._thread.start()
            self._queue.put((fut, finish))
        return fut

    def _run(self) -> None:
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

    def drain(self) -> None:
        """Run every submitted job to its end and stop the thread."""
        with self._lock:
            thread, self._thread = self._thread, None
            if thread is not None:
                self._queue.put(None)
        if thread is not None:
            thread.join()
