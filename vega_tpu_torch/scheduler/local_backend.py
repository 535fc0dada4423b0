"""The local task backend, a thread pool in this process: the port's copy
of vega_tpu/scheduler/local_backend.py.

Tasks run on a ThreadPoolExecutor of num_workers threads. With
serialize_tasks_locally, each task's stage binary (task.py) is
serialized once per stage and deserialized once per stage through a
TaskBinaryCache, and the task's header makes the round trip per task, as
a distributed run ships them (serialization.py: functions by value; a
lineage it cannot carry fails there). A task cancelled
before a thread picks it up fails with TaskCancelledError instead of
running (a running thread cannot be interrupted). The chaos hook
faults.maybe_slow_task runs inside each task's timed window."""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

from vega_tpu_torch import faults, serialization
from vega_tpu_torch.errors import TaskCancelledError
from vega_tpu_torch.lint.sync_witness import named_lock
from vega_tpu_torch.scheduler.dag import TaskBackend
from vega_tpu_torch.scheduler.task import (Task, TaskBinaryCache,
                                           TaskEndEvent, run_from_header)

log = logging.getLogger(__name__)

_local = threading.local()


def in_task() -> bool:
    """Whether the calling thread is running a task of a local backend."""
    return getattr(_local, "in_task", False)


class LocalBackend(TaskBackend):
    def __init__(self, conf):
        self._num_workers = conf.num_workers
        self._serialize = conf.serialize_tasks_locally
        self._binaries = TaskBinaryCache(conf.task_binary_cache_entries)
        self._pool = ThreadPoolExecutor(max_workers=self._num_workers,
                                        thread_name_prefix="vega-task")
        # task ids cancelled before a thread picked them up (bounded)
        self._cancelled: "OrderedDict[int, float]" = OrderedDict()
        self._cancel_lock = named_lock(
            "scheduler.local_backend.LocalBackend._cancel_lock")

    @property
    def parallelism(self) -> int:
        return self._num_workers

    @property
    def preserialize_stage_binaries(self) -> bool:
        return self._serialize

    def cancel_task(self, task_id: int) -> None:
        with self._cancel_lock:
            self._cancelled[task_id] = time.time()
            while len(self._cancelled) > 1024:
                self._cancelled.popitem(last=False)

    def submit(self, task: Task,
               callback: Callable[[TaskEndEvent], None]) -> None:
        def run():
            with self._cancel_lock:
                cancelled = self._cancelled.pop(task.task_id, None)
            if cancelled is not None:
                callback(TaskEndEvent(
                    task=task, success=False,
                    error=TaskCancelledError(
                        f"attempt {task.task_id} cancelled before it "
                        "started")))
                return
            _local.in_task = True
            try:
                result, duration = self._run_one(task)
            except BaseException as exc:  # noqa: BLE001 — reported
                log.debug("task %s failed", task, exc_info=True)
                callback(TaskEndEvent(task=task, success=False, error=exc))
            else:
                callback(TaskEndEvent(task=task, success=True,
                                      result=result, duration_s=duration))
            finally:
                _local.in_task = False

        self._pool.submit(run)

    def _run_one(self, task: Task):
        """(result, execution wall s): the wall starts after the
        serialization round trips, as a worker measures it."""
        if not self._serialize:
            t0 = time.monotonic()
            faults.get().maybe_slow_task()
            return task.run(), time.monotonic() - t0
        binary = task.stage_binary
        if binary is None:
            # a task made outside the DAG scheduler: the whole task
            clone = serialization.loads(serialization.dumps(task))
            t0 = time.monotonic()
            faults.get().maybe_slow_task()
            return clone.run(), time.monotonic() - t0
        payload = binary.ensure_serialized()
        obj = self._binaries.get(binary.sha)
        if obj is None:
            obj = self._binaries.load(binary.sha, payload)
        header = serialization.loads(serialization.dumps(task.header()))
        t0 = time.monotonic()
        faults.get().maybe_slow_task()
        return run_from_header(header, obj), time.monotonic() - t0

    def stop(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
