"""Tasks: the port's copy of vega_tpu/scheduler/task.py.

A ResultTask runs the job's function over one partition of the final
RDD; a ShuffleMapTask runs a ShuffleDependency's map side over one
partition of its parent (dependency.py do_shuffle_task). The
stage-invariant half of a task, (rdd, func) or (rdd, dep), is a
StageBinary, serialized (serialization.py) at most once per stage and
addressed by its content hash; a TaskHeader is the per-task rest (ids,
split, attempt, the binary's hash); run_from_header runs a task from the
two. TaskBinaryCache is the bounded LRU of deserialized binaries that a
serializing backend shares between its task threads. TaskContext is what
a task's function receives: stage_id, split_index, attempt_id.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import itertools
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

from vega_tpu_torch.dependency import ShuffleDependency
from vega_tpu_torch.lint.sync_witness import named_lock
from vega_tpu_torch.split import Split


@dataclasses.dataclass
class TaskContext:
    stage_id: int
    split_index: int
    attempt_id: int


_task_ids = itertools.count(1)


class StageBinary:
    """(kind, rdd, func | dep), serialized lazily exactly once."""

    # every lineage serialization of this process (the once-per-stage
    # contract's observation point)
    total_serializations = 0
    _count_lock = named_lock("scheduler.task.StageBinary._count_lock")

    def __init__(self, kind: str, rdd, aux):
        assert kind in ("result", "shuffle")
        self.kind = kind
        self.rdd = rdd
        self.aux = aux  # func (result) | ShuffleDependency (shuffle)
        # (payload, sha) swapped as one tuple
        self._frozen: Optional[Tuple[bytes, str]] = None
        self._lock = named_lock("scheduler.task.StageBinary._lock")

    def _materialize(self) -> Tuple[bytes, str]:
        """Serialize once (a lineage that cannot pickle raises here,
        once per stage)."""
        frozen = self._frozen
        if frozen is None:
            with self._lock:
                frozen = self._frozen
                if frozen is None:
                    from vega_tpu_torch import serialization

                    payload = serialization.dumps(
                        (self.kind, self.rdd, self.aux))
                    with StageBinary._count_lock:
                        StageBinary.total_serializations += 1
                    frozen = self._frozen = (
                        payload, hashlib.sha256(payload).hexdigest())
        return frozen

    def ensure_serialized(self) -> bytes:
        return self._materialize()[0]

    def release_payload(self) -> None:
        """Drop the bytes (the live refs stay; a later resubmission
        serializes again)."""
        with self._lock:
            self._frozen = None

    @property
    def payload(self) -> bytes:
        return self._materialize()[0]

    @property
    def sha(self) -> str:
        return self._materialize()[1]

    def __repr__(self):
        frozen = self._frozen
        state = "lazy" if frozen is None else f"{len(frozen[0])}B"
        return f"StageBinary({self.kind}, rdd={self.rdd.rdd_id}, {state})"


@dataclasses.dataclass
class TaskHeader:
    task_id: int
    stage_id: int
    partition: int
    split: Split
    attempt: int
    binary_sha: str
    kind: str  # "result" | "shuffle"
    output_id: Optional[int] = None


def run_from_header(header: TaskHeader, binary: Tuple[str, Any, Any]) -> Any:
    """A task from its header and its stage's deserialized binary."""
    kind, rdd, aux = binary
    tc = TaskContext(header.stage_id, header.split.index, header.attempt)
    if kind == "result":
        return aux(tc, rdd.iterator(header.split, tc))
    return aux.do_shuffle_task(header.split, tc)


class TaskBinaryCache:
    """Bounded LRU of deserialized stage binaries keyed by content hash;
    concurrent loads of one hash deserialize once (the first loader
    claims a pending event, the others wait on it)."""

    _LOAD_WAIT_S = 5.0

    def __init__(self, capacity: int):
        self._capacity = max(1, int(capacity))
        self._entries: "OrderedDict[str, tuple]" = OrderedDict()
        self._pending: Dict[str, threading.Event] = {}
        self._lock = named_lock("scheduler.task.TaskBinaryCache._lock")

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, sha: str):
        with self._lock:
            obj = self._entries.get(sha)
            if obj is not None:
                self._entries.move_to_end(sha)
            return obj

    def wait_for(self, sha: str, timeout: Optional[float] = None):
        """The cached object, or None; a load in flight is waited for."""
        with self._lock:
            obj = self._entries.get(sha)
            if obj is not None:
                self._entries.move_to_end(sha)
                return obj
            event = self._pending.get(sha)
        if event is None:
            return None
        event.wait(self._LOAD_WAIT_S if timeout is None else timeout)
        return self.get(sha)

    def claim(self, sha: str):
        """Announce a load of sha before its bytes are in hand: a token
        for load() / abandon(), or None when it is cached or claimed."""
        with self._lock:
            if sha in self._entries or sha in self._pending:
                return None
            event = self._pending[sha] = threading.Event()
            return event

    def abandon(self, sha: str, token) -> None:
        """Release a claim whose load will not come; waiters re-miss."""
        if token is None:
            return
        with self._lock:
            if self._pending.get(sha) is token:
                self._pending.pop(sha)
        token.set()

    def load(self, sha: str, raw: bytes, token=None):
        """Deserialize and insert, once per hash across loaders."""
        with self._lock:
            obj = self._entries.get(sha)
            if obj is not None:
                self._entries.move_to_end(sha)
                return obj
            event = self._pending.get(sha)
            owner = event is None or event is token
            if event is None:
                event = self._pending[sha] = threading.Event()
        if not owner:
            event.wait(self._LOAD_WAIT_S)
            obj = self.get(sha)
            if obj is not None:
                return obj
        from vega_tpu_torch import serialization

        try:
            obj = serialization.loads(raw)
        except BaseException:
            if owner:
                with self._lock:
                    pending = self._pending.pop(sha, None)
                if pending is not None:
                    pending.set()
            raise
        self.put(sha, obj)
        return obj

    def put(self, sha: str, obj) -> None:
        with self._lock:
            self._entries[sha] = obj
            self._entries.move_to_end(sha)
            while len(self._entries) > self._capacity:
                self._entries.popitem(last=False)
            pending = self._pending.pop(sha, None)
        if pending is not None:
            pending.set()

    def drop(self, sha: str) -> None:
        with self._lock:
            self._entries.pop(sha, None)


class Task:
    speculative = False
    exclude_executors: frozenset = frozenset()
    dispatched_to: Optional[str] = None
    # the owning job (DAGScheduler._submit_task): the arbiter keys on it
    job_id: int = -1

    def __init__(self, stage_id: int, partition: int, split: Split,
                 preferred_locs: Optional[List[str]] = None,
                 pinned: bool = False):
        self.task_id = next(_task_ids)
        self.stage_id = stage_id
        self.partition = partition
        self.split = split
        self.preferred_locs = preferred_locs or []
        self.pinned = pinned
        self.attempt = 0
        self.stage_binary: Optional[StageBinary] = None

    def __getstate__(self):
        state = dict(self.__dict__)
        state["stage_binary"] = None
        return state

    def speculative_copy(self) -> "Task":
        """A duplicate attempt with its own task id and the next attempt
        number, sharing the stage binary."""
        clone = copy.copy(self)
        clone.task_id = next(_task_ids)
        clone.attempt = self.attempt + 1
        clone.speculative = True
        clone.exclude_executors = frozenset(
            e for e in (self.dispatched_to,) if e)
        return clone

    def header(self) -> TaskHeader:
        binary = self.stage_binary
        return TaskHeader(
            task_id=self.task_id, stage_id=self.stage_id,
            partition=self.partition, split=self.split, attempt=self.attempt,
            binary_sha=binary.sha if binary is not None else "",
            kind=binary.kind if binary is not None else "",
            output_id=getattr(self, "output_id", None))

    def run(self) -> Any:
        raise NotImplementedError

    def __repr__(self):
        return (f"{type(self).__name__}(id={self.task_id}, "
                f"stage={self.stage_id}, part={self.partition})")


class ResultTask(Task):
    """A final-stage task: func(task_context, rdd.iterator(split))."""

    def __init__(self, stage_id: int, rdd, func: Callable, partition: int,
                 split: Split, output_id: int,
                 preferred_locs: Optional[List[str]] = None,
                 pinned: bool = False):
        super().__init__(stage_id, partition, split, preferred_locs, pinned)
        self.rdd = rdd
        self.func = func
        self.output_id = output_id

    def run(self) -> Any:
        tc = TaskContext(self.stage_id, self.split.index, self.attempt)
        return self.func(tc, self.rdd.iterator(self.split, tc))


class ShuffleMapTask(Task):
    """A parent-stage task: the map side of dep over one partition;
    returns (location, per-reduce bucket bytes)."""

    def __init__(self, stage_id: int, rdd, dep: ShuffleDependency,
                 partition: int, split: Split,
                 preferred_locs: Optional[List[str]] = None,
                 pinned: bool = False):
        super().__init__(stage_id, partition, split, preferred_locs, pinned)
        self.rdd = rdd
        self.dep = dep

    def run(self) -> tuple:
        tc = TaskContext(self.stage_id, self.split.index, self.attempt)
        return self.dep.do_shuffle_task(self.split, tc)


@dataclasses.dataclass
class TaskEndEvent:
    task: Task
    success: bool
    result: Any = None
    error: Optional[BaseException] = None
    duration_s: float = 0.0
    dispatch: Optional[dict] = None
    executor: Optional[str] = None
    locality: str = ""
