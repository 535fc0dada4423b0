"""The event bus and the metrics it feeds: the port's copy of the part of
vega_tpu/scheduler/events.py that its job worker (jobs.py) and its
streaming plane (streaming/) post to.

The bus is synchronous and in-process: post() hands the event to every
listener on the posting thread, so flush() has nothing to wait for and
returns True. (The reference dispatches on a thread of its own; its
flush() waits for that thread.) A listener that raises is logged and the
others still see the event.

MetricsListener keeps what these events feed, under the reference's
names and meanings: per-job records, jobs_cancelled, jobs_rejected, the
streaming counters (batch_wall_s included), per-pool job-wall
percentiles (pool_latency, which the streaming rate controller steers
by) and job_summary. The reference's other summary keys (tasks, stages,
executors, fetch, push, speculation, elastic, locality, dispatch, spill
events) come from planes the port does not have and are left out;
Context.metrics_summary() adds the exchange_plans summary of
Context.exchange_plans().
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Dict, List

log = logging.getLogger(__name__)


@dataclasses.dataclass
class Event:
    time: float = dataclasses.field(default_factory=time.time)


@dataclasses.dataclass
class JobStart(Event):
    job_id: int = -1
    num_stages: int = 0
    # the pool the job was submitted under: tenant metrics key on it
    pool: str = "default"


@dataclasses.dataclass
class JobEnd(Event):
    job_id: int = -1
    succeeded: bool = True
    duration_s: float = 0.0
    # ended by cancel(), not by a failure; always with succeeded=False
    cancelled: bool = False


@dataclasses.dataclass
class JobRejected(Event):
    """Admission refused a job: its pool already held its bound of jobs
    in flight under admission_mode="reject" (jobs.py). A blocked
    submission ("block") posts nothing; it waits."""

    pool: str = "default"
    queued: int = 0
    bound: int = 0


@dataclasses.dataclass
class ReceiverStarted(Event):
    """A stream's receiver began ingesting: at start (attempt 0) or after
    a crash (attempt > 0, resuming at from_offset)."""

    stream_id: int = -1
    kind: str = ""  # "generator" | "file_tail" | "socket"
    attempt: int = 0
    from_offset: int = 0


@dataclasses.dataclass
class BatchSubmitted(Event):
    """A micro-batch was formed from receiver blocks and its jobs run;
    attempt > 0 is a replay of the same batch_id over the same blocks."""

    batch_id: int = -1
    records: int = 0
    blocks: int = 0
    pool: str = "streaming"
    attempt: int = 0


@dataclasses.dataclass
class BatchCompleted(Event):
    """A micro-batch's jobs settled; succeeded=False means it replays."""

    batch_id: int = -1
    wall_s: float = 0.0
    records: int = 0
    succeeded: bool = True
    pool: str = "streaming"


@dataclasses.dataclass
class StateCheckpointed(Event):
    """A stateful stream committed (batch_id, offsets, state);
    duplicate=True is a commit of an already-committed batch_id, skipped
    with no effect."""

    batch_id: int = -1
    keys: int = 0
    wall_s: float = 0.0
    duplicate: bool = False


class Listener:
    def on_event(self, event: Event) -> None:
        raise NotImplementedError


class LiveListenerBus:
    """Registered listeners, each handed every event as it is posted."""

    def __init__(self):
        self._listeners: List[Listener] = []
        self._lock = threading.Lock()

    def add_listener(self, listener: Listener) -> None:
        with self._lock:
            self._listeners.append(listener)

    def post(self, event: Event) -> None:
        with self._lock:
            listeners = list(self._listeners)
        for listener in listeners:
            try:
                listener.on_event(event)
            except Exception:  # noqa: BLE001 — a listener's bug is its own
                log.exception("listener raised")

    def flush(self, timeout: float = 2.0) -> bool:
        """Every posted event is already dispatched: True."""
        return True


class MetricsListener(Listener):
    """Job and streaming aggregates, queryable from any thread."""

    def __init__(self):
        self.jobs: Dict[int, Dict[str, Any]] = {}
        self.jobs_cancelled = 0
        self.jobs_rejected = 0
        self.streaming: Dict[str, Any] = {
            "receivers_started": 0, "receiver_restarts": 0,
            "batches_submitted": 0, "batch_replays": 0,
            "batches_completed": 0, "batch_failures": 0,
            "records": 0, "blocks": 0, "batch_wall_s": 0.0,
            "state_checkpoints": 0, "duplicate_commits": 0,
        }
        # per-pool walls of jobs that succeeded (a bounded ring, newest
        # kept): the source of pool_latency()
        self._pool_walls: Dict[str, list] = {}
        self._lock = threading.Lock()

    def on_event(self, event: Event) -> None:
        with self._lock:
            if isinstance(event, JobStart):
                info = self.jobs.setdefault(event.job_id, {})
                info["start"] = event.time
                info["stages"] = event.num_stages
                info["pool"] = event.pool
            elif isinstance(event, JobEnd):
                info = self.jobs.setdefault(event.job_id, {})
                info["duration_s"] = event.duration_s
                info["succeeded"] = event.succeeded
                if event.cancelled:
                    info["cancelled"] = True
                    self.jobs_cancelled += 1
                elif event.succeeded:
                    # failed and cancelled walls would skew the
                    # percentiles the rate controller steers by
                    walls = self._pool_walls.setdefault(
                        info.get("pool", "default"), [])
                    walls.append(event.duration_s)
                    if len(walls) > 512:
                        del walls[:256]
            elif isinstance(event, JobRejected):
                self.jobs_rejected += 1
            elif isinstance(event, ReceiverStarted):
                self.streaming["receivers_started"] += 1
                if event.attempt > 0:
                    self.streaming["receiver_restarts"] += 1
            elif isinstance(event, BatchSubmitted):
                self.streaming["batches_submitted"] += 1
                if event.attempt > 0:
                    self.streaming["batch_replays"] += 1
                else:  # a replay re-runs the same blocks: count them once
                    self.streaming["records"] += event.records
                    self.streaming["blocks"] += event.blocks
            elif isinstance(event, BatchCompleted):
                self.streaming["batches_completed"] += 1
                self.streaming["batch_wall_s"] += event.wall_s
                if not event.succeeded:
                    self.streaming["batch_failures"] += 1
            elif isinstance(event, StateCheckpointed):
                if event.duplicate:
                    self.streaming["duplicate_commits"] += 1
                else:
                    self.streaming["state_checkpoints"] += 1

    @staticmethod
    def _percentile(ordered: list, q: float) -> float:
        """Nearest-rank percentile of a sorted sample."""
        idx = min(len(ordered) - 1, max(0, int(q * len(ordered))))
        return ordered[idx]

    def _pool_latency_locked(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for pool, walls in self._pool_walls.items():
            if not walls:
                continue
            ordered = sorted(walls)
            out[pool] = {
                "count": len(ordered),
                "p50_s": round(self._percentile(ordered, 0.50), 6),
                "p95_s": round(self._percentile(ordered, 0.95), 6),
            }
        return out

    def pool_latency(self) -> Dict[str, Dict[str, float]]:
        """{pool: {count, p50_s, p95_s}} of recent successful job walls."""
        with self._lock:
            return self._pool_latency_locked()

    def job_summary(self, job_id: int) -> Dict[str, Any]:
        """One job's record (pool, start, duration once ended) with its
        pool's recent p50 / p95 walls."""
        with self._lock:
            info = dict(self.jobs.get(job_id, {}))
            walls = self._pool_walls.get(info.get("pool", "default"))
            if walls:
                ordered = sorted(walls)
                info["pool_p50_s"] = round(
                    self._percentile(ordered, 0.50), 6)
                info["pool_p95_s"] = round(
                    self._percentile(ordered, 0.95), 6)
            return info

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "jobs": len(self.jobs),
                "jobs_cancelled": self.jobs_cancelled,
                "jobs_rejected": self.jobs_rejected,
                "streaming": {**self.streaming,
                              "batch_wall_s": round(
                                  self.streaming["batch_wall_s"], 6)},
                "pool_latency": self._pool_latency_locked(),
            }
