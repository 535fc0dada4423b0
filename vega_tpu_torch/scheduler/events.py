"""The event bus and the metrics it feeds: the port's copy of
vega_tpu/scheduler/events.py for the local runtime.

LiveListenerBus hands every posted event to each registered listener on
a dispatch thread of its own (start() starts it; an event posted before
start() or after stop() is dropped, as the reference's are); flush()
waits until every posted event has been dispatched. A listener that
raises is logged and the others still see the event. Per-job listeners
(add_job_listener) see only the events of their job.

The events are the scheduler's (jobs, stages, tasks, resubmissions,
speculation), the distributed backend's (ExecutorLost,
ExecutorRestarted, ExecutorAdded, ExecutorDecommissioned), the push
plan's (ShufflePushCompleted), the stores' (spills and promotions of
the partition cache and the shuffle store), the fetcher's
(ShuffleFetchCompleted, FetchFailedOver), the job server's (JobRejected)
and the streaming plane's. MetricsListener.summary() gives the
reference's keys: jobs, stages, tasks and their failures and seconds,
executors lost and restarted, stage resubmissions, rejections,
cancellations, spills and promotions, speculation, the fetch counters,
locality (placements by tier), dispatch (the task plane's bytes and
binary shipments), the streaming counters and per-pool job-wall
percentiles (pool_latency, which the streaming rate controller steers
by). The elastic section counts the fleet's moves and what decommissions
migrated, and shuffle_push the push plan's map-side pushes.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from typing import Any, Dict, List, Optional
from vega_tpu_torch.lint.sync_witness import named_lock, note_thread_role

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
class StageSubmitted(Event):
    stage_id: int = -1
    num_tasks: int = 0
    is_shuffle_map: bool = False
    # the job whose event loop submitted the tasks
    job_id: int = -1


@dataclasses.dataclass
class StageCompleted(Event):
    stage_id: int = -1
    duration_s: float = 0.0
    speculative: bool = False
    job_id: int = -1


@dataclasses.dataclass
class TaskEnd(Event):
    task_id: int = -1
    stage_id: int = -1
    partition: int = -1
    success: bool = True
    # the task's execution wall, measured on its thread
    duration_s: float = 0.0
    executor: str = "local"
    speculative: bool = False
    # a completion of a (stage, partition) already committed: discarded
    duplicate: bool = False
    dispatch: Optional[Dict[str, Any]] = None
    job_id: int = -1
    locality: str = ""


@dataclasses.dataclass
class ExecutorLost(Event):
    """The reaper declared an executor gone: its map outputs were
    unregistered and its dispatches failed over."""

    executor_id: str = ""
    host: str = ""
    reason: str = ""  # "process exited" | "heartbeat timeout" | ...


@dataclasses.dataclass
class ExecutorRestarted(Event):
    """A dead executor slot was respawned; attempt counts from 1."""

    executor_id: str = ""
    host: str = ""
    attempt: int = 0


@dataclasses.dataclass
class ExecutorAdded(Event):
    """A new executor slot joined the fleet (fleet_size after it)."""

    executor_id: str = ""
    host: str = ""
    fleet_size: int = 0


@dataclasses.dataclass
class ExecutorDecommissioned(Event):
    """The elastic fleet retired an executor: it drained, its shuffle
    outputs were migrated (a sole copy pushed to a survivor), left to
    their replicas or parity, or scrubbed for recompute, and it was
    reaped. forced: the drain timed out and the executor-lost path took
    over."""

    executor_id: str = ""
    host: str = ""
    migrated_outputs: int = 0
    migrated_bytes: int = 0
    replica_covered: int = 0
    recomputed_outputs: int = 0
    forced: bool = False
    duration_s: float = 0.0


@dataclasses.dataclass
class FetchFailedOver(Event):
    """A reduce task moved its undelivered buckets from a failed or slow
    server to their replicas (no resubmission)."""

    shuffle_id: int = -1
    reduce_id: int = -1
    from_uri: str = ""
    buckets: int = 0


@dataclasses.dataclass
class JobRejected(Event):
    """Admission refused a job: its pool already held its bound of jobs
    in flight under admission_mode="reject" (jobserver.py). A blocked
    submission ("block") posts nothing; it waits."""

    pool: str = "default"
    queued: int = 0
    bound: int = 0


@dataclasses.dataclass
class StageResubmitted(Event):
    """A stage failed by a fetch failure (or left with holes) re-entered
    submission."""

    stage_id: int = -1
    job_id: int = -1


@dataclasses.dataclass
class SpeculativeLaunched(Event):
    """A straggler got a duplicate attempt (first result wins)."""

    stage_id: int = -1
    partition: int = -1
    task_id: int = -1
    job_id: int = -1


@dataclasses.dataclass
class SpeculativeWon(Event):
    stage_id: int = -1
    partition: int = -1
    job_id: int = -1


@dataclasses.dataclass
class SpeculativeLost(Event):
    """The duplicate was wasted: the original committed first, or the
    duplicate failed while the original ran on. Every launch settles as
    one Won or one Lost."""

    stage_id: int = -1
    partition: int = -1
    job_id: int = -1


@dataclasses.dataclass
class BlockSpilled(Event):
    """A block left RAM for the disk tier (a partition-cache demotion or
    a shuffle-store spill)."""

    store: str = "cache"  # "cache" | "shuffle"
    key: str = ""
    nbytes: int = 0


@dataclasses.dataclass
class BlockPromoted(Event):
    """A disk-resident block was read back (a disk hit, no recompute)."""

    store: str = "cache"
    key: str = ""
    nbytes: int = 0


@dataclasses.dataclass
class ShuffleFetchCompleted(Event):
    """One reduce task's fetch stream finished (shuffle/fetcher.py)."""

    shuffle_id: int = -1
    reduce_id: int = -1
    buckets: int = 0
    nbytes: int = 0
    round_trips: int = 0
    wall_s: float = 0.0
    net_s: float = 0.0
    overlap_s: float = 0.0
    batched: bool = True
    # the push plan: buckets read pre-merged, and how the blob was read
    premerged_buckets: int = 0
    local_blob_reads: int = 0
    merged_rtts: int = 0
    # the coded shuffle: decode incidents, buckets decoded, their bytes
    coded_failovers: int = 0
    parity_decodes: int = 0
    decode_bytes: int = 0


@dataclasses.dataclass
class ShufflePushCompleted(Event):
    """One map task pushed its row to the owning servers
    (shuffle_plan="push"): merged buckets fed a pre-merge state, stored
    ones were kept raw, duplicates were dropped by map id, failed ones
    are left to the pull plan; targets is the owners contacted."""

    shuffle_id: int = -1
    map_id: int = -1
    buckets: int = 0
    nbytes: int = 0
    merged: int = 0
    stored: int = 0
    duplicates: int = 0
    failed: int = 0
    targets: int = 0
    wall_s: float = 0.0


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
    """Registered listeners, each handed every event on the bus's
    dispatch thread."""

    def __init__(self):
        self._queue: "queue.Queue[Optional[Event]]" = queue.Queue()
        self._listeners: List[Listener] = []
        self._job_listeners: Dict[int, List[Listener]] = {}
        self._thread: Optional[threading.Thread] = None
        self._started = False
        self._lock = named_lock("scheduler.events.EventBus._lock")

    def add_listener(self, listener: Listener) -> None:
        with self._lock:
            self._listeners.append(listener)

    def add_job_listener(self, job_id: int, listener: Listener) -> None:
        """listener sees only the events that carry job_id."""
        with self._lock:
            self._job_listeners.setdefault(job_id, []).append(listener)

    def remove_job_listener(self, job_id: int,
                            listener: Optional[Listener] = None) -> None:
        with self._lock:
            if listener is None:
                self._job_listeners.pop(job_id, None)
                return
            listeners = self._job_listeners.get(job_id)
            if listeners and listener in listeners:
                listeners.remove(listener)
                if not listeners:
                    self._job_listeners.pop(job_id, None)

    def start(self) -> None:
        with self._lock:
            if self._started:
                return
            self._started = True
            self._thread = threading.Thread(
                target=self._dispatch_loop, name="listener-bus", daemon=True)
            self._thread.start()

    def post(self, event: Event) -> None:
        with self._lock:
            if not self._started:
                return
            self._queue.put(event)

    def flush(self, timeout: float = 2.0) -> bool:
        """Wait until every posted event has been dispatched; False if
        timeout seconds pass first."""
        deadline = time.monotonic() + timeout
        with self._queue.all_tasks_done:
            while self._queue.unfinished_tasks:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._queue.all_tasks_done.wait(remaining)
        return True

    def stop(self) -> None:
        with self._lock:
            if not self._started:
                return
            self._started = False
        self._queue.put(None)
        if self._thread:
            self._thread.join(timeout=5)

    def _dispatch_loop(self) -> None:
        note_thread_role("listener-bus")
        while True:
            event = self._queue.get()
            try:
                if event is None:
                    return
                with self._lock:
                    listeners = list(self._listeners)
                    job_id = getattr(event, "job_id", -1)
                    if job_id != -1 and job_id in self._job_listeners:
                        listeners.extend(self._job_listeners[job_id])
                for listener in listeners:
                    try:
                        listener.on_event(event)
                    except Exception:  # noqa: BLE001 — a listener's own bug
                        log.exception("listener raised")
            finally:
                self._queue.task_done()


class MetricsListener(Listener):
    """Job, stage, task, storage, fetch and streaming aggregates,
    queryable from any thread."""

    def __init__(self):
        self.jobs: Dict[int, Dict[str, Any]] = {}
        self.stages: Dict[int, Dict[str, Any]] = {}
        self.task_count = 0
        self.task_failures = 0
        self.total_task_time_s = 0.0
        self.spilled_bytes: Dict[str, int] = {}
        self.promoted_bytes: Dict[str, int] = {}
        self.spill_count = 0
        self.promote_count = 0
        self.jobs_cancelled = 0
        self.stages_resubmitted = 0
        self.jobs_rejected = 0
        self.speculation: Dict[str, int] = {
            "launched": 0, "won": 0, "lost": 0, "duplicate_completions": 0,
        }
        self.fetch: Dict[str, Any] = {
            "streams": 0, "buckets": 0, "bytes": 0, "round_trips": 0,
            "wall_s": 0.0, "net_s": 0.0, "overlap_s": 0.0, "failovers": 0,
            "failover_buckets": 0, "premerged_buckets": 0,
            "local_blob_reads": 0, "merged_rtts": 0, "coded_failovers": 0,
            "parity_decodes": 0, "decode_bytes": 0,
        }
        self.executors_lost = 0
        self.executors_restarted = 0
        # the elastic fleet's moves and what its decommissions cost
        self.elastic: Dict[str, int] = {
            "executors_added": 0, "executors_decommissioned": 0,
            "decommissions_forced": 0, "migrated_outputs": 0,
            "migrated_bytes": 0, "replica_covered": 0,
            "recomputed_outputs": 0,
        }
        # the push plan's map-side pushes (ShufflePushCompleted)
        self.shuffle_push: Dict[str, Any] = {
            "pushes": 0, "buckets": 0, "bytes": 0, "merged": 0,
            "stored": 0, "duplicates": 0, "failed": 0, "targets": 0,
            "wall_s": 0.0,
        }
        # placements by locality tier (TaskEnd.locality; empty while
        # placement is unscored)
        self.locality: Dict[str, int] = {"process": 0, "host": 0, "any": 0}
        # the task plane's counters (TaskEnd.dispatch)
        self.dispatch: Dict[str, int] = {
            "tasks_v2": 0, "tasks_legacy": 0, "header_bytes": 0,
            "binary_bytes": 0, "binaries_shipped": 0,
            "binary_cache_hits": 0, "need_binary": 0,
            "legacy_task_bytes": 0, "result_bytes": 0,
            "driver_serialized_bytes": 0,
        }
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
        self._lock = named_lock("scheduler.events.MetricsListener._lock")

    def _job(self, job_id: int) -> Dict[str, Any]:
        return self.jobs.setdefault(job_id, {
            "tasks": 0, "task_failures": 0, "task_time_s": 0.0,
        })

    def on_event(self, event: Event) -> None:
        with self._lock:
            self._fold(event)

    def _fold(self, event: Event) -> None:
        if isinstance(event, JobStart):
            info = self._job(event.job_id)
            info["start"] = event.time
            info["stages"] = event.num_stages
            info["pool"] = event.pool
        elif isinstance(event, JobEnd):
            info = self._job(event.job_id)
            info["duration_s"] = event.duration_s
            info["succeeded"] = event.succeeded
            if event.cancelled:
                info["cancelled"] = True
                self.jobs_cancelled += 1
            elif event.succeeded:
                # failed and cancelled walls would skew the percentiles
                # the rate controller steers by
                walls = self._pool_walls.setdefault(
                    info.get("pool", "default"), [])
                walls.append(event.duration_s)
                if len(walls) > 512:
                    del walls[:256]
        elif isinstance(event, StageSubmitted):
            self.stages[event.stage_id] = {
                "tasks": event.num_tasks, "shuffle": event.is_shuffle_map,
                "start": event.time, "job_id": event.job_id,
            }
        elif isinstance(event, StageCompleted):
            info = self.stages.setdefault(event.stage_id, {})
            info["duration_s"] = event.duration_s
        elif isinstance(event, TaskEnd):
            self.task_count += 1
            self.total_task_time_s += event.duration_s
            if not event.success:
                self.task_failures += 1
            if event.duplicate:
                self.speculation["duplicate_completions"] += 1
            if event.job_id != -1:
                info = self._job(event.job_id)
                info["tasks"] += 1
                info["task_time_s"] += event.duration_s
                if not event.success:
                    info["task_failures"] += 1
            if event.locality:
                self.locality[event.locality] = \
                    self.locality.get(event.locality, 0) + 1
                hist = self.stages.setdefault(event.stage_id, {}) \
                    .setdefault("locality", {})
                hist[event.locality] = hist.get(event.locality, 0) + 1
            if event.dispatch:
                self._fold_dispatch(event.dispatch)
        elif isinstance(event, ExecutorLost):
            self.executors_lost += 1
        elif isinstance(event, ExecutorRestarted):
            self.executors_restarted += 1
        elif isinstance(event, ExecutorAdded):
            self.elastic["executors_added"] += 1
        elif isinstance(event, ExecutorDecommissioned):
            el = self.elastic
            el["executors_decommissioned"] += 1
            if event.forced:
                el["decommissions_forced"] += 1
            for key in ("migrated_outputs", "migrated_bytes",
                        "replica_covered", "recomputed_outputs"):
                el[key] += getattr(event, key)
        elif isinstance(event, ShufflePushCompleted):
            sp = self.shuffle_push
            sp["pushes"] += 1
            sp["buckets"] += event.buckets
            sp["bytes"] += event.nbytes
            for key in ("merged", "stored", "duplicates", "failed",
                        "targets", "wall_s"):
                sp[key] += getattr(event, key)
        elif isinstance(event, FetchFailedOver):
            self.fetch["failovers"] += 1
            self.fetch["failover_buckets"] += event.buckets
        elif isinstance(event, SpeculativeLaunched):
            self.speculation["launched"] += 1
        elif isinstance(event, SpeculativeWon):
            self.speculation["won"] += 1
        elif isinstance(event, SpeculativeLost):
            self.speculation["lost"] += 1
        elif isinstance(event, JobRejected):
            self.jobs_rejected += 1
        elif isinstance(event, StageResubmitted):
            self.stages_resubmitted += 1
        elif isinstance(event, ShuffleFetchCompleted):
            f = self.fetch
            f["streams"] += 1
            f["buckets"] += event.buckets
            f["bytes"] += event.nbytes
            f["round_trips"] += event.round_trips
            for key in ("wall_s", "net_s", "overlap_s", "premerged_buckets",
                        "local_blob_reads", "merged_rtts", "coded_failovers",
                        "parity_decodes", "decode_bytes"):
                f[key] += getattr(event, key)
        elif isinstance(event, BlockSpilled):
            self.spill_count += 1
            self.spilled_bytes[event.store] = (
                self.spilled_bytes.get(event.store, 0) + event.nbytes)
        elif isinstance(event, BlockPromoted):
            self.promote_count += 1
            self.promoted_bytes[event.store] = (
                self.promoted_bytes.get(event.store, 0) + event.nbytes)
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

    def _fold_dispatch(self, d: Dict[str, Any]) -> None:
        dd = self.dispatch
        if d.get("mode") == "v2":
            dd["tasks_v2"] += 1
            dd["header_bytes"] += d.get("header_bytes", 0)
            dd["binary_bytes"] += d.get("binary_bytes", 0)
            dd["binaries_shipped"] += d.get("binaries_shipped", 0)
            dd["binary_cache_hits"] += d.get("cache_hit", 0)
            dd["need_binary"] += d.get("need_binary", 0)
            dd["driver_serialized_bytes"] += (d.get("header_bytes", 0)
                                              + d.get("binary_bytes", 0))
        else:
            dd["tasks_legacy"] += 1
            dd["legacy_task_bytes"] += d.get("task_bytes", 0)
            dd["driver_serialized_bytes"] += d.get("task_bytes", 0)
        dd["result_bytes"] += d.get("result_bytes", 0)

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
        """One job's record (tasks, failures, task seconds, pool, start,
        duration once ended) with its pool's recent p50 / p95 walls."""
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
                "stages": len(self.stages),
                "tasks": self.task_count,
                "task_failures": self.task_failures,
                "total_task_time_s": round(self.total_task_time_s, 6),
                "executors_lost": self.executors_lost,
                "executors_restarted": self.executors_restarted,
                "stages_resubmitted": self.stages_resubmitted,
                "elastic": dict(self.elastic),
                "jobs_rejected": self.jobs_rejected,
                "spills": self.spill_count,
                "promotes": self.promote_count,
                "spilled_bytes": dict(self.spilled_bytes),
                "promoted_bytes": dict(self.promoted_bytes),
                "speculation": dict(self.speculation),
                "fetch": {**self.fetch,
                          **{k: round(self.fetch[k], 6)
                             for k in ("wall_s", "net_s", "overlap_s")}},
                "locality": dict(self.locality),
                "shuffle_push": {**self.shuffle_push,
                                 "wall_s": round(
                                     self.shuffle_push["wall_s"], 6)},
                "dispatch": dict(self.dispatch),
                "streaming": {**self.streaming,
                              "batch_wall_s": round(
                                  self.streaming["batch_wall_s"], 6)},
                "pool_latency": self._pool_latency_locked(),
            }
