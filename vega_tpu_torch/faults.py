"""Fault injection: the port's copy of vega_tpu/faults.py.

Deterministic failure points that the runtime consults at its seams, so
its recovery paths are driven by tests and the chip script:

  distributed/worker.py    maybe_hang_task (wedged but alive),
                           maybe_slow_task (a straggler; a cancel ends
                           its sleep), maybe_kill_worker (SIGKILL after N
                           tasks, after the task ran and before its result
                           is sent), suppress_heartbeat, maybe_drop_binary
                           (evict a cached stage binary: need_binary)
  distributed/shuffle_server.py
                           serve_fetch (drop or delay a get),
                           serve_stream_fetch (cut a get_many stream after
                           FETCH_DROP_AFTER_BUCKETS buckets), serve_push
                           (cut a push_merged round before its ack),
                           serve_merged (delay a get_merged reply),
                           corrupt_parity (flip a byte of a served parity
                           frame: the client's CRC reads it as missing)
  shuffle/store.py         corrupt_spilled (flip a spilled bucket's byte)
  scheduler/local_backend.py
                           maybe_slow_task
  scheduler/elastic.py     decommission_hang (a victim that never drains;
                           a driver-side hook aimed at the victim's id)
  streaming/source.py      maybe_crash_receiver

The VEGA_TPU_FAULT_* variables arm them, so an executor spawned with them
(distributed/backend.py passes the driver's environment on) is armed too;
configure(field=value) arms this process's injector directly:

  VEGA_TPU_FAULT_EXECUTOR            only this executor id (empty: all)
  VEGA_TPU_FAULT_KILL_AFTER_TASKS    SIGKILL self after N tasks
  VEGA_TPU_FAULT_HANG_TASKS          1: task handlers sleep forever
  VEGA_TPU_FAULT_SLOW_TASKS          slow the first N tasks
  VEGA_TPU_FAULT_SLOW_TASK_S         seconds each sleeps (5.0)
  VEGA_TPU_FAULT_SUPPRESS_HEARTBEATS 1: stop heartbeating
  VEGA_TPU_FAULT_FETCH_DROP_N        drop the first N bucket gets
  VEGA_TPU_FAULT_FETCH_DELAY_S       delay every served get
  VEGA_TPU_FAULT_FETCH_STREAM_DROP_N cut the first N get_many streams
  VEGA_TPU_FAULT_FETCH_DROP_AFTER_BUCKETS
                                     buckets served before the cut (1)
  VEGA_TPU_FAULT_MERGED_DELAY_S      delay every get_merged reply
  VEGA_TPU_FAULT_PUSH_DROP_N         cut the first N push_merged rounds
  VEGA_TPU_FAULT_DECOMMISSION_HANG_S wedge a decommission's drain
  VEGA_TPU_FAULT_RECEIVER_CRASH_AFTER_BLOCKS
                                     crash a streaming receiver once
  VEGA_TPU_FAULT_CORRUPT_SPILL_N     corrupt the first N spilled buckets
  VEGA_TPU_FAULT_PARITY_CORRUPT_N    corrupt the first N served parity
                                     frames
  VEGA_TPU_FAULT_DROP_BINARY_N       drop the cached binary of the first
                                     N binary_cached dispatches
  VEGA_TPU_FAULT_STATS_DIR           one JSON line per fault fired, in
                                     <dir>/faults-<pid>.jsonl (read_stats)
  VEGA_TPU_FAULT_INCARNATION         set by the backend on a respawned
                                     executor: its faults are disarmed
                                     unless VEGA_TPU_FAULT_ALL_INCARNATIONS=1

Every decision counts down (the first N); none is random.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import time
from typing import Optional
from vega_tpu_torch.lint.sync_witness import named_lock

log = logging.getLogger(__name__)

# this process's executor id (distributed/worker.py sets it), which
# VEGA_TPU_FAULT_EXECUTOR is compared with
_executor_id: Optional[str] = None


def set_executor_id(executor_id: Optional[str]) -> None:
    global _executor_id
    _executor_id = executor_id


class FaultInjector:
    def __init__(self, environ=None):
        env = os.environ if environ is None else environ
        pref = "VEGA_TPU_FAULT_"

        def _int(name: str, default: int = 0) -> int:
            raw = env.get(pref + name, "")
            try:
                return int(raw) if raw else default
            except ValueError:
                return default

        def _float(name: str, default: float = 0.0) -> float:
            raw = env.get(pref + name, "")
            try:
                return float(raw) if raw else default
            except ValueError:
                return default

        def _flag(name: str) -> bool:
            return env.get(pref + name, "").lower() in ("1", "true")

        incarnation = _int("INCARNATION", 0)
        armed = incarnation == 0 or _flag("ALL_INCARNATIONS")

        self.executor_filter: Optional[str] = env.get(pref + "EXECUTOR") or None
        self.kill_after_tasks = _int("KILL_AFTER_TASKS") if armed else 0
        self.hang_tasks = armed and _flag("HANG_TASKS")
        self.slow_tasks = _int("SLOW_TASKS") if armed else 0
        self.slow_task_s = _float("SLOW_TASK_S", 5.0)
        self.suppress_heartbeats = armed and _flag("SUPPRESS_HEARTBEATS")
        self.fetch_drop_n = _int("FETCH_DROP_N") if armed else 0
        self.fetch_delay_s = _float("FETCH_DELAY_S") if armed else 0.0
        self.fetch_stream_drop_n = _int("FETCH_STREAM_DROP_N") if armed else 0
        self.fetch_drop_after_buckets = _int("FETCH_DROP_AFTER_BUCKETS", 1)
        self.push_drop_n = _int("PUSH_DROP_N") if armed else 0
        self.merged_delay_s = _float("MERGED_DELAY_S") if armed else 0.0
        self.corrupt_spill_n = _int("CORRUPT_SPILL_N") if armed else 0
        self.parity_corrupt_n = _int("PARITY_CORRUPT_N") if armed else 0
        self.receiver_crash_after_blocks = \
            _int("RECEIVER_CRASH_AFTER_BLOCKS") if armed else 0
        self.drop_binary_n = _int("DROP_BINARY_N") if armed else 0
        self.decommission_hang_s = \
            _float("DECOMMISSION_HANG_S") if armed else 0.0
        self.stats_dir = env.get(pref + "STATS_DIR") or None

        self._tasks_done = 0
        self._lock = named_lock("faults.FaultInjector._lock")

    # ------------------------------------------------------------- targeting
    @property
    def active(self) -> bool:
        """Cheap gate for the hot paths: anything armed at all?"""
        return bool(
            self.kill_after_tasks or self.hang_tasks or self.slow_tasks
            or self.suppress_heartbeats or self.fetch_drop_n
            or self.fetch_delay_s or self.corrupt_spill_n
            or self.parity_corrupt_n
            or self.fetch_stream_drop_n or self.drop_binary_n
            or self.push_drop_n or self.merged_delay_s
            or self.decommission_hang_s or self.receiver_crash_after_blocks
        )

    def _targets_me(self) -> bool:
        """The executor filter, read at each hook: the worker sets its id
        after this injector may exist."""
        if self.executor_filter is None:
            return True
        return _executor_id == self.executor_filter

    # ----------------------------------------------------------------- hooks
    def maybe_hang_task(self) -> None:
        """worker.py, before running a task: simulate a wedged-but-alive
        executor (the process responds to nothing but never dies)."""
        if not (self.active and self.hang_tasks and self._targets_me()):
            return
        self._record("hang_task")
        log.warning("FAULT: hanging task handler (wedged executor)")
        while True:
            time.sleep(3600.0)

    def maybe_slow_task(self, cancel_event=None) -> None:
        """worker.py, inside the timed execution window: make this task a
        STRAGGLER — a bounded, deterministic sleep (unlike hang, the task
        finishes and delivers its result, so first-result-wins dedup and
        loser accounting are exercised end to end). The sleep waits on the
        attempt's cancel event when one is supplied: a driver-side
        cancel_task interrupts it and the attempt exits early with
        TaskCancelledError instead of sleeping out the injection."""
        if not (self.active and self.slow_tasks and self._targets_me()):
            return
        with self._lock:
            if self.slow_tasks <= 0:
                return
            self.slow_tasks -= 1
        self._record("slow_task", sleep_s=self.slow_task_s)
        log.warning("FAULT: slowing task by %.1fs (straggler)",
                    self.slow_task_s)
        if cancel_event is not None:
            if cancel_event.wait(self.slow_task_s):
                from vega_tpu_torch.errors import TaskCancelledError

                log.warning("FAULT: slowed task cancelled mid-sleep")
                raise TaskCancelledError(
                    "straggling attempt cancelled by the driver"
                )
        else:
            time.sleep(self.slow_task_s)

    def maybe_kill_worker(self) -> None:
        """worker.py, after a task computes but BEFORE its result is sent:
        the most brutal loss point — the driver sees the socket die with
        the task unacknowledged."""
        if not (self.active and self.kill_after_tasks and self._targets_me()):
            return
        with self._lock:
            self._tasks_done += 1
            if self._tasks_done < self.kill_after_tasks:
                return
            # under the lock: the one death is recorded once, before any
            # task thread's signal (a second due thread waits here)
            if self._tasks_done == self.kill_after_tasks:
                self._record("kill_worker")
            log.warning("FAULT: SIGKILL self after %d tasks", self._tasks_done)
            os.kill(os.getpid(), signal.SIGKILL)

    def suppress_heartbeat(self) -> bool:
        """worker.py heartbeat loop: True -> skip this beat (stay alive)."""
        if not (self.active and self.suppress_heartbeats and self._targets_me()):
            return False
        self._record("suppress_heartbeat")
        return True

    def serve_fetch(self) -> bool:
        """shuffle_server.py, on each bucket get: True -> the server must
        drop the connection without replying (transient network fault).
        Applies the configured delay first."""
        if not (self.active and self._targets_me()):
            return False
        if self.fetch_delay_s:
            self._record("fetch_delay")
            time.sleep(self.fetch_delay_s)
        with self._lock:
            if self.fetch_drop_n <= 0:
                return False
            self.fetch_drop_n -= 1
        self._record("fetch_drop")
        log.warning("FAULT: dropping shuffle fetch connection")
        return True

    def serve_stream_fetch(self, bucket_index: int) -> bool:
        """shuffle_server.py, per bucket of a get_many stream: True -> cut
        the connection NOW, after `fetch_drop_after_buckets` buckets have
        already been framed — a partial batch the client must complete by
        retrying only the undelivered tail."""
        if not (self.active and self.fetch_stream_drop_n
                and self._targets_me()):
            return False
        if bucket_index < self.fetch_drop_after_buckets:
            return False
        with self._lock:
            if self.fetch_stream_drop_n <= 0:
                return False
            self.fetch_stream_drop_n -= 1
        self._record("fetch_stream_drop", bucket_index=bucket_index)
        log.warning("FAULT: cutting get_many stream after %d buckets",
                    bucket_index)
        return True

    def serve_push(self) -> bool:
        """shuffle_server.py, on a push_merged round (shuffle_plan=push):
        True -> cut the connection after consuming the payload frames but
        BEFORE feeding the tier or acking — the worst-timed drop: the
        mapper sees a dead socket and must degrade that row to the pull
        plan, and its local buckets must make the reducer whole."""
        if not (self.active and self.push_drop_n and self._targets_me()):
            return False
        with self._lock:
            if self.push_drop_n <= 0:
                return False
            self.push_drop_n -= 1
        self._record("push_drop")
        log.warning("FAULT: dropping shuffle push connection")
        return True

    def serve_merged(self) -> None:
        """shuffle_server.py, on each get_merged round: delay the reply by
        MERGED_DELAY_S seconds — a deterministic modeled network RTT. The
        locality A/B's off-leg pays it once per REMOTE pre-merged blob
        read; a reducer the locality plane scheduled onto its owning
        executor reads the tier in-process and never enters this hook."""
        if not (self.active and self.merged_delay_s and self._targets_me()):
            return
        self._record("merged_delay", sleep_s=self.merged_delay_s)
        time.sleep(self.merged_delay_s)

    def maybe_drop_binary(self) -> bool:
        """worker.py, on a task_v2 dispatch whose driver believes the stage
        binary is already cached here: True -> the worker must evict it
        first, forcing the `need_binary` re-ship recovery mid-stage (the
        LRU-eviction / respawn-staleness path, driven deterministically)."""
        if not (self.active and self.drop_binary_n and self._targets_me()):
            return False
        with self._lock:
            if self.drop_binary_n <= 0:
                return False
            self.drop_binary_n -= 1
        self._record("drop_binary")
        log.warning("FAULT: dropping cached task binary (forcing "
                    "need_binary re-ship)")
        return True

    def decommission_hang(self, executor_id: str) -> float:
        """scheduler/elastic.py, at drain start: seconds the victim should
        read as still-busy (a wedged victim that never drains). DRIVER-
        side hook, so the executor filter compares against the VICTIM's
        id, not this process's Env.executor_id. Returns 0.0 when unarmed
        or the victim doesn't match."""
        if not (self.active and self.decommission_hang_s):
            return 0.0
        if self.executor_filter is not None \
                and self.executor_filter != executor_id:
            return 0.0
        self._record("decommission_hang", executor=executor_id,
                     hang_s=self.decommission_hang_s)
        log.warning("FAULT: wedging decommission drain of %s for %.1fs",
                    executor_id, self.decommission_hang_s)
        return self.decommission_hang_s

    def maybe_crash_receiver(self, blocks_landed: int) -> None:
        """streaming/source.py, after a receiver lands a block in the
        tiered store: crash the receiver THREAD (raise) once it has landed
        N blocks — mid-ingest loss with the block already durable. The
        streaming context must restart the receiver resuming from its
        tracked offset, and the final state must be bit-identical to an
        uninterrupted run. One-shot: the counter disarms after firing so
        the restarted receiver is healthy."""
        if not (self.active and self.receiver_crash_after_blocks
                and self._targets_me()):
            return
        with self._lock:
            if self.receiver_crash_after_blocks <= 0:
                return
            if blocks_landed < self.receiver_crash_after_blocks:
                return
            self.receiver_crash_after_blocks = 0
        self._record("receiver_crash", blocks_landed=blocks_landed)
        log.warning("FAULT: crashing streaming receiver after %d blocks",
                    blocks_landed)
        raise RuntimeError("FAULT: injected receiver crash")

    def corrupt_parity(self) -> bool:
        """shuffle_server.py, serving a get_parity frame: True -> the
        server must flip a byte in the frame it serves. The fetcher's
        CRC check then rejects the frame as MISSING and the recovery
        degrades down the ladder (coded -> replica failover ->
        FetchFailed -> stage resubmit) — corrupt parity must never be
        decoded into wrong data."""
        if not (self.active and self.parity_corrupt_n
                and self._targets_me()):
            return False
        with self._lock:
            if self.parity_corrupt_n <= 0:
                return False
            self.parity_corrupt_n -= 1
        self._record("parity_corrupt")
        log.warning("FAULT: corrupting served parity frame")
        return True

    def corrupt_spilled(self, disk_store, key: str) -> None:
        """shuffle/store.py, after a bucket spills: flip payload bytes in
        the on-disk file. The checksummed read must surface this as a
        miss -> FetchFailed -> stage retry, never as wrong data."""
        if not (self.active and self.corrupt_spill_n and self._targets_me()):
            return
        with self._lock:
            if self.corrupt_spill_n <= 0:
                return
            self.corrupt_spill_n -= 1
        path = disk_store.path_of(key)
        if path is None:
            return
        try:
            with open(path, "r+b") as f:
                f.seek(-1, os.SEEK_END)
                last = f.read(1)
                f.seek(-1, os.SEEK_END)
                f.write(bytes([last[0] ^ 0xFF]))
        except OSError:
            log.warning("FAULT: corrupt_spilled(%s) could not write", key)
            return
        self._record("corrupt_spill", key=key)
        log.warning("FAULT: corrupted spilled bucket %s", key)

    # ------------------------------------------------------------- recording
    def _record(self, kind: str, **extra) -> None:
        """Best-effort evidence trail: cross-process tests assert the fault
        actually fired by reading these lines (a chaos test that injects
        nothing proves nothing)."""
        if self.stats_dir is None:
            return
        try:
            os.makedirs(self.stats_dir, exist_ok=True)
            line = json.dumps(dict(fault=kind, pid=os.getpid(),
                                   time=time.time(), **extra))
            with open(os.path.join(self.stats_dir,
                                   f"faults-{os.getpid()}.jsonl"), "a") as f:
                f.write(line + "\n")
        except OSError:
            pass


_injector: Optional[FaultInjector] = None
_injector_lock = named_lock("faults._injector_lock")


def get() -> FaultInjector:
    """Process-local injector, built lazily from the environment."""
    global _injector
    if _injector is None:
        with _injector_lock:
            if _injector is None:
                _injector = FaultInjector()
    return _injector


def configure(**fields) -> FaultInjector:
    """Same-process (local-mode) test hook: build a fresh injector from the
    current environment, then override attributes directly."""
    global _injector
    with _injector_lock:
        inj = FaultInjector()
        for name, value in fields.items():
            if not hasattr(inj, name):
                raise AttributeError(f"unknown fault field: {name}")
            setattr(inj, name, value)
        _injector = inj
    return inj


def reset() -> None:
    """Drop the cached injector (tests: env vars changed since first use)."""
    global _injector
    with _injector_lock:
        _injector = None


def read_stats(stats_dir: str):
    """All recorded fault lines across every process (chaos-test assert)."""
    out = []
    try:
        names = os.listdir(stats_dir)
    except OSError:
        return out
    for name in sorted(names):
        if not name.startswith("faults-"):
            continue
        try:
            with open(os.path.join(stats_dir, name)) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        out.append(json.loads(line))
        except (OSError, ValueError):
            continue
    return out
