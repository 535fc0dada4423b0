"""The distributed task backend, the driver's side: the port's copy of
vega_tpu/distributed/backend.py.

DistributedBackend spawns num_executors executor processes
(python -m vega_tpu_torch.distributed.worker, each with
CUDA_VISIBLE_DEVICES empty and none of the driver's process-group
variables: executors run host work on the CPU, and the dense tier stays
on the driver's card; under multihost= each rank spawns a fleet of its
own), waits for each one's READY line
and pings its task port, and runs the DAG scheduler's tasks on them
over TCP, one connection per task (protocol.py):

- task_v2: the stage binary (scheduler/task.py StageBinary, serialized
  once per stage) shipped once per (stage, executor) and a small header
  per task; an executor that lacks it answers need_binary and gets it
  on the same connection. task_binary_dedup=False sends the whole task
  per task (the legacy envelope). Results come back with their buffers
  out of band.
- placement: with locality_wait_s > 0, executors are scored
  PROCESS_LOCAL (the task's preferred executor or shuffle server) >
  HOST_LOCAL > ANY, ties to the least loaded; 0 is round-robin with a
  preferred-location seek. An executor with executor_blacklist_threshold
  consecutive dispatch failures is passed over while another is clean
  (forgiven after blacklist_decay_s).
- loss: a dead connection re-dispatches the task elsewhere; the reaper
  (every executor_reap_interval_s) declares an executor lost when its
  process exits or its heartbeat is older than
  executor_liveness_timeout_s: its connections are shut, its map outputs
  unregistered (the tracker's generation bumps), the DAG scheduler's
  listener scrubs and resubmits the stages that lost outputs, and
  ExecutorLost is posted; the slot is respawned up to
  executor_max_restarts times with exponential backoff
  (ExecutorRestarted).

- hosts: with hosts_file (or VEGA_TPU_HOSTS_FILE) the executors run on
  its slaves, a "host:N" entry N times; a remote host's executor is
  started over ssh with its settings on the command line (env K=V ...),
  and killed over ssh by the pid it registered when it is lost. New
  slots of the elastic fleet go to the host with the least executors
  per entry.
- the fleet's shape, for scheduler/elastic.py: add_executor,
  claim_decommission / release_decommission / remove_executor,
  declare_lost, fleet_snapshot, executor_inflight, shuffle_peer_uris.

Before it spawns executors the backend builds the native shuffle runtime
(native.py) and hands them its path (VEGA_TPU_NATIVE_LIB); a respawned
executor gets VEGA_TPU_FAULT_INCARNATION, which disarms its fault hooks
(faults.py)."""

from __future__ import annotations

import itertools
import logging
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Set

from vega_tpu_torch import serialization
from vega_tpu_torch.distributed import protocol
from vega_tpu_torch.distributed.driver_service import DriverService
from vega_tpu_torch.errors import NetworkError, TaskError
from vega_tpu_torch.lint.sync_witness import (
    assert_role,
    named_lock,
    note_thread_role,
)
from vega_tpu_torch.scheduler import events as ev
from vega_tpu_torch.scheduler.dag import TaskBackend
from vega_tpu_torch.scheduler.task import Task, TaskEndEvent

log = logging.getLogger(__name__)

# seconds an executor has from its spawn to its READY line
READY_DEADLINE_S = 30.0

_LOCAL_HOSTS = ("127.0.0.1", "localhost")

# the variables through which a process joins a driver's process group
# (mesh._normalize_multihost's JAX_* defaults, torch.distributed's env://
# rendezvous): a local executor's environment never carries them
_GROUP_VARS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
               "JAX_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT", "RANK",
               "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


def _weighted_scale_host(weights: Dict[str, int],
                         live_by_host: Dict[str, int]) -> str:
    """The host a new slot goes to: the lowest (live + 1) / weight, ties
    to the larger weight, then the name."""
    if not weights:
        return "127.0.0.1"
    return min(weights, key=lambda h: ((live_by_host.get(h, 0) + 1)
                                       / weights[h], -weights[h], h))


def _remote_kill(host: str, pid: int) -> None:
    """kill -9 of a remote executor over ssh, best effort."""
    try:
        subprocess.run(["ssh", host, "kill", "-9", str(pid)], timeout=15.0,
                       stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
                       stderr=subprocess.DEVNULL)
    except (OSError, subprocess.TimeoutExpired):
        pass


class _Executor:
    def __init__(self, executor_id: str, task_uri: str, host: str,
                 process: Optional[subprocess.Popen] = None,
                 restarts: int = 0):
        self.executor_id = executor_id
        self.task_uri = task_uri
        self.host = host
        self.process = process
        self.restarts = restarts  # respawns of this slot
        # its shuffle server, read from its registration at first need
        self.shuffle_uri: Optional[str] = None
        self.alive = True
        self.reaped = False      # declared lost: never alive again
        self.respawning = False  # a replacement launch in flight
        self.draining = False    # being decommissioned: no placements
        self.failures = 0        # consecutive dispatch failures
        self.last_failure_at = 0.0
        self.lost_at = 0.0
        self.sockets: Set[socket.socket] = set()  # dispatches in flight


class DistributedBackend(TaskBackend):
    def __init__(self, conf, env, num_executors: Optional[int] = None):
        from vega_tpu_torch import native

        # built here, once: executors load this file and never compile
        self.native_lib = native.build()
        self.service = DriverService(
            env.map_output_tracker, env.cache_tracker,
            liveness_timeout_s=conf.executor_liveness_timeout_s)
        env.shuffle_server = None  # the driver serves no shuffle data
        self.conf = conf
        self._executors: Dict[str, _Executor] = {}
        # stage-binary hashes believed delivered, per executor id (a
        # respawned slot inherits them; need_binary corrects that)
        self._known_hashes: Dict[str, Set[str]] = {}
        self._rr = itertools.count(0)
        # task_id -> the executor running it (cancel_task's target)
        self._running_on: Dict[int, str] = {}
        self._lock = named_lock("distributed.backend.DistributedBackend._lock")
        self._stopped = False
        self._stop_event = threading.Event()
        # the Context's bus.post, for ExecutorLost / ExecutorRestarted /
        # ExecutorAdded
        self.event_sink: Optional[Callable] = None
        self._executor_lost_listeners: List[Callable] = []
        # a hosts file only when one is named: a stray ~/hosts.conf never
        # overrides num_executors
        hosts = None
        explicit = conf.hosts_file or os.environ.get("VEGA_TPU_HOSTS_FILE")
        if explicit:
            from vega_tpu_torch.hosts import Hosts

            if not os.path.exists(explicit):
                self.service.stop()
                raise NetworkError(
                    f"configured hosts file does not exist: {explicit}")
            hosts = Hosts.load(explicit).slaves or None
        n = num_executors or conf.num_executors or 2
        hosts = hosts or ["127.0.0.1"] * n
        self._slot_ids = itertools.count(len(hosts))
        # each host's entries in the hosts file: its capacity
        self._host_weights: Dict[str, int] = {}
        for h in hosts:
            self._host_weights[h] = self._host_weights.get(h, 0) + 1
        # spawn to ready of each executor of the first fleet (seconds)
        self.spawn_s: Dict[str, float] = {}
        try:
            self._spawn_workers(hosts)
        except BaseException:
            self.stop()
            raise
        self._reaper = threading.Thread(
            target=self._reaper_loop, name="executor-reaper", daemon=True)
        self._reaper.start()

    # --- lifecycle ----------------------------------------------------------
    def add_executor_lost_listener(self, callback: Callable) -> None:
        """callback(executor_id, host, shuffle_uri, reason), once per lost
        executor, on the reaper's thread."""
        self._executor_lost_listeners.append(callback)

    @staticmethod
    def _worker_knobs(conf) -> Dict[str, str]:
        """Every setting an executor reads, as the VEGA_TPU_* variables
        Configuration.from_environ takes: the one source of an executor's
        settings, a local spawn's environment and an ssh command line
        alike."""
        return {
            "VEGA_TPU_DEPLOYMENT_MODE": "distributed",
            "VEGA_TPU_NUM_WORKERS": str(conf.num_workers),
            "VEGA_TPU_HEARTBEAT_INTERVAL_S": str(conf.heartbeat_interval_s),
            "VEGA_TPU_FETCH_RETRIES": str(conf.fetch_retries),
            "VEGA_TPU_FETCH_RETRY_INTERVAL_S": str(
                conf.fetch_retry_interval_s),
            "VEGA_TPU_FETCH_BATCH_ENABLED":
                "1" if conf.fetch_batch_enabled else "0",
            "VEGA_TPU_FETCH_QUEUE_BUCKETS": str(conf.fetch_queue_buckets),
            "VEGA_TPU_TASK_BINARY_DEDUP":
                "1" if conf.task_binary_dedup else "0",
            "VEGA_TPU_TASK_BINARY_CACHE_ENTRIES": str(
                conf.task_binary_cache_entries),
            "VEGA_TPU_SHUFFLE_REPLICATION": str(conf.shuffle_replication),
            "VEGA_TPU_FETCH_SLOW_SERVER_S": str(conf.fetch_slow_server_s),
            "VEGA_TPU_SHUFFLE_MEMORY_BUDGET": str(
                conf.shuffle_memory_budget),
            "VEGA_TPU_SHUFFLE_SPILL_THRESHOLD": str(
                conf.shuffle_spill_threshold),
            "VEGA_TPU_CACHE_CAPACITY_BYTES": str(conf.cache_capacity_bytes),
            "VEGA_TPU_LOCALITY_WAIT_S": str(conf.locality_wait_s),
            "VEGA_TPU_DECOMMISSION_TIMEOUT_S": str(
                conf.decommission_timeout_s),
            "VEGA_TPU_BLACKLIST_DECAY_S": str(conf.blacklist_decay_s),
            "VEGA_TPU_SHUFFLE_PLAN": str(conf.shuffle_plan),
            "VEGA_TPU_SHUFFLE_CODING": str(conf.shuffle_coding),
            "VEGA_TPU_CODING_GROUP_K": str(conf.coding_group_k),
            "VEGA_TPU_CODING_PARITY_M": str(conf.coding_parity_m),
            "VEGA_TPU_ELASTIC_ENABLED":
                "1" if conf.elastic_enabled else "0",
            "VEGA_TPU_ELASTIC_MIN_EXECUTORS": str(
                conf.elastic_min_executors),
            "VEGA_TPU_ELASTIC_MAX_EXECUTORS": str(
                conf.elastic_max_executors),
            "VEGA_TPU_ELASTIC_SCALE_UP_THRESHOLD": str(
                conf.elastic_scale_up_threshold),
            "VEGA_TPU_ELASTIC_SCALE_DOWN_THRESHOLD": str(
                conf.elastic_scale_down_threshold),
            "VEGA_TPU_ELASTIC_DECISION_INTERVAL_S": str(
                conf.elastic_decision_interval_s),
        }

    @staticmethod
    def _fault_knobs(incarnation: int = 0) -> Dict[str, str]:
        """The driver's VEGA_TPU_FAULT_* variables, which arm an
        executor's fault hooks (faults.py), and its incarnation: a
        respawned executor's (incarnation > 0) hooks are disarmed unless
        VEGA_TPU_FAULT_ALL_INCARNATIONS is set."""
        knobs = {k: v for k, v in os.environ.items()
                 if k.startswith("VEGA_TPU_FAULT_")}
        knobs["VEGA_TPU_FAULT_INCARNATION"] = str(incarnation)
        return knobs

    def _launch(self, executor_id: str, host: str = "127.0.0.1",
                incarnation: int = 0) -> subprocess.Popen:
        """One executor process, off the card and outside any process
        group: on this host a child with the settings in its environment
        (the driver's, less _GROUP_VARS), on another host over ssh with
        them on the remote command line (the package must be importable
        there, and the native library at the same path)."""
        knobs = dict(self._worker_knobs(self.conf),
                     **self._fault_knobs(incarnation),
                     VEGA_TPU_NATIVE_LIB=self.native_lib)
        if host not in _LOCAL_HOSTS:
            cmd = ["ssh", host, "env",
                   *[f"{k}={v}" for k, v in sorted(knobs.items())],
                   sys.executable, "-m", "vega_tpu_torch.distributed.worker",
                   "--driver", self.service.uri, "--executor-id",
                   executor_id, "--host", host, "--log-level",
                   str(self.conf.log_level)]
            return subprocess.Popen(cmd, stdin=subprocess.DEVNULL,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.DEVNULL, text=True)
        cmd = [sys.executable, "-m", "vega_tpu_torch.distributed.worker",
               "--driver", self.service.uri, "--executor-id", executor_id,
               "--log-level", str(self.conf.log_level)]
        worker_env = {k: v for k, v in os.environ.items()
                      if k not in _GROUP_VARS}
        worker_env.update(
            CUDA_VISIBLE_DEVICES="",
            VEGA_TPU_LOG_LEVEL=str(self.conf.log_level),
            VEGA_TPU_LOG_CLEANUP="true" if self.conf.log_cleanup else "false",
            VEGA_TPU_LOCAL_DIR=self.conf.local_dir, **knobs)
        if self.conf.spill_dir:
            worker_env["VEGA_TPU_SPILL_DIR"] = self.conf.spill_dir
        # the executor imports this package from where the driver does
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        path = worker_env.get("PYTHONPATH")
        worker_env["PYTHONPATH"] = pkg_root + (os.pathsep + path
                                               if path else "")
        # stdin from /dev/null: an executor never holds its driver's input
        return subprocess.Popen(cmd, env=worker_env, stdin=subprocess.DEVNULL,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, text=True)

    @staticmethod
    def _wait_ready(executor_id: str, proc: subprocess.Popen,
                    deadline: float) -> str:
        """The READY line, read on a helper thread and waited for until
        deadline: a worker that never prints fails loudly."""
        box: Dict[str, str] = {}

        def reader():
            while True:
                line = proc.stdout.readline() if proc.stdout else ""
                if not line:
                    return
                if line.startswith("VEGA_WORKER_READY"):
                    box["line"] = line
                    return

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        t.join(max(0.1, deadline - time.time()))
        if "line" not in box:
            if proc.poll() is not None:
                raise NetworkError(f"worker {executor_id} exited during "
                                   "startup")
            proc.kill()
            raise NetworkError(f"worker {executor_id} never became ready")
        return box["line"]

    @staticmethod
    def _confirm_task_port(executor_id: str, task_uri: str) -> None:
        """READY proves the worker printed; a ping proves it serves."""
        host, port = protocol.parse_uri(task_uri)
        got = protocol.request(host, port, "ping", timeout=5.0)
        if got != executor_id:
            raise NetworkError(
                f"worker {executor_id} task port answered ping as {got!r}")

    @staticmethod
    def _drain_stdout(executor_id: str, proc: subprocess.Popen) -> None:
        """Read the worker's stdout past READY, so a task's prints never
        fill the pipe and block it."""
        def drain():
            try:
                while True:
                    line = proc.stdout.readline() if proc.stdout else ""
                    if not line:
                        return
                    log.debug("[%s stdout] %s", executor_id, line.rstrip())
            except (OSError, ValueError):
                pass

        threading.Thread(target=drain, daemon=True,
                         name=f"drain-{executor_id}").start()

    def _ready(self, executor_id: str, proc: subprocess.Popen,
               deadline: float):
        """(executor id, task uri) of a launched worker once it serves;
        the process killed when it does not."""
        line = self._wait_ready(executor_id, proc, deadline)
        _tag, wid, task_uri = line.split()
        try:
            self._confirm_task_port(wid, task_uri)
        except NetworkError:
            proc.kill()
            raise
        return wid, task_uri

    def _spawn_workers(self, hosts: List[str]) -> None:
        t0 = time.perf_counter()
        procs = []
        for i, host in enumerate(hosts):
            executor_id = f"exec-{i}"
            with self._lock:
                self._executors[executor_id] = _Executor(
                    executor_id, "", host, None)
                self._executors[executor_id].alive = False
            proc = self._launch(executor_id, host)
            self._executors[executor_id].process = proc
            procs.append((executor_id, host, proc))
        deadline = time.time() + READY_DEADLINE_S
        for executor_id, host, proc in procs:
            wid, task_uri = self._ready(executor_id, proc, deadline)
            with self._lock:
                self._executors[wid] = _Executor(wid, task_uri, host, proc)
            self.spawn_s[wid] = time.perf_counter() - t0
            self._drain_stdout(wid, proc)
        log.info("distributed backend up: %d executors", len(procs))

    def stop(self) -> None:
        self._stopped = True
        self._stop_event.set()
        with self._lock:
            executors = list(self._executors.values())
        for ex in executors:
            self._shutdown_worker(ex)
        reaper = getattr(self, "_reaper", None)
        if reaper is not None and reaper.is_alive():
            reaper.join(timeout=2.0)
        self.service.stop()

    # --- liveness -----------------------------------------------------------
    def _reaper_loop(self) -> None:
        note_thread_role("reaper")
        while not self._stop_event.wait(self.conf.executor_reap_interval_s):
            try:
                self._sweep()
            except Exception:  # noqa: BLE001 — the reaper must survive
                log.exception("liveness sweep failed")

    def _sweep(self) -> None:
        live = self.service.live_workers()
        with self._lock:
            suspects = [ex for ex in self._executors.values()
                        if not ex.reaped]
        for ex in suspects:
            if ex.process is not None and ex.process.poll() is not None:
                self._mark_lost(ex, "process exited")
            elif ex.executor_id in self.service.workers \
                    and ex.executor_id not in live:
                self._mark_lost(ex, "heartbeat timeout")
        if not self._stopped:
            self._maybe_respawn()

    def _mark_lost(self, ex: _Executor, reason: str) -> None:
        with self._lock:
            if ex.reaped:
                return
            ex.reaped = True
            ex.alive = False
            ex.lost_at = time.time()
            inflight = list(ex.sockets)
        log.warning("executor %s lost (%s); failing over its in-flight "
                    "tasks", ex.executor_id, reason)
        info = self.service.workers.get(ex.executor_id) or {}
        shuffle_uri = info.get("shuffle_uri")
        # a wedged worker holds its ports: killed so the slot respawns
        if ex.process is not None and ex.process.poll() is None:
            ex.process.kill()
        # an ssh slot's process is the local ssh client: the remote worker
        # is killed by the pid it registered, off this thread
        if ex.host not in _LOCAL_HOSTS and info.get("pid"):
            threading.Thread(target=_remote_kill,
                             args=(ex.host, info["pid"]), daemon=True,
                             name=f"remote-kill-{ex.executor_id}").start()
        # dispatch threads blocked on it re-dispatch to survivors
        for sock in inflight:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        if shuffle_uri:
            removed = self.service.map_output_tracker \
                .unregister_server_outputs(shuffle_uri)
            if removed:
                log.info("unregistered %d map outputs of lost executor %s",
                         removed, ex.executor_id)
        for callback in list(self._executor_lost_listeners):
            try:
                callback(ex.executor_id, ex.host, shuffle_uri, reason)
            except Exception:  # noqa: BLE001 — a listener's own bug
                log.exception("executor-lost listener raised")
        sink = self.event_sink
        if sink is not None:
            sink(ev.ExecutorLost(executor_id=ex.executor_id, host=ex.host,
                                 reason=reason))

    # --- respawn ------------------------------------------------------------
    def _respawn_possible(self) -> bool:
        """A dead slot with restart budget left, or a respawn in flight:
        a task with no live executor waits for it."""
        with self._lock:
            return any(not ex.alive and ex.process is not None
                       and not ex.draining
                       and (ex.respawning
                            or ex.restarts < self.conf.executor_max_restarts)
                       for ex in self._executors.values())

    def _maybe_respawn(self) -> None:
        with self._lock:
            dead = [ex for ex in self._executors.values()
                    if ex.reaped and ex.process is not None
                    and not ex.respawning and not ex.draining]
        for ex in dead:
            if self._stop_event.is_set():
                return
            if ex.restarts >= self.conf.executor_max_restarts:
                continue
            backoff = self.conf.executor_restart_backoff_s * (2 ** ex.restarts)
            if time.time() - ex.lost_at < backoff:
                continue
            with self._lock:
                if ex.respawning:
                    continue
                ex.respawning = True
            # off the reaper's thread: a slow start must not stall the
            # liveness of the others
            threading.Thread(target=self._respawn, args=(ex,), daemon=True,
                             name=f"respawn-{ex.executor_id}").start()

    def _respawn(self, ex: _Executor) -> None:
        if self._stop_event.is_set():
            ex.respawning = False
            return
        attempt = ex.restarts + 1
        log.warning("respawning executor %s (restart %d/%d)",
                    ex.executor_id, attempt, self.conf.executor_max_restarts)
        try:
            proc = self._launch(ex.executor_id, ex.host, incarnation=attempt)
            wid, task_uri = self._ready(ex.executor_id, proc,
                                        time.time() + READY_DEADLINE_S)
        except (NetworkError, ValueError) as e:
            log.warning("respawn of %s failed: %s", ex.executor_id, e)
            ex.restarts = attempt
            ex.lost_at = time.time()
            ex.respawning = False
            return
        fresh = _Executor(wid, task_uri, ex.host, proc, restarts=attempt)
        with self._lock:
            if self._stopped:
                proc.kill()
                ex.respawning = False
                return
            self._executors[wid] = fresh
            ex.respawning = False
        self._drain_stdout(wid, proc)
        sink = self.event_sink
        if sink is not None:
            sink(ev.ExecutorRestarted(executor_id=wid, host=ex.host,
                                      attempt=attempt))

    # --- the fleet's shape --------------------------------------------------
    def add_executor(self) -> str:
        """One new executor slot, spawned, confirmed and in rotation;
        ExecutorAdded posted. NetworkError when it never serves."""
        assert_role("elastic")  # fleet mutation: driver-side control only
        with self._lock:
            if self._stopped:
                raise NetworkError("backend is stopped; cannot scale up")
            idx = next(self._slot_ids)
            live_by_host: Dict[str, int] = {}
            for e in self._executors.values():
                if e.alive and not e.draining:
                    live_by_host[e.host] = live_by_host.get(e.host, 0) + 1
        executor_id = f"exec-{idx}"
        host = _weighted_scale_host(self._host_weights, live_by_host)
        proc = self._launch(executor_id, host)
        wid, task_uri = self._ready(executor_id, proc,
                                    time.time() + READY_DEADLINE_S)
        with self._lock:
            if self._stopped:
                proc.kill()
                raise NetworkError("backend stopped during scale-up")
            self._executors[wid] = _Executor(wid, task_uri, host, proc)
            fleet = len([e for e in self._executors.values()
                         if e.alive and not e.draining])
        self._drain_stdout(wid, proc)
        sink = self.event_sink
        if sink is not None:
            sink(ev.ExecutorAdded(executor_id=wid, host=host,
                                  fleet_size=fleet))
        return wid

    def claim_decommission(self, executor_id: str, min_live: int = 0) -> str:
        """"ok" (the slot now drains: no placements, out of the peer
        registry, never respawned), "unknown", "claimed" (already
        draining) or "floor" (fewer than min_live live slots would
        remain)."""
        with self._lock:
            ex = self._executors.get(executor_id)
            if ex is None:
                return "unknown"
            if ex.draining:
                return "claimed"
            if ex.alive:
                live = len([e for e in self._executors.values()
                            if e.alive and not e.draining])
                if live - 1 < min_live:
                    return "floor"
            ex.draining = True
        self.service.set_draining(executor_id, True)
        return "ok"

    def release_decommission(self, executor_id: str) -> None:
        with self._lock:
            ex = self._executors.get(executor_id)
            if ex is None:
                return
            ex.draining = False
        self.service.set_draining(executor_id, False)

    @staticmethod
    def _shutdown_worker(ex: _Executor, graceful: bool = True) -> None:
        graceful = graceful and bool(ex.task_uri)  # not yet serving: kill
        if graceful:
            try:
                host, port = protocol.parse_uri(ex.task_uri)
                with protocol.connect(host, port, timeout=2.0) as sock:
                    protocol.send_msg(sock, "shutdown")
                    protocol.recv_msg(sock)
            except NetworkError:
                pass
        if ex.process is not None:
            if not graceful:
                ex.process.kill()
            try:
                ex.process.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                ex.process.kill()
                ex.process.wait(timeout=5.0)

    def remove_executor(self, executor_id: str,
                        graceful: bool = True) -> None:
        """A decommissioned slot out of the table and the registry first
        (its exit is no loss), then shut down."""
        assert_role("elastic")  # fleet mutation: driver-side control only
        with self._lock:
            ex = self._executors.pop(executor_id, None)
            self._known_hashes.pop(executor_id, None)
            if ex is not None:
                ex.draining = True
                ex.alive = False
                ex.reaped = True
        if ex is None:
            return
        self.service.unregister_worker(executor_id)
        self._shutdown_worker(ex, graceful=graceful)

    def declare_lost(self, executor_id: str, reason: str) -> None:
        with self._lock:
            ex = self._executors.get(executor_id)
        if ex is not None:
            self._mark_lost(ex, reason)

    def executor_inflight(self) -> Dict[str, int]:
        with self._lock:
            counts: Dict[str, int] = {}
            for eid in self._running_on.values():
                counts[eid] = counts.get(eid, 0) + 1
            return counts

    def fleet_snapshot(self) -> List[dict]:
        inflight = self.executor_inflight()
        with self._lock:
            return [{"executor_id": ex.executor_id, "host": ex.host,
                     "alive": ex.alive, "draining": ex.draining,
                     "restarts": ex.restarts,
                     "inflight": inflight.get(ex.executor_id, 0)}
                    for ex in self._executors.values()]

    @property
    def parallelism(self) -> int:
        with self._lock:
            n = max(1, len([e for e in self._executors.values()
                            if e.alive and not e.draining]))
        return n * self.conf.num_workers

    # locality tiers by score, 0 best
    _TIER_NAMES = ("process", "host", "any")

    def shuffle_peer_uris(self) -> List[str]:
        """The live, non-draining executors' shuffle servers."""
        return [info["shuffle_uri"]
                for wid, info in self.service.live_workers().items()
                if info.get("shuffle_uri")
                and wid not in self.service.draining]

    def _effective_failures(self, ex: _Executor, now: float) -> int:
        """The consecutive-failure count, forgiven once its last failure
        is blacklist_decay_s old. Caller holds self._lock."""
        decay = float(self.conf.blacklist_decay_s or 0.0)
        if decay > 0 and ex.failures and now - ex.last_failure_at >= decay:
            ex.failures = 0
        return ex.failures

    def _match_tier(self, executor: _Executor, locs) -> int:
        if not locs:
            return 2
        if executor.executor_id in locs:
            return 0
        uri = executor.shuffle_uri
        if uri is None:
            info = self.service.workers.get(executor.executor_id)
            uri = executor.shuffle_uri = (info or {}).get("shuffle_uri")
        if uri and uri in locs:
            return 0
        if executor.host in locs:
            return 1
        return 2

    def _recoverable_better_tier_locked(self, locs, best_tier: int,
                                        exclude) -> bool:
        """Could waiting improve the tier: a dead slot with restart budget
        whose host the task prefers, while the task scores ANY. Caller
        holds self._lock."""
        if best_tier <= 1:
            return False
        now = time.time()
        for ex in self._executors.values():
            if ex.alive or ex.process is None or ex.draining:
                continue
            if not (ex.respawning
                    or ex.restarts < self.conf.executor_max_restarts):
                continue
            if ex.executor_id in exclude:
                continue
            if self._effective_failures(ex, now) >= \
                    self.conf.executor_blacklist_threshold:
                continue
            if ex.host in locs:
                return True
        return False

    def _pick_executor(self, task: Task) -> _Executor:
        return self._pick_executor_scored(task)[0]

    def _pick_executor_scored(self, task: Task):
        """(executor, locality tier, improvable) of one placement. A
        speculative copy goes to another executor than the original's and
        never to a blacklisted one (none eligible raises); an ordinary
        task treats the blacklist as advice."""
        speculative = bool(task.speculative)
        exclude = task.exclude_executors or ()
        locs = task.preferred_locs or ()
        wait_s = float(self.conf.locality_wait_s or 0.0)
        with self._lock:
            now = time.time()
            alive = [e for e in self._executors.values() if e.alive]
            if not alive:
                raise NetworkError("no live executors")
            active = [e for e in alive if not e.draining]
            if active:
                alive = active
            threshold = self.conf.executor_blacklist_threshold
            if exclude:
                eligible = [e for e in alive if e.executor_id not in exclude]
                if eligible or speculative:
                    alive = eligible
            if speculative:
                alive = [e for e in alive
                         if self._effective_failures(e, now) < threshold]
                if not alive:
                    raise NetworkError(
                        "no eligible executor for speculative attempt "
                        f"(excluded={set(exclude) or '{}'})")
            else:
                clean = [e for e in alive
                         if self._effective_failures(e, now) < threshold]
                if clean:
                    alive = clean
            if wait_s <= 0:
                if locs:
                    matches = [e for e in alive
                               if e.executor_id in locs or e.host in locs]
                    if matches:
                        return (matches[next(self._rr) % len(matches)],
                                "", False)
                return alive[next(self._rr) % len(alive)], "", False
            tiers = [(self._match_tier(e, locs), e) for e in alive]
            best = min(t for t, _ in tiers)
            cands = [e for t, e in tiers if t == best]
            running: Dict[str, int] = {}
            for eid in self._running_on.values():
                running[eid] = running.get(eid, 0) + 1
            least = min(running.get(e.executor_id, 0) for e in cands)
            cands = [e for e in cands
                     if running.get(e.executor_id, 0) == least]
            chosen = cands[next(self._rr) % len(cands)]
            improvable = bool(locs) and best > 0 and \
                self._recoverable_better_tier_locked(locs, best, exclude)
            return chosen, self._TIER_NAMES[best], improvable

    def _pick_with_locality_wait(self, task: Task):
        """(executor, tier): a task whose preferred host's executor is
        respawning re-picks every 50 ms for up to locality_wait_s."""
        deadline = None
        while True:
            executor, tier, improvable = self._pick_executor_scored(task)
            if not improvable or task.speculative:
                return executor, tier
            now = time.time()
            if deadline is None:
                deadline = now + float(self.conf.locality_wait_s)
            elif now >= deadline:
                return executor, tier
            time.sleep(min(0.05, max(0.001, deadline - now)))

    @property
    def preserialize_stage_binaries(self) -> bool:
        return bool(self.conf.task_binary_dedup)

    def cancel_task(self, task_id: int) -> None:
        """One cancel_task message to the executor running the attempt,
        from a thread of its own (completions are deduplicated
        driver-side, so delivery is never needed)."""
        with self._lock:
            executor_id = self._running_on.get(task_id)
            ex = self._executors.get(executor_id) if executor_id else None
        if ex is None or not ex.alive:
            return

        def _send(uri=ex.task_uri):
            try:
                host, port = protocol.parse_uri(uri)
                with protocol.connect(host, port, timeout=5.0) as sock:
                    protocol.send_msg(sock, "cancel_task", task_id)
                    protocol.recv_msg(sock)
            except NetworkError:
                pass

        threading.Thread(target=_send, daemon=True,
                         name=f"cancel-{task_id}").start()

    def worker_stats(self) -> Dict[str, dict]:
        """Every live executor's own counters (fetch, replica pushes,
        wire), probed in parallel under one 5 s deadline; an executor that
        does not answer is left out."""
        with self._lock:
            executors = [e for e in self._executors.values() if e.alive]
        out: Dict[str, dict] = {}
        out_lock = named_lock(
            "distributed.backend.DistributedBackend.worker_stats.out_lock")

        def probe(ex: _Executor) -> None:
            try:
                host, port = protocol.parse_uri(ex.task_uri)
                with protocol.connect(host, port, timeout=5.0) as sock:
                    sock.settimeout(5.0)
                    protocol.send_msg(sock, "worker_stats")
                    reply_type, reply = protocol.recv_msg(sock)
                if reply_type != "ok":
                    raise NetworkError(
                        f"worker_stats refused: {reply_type!r}")
            except NetworkError:
                log.debug("worker_stats probe of %s failed",
                          ex.executor_id, exc_info=True)
                return
            with out_lock:
                out[ex.executor_id] = reply

        threads = [threading.Thread(target=probe, args=(ex,), daemon=True,
                                    name=f"worker-stats-{ex.executor_id}")
                   for ex in executors]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=6.0)
        with out_lock:
            return dict(out)

    # --- dispatch -----------------------------------------------------------
    def submit(self, task: Task,
               callback: Callable[[TaskEndEvent], None]) -> None:
        binary = task.stage_binary
        dedup = bool(self.conf.task_binary_dedup) and binary is not None
        if dedup:
            header_payload = serialization.dumps(task.header())
            payload = None
            stats = {"mode": "v2", "header_bytes": 0, "binary_bytes": 0,
                     "binaries_shipped": 0, "need_binary": 0,
                     "cache_hit": 0, "result_bytes": 0}
        else:
            header_payload = None
            payload = serialization.dumps(task)
            stats = {"mode": "legacy", "task_bytes": 0, "result_bytes": 0}

        def dispatch():
            try:
                _dispatch_loop()
            except BaseException as exc:  # noqa: BLE001 — always an event
                log.exception("dispatch for %s failed", task)
                callback(TaskEndEvent(task=task, success=False, error=exc,
                                      dispatch=stats))
            finally:
                with self._lock:
                    self._running_on.pop(task.task_id, None)

        def _send_task(sock: socket.socket, executor: _Executor) -> None:
            if not dedup:
                protocol.send_msg(sock, "task", payload)
                stats["task_bytes"] += len(payload)
                return
            sha = binary.sha
            with self._lock:
                known = self._known_hashes.setdefault(executor.executor_id,
                                                      set())
                if len(known) > 4096:
                    known.clear()
                ship = sha not in known
                if ship:
                    # marked before the send, so the stage's other tasks
                    # ride the cache; a failed send heals by need_binary
                    known.add(sha)
            frames = [protocol.encode_msg("task_v2", sha),
                      serialization.frame_bytes(header_payload)]
            stats["header_bytes"] += len(header_payload)
            if ship:
                payload_bytes = binary.payload
                frames.append(protocol.encode_msg("binary", sha))
                frames.append(serialization.frame_prefix(len(payload_bytes)))
                protocol.send_raw(sock, b"".join(frames))
                protocol.send_raw(sock, payload_bytes)
                stats["binaries_shipped"] += 1
                stats["binary_bytes"] += len(payload_bytes)
            else:
                frames.append(protocol.encode_msg("binary_cached", sha))
                protocol.send_raw(sock, b"".join(frames))

        def _recv_result(sock: socket.socket):
            reply_type, meta = protocol.recv_msg(sock)
            while reply_type == "need_binary":
                protocol.send_msg(sock, "binary", binary.sha)
                protocol.send_bytes(sock, binary.payload)
                stats["need_binary"] += 1
                stats["binaries_shipped"] += 1
                stats["binary_bytes"] += len(binary.payload)
                reply_type, meta = protocol.recv_msg(sock)
            if reply_type != "result":
                raise NetworkError(f"bad reply {reply_type}")
            if meta is None:
                reply = protocol.recv_bytes(sock)
                stats["result_bytes"] += len(reply)
                return serialization.loads(reply)
            head = protocol.recv_bytes(sock)
            buffers = [protocol.recv_buffer(sock) for _ in range(meta)]
            stats["result_bytes"] += len(head) + sum(len(b) for b in buffers)
            if dedup and stats["need_binary"] == 0 \
                    and not stats["binaries_shipped"]:
                stats["cache_hit"] = 1
            return serialization.loads_oob(head, buffers)

        def _dispatch_loop():
            attempts = 0
            # with every executor dead at once, wait for a respawn for
            # the restart budget before the task fails
            no_executor_deadline = None
            while True:
                try:
                    executor, tier = self._pick_with_locality_wait(task)
                except NetworkError as e:
                    if task.speculative:
                        callback(TaskEndEvent(task=task, success=False,
                                              error=e, dispatch=stats))
                        return
                    if not self._stopped and self._respawn_possible():
                        if no_executor_deadline is None:
                            conf = self.conf
                            budget = sum(
                                conf.executor_restart_backoff_s * (2 ** k)
                                for k in range(conf.executor_max_restarts)
                            ) + READY_DEADLINE_S + 5.0
                            no_executor_deadline = time.time() + budget
                        if time.time() < no_executor_deadline:
                            time.sleep(0.25)
                            continue
                    callback(TaskEndEvent(task=task, success=False, error=e,
                                          dispatch=stats))
                    return
                no_executor_deadline = None
                task.dispatched_to = executor.executor_id
                with self._lock:
                    self._running_on[task.task_id] = executor.executor_id
                try:
                    host, port = protocol.parse_uri(executor.task_uri)
                    with protocol.connect(host, port) as sock:
                        # registered so the reaper can shut it if the
                        # executor wedges; refused once it was reaped
                        with self._lock:
                            if executor.reaped:
                                raise NetworkError(
                                    f"executor {executor.executor_id} was "
                                    "reaped while connecting")
                            executor.sockets.add(sock)
                        try:
                            _send_task(sock, executor)
                            # a task may run for hours: no IO deadline;
                            # the reaper or the OS ends a dead one
                            # vegalint: ignore[VG012] — deliberately unbounded: tasks may run for hours; executor death unblocks via the reaper's socket shutdown / OS keepalive
                            sock.settimeout(None)
                            sock.setsockopt(socket.SOL_SOCKET,
                                            socket.SO_KEEPALIVE, 1)
                            status, *rest = _recv_result(sock)
                        finally:
                            with self._lock:
                                executor.sockets.discard(sock)
                    with self._lock:
                        executor.failures = 0
                    if status == "success":
                        result, duration = rest
                        callback(TaskEndEvent(task=task, success=True,
                                              result=result,
                                              duration_s=duration,
                                              dispatch=stats,
                                              executor=executor.executor_id,
                                              locality=tier))
                    else:
                        exc, remote_tb = rest
                        if not isinstance(exc, BaseException):
                            exc = TaskError(repr(exc),
                                            remote_traceback=remote_tb)
                        if getattr(exc, "remote_traceback", None) is None:
                            try:
                                exc.remote_traceback = remote_tb
                            except AttributeError:
                                pass
                        callback(TaskEndEvent(task=task, success=False,
                                              error=exc, dispatch=stats,
                                              executor=executor.executor_id,
                                              locality=tier))
                    return
                except NetworkError as e:
                    # the executor is unreachable: re-dispatched elsewhere
                    attempts += 1
                    log.warning("executor %s unreachable (%s); "
                                "re-dispatching", executor.executor_id, e)
                    with self._lock:
                        executor.failures += 1
                        executor.last_failure_at = time.time()
                        if executor.reaped:
                            executor.alive = False
                        else:
                            executor.alive = executor.process is not None \
                                and executor.process.poll() is None
                    if attempts >= 3 + len(self._executors):
                        callback(TaskEndEvent(task=task, success=False,
                                              error=e, dispatch=stats))
                        return
                    time.sleep(0.1 * attempts)

        threading.Thread(target=dispatch, daemon=True,
                         name=f"dispatch-{task.task_id}").start()
