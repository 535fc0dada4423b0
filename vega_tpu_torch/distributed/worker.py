"""An executor process: the port's copy of vega_tpu/distributed/worker.py.

A TCP listener takes one task per connection and runs it on that
connection's own thread (a reduce task waiting on map outputs never
starves the map task it waits for), with the cyclic garbage collector
paused while any task runs (scheduler/dag.py paused_gc, as the driver's
jobs run), then writes the result back on the same connection
(protocol.py: task, task_v2 with the stage-binary cache, cancel_task,
ping, worker_stats, shutdown). The worker registers with
the driver service, heartbeats every heartbeat_interval_s and serves its
shuffle buckets through its own ShuffleServer, whose pre-merge tier
takes a quarter of shuffle_memory_budget. The VEGA_TPU_FAULT_* hooks
(faults.py) sit before a task (hang, a dropped binary), inside its timed
window (slow), after it and before its result (kill) and in the
heartbeat loop. worker_stats answers this process's fetch, push,
redundancy and wire counters.

An executor runs host work on the CPU: the backend starts it with
CUDA_VISIBLE_DEVICES empty, and no lineage it receives reaches the card
(a DenseRDD arrives as its rows, dense_rdd._HostDenseView). It makes one
Env, with no Context, from the VEGA_TPU_* variables it was started with
(env.Configuration.from_environ), and lineages that name their Context
get context._StubContext in its place.

Run:  python -m vega_tpu_torch.distributed.worker --driver HOST:PORT \\
          [--host 127.0.0.1] [--port 0] [--executor-id ID] \\
          [--log-level WARNING]
It prints "VEGA_WORKER_READY <executor id> <host:port>" once it serves.
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import socket
import socketserver
import sys
import tempfile
import threading
import time
import traceback
import uuid
from collections import OrderedDict

from vega_tpu_torch import faults, serialization
from vega_tpu_torch.distributed import protocol
from vega_tpu_torch.distributed.driver_service import RemoteTrackerClient
from vega_tpu_torch.distributed.shuffle_server import ShuffleServer
from vega_tpu_torch.env import (Configuration, DeploymentMode, Env,
                                attach_session_logger,
                                detach_session_logger, normalize_log_level)
from vega_tpu_torch.errors import NetworkError, TaskCancelledError
from vega_tpu_torch.lint.sync_witness import named_lock, note_thread_role
from vega_tpu_torch.scheduler.dag import paused_gc
from vega_tpu_torch.scheduler.task import TaskBinaryCache, run_from_header

log = logging.getLogger(__name__)


def _pre_run_cancel_gate(cancel_event) -> None:
    """A cancel that reached this executor before its attempt started
    fails the attempt instead of running it."""
    if cancel_event.is_set():
        raise TaskCancelledError("attempt cancelled before it started")


class _TaskHandler(socketserver.BaseRequestHandler):
    def handle(self):
        note_thread_role("worker-task")
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        worker: Worker = self.server.worker  # type: ignore[attr-defined]
        try:
            msg_type, payload = protocol.recv_msg(sock)
        except NetworkError:
            return
        if msg_type == "shutdown":
            protocol.send_msg(sock, "ok", None)
            worker.request_shutdown()
            return
        if msg_type == "ping":
            protocol.send_msg(sock, "ok", worker.executor_id)
            return
        if msg_type == "worker_stats":
            protocol.send_msg(sock, "ok", worker.stats())
            return
        if msg_type == "cancel_task":
            protocol.send_msg(sock, "ok", worker.cancel_task(payload))
            return
        if msg_type == "task_v2":
            self._handle_task_v2(sock, worker, payload)
            return
        if msg_type != "task":
            protocol.send_msg(sock, "error", f"unknown {msg_type}")
            return
        try:
            faults.get().maybe_hang_task()
            task = serialization.loads(payload)
            cancel_event = worker.begin_task(task.task_id)
            try:
                _pre_run_cancel_gate(cancel_event)
                # the wall starts after the decode: the task's own cost
                t0 = time.monotonic()
                faults.get().maybe_slow_task(cancel_event)
                with paused_gc():
                    result = task.run()
                duration = time.monotonic() - t0
            finally:
                worker.end_task(task.task_id)
            # computed, not yet acknowledged: the loss the driver recovers
            faults.get().maybe_kill_worker()
            reply = serialization.dumps(("success", result, duration))
            protocol.send_msg(sock, "result", None)
            protocol.send_bytes(sock, reply)
        except BaseException as exc:  # noqa: BLE001 — shipped to the driver
            log.debug("task failed", exc_info=True)
            try:
                protocol.send_msg(sock, "result", None)
                protocol.send_bytes(sock, _pickle_error(exc))
            except NetworkError:
                pass

    def _handle_task_v2(self, sock, worker: "Worker", sha: str) -> None:
        """A header frame and the stage binary on first use; a hash this
        executor lacks (a respawn, an eviction) is asked for with
        need_binary and re-shipped on this connection."""
        claim = None
        try:
            header_bytes = protocol.recv_bytes(sock)
            marker, _marker_sha = protocol.recv_msg(sock)
            if marker == "binary":
                # announced before the payload arrives: sibling
                # binary_cached dispatches wait for it
                claim = worker.binaries.claim(sha)
            elif marker != "binary_cached":
                protocol.send_msg(sock, "error", f"unknown marker {marker}")
                return
            raw = protocol.recv_bytes(sock) if marker == "binary" else None
        except NetworkError:
            worker.binaries.abandon(sha, claim)
            return
        try:
            faults.get().maybe_hang_task()
            if marker == "binary_cached" and faults.get().maybe_drop_binary():
                worker.binaries.drop(sha)
            binary = None
            if raw is None:
                binary = worker.binaries.wait_for(sha)
                if binary is None:
                    protocol.send_msg(sock, "need_binary", sha)
                    claim = worker.binaries.claim(sha)
                    sock.settimeout(protocol.IO_TIMEOUT)
                    try:
                        reply_type, _ = protocol.recv_msg(sock)
                        if reply_type != "binary":
                            raise NetworkError(
                                f"expected binary re-ship, got {reply_type}")
                        raw = protocol.recv_bytes(sock)
                    finally:
                        # vegalint: ignore[VG012] — restores the handler socket's normal no-deadline idle state after the bounded re-ship window
                        sock.settimeout(None)
            if binary is None:
                binary = worker.binaries.load(sha, raw, claim)
            header = serialization.loads(header_bytes)
            cancel_event = worker.begin_task(header.task_id)
            try:
                _pre_run_cancel_gate(cancel_event)
                # the wall starts after the binary's transfer and decode
                t0 = time.monotonic()
                faults.get().maybe_slow_task(cancel_event)
                with paused_gc():
                    result = run_from_header(header, binary)
                duration = time.monotonic() - t0
            finally:
                worker.end_task(header.task_id)
            faults.get().maybe_kill_worker()
            head, buffers = serialization.dumps_oob(
                ("success", result, duration))
        except BaseException as exc:  # noqa: BLE001 — shipped to the driver
            worker.binaries.abandon(sha, claim)
            log.debug("task failed", exc_info=True)
            head, buffers = _pickle_error(exc), []
        try:
            protocol.send_msg(sock, "result", len(buffers))
            protocol.send_bytes(sock, head)
            for buf in buffers:
                protocol.send_bytes(sock, buf)
        except NetworkError:
            pass


def _pickle_error(exc: BaseException) -> bytes:
    tb = traceback.format_exc()
    try:
        return serialization.dumps(("error", exc, tb))
    except Exception:  # noqa: BLE001 — an unpicklable exception: its repr
        log.warning("task exception %r is unpicklable; shipping its repr",
                    exc, exc_info=True)
        return serialization.dumps(("error", RuntimeError(repr(exc)), tb))


class Worker:
    def __init__(self, driver_uri: str, host: str = "127.0.0.1",
                 port: int = 0, executor_id: str | None = None):
        from vega_tpu_torch import context as context_mod
        from vega_tpu_torch.store import DiskStore

        self.executor_id = executor_id or f"exec-{os.getpid()}"
        faults.set_executor_id(self.executor_id)
        conf = Configuration.from_environ()
        conf.deployment_mode = DeploymentMode.DISTRIBUTED
        base = conf.spill_dir or os.path.join(tempfile.gettempdir(),
                                              "vega-tpu", "spill")
        self.session_root = os.path.join(
            base, f"session-{uuid.uuid4().hex[:12]}")
        env = Env(conf, self.session_root,
                  DiskStore(os.path.join(self.session_root, "cache")))
        env.executor_id = self.executor_id
        tracker = RemoteTrackerClient(driver_uri)
        env.map_output_tracker = tracker
        env.cache_tracker = tracker
        env.shuffle_server = ShuffleServer(
            env.shuffle_store, host,
            premerge_budget=conf.shuffle_memory_budget // 4)
        self.env = env
        context_mod._install_executor_env(env)
        self.tracker = tracker
        # deserialized stage binaries, one decode per stage here
        self.binaries = TaskBinaryCache(conf.task_binary_cache_entries)
        self._server = protocol.ThreadingServer(
            (host, port), _TaskHandler, bind_and_activate=True)
        self._server.worker = self  # type: ignore[attr-defined]
        self.host = host
        self.port = self._server.server_address[1]
        self._shutdown = threading.Event()
        # running attempts' cancel events, and the ids cancelled before
        # their attempt arrived
        self._cancel_lock = named_lock(
            "distributed.worker.Worker._cancel_lock")
        self._cancel_events: dict = {}
        self._cancelled_recently: "OrderedDict[int, float]" = OrderedDict()
        self._log_dir = os.path.join(conf.local_dir,
                                     f"session-{uuid.uuid4().hex[:12]}")
        self._log_handler = attach_session_logger(
            self._log_dir, f"executor-{self.executor_id}", conf.log_level)
        tracker.register_worker({
            "executor_id": self.executor_id,
            "host": host,
            "task_uri": f"{host}:{self.port}",
            "shuffle_uri": env.shuffle_server.uri,
            "pid": os.getpid(),
        })

    @property
    def task_uri(self) -> str:
        return f"{self.host}:{self.port}"

    def stats(self) -> dict:
        """This process's fetch, push, redundancy and wire counters."""
        from vega_tpu_torch import dependency
        from vega_tpu_torch.distributed import shuffle_server
        from vega_tpu_torch.shuffle import fetcher

        return {"executor_id": self.executor_id,
                "fetch": fetcher.stats_snapshot(),
                "push": dependency.push_stats_snapshot(),
                "redundancy": dependency.redundancy_stats_snapshot(),
                "premerge": self.env.shuffle_server.premerge.status(),
                "wire": shuffle_server.wire_snapshot()}

    def begin_task(self, task_id: int) -> threading.Event:
        """A starting attempt's cancel event, already set when a cancel
        came first."""
        with self._cancel_lock:
            event = self._cancel_events.get(task_id)
            if event is None:
                event = self._cancel_events[task_id] = threading.Event()
            if task_id in self._cancelled_recently:
                event.set()
            return event

    def end_task(self, task_id: int) -> None:
        with self._cancel_lock:
            self._cancel_events.pop(task_id, None)

    def cancel_task(self, task_id: int) -> bool:
        """Set the attempt's cancel event (True: it was running here), or
        remember the id for an attempt still on its way."""
        with self._cancel_lock:
            event = self._cancel_events.get(task_id)
            if event is not None:
                event.set()
                return True
            self._cancelled_recently[task_id] = time.time()
            while len(self._cancelled_recently) > 256:
                self._cancelled_recently.popitem(last=False)
            return False

    def request_shutdown(self) -> None:
        self._shutdown.set()

    def serve_forever(self) -> None:
        threading.Thread(target=self._server.serve_forever,
                         name="task-server", daemon=True).start()
        while not self._shutdown.wait(self.env.conf.heartbeat_interval_s):
            if faults.get().suppress_heartbeat():
                continue
            try:
                self.tracker.heartbeat(self.executor_id)
            except NetworkError:
                log.warning("driver unreachable; shutting down")
                break
        self.stop()

    def stop(self) -> None:
        self._shutdown.set()
        self._server.shutdown()
        self._server.server_close()
        env = self.env
        env.shuffle_server.stop()
        env.close()
        shutil.rmtree(self.session_root, ignore_errors=True)
        detach_session_logger(self._log_handler)
        self._log_handler = None
        if env.conf.log_cleanup:
            shutil.rmtree(self._log_dir, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="vega_tpu_torch executor")
    parser.add_argument("--driver", required=True,
                        help="the driver service's HOST:PORT")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--executor-id", default=None)
    parser.add_argument("--log-level", default="WARNING")
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=normalize_log_level(args.log_level),
        format=f"%(asctime)s {args.executor_id or 'worker'} %(levelname)s "
               "%(message)s")
    os.environ.setdefault("VEGA_TPU_LOG_LEVEL", args.log_level)
    worker = Worker(args.driver, args.host, args.port, args.executor_id)
    print(f"VEGA_WORKER_READY {worker.executor_id} {worker.task_uri}",
          flush=True)
    worker.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
