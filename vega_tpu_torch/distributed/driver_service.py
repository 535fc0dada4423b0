"""The driver's control-plane service: the port's copy of
vega_tpu/distributed/driver_service.py.

One framed-TCP server (protocol.py) answers the executors' tracker
queries (map-output locations, waited for on the driver's condition, not
polled), their cached-partition registrations and lookups, their
registration and heartbeats, and the live shuffle peers a map task
replicates to, and the coded shuffle's parity registrations.
RemoteTrackerClient is the executor's side: the
map-output and cache trackers' interface over one cached connection per
thread, reconnected once when it broke."""

from __future__ import annotations

import logging
import socket
import socketserver
import threading
import time
from typing import Dict, Optional

from vega_tpu_torch.distributed import protocol
from vega_tpu_torch.errors import NetworkError
from vega_tpu_torch.lint.sync_witness import named_lock

log = logging.getLogger(__name__)


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        svc: DriverService = self.server.service  # type: ignore[attr-defined]
        try:
            while True:
                msg_type, payload = protocol.recv_msg(sock)
                try:
                    reply = svc.dispatch(msg_type, payload)
                    protocol.send_msg(sock, "ok", reply)
                except Exception as e:  # noqa: BLE001 — the client's error
                    log.exception("driver service error on %s", msg_type)
                    protocol.send_msg(sock, "error", repr(e))
        except NetworkError:
            pass


class DriverService:
    """The driver's trackers over RPC, and the executors' registry."""

    def __init__(self, map_output_tracker, cache_tracker,
                 host: str = "127.0.0.1", port: int = 0,
                 liveness_timeout_s: float = 30.0):
        self.map_output_tracker = map_output_tracker
        self.cache_tracker = cache_tracker
        # live_workers()'s default staleness bound
        self.liveness_timeout_s = liveness_timeout_s
        self.workers: Dict[str, dict] = {}  # executor_id -> registration
        # executors being decommissioned: still live, but no new replica
        # lands on them
        self.draining: set = set()
        self._lock = named_lock(
            "distributed.driver_service.DriverService._lock")
        self._server = protocol.ThreadingServer(
            (host, port), _Handler, bind_and_activate=True)
        self._server.service = self  # type: ignore[attr-defined]
        self.host = host
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="driver-service",
            daemon=True)
        self._thread.start()

    @property
    def uri(self) -> str:
        return f"{self.host}:{self.port}"

    def dispatch(self, msg_type: str, payload):
        if msg_type == "register_worker":
            with self._lock:
                self.workers[payload["executor_id"]] = dict(
                    payload, last_seen=time.time())
            log.info("worker registered: %s", payload["executor_id"])
            return True
        if msg_type == "heartbeat":
            with self._lock:
                info = self.workers.get(payload)
                if info is not None:
                    info["last_seen"] = time.time()
            return True
        if msg_type == "get_server_uris":
            shuffle_id, timeout = payload
            return self.map_output_tracker.get_server_uris(shuffle_id,
                                                           timeout)
        if msg_type == "get_server_uri_lists":
            shuffle_id, timeout = payload
            return self.map_output_tracker.get_server_uri_lists(shuffle_id,
                                                                timeout)
        if msg_type == "list_shuffle_peers":
            with self._lock:
                draining = set(self.draining)
            return {wid: info["shuffle_uri"]
                    for wid, info in self.live_workers().items()
                    if info.get("shuffle_uri") and wid not in draining}
        if msg_type == "register_parity":
            self.map_output_tracker.register_parity(*payload)
            return True
        if msg_type == "get_parity_map":
            return self.map_output_tracker.get_parity_map(payload)
        if msg_type == "has_outputs":
            return self.map_output_tracker.has_outputs(payload)
        if msg_type == "generation":
            return self.map_output_tracker.generation
        if msg_type == "cache_add_host":
            rdd_id, partition, host = payload
            self.cache_tracker.add_host(rdd_id, partition, host)
            return True
        if msg_type == "cache_get_locs":
            rdd_id, partition = payload
            return self.cache_tracker.get_cache_locs(rdd_id, partition)
        raise ValueError(f"unknown message type: {msg_type}")

    def live_workers(self, max_age: Optional[float] = None
                     ) -> Dict[str, dict]:
        if max_age is None:
            max_age = self.liveness_timeout_s
        now = time.time()
        with self._lock:
            return {wid: info for wid, info in self.workers.items()
                    if now - info["last_seen"] < max_age}

    def set_draining(self, executor_id: str, draining: bool) -> None:
        with self._lock:
            if draining:
                self.draining.add(executor_id)
            else:
                self.draining.discard(executor_id)

    def unregister_worker(self, executor_id: str) -> None:
        with self._lock:
            self.workers.pop(executor_id, None)
            self.draining.discard(executor_id)

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


class RemoteTrackerClient:
    """An executor's map-output and cache tracker: blocking RPCs to the
    driver service."""

    def __init__(self, driver_uri: str):
        self.driver_host, self.driver_port = protocol.parse_uri(driver_uri)
        self._local = threading.local()
        # per-partition locks of get_or_compute (cache_tracker.py), local
        # to this executor
        # (plain, as cache_tracker's are: one name for every partition
        # would read a nested get_or_compute as a self-deadlock)
        self._loading: Dict[tuple, threading.Lock] = {}
        self._loading_lock = named_lock(
            "distributed.driver_service.RemoteTrackerClient._loading_lock")

    def _sock(self) -> socket.socket:
        sock = getattr(self._local, "sock", None)
        if sock is None:
            sock = protocol.connect(self.driver_host, self.driver_port)
            self._local.sock = sock
        return sock

    def _call(self, msg_type: str, payload=None):
        # a broken cached connection is reconnected and the call retried
        # once: every message here is idempotent
        for attempt in (0, 1):
            try:
                sock = self._sock()
                protocol.send_msg(sock, msg_type, payload)
                reply_type, reply = protocol.recv_msg(sock)
                break
            except NetworkError:
                self._local.sock = None
                if attempt:
                    raise
        if reply_type == "error":
            raise NetworkError(f"driver error for {msg_type}: {reply}")
        return reply

    def get_server_uris(self, shuffle_id: int, timeout: float = 60.0):
        return self._call("get_server_uris", (shuffle_id, timeout))

    def get_server_uri_lists(self, shuffle_id: int, timeout: float = 60.0):
        return self._call("get_server_uri_lists", (shuffle_id, timeout))

    def list_shuffle_peers(self) -> dict:
        return self._call("list_shuffle_peers")

    def register_parity(self, shuffle_id: int, parity_uri: str,
                        group_id: int, map_id: int, idx: int, scheme: str,
                        k: int, m: int) -> None:
        self._call("register_parity", (shuffle_id, parity_uri, group_id,
                                       map_id, idx, scheme, k, m))

    def get_parity_map(self, shuffle_id: int) -> dict:
        return self._call("get_parity_map", shuffle_id)

    def has_outputs(self, shuffle_id: int) -> bool:
        return self._call("has_outputs", shuffle_id)

    @property
    def generation(self) -> int:
        return self._call("generation")

    def add_host(self, rdd_id: int, partition: int, host: str) -> None:
        self._call("cache_add_host", (rdd_id, partition, host))

    def get_cache_locs(self, rdd_id: int, partition: int):
        return self._call("cache_get_locs", (rdd_id, partition))

    def loading_lock(self, key: tuple) -> threading.Lock:
        with self._loading_lock:
            return self._loading.setdefault(key, threading.Lock())

    def register_worker(self, info: dict) -> None:
        self._call("register_worker", info)

    def heartbeat(self, executor_id: str) -> None:
        self._call("heartbeat", executor_id)
