"""An executor's shuffle data server (pull), and the client calls that read
from it: the port's copy of vega_tpu/distributed/shuffle_server.py.

The server answers over the framed-TCP protocol (protocol.py) from its
executor's ShuffleStore (shuffle/store.py), memory and disk tiers alike:
get (one bucket), get_many (every bucket a reducer needs from this
server, streamed), put_many (a peer map task's replica row), status (the
store's counters; the healthcheck) and spill (every in-memory bucket to
disk).

fetch_remote and fetch_many_remote are the reducer's side, over one
pooled connection per (thread, server). A dropped connection is retried
in place fetch_retries times with a linear backoff; a batched stream cut
part-way re-requests only its undelivered tail, so every bucket is
delivered once. A "missing" reply raises FetchFailedError at once: the
bucket is gone and only the scheduler's resubmission brings it back.
push_buckets_remote is the map side's replica push. The reference's
push-plan pre-merge tier and parity messages wait for ROADMAP queue 1
items 7-8."""

from __future__ import annotations

import logging
import socket
import socketserver
import threading
import time
from typing import Optional

from vega_tpu_torch.distributed import protocol
from vega_tpu_torch.errors import FetchFailedError, NetworkError

log = logging.getLogger(__name__)


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        store = self.server.shuffle_store  # type: ignore[attr-defined]
        try:
            while True:
                msg_type, payload = protocol.recv_msg(sock)
                if msg_type == "get":
                    shuffle_id, map_id, reduce_id = payload
                    data = store.get(shuffle_id, map_id, reduce_id)
                    if data is None:
                        protocol.send_msg(sock, "missing", payload)
                    else:
                        protocol.send_msg(sock, "ok", None)
                        protocol.send_bytes(sock, data)
                elif msg_type == "get_many":
                    # buckets read one at a time as they are written out,
                    # disk-tier buckets included
                    shuffle_id, map_ids, reduce_id = payload
                    for map_id, data in store.iter_buckets(
                            shuffle_id, map_ids, reduce_id):
                        if data is None:
                            # the client drops the connection on this
                            # reply: nothing after it would be read
                            protocol.send_bucket_missing(sock, map_id)
                            return
                        protocol.send_bucket(sock, map_id, data)
                    protocol.send_batch_end(sock, len(map_ids))
                elif msg_type == "put_many":
                    shuffle_id, map_id, n_buckets = payload
                    for reduce_id in range(n_buckets):
                        store.put(shuffle_id, map_id, reduce_id,
                                  protocol.recv_bytes(sock))
                    protocol.send_msg(sock, "ok", n_buckets)
                elif msg_type == "status":
                    protocol.send_msg(sock, "ok", store.status())
                elif msg_type == "spill":
                    protocol.send_msg(sock, "ok",
                                      {"spilled": store.spill_all()})
                else:
                    protocol.send_msg(sock, "error", f"unknown {msg_type}")
                    return
        except NetworkError:
            pass  # the client hung up


class ShuffleServer:
    def __init__(self, shuffle_store, host: str = "127.0.0.1",
                 port: int = 0):
        self._server = protocol.ThreadingServer(
            (host, port), _Handler, bind_and_activate=True)
        self._server.shuffle_store = shuffle_store  # type: ignore[attr-defined]
        self.host = host
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="shuffle-server",
            daemon=True)
        self._thread.start()

    @property
    def uri(self) -> str:
        return f"{self.host}:{self.port}"

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


# one pooled connection per (thread, server)
_pool = threading.local()

# the fetch counters of this process (the worker_stats reply):
# round trips of each kind
_wire_lock = threading.Lock()
_WIRE = {"gets": 0, "get_many": 0, "put_many": 0}


def wire_snapshot() -> dict:
    with _wire_lock:
        return dict(_WIRE)


def _count(kind: str) -> None:
    with _wire_lock:
        _WIRE[kind] += 1


def _retry_settings(conf):
    if conf is None:
        return 3, 0.2
    return (max(1, int(conf.fetch_retries)),
            float(conf.fetch_retry_interval_s))


def _pooled_connection(uri: str,
                       connect_timeout: Optional[float] = None
                       ) -> socket.socket:
    conns = getattr(_pool, "conns", None)
    if conns is None:
        conns = _pool.conns = {}
    sock = conns.get(uri)
    if sock is None:
        host, port = protocol.parse_uri(uri)
        sock = protocol.connect(
            host, port, timeout=connect_timeout or protocol.CONNECT_TIMEOUT)
        conns[uri] = sock
    return sock


def _drop_connection(uri: str) -> None:
    conns = getattr(_pool, "conns", {})
    sock = conns.pop(uri, None)
    if sock is not None:
        try:
            sock.close()
        except OSError:
            pass


def fetch_remote(uri: str, shuffle_id: int, map_id: int, reduce_id: int,
                 conf=None) -> bytes:
    """One bucket over a get round trip (conf: its fetch_retries and
    fetch_retry_interval_s; None, their defaults)."""
    attempts, interval = _retry_settings(conf)
    key = (shuffle_id, map_id, reduce_id)
    last_error: Optional[NetworkError] = None
    for attempt in range(attempts):
        try:
            sock = _pooled_connection(uri)
            protocol.send_msg(sock, "get", key)
            _count("gets")
            reply_type, _ = protocol.recv_msg(sock)
            if reply_type == "missing":
                _drop_connection(uri)
                raise FetchFailedError(uri, shuffle_id, map_id, reduce_id,
                                       "server has no such bucket")
            return protocol.recv_bytes(sock)
        except NetworkError as e:
            _drop_connection(uri)
            last_error = e
            if attempt + 1 < attempts:
                log.warning("transient fetch failure from %s (attempt "
                            "%d/%d): %s; retrying in place", uri,
                            attempt + 1, attempts, e)
                time.sleep(interval * (attempt + 1))
    raise FetchFailedError(
        uri, shuffle_id, map_id, reduce_id,
        f"fetch failed after {attempts} attempts: {last_error}",
    ) from last_error


def push_buckets_remote(uri: str, shuffle_id: int, map_id: int,
                        blobs) -> None:
    """One map task's whole bucket row into a peer's store, one put_many
    round trip; NetworkError on failure (the caller keeps fewer
    replicas)."""
    clean = False
    try:
        sock = _pooled_connection(uri)
        protocol.send_msg(sock, "put_many", (shuffle_id, map_id, len(blobs)))
        for blob in blobs:
            protocol.send_bytes(sock, blob)
        reply_type, _ = protocol.recv_msg(sock)
        _count("put_many")
        if reply_type != "ok":
            raise NetworkError(f"replica push refused: {reply_type!r}")
        clean = True
    finally:
        if not clean:
            _drop_connection(uri)


def fetch_many_remote(uri: str, shuffle_id: int, map_ids, reduce_id: int,
                      deliver, deadline_s: Optional[float] = None,
                      conf=None) -> int:
    """Every bucket of map_ids for reduce_id from uri in one get_many
    round trip, each handed to deliver(map_id, data) as it comes off the
    wire; returns the round trips spent (1 when nothing failed).

    A stream cut part-way is retried in place for its undelivered tail
    only; a bucket_missing reply raises FetchFailedError at once. With
    deadline_s (every bucket asked for has a replica) each socket IO runs
    under that deadline with no retry, so a server that does not answer
    fails over to the replicas in deadline_s seconds."""
    attempts, interval = _retry_settings(conf)
    if deadline_s:
        attempts = 1
    remaining = dict.fromkeys(map_ids)  # the undelivered ids, in order
    round_trips = 0
    last_error: Optional[NetworkError] = None
    for attempt in range(attempts):
        try:
            return _get_many_round(uri, shuffle_id, remaining, reduce_id,
                                   deliver, round_trips,
                                   deadline_s=deadline_s)
        except NetworkError as e:
            _drop_connection(uri)
            last_error = e
            round_trips += 1  # the failed round went on the wire
            if attempt + 1 < attempts:
                log.warning("transient batched-fetch failure from %s "
                            "(attempt %d/%d, %d/%d buckets delivered): %s; "
                            "retrying the tail in place", uri, attempt + 1,
                            attempts, len(map_ids) - len(remaining),
                            len(map_ids), e)
                time.sleep(interval * (attempt + 1))
    first_missing = next(iter(remaining), None)
    raise FetchFailedError(
        uri, shuffle_id, first_missing, reduce_id,
        f"batched fetch failed after {attempts} attempts: {last_error}",
    ) from last_error


def _get_many_round(uri, shuffle_id, remaining, reduce_id, deliver,
                    round_trips, deadline_s=None):
    """One get_many request and its stream. Anything but a clean end
    drops the pooled connection (it may still hold unread frames)."""
    clean = False
    try:
        sock = _pooled_connection(uri, connect_timeout=deadline_s)
        if deadline_s:
            sock.settimeout(deadline_s)
        protocol.send_msg(sock, "get_many",
                          (shuffle_id, list(remaining), reduce_id))
        _count("get_many")
        round_trips += 1
        while True:
            reply_type, payload = protocol.recv_msg(sock)
            if reply_type == "bucket":
                data = protocol.recv_bytes(sock)
                if payload in remaining:  # a repeat is ignored
                    deliver(payload, data)
                    del remaining[payload]
            elif reply_type == "bucket_missing":
                raise FetchFailedError(uri, shuffle_id, payload, reduce_id,
                                       "server has no such bucket")
            elif reply_type == "batch_end":
                break
            else:
                raise NetworkError(
                    f"unexpected get_many reply {reply_type!r}")
        if not remaining:
            clean = True
            if deadline_s:
                sock.settimeout(protocol.IO_TIMEOUT)
            return round_trips
        # a well-framed end with buckets undelivered is a broken server,
        # not a transient fault: retrying would get the same answer
        raise FetchFailedError(
            uri, shuffle_id, next(iter(remaining)), reduce_id,
            f"get_many stream ended with {len(remaining)} buckets "
            "undelivered")
    finally:
        if not clean:
            _drop_connection(uri)


def check_status(uri: str, timeout: float = 5.0) -> Optional[dict]:
    """The server's store counters, or None when it does not answer."""
    try:
        host, port = protocol.parse_uri(uri)
        return protocol.request(host, port, "status", timeout=timeout)
    except NetworkError:
        return None


def request_spill(uri: str, timeout: float = 10.0) -> Optional[dict]:
    """Ask a server to spill its in-memory buckets to disk."""
    try:
        host, port = protocol.parse_uri(uri)
        return protocol.request(host, port, "spill", timeout=timeout)
    except NetworkError:
        return None
