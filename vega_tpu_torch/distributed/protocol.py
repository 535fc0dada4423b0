"""Length-framed messages of the control and data planes: the port's copy
of vega_tpu/distributed/protocol.py.

Every frame is an 8-byte little-endian length and its payload
(serialization.py); a message is one frame holding the pickled
(msg_type, payload) tuple, one request and one reply per round on a
connection, except where a grammar below says otherwise.

The shuffle plane's batched pull, get_many, is one request answered by a
stream of per-bucket replies:

    -> ("get_many", (shuffle_id, [map_id, ...], reduce_id))
    <- per requested map_id, in request order:
         ("bucket", map_id) + one raw bytes frame        (served)
       | ("bucket_missing", map_id)                      (gone: the stream
                                                          ends; the client
                                                          raises
                                                          FetchFailedError
                                                          and drops the
                                                          connection)
    <- ("batch_end", n_sent)                             (terminator)

A stream cut before batch_end is retried for its undelivered tail only.
The single-bucket get is ("get", (shuffle_id, map_id, reduce_id)),
answered ("ok", None) + one raw frame, or ("missing", key).

The task plane: the legacy ("task", pickled task) carries the whole task
and is answered ("result", None) + one pickled frame. The deduplicated
task_v2 ships a stage's binary once per executor:

    -> ("task_v2", sha) + one header frame          (TaskHeader pickle)
    -> ("binary", sha) + one binary frame           (first use here)
     | ("binary_cached", sha)                       (believed cached)
    <- ("need_binary", sha)                         (the worker lacks it)
    -> ("binary", sha) + one binary frame           (re-shipped inline)
    <- ("result", n_oob) + one pickle-header frame + n_oob out-of-band
       buffer frames (serialization.dumps_oob; received into writable
       bytearrays, so arrays that come back stay writable)

and ("cancel_task", task_id) -> ("ok", was_running), ("ping", None) ->
("ok", executor_id), ("worker_stats", None) -> ("ok", counters),
("shutdown", None) -> ("ok", None).

The replica push of shuffle_replication > 1, map task to a peer's
shuffle server:

    -> ("put_many", (shuffle_id, map_id, n_buckets))
       + n_buckets raw bytes frames in reduce_id order
    <- ("ok", n_buckets)

The reference's push-plan (push_merged, get_merged) and coded-shuffle
(put_parity, get_parity) messages are not here: the port refuses
shuffle_plan="push" and shuffle_coding other than "none"."""

from __future__ import annotations

import socket
import socketserver
from typing import Any, Tuple

from vega_tpu_torch import serialization
from vega_tpu_torch.errors import NetworkError

CONNECT_TIMEOUT = 10.0
IO_TIMEOUT = 120.0


class ThreadingServer(socketserver.ThreadingTCPServer):
    """A thread per connection, daemon threads, and a listen backlog of
    128: socketserver's default of 5 drops the SYNs of a burst of
    connections (a stage's tasks dispatched at once, its reducers'
    fetches), and each dropped one waits out the kernel's 1 s
    retransmit."""

    daemon_threads = True
    request_queue_size = 128


def connect(host: str, port: int,
            timeout: float = CONNECT_TIMEOUT) -> socket.socket:
    try:
        sock = socket.create_connection((host, port), timeout=timeout)
        sock.settimeout(IO_TIMEOUT)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock
    except OSError as e:
        raise NetworkError(f"connect to {host}:{port} failed: {e}") from e


class _SockStream:
    """A socket as the read / write stream the framing helpers take."""

    __slots__ = ("sock",)

    def __init__(self, sock: socket.socket):
        self.sock = sock

    def read(self, n: int) -> bytes:
        try:
            # Client sockets arrive here with CONNECT/IO_TIMEOUT or a
            # caller-set deadline already applied by connect()/settimeout;
            # server handler sockets idle in recv between requests by
            # design (the client hanging up ends the loop with EOF).
            # vegalint: ignore[VG012] — deadline is set on the socket by connect()/the caller; handler sockets idle between requests by design
            return self.sock.recv(min(n, 1 << 20))
        except OSError as e:
            raise NetworkError(f"socket read failed: {e}") from e

    def write(self, data) -> int:
        try:
            self.sock.sendall(data)
            return len(data)
        except OSError as e:
            raise NetworkError(f"socket write failed: {e}") from e


def send_msg(sock: socket.socket, msg_type: str, payload: Any = None) -> None:
    serialization.write_frame(_SockStream(sock),
                              serialization.dumps((msg_type, payload)))


def recv_msg(sock: socket.socket) -> Tuple[str, Any]:
    try:
        data = serialization.read_frame(_SockStream(sock))
    except EOFError as e:
        raise NetworkError("connection closed mid-message") from e
    return serialization.loads(data)


def send_bytes(sock: socket.socket, data) -> None:
    serialization.write_frame(_SockStream(sock), data)


def encode_msg(msg_type: str, payload: Any = None) -> bytes:
    """One message as framed bytes, as send_msg writes it, for a caller
    that joins several frames into one send."""
    return serialization.frame_bytes(serialization.dumps((msg_type, payload)))


def send_raw(sock: socket.socket, data) -> None:
    """One sendall of bytes already framed (encode_msg)."""
    _SockStream(sock).write(data)


def recv_bytes(sock: socket.socket) -> bytes:
    try:
        return serialization.read_frame(_SockStream(sock))
    except EOFError as e:
        raise NetworkError("connection closed mid-message") from e


def recv_buffer(sock: socket.socket) -> bytearray:
    """One frame received into a writable bytearray (recv_into): arrays
    loads_oob rebuilds over it stay writable."""
    try:
        n = serialization.read_frame_len(_SockStream(sock))
    except EOFError as e:
        raise NetworkError("connection closed mid-message") from e
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        try:
            # vegalint: ignore[VG012] — same contract as _SockStream.read: the socket's deadline (IO_TIMEOUT or the caller's) is already set and recv_into inherits it
            r = sock.recv_into(view[got:], n - got)
        except OSError as e:
            raise NetworkError(f"socket read failed: {e}") from e
        if not r:
            raise NetworkError(
                f"connection closed with {n - got} buffer bytes outstanding")
        got += r
    return buf


def request(host: str, port: int, msg_type: str, payload: Any = None,
            timeout: float = CONNECT_TIMEOUT) -> Any:
    """One request / reply round on a connection of its own."""
    with connect(host, port, timeout) as sock:
        send_msg(sock, msg_type, payload)
        reply_type, reply = recv_msg(sock)
        if reply_type == "error":
            raise NetworkError(f"remote error for {msg_type}: {reply}")
        return reply


def send_bucket(sock: socket.socket, map_id: int, data) -> None:
    """One served bucket of a get_many stream: its status, then its raw
    bytes."""
    send_msg(sock, "bucket", map_id)
    send_bytes(sock, data)


def send_bucket_missing(sock: socket.socket, map_id: int) -> None:
    send_msg(sock, "bucket_missing", map_id)


def send_batch_end(sock: socket.socket, n_sent: int) -> None:
    send_msg(sock, "batch_end", n_sent)


def parse_uri(uri: str) -> Tuple[str, int]:
    host, _, port = uri.rpartition(":")
    return host, int(port)
