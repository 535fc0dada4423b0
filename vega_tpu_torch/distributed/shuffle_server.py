"""An executor's shuffle data server, and the client calls that read
from it: the port's copy of vega_tpu/distributed/shuffle_server.py.

The server answers over the framed-TCP protocol (protocol.py) from its
executor's ShuffleStore (shuffle/store.py), memory and disk tiers alike:
get (one bucket), get_many (every bucket a reducer needs from this
server, streamed), put_many (a peer map task's replica row), push_merged
(a mapper's pushed buckets into this server's pre-merge tier,
shuffle/premerge.py, under shuffle_plan="push"), get_merged (a
reducer's read of that tier: the frozen blob and the raw pushed
buckets), put_parity (a peer's compressed row folded into a parity
group of this server, shuffle/coding.py), get_parity (one parity
frame), status (the store's and the tier's counters; the healthcheck)
and spill (every in-memory bucket to disk). Parity groups are assigned
here, first come first placed, with at most one member of each origin
server per group, so one lost server costs a group one member.

fetch_remote and fetch_many_remote are the reducer's side, over one
pooled connection per (thread, server). A dropped connection is retried
in place fetch_retries times with a linear backoff; a batched stream cut
part-way re-requests only its undelivered tail, so every bucket is
delivered once. A "missing" reply raises FetchFailedError at once: the
bucket is gone and only the scheduler's resubmission brings it back.
push_buckets_remote is the map side's replica push; push_merged_remote,
fetch_merged_remote, put_parity_remote and fetch_parity_remote run each
IO under a deadline (fetch_slow_server_s, else PUSH_IO_DEADLINE_S):
they never carry the only copy of anything. The executors' fault hooks
(faults.py) sit on get, get_many, push_merged, get_merged and
get_parity."""

from __future__ import annotations

import logging
import socket
import socketserver
import threading
import time
from typing import Optional

from zlib import error as zlib_error

from vega_tpu_torch import faults
from vega_tpu_torch.distributed import protocol
from vega_tpu_torch.errors import FetchFailedError, NetworkError
from vega_tpu_torch.lint.sync_witness import named_lock

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
                    if faults.get().serve_fetch():
                        return  # an injected drop: no reply
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
                    inj = faults.get()
                    for i, (map_id, data) in enumerate(store.iter_buckets(
                            shuffle_id, map_ids, reduce_id)):
                        if inj.serve_fetch() or inj.serve_stream_fetch(i):
                            return  # an injected cut mid-stream
                        if data is None:
                            # the client drops the connection on this
                            # reply: nothing after it would be read
                            protocol.send_bucket_missing(sock, map_id)
                            return
                        protocol.send_bucket(sock, map_id, data)
                    protocol.send_batch_end(sock, len(map_ids))
                elif msg_type == "push_merged":
                    (shuffle_id, map_id, attempt, op_name,
                     reduce_ids) = payload
                    entries = [(rid, protocol.recv_bytes(sock))
                               for rid in reduce_ids]
                    if faults.get().serve_push():
                        return  # an injected cut before the ack
                    counts = self.server.premerge.feed_row(  # type: ignore[attr-defined]
                        shuffle_id, map_id, attempt, op_name, entries)
                    protocol.send_msg(sock, "ok", counts)
                elif msg_type == "get_merged":
                    faults.get().serve_merged()
                    shuffle_id, reduce_id = payload
                    merged_ids, blob, raws = self.server.premerge.read(  # type: ignore[attr-defined]
                        shuffle_id, reduce_id)
                    protocol.send_msg(sock, "merged",
                                      {"map_ids": merged_ids,
                                       "blob": blob is not None})
                    if blob is not None:
                        protocol.send_bytes(sock, blob)
                    for m, data in raws:
                        protocol.send_bucket(sock, m, data)
                    protocol.send_batch_end(sock, len(raws))
                elif msg_type == "put_many":
                    shuffle_id, map_id, n_buckets = payload
                    for reduce_id in range(n_buckets):
                        store.put(shuffle_id, map_id, reduce_id,
                                  protocol.recv_bytes(sock))
                    protocol.send_msg(sock, "ok", n_buckets)
                elif msg_type == "put_parity":
                    if not self._put_parity(sock, store, payload):
                        return
                elif msg_type == "get_parity":
                    from vega_tpu_torch.shuffle import coding

                    shuffle_id, gid, unit, reduce_id = payload
                    data = store.get(shuffle_id,
                                     coding.parity_map_id(gid, unit),
                                     reduce_id)
                    if data is None:
                        protocol.send_msg(sock, "missing", payload)
                    else:
                        if faults.get().corrupt_parity():
                            flip = len(data) // 2
                            data = (data[:flip] + bytes([data[flip] ^ 0xFF])
                                    + data[flip + 1:])
                        protocol.send_msg(sock, "ok", None)
                        protocol.send_bytes(sock, data)
                elif msg_type == "status":
                    status = store.status()
                    status["premerge"] = self.server.premerge.status()  # type: ignore[attr-defined]
                    protocol.send_msg(sock, "ok", status)
                elif msg_type == "spill":
                    protocol.send_msg(sock, "ok",
                                      {"spilled": store.spill_all()})
                else:
                    protocol.send_msg(sock, "error", f"unknown {msg_type}")
                    return
        except NetworkError:
            pass  # the client hung up

    def _put_parity(self, sock, store, payload) -> bool:
        """A peer's compressed row folded into one of this server's parity
        groups; a repeated map id gets its first assignment back and is
        not folded again (XOR would cancel it). A fold that fails is
        refused, its membership rolled back and the connection closed
        (False)."""
        from vega_tpu_torch.shuffle import coding

        (shuffle_id, map_id, origin, scheme, group_k, units,
         n_buckets) = payload
        frames = [protocol.recv_bytes(sock) for _ in range(n_buckets)]
        owner = self.server.owner  # type: ignore[attr-defined]
        gid, idx, first = owner.assign_parity_member(
            shuffle_id, map_id, origin, scheme, group_k, units)
        if first:
            try:
                bufs = [coding.wire_unpack(f) for f in frames]
                for unit in range(units):
                    for reduce_id, raw in enumerate(bufs):
                        store.fold_parity(shuffle_id, gid, unit, reduce_id,
                                          map_id, idx, scheme, group_k, raw)
            except (ValueError, zlib_error) as e:
                owner.drop_parity_member(shuffle_id, map_id)
                protocol.send_msg(sock, "error", f"parity fold failed: {e}")
                return False
        protocol.send_msg(sock, "ok", (gid, idx))
        return True


class ShuffleServer:
    def __init__(self, shuffle_store, host: str = "127.0.0.1",
                 port: int = 0, premerge_budget: Optional[int] = None):
        from vega_tpu_torch.shuffle.premerge import PreMergeTier

        self._server = protocol.ThreadingServer(
            (host, port), _Handler, bind_and_activate=True)
        self._server.shuffle_store = shuffle_store  # type: ignore[attr-defined]
        # the push plan's pre-merge tier over this server's store; its
        # accumulators are bounded by premerge_budget (they cannot spill)
        self.premerge = PreMergeTier(
            shuffle_store, budget_bytes=((1 << 28) if premerge_budget is None
                                         else int(premerge_budget)))
        self._server.premerge = self.premerge  # type: ignore[attr-defined]
        self._server.owner = self  # type: ignore[attr-defined]
        # the coded shuffle's parity groups held here: shuffle_id ->
        # {"next_gid", "by_map": {map_id: (gid, idx)}, "groups"}
        self._parity_lock = named_lock("shuffle_server.parity_groups")
        self._parity_groups: dict = {}
        self.host = host
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="shuffle-server",
            daemon=True)
        self._thread.start()

    @property
    def uri(self) -> str:
        return f"{self.host}:{self.port}"

    def assign_parity_member(self, shuffle_id: int, map_id: int,
                             origin: str, scheme: str, group_k: int,
                             units: int):
        """(group id, member index, first time) of a mapper's row: the
        first open group of this shape with fewer than group_k members
        and none from origin, else a new group; a repeated map id gets
        its first assignment with first_time False."""
        with self._parity_lock:
            st = self._parity_groups.setdefault(
                shuffle_id, {"next_gid": 0, "by_map": {}, "groups": {}})
            prior = st["by_map"].get(map_id)
            if prior is not None:
                return prior[0], prior[1], False
            for g in st["groups"].values():
                if (g["scheme"] == scheme and g["k"] == group_k
                        and g["m"] == units and g["count"] < g["k"]
                        and origin not in g["origins"]):
                    idx = g["count"]
                    g["count"] += 1
                    g["origins"].add(origin)
                    st["by_map"][map_id] = (g["gid"], idx)
                    return g["gid"], idx, True
            gid = st["next_gid"]
            st["next_gid"] += 1
            st["groups"][gid] = {"gid": gid, "scheme": scheme,
                                 "k": group_k, "m": units, "count": 1,
                                 "origins": {origin}}
            st["by_map"][map_id] = (gid, 0)
            return gid, 0, True

    def drop_parity_member(self, shuffle_id: int, map_id: int) -> None:
        """Roll back a membership whose fold failed (its index is not
        reused; a retry may land in another group)."""
        with self._parity_lock:
            st = self._parity_groups.get(shuffle_id)
            if st is not None:
                st["by_map"].pop(map_id, None)

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


# one pooled connection per (thread, server)
_pool = threading.local()

# the fetch counters of this process (the worker_stats reply):
# round trips of each kind
_wire_lock = named_lock("distributed.shuffle_server._wire_lock")
_WIRE = {"gets": 0, "get_many": 0, "put_many": 0, "push_merged": 0,
         "get_merged": 0, "put_parity": 0, "get_parity": 0}

# the per-IO deadline of the calls that never carry the only copy of
# anything (push_merged, get_merged, put_parity, get_parity), unless
# fetch_slow_server_s sets a tighter one
PUSH_IO_DEADLINE_S = 15.0


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


def put_parity_remote(uri: str, shuffle_id: int, map_id: int, origin: str,
                      scheme: str, group_k: int, units: int,
                      payloads) -> tuple:
    """A map task's whole row (compressed frames in reduce order) to a
    parity server in one put_parity round trip; returns the (group id,
    member index) it was given. NetworkError on failure."""
    clean = False
    try:
        sock = _pooled_connection(uri, connect_timeout=PUSH_IO_DEADLINE_S)
        sock.settimeout(PUSH_IO_DEADLINE_S)
        protocol.send_msg(sock, "put_parity",
                          (shuffle_id, map_id, origin, scheme, group_k,
                           units, len(payloads)))
        for blob in payloads:
            protocol.send_bytes(sock, blob)
        reply_type, assigned = protocol.recv_msg(sock)
        _count("put_parity")
        if reply_type != "ok":
            raise NetworkError(f"parity push refused: {assigned!r}")
        clean = True
        sock.settimeout(protocol.IO_TIMEOUT)
        return tuple(assigned)
    finally:
        if not clean:
            _drop_connection(uri)


def fetch_parity_remote(uri: str, shuffle_id: int, group_id: int,
                        unit: int, reduce_id: int):
    """(unit, header, payload uint8) of one parity frame, checked here;
    None when the server has none or the frame fails its magic or CRC
    (corrupt parity reads as missing). NetworkError on a transport
    failure."""
    from vega_tpu_torch.shuffle import coding

    clean = False
    try:
        sock = _pooled_connection(uri, connect_timeout=PUSH_IO_DEADLINE_S)
        sock.settimeout(PUSH_IO_DEADLINE_S)
        protocol.send_msg(sock, "get_parity",
                          (shuffle_id, group_id, unit, reduce_id))
        _count("get_parity")
        reply_type, _ = protocol.recv_msg(sock)
        if reply_type == "missing":
            clean = True
            sock.settimeout(protocol.IO_TIMEOUT)
            return None
        if reply_type != "ok":
            raise NetworkError(f"unexpected get_parity reply "
                               f"{reply_type!r}")
        blob = protocol.recv_bytes(sock)
        clean = True
        sock.settimeout(protocol.IO_TIMEOUT)
    finally:
        if not clean:
            _drop_connection(uri)
    parsed = coding.parse_frame(blob)
    if parsed is None:
        log.warning("parity frame (shuffle %d group %d unit %d reduce %d)"
                    " from %s failed its checks; read as missing",
                    shuffle_id, group_id, unit, reduce_id, uri)
        return None
    header, payload = parsed
    return unit, header, payload


def push_merged_remote(uri: str, shuffle_id: int, map_id: int, attempt: int,
                       op_name, entries,
                       deadline_s: Optional[float] = None) -> dict:
    """A map task's buckets of the partitions uri owns, in one
    push_merged round trip; returns the owner's counts ({"merged",
    "stored", "duplicate"}). NetworkError on failure (the caller leaves
    them to the pull plan)."""
    deadline_s = deadline_s or PUSH_IO_DEADLINE_S
    clean = False
    try:
        sock = _pooled_connection(uri, connect_timeout=deadline_s)
        sock.settimeout(deadline_s)
        protocol.send_msg(sock, "push_merged",
                          (shuffle_id, map_id, attempt, op_name,
                           [rid for rid, _ in entries]))
        for _rid, blob in entries:
            protocol.send_bytes(sock, blob)
        reply_type, counts = protocol.recv_msg(sock)
        _count("push_merged")
        if reply_type != "ok":
            raise NetworkError(f"push refused: {reply_type!r}")
        clean = True
        sock.settimeout(protocol.IO_TIMEOUT)
        return counts
    finally:
        if not clean:
            _drop_connection(uri)


def fetch_merged_remote(uri: str, shuffle_id: int, reduce_id: int,
                        deadline_s: Optional[float] = None):
    """The owner's pre-merge tier for one reducer in one get_merged round
    trip: (merged map ids, frozen blob or None, [(map id, raw bucket)]).
    The first read freezes the merge. NetworkError on any transport
    fault (the caller pulls everything)."""
    deadline_s = deadline_s or PUSH_IO_DEADLINE_S
    clean = False
    raws = []
    try:
        sock = _pooled_connection(uri, connect_timeout=deadline_s)
        sock.settimeout(deadline_s)
        protocol.send_msg(sock, "get_merged", (shuffle_id, reduce_id))
        _count("get_merged")
        reply_type, head = protocol.recv_msg(sock)
        if reply_type != "merged":
            raise NetworkError(f"unexpected get_merged reply {reply_type!r}")
        blob = protocol.recv_bytes(sock) if head.get("blob") else None
        merged_ids = list(head.get("map_ids") or ()) if blob is not None \
            else []
        while True:
            reply_type, payload = protocol.recv_msg(sock)
            if reply_type == "bucket":
                raws.append((payload, protocol.recv_bytes(sock)))
            elif reply_type == "batch_end":
                break
            else:
                raise NetworkError(
                    f"unexpected get_merged stream frame {reply_type!r}")
        clean = True
        sock.settimeout(protocol.IO_TIMEOUT)
        return merged_ids, blob, raws
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
