"""Unbounded streaming sources: the port's copy of
vega_tpu/streaming/source.py (receivers, offset-tracked blocks, replay).

A Receiver is a thread that pulls records from an unbounded source, cuts
them into blocks of at most stream_block_max_records, and lands each
block in the Context's stream block store (BlockStore, keyed
(stream_id, seq) as the reference's KeySpace.STREAM) at
stream_storage_level BEFORE queueing it for the next micro-batch, so a
batch whose job fails recomputes from stored blocks, not from the wire.
Every block also carries a replay handle (the source and the offset
span), read on a store miss.

Offsets are the exactly-once currency: each source has a monotone offset
(the record index for a generator, the byte position for a file tail,
the record count for a socket), every block records its [start, end)
span, and the stateful commit records the end offsets. A crashed
receiver restarts from its landed frontier: landed records are never
ingested again, unlanded ones never skipped (for replayable sources).

Backpressure: before landing a block the receiver asks the
RateController (controller.py): "block" parks the thread until batches
drain the queue; "shed" drops the block and still advances the offsets.

A receiver crashes when its source raises, or at the fault seam
faults.maybe_crash_receiver after it lands a block (the reference's).
"""

from __future__ import annotations

import logging
import os
import pickle
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from vega_tpu_torch import faults
from vega_tpu_torch.lint.sync_witness import named_lock, note_thread_role
from vega_tpu_torch.store import StorageLevel

log = logging.getLogger(__name__)


class BlockStore:
    """The landed blocks of a Context's streams. MEMORY_ONLY and
    MEMORY_AND_DISK keep a block's records in memory (the host tier has
    no budget to demote under, as for persisted host partitions);
    DISK_ONLY keeps them in the Context's disk store as a pickled list.
    The batch loop removes a block once no window reaches it, and stop()
    removes every block of its streams."""

    def __init__(self, disk):
        self._disk = disk
        self._mem: Dict[Tuple[int, int], List[Any]] = {}
        self._on_disk: set = set()
        self._lock = named_lock("streaming.source.BlockStore._lock")

    @staticmethod
    def _disk_key(stream_id: int, seq: int) -> str:
        return f"stream-{stream_id}-{seq}"

    def put(self, stream_id: int, seq: int, records: List[Any],
            level) -> None:
        if StorageLevel.coerce(level) is StorageLevel.DISK_ONLY:
            self._disk.put(self._disk_key(stream_id, seq), pickle.dumps(
                records, protocol=pickle.HIGHEST_PROTOCOL))
            with self._lock:
                self._on_disk.add((stream_id, seq))
            return
        with self._lock:
            self._mem[(stream_id, seq)] = records

    def get(self, stream_id: int, seq: int) -> Optional[List[Any]]:
        with self._lock:
            records = self._mem.get((stream_id, seq))
            on_disk = (stream_id, seq) in self._on_disk
        if records is not None or not on_disk:
            return records
        data = self._disk.get(self._disk_key(stream_id, seq))
        return None if data is None else pickle.loads(data)

    def remove(self, stream_id: int, seq: int) -> None:
        with self._lock:
            self._mem.pop((stream_id, seq), None)
            on_disk = (stream_id, seq) in self._on_disk
            self._on_disk.discard((stream_id, seq))
        if on_disk:
            self._disk.remove(self._disk_key(stream_id, seq))

    def remove_datum(self, stream_id: int) -> None:
        """Every block of one stream."""
        with self._lock:
            keys = [k for k in self._mem if k[0] == stream_id]
            keys += [k for k in self._on_disk if k[0] == stream_id]
        for sid, seq in keys:
            self.remove(sid, seq)

    def __len__(self) -> int:
        with self._lock:
            return len(self._mem) + len(self._on_disk)


# --- replay -----------------------------------------------------------------
class GeneratorReplay:
    """Records [start, end) again, from the deterministic generator."""

    def __init__(self, fn: Callable[[int], Any], start: int, end: int):
        self.fn, self.start, self.end = fn, start, end

    def records(self) -> List[Any]:
        return [self.fn(i) for i in range(self.start, self.end)]


class FileTailReplay:
    """The byte span [start, end) of an append-only file again, split
    into line records; byte offsets make it exact while the file grows."""

    def __init__(self, path: str, start: int, end: int):
        self.path, self.start, self.end = path, start, end

    def records(self) -> List[str]:
        with open(self.path, "rb") as f:
            f.seek(self.start)
            data = f.read(self.end - self.start)
        if data.endswith(b"\n"):
            data = data[:-1]
        return [line.decode("utf-8", "replace") for line in data.split(b"\n")]


class InlineReplay:
    """A socket cannot be read again: the records ride in the handle."""

    def __init__(self, records: List[Any]):
        self._records = list(records)

    def records(self) -> List[Any]:
        return list(self._records)


class Block:
    """One landed receiver block: its key, offset span and replay
    handle."""

    __slots__ = ("stream_id", "seq", "start_offset", "end_offset", "count",
                 "replay", "store")

    def __init__(self, stream_id: int, seq: int, start_offset: int,
                 end_offset: int, count: int, replay, store=None):
        self.stream_id = stream_id
        self.seq = seq
        self.start_offset = start_offset
        self.end_offset = end_offset
        self.count = count
        self.replay = replay
        self.store = store

    def records(self) -> List[Any]:
        """The stored copy; the replay handle on a store miss."""
        if self.store is not None:
            value = self.store.get(self.stream_id, self.seq)
            if value is not None:
                return value
        return self.replay.records()

    def __repr__(self):
        return (f"Block(stream={self.stream_id}, seq={self.seq}, "
                f"offsets=[{self.start_offset},{self.end_offset}))")


# --- receivers --------------------------------------------------------------
class Receiver:
    """The ingest thread, block cutting and landing, offset tracking and
    the crash / restart bookkeeping. A subclass's _poll returns (records,
    new_offset) for one pull from its source. conf is the Context (its
    stream_* settings); store its BlockStore."""

    kind = "base"

    def __init__(self, stream_id: int, controller, conf, store):
        self.stream_id = stream_id
        self.controller = controller
        self.store = store
        self.block_max_records = conf.stream_block_max_records
        self.storage_level = conf.stream_storage_level
        self.next_offset = 0       # source offset of the next unseen record
        self.attempt = 0
        self.crashed = False
        self.shed_blocks = 0
        self.shed_records = 0
        self.blocks_landed = 0
        self._seq = 0              # next block sequence number
        self._pending: List[Block] = []
        self._buf: List[Any] = []  # records ingested, not yet in a block
        self._buf_start = 0        # source offset of _buf[0]
        self._lock = named_lock("streaming.source.Receiver._lock")
        self._stop = threading.Event()
        self._flush_req = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # --- lifecycle ----------------------------------------------------------
    def start(self, from_offset: Optional[int] = None) -> None:
        """(Re)start the ingest thread. After a crash (from_offset None)
        ingest resumes at the landed frontier (_buf_start): records
        polled but never landed died with the thread and are read
        again."""
        if from_offset is not None:
            self.next_offset = from_offset
        else:
            self.next_offset = self._buf_start
        self.crashed = False
        self._buf = []
        self._buf_start = self.next_offset
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"stream-recv-{self.stream_id}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _run(self) -> None:
        note_thread_role("stream-receiver")
        try:
            self._open()
            while not self._stop.is_set():
                records, new_offset = self._poll()
                if records:
                    self._buf.extend(records)
                    self.next_offset = new_offset
                    while (len(self._buf) >= self.block_max_records
                           and not self._stop.is_set()):
                        self._cut_block(self.block_max_records)
                if self._flush_req.is_set():
                    if self._buf and not self._stop.is_set():
                        self._cut_block(len(self._buf))
                    self._flush_req.clear()
                if not records:
                    self._stop.wait(0.01)
        except Exception:  # noqa: BLE001 — the batch loop restarts it
            if not self._stop.is_set():
                self.crashed = True
                log.warning("receiver %d (%s) crashed; awaiting restart",
                            self.stream_id, self.kind, exc_info=True)
        finally:
            self._close()

    # --- blocks -------------------------------------------------------------
    def _cut_block(self, n: int) -> None:
        """Seal the first n buffered records into a block: ask the
        controller, land it in the store, queue it for the next batch."""
        records = self._buf[:n]
        start = self._buf_start
        decision = self.controller.offer_block(self._stop)
        if decision == "stop":
            return  # stopping while parked: the buffer stays
        end = self._advance(start, records)
        if decision == "shed":
            # the offsets advance (dropped by policy); nothing lands
            self._buf = self._buf[n:]
            self._buf_start = end
            self.shed_blocks += 1
            self.shed_records += len(records)
            return
        seq = self._seq
        self._seq += 1
        self.store.put(self.stream_id, seq, records, self.storage_level)
        block = Block(self.stream_id, seq, start, end, len(records),
                      self._replay_handle(start, end, records), self.store)
        with self._lock:
            self._pending.append(block)
        self._buf = self._buf[n:]
        self._buf_start = end
        self.blocks_landed += 1
        self.controller.block_landed()
        faults.get().maybe_crash_receiver(self.blocks_landed)

    def flush(self, wait_s: float = 0.25) -> None:
        """The batch tick seals the partial block, so slow streams make
        progress. Every buffer change happens on the ingest thread (no
        lock may be held across a backpressure park), so a live receiver
        is asked and waited for, within wait_s; a dead thread's buffer is
        flushed here."""
        if self._thread is None or not self._thread.is_alive():
            if self._buf and not self.crashed:
                self._cut_block(len(self._buf))
            return
        self._flush_req.set()
        deadline = time.monotonic() + wait_s
        while self._flush_req.is_set() and time.monotonic() < deadline:
            time.sleep(0.005)

    def take_pending(self) -> List[Block]:
        with self._lock:
            blocks, self._pending = self._pending, []
        return blocks

    # --- the subclasses' part -----------------------------------------------
    def _open(self) -> None:
        pass

    def _close(self) -> None:
        pass

    def _poll(self):
        raise NotImplementedError

    def _advance(self, start: int, records: List[Any]) -> int:
        """End offset of a block at start holding records (record-counted
        by default)."""
        return start + len(records)

    def _replay_handle(self, start: int, end: int, records: List[Any]):
        return InlineReplay(records)


class GeneratorSource(Receiver):
    """fn(offset) -> record | None (None: no data yet). A deterministic
    fn makes this source fully replayable."""

    kind = "generator"

    def __init__(self, stream_id: int, controller, conf, store,
                 fn: Callable[[int], Any]):
        super().__init__(stream_id, controller, conf, store)
        self.fn = fn

    def _poll(self):
        records = []
        offset = self.next_offset
        for _ in range(256):
            rec = self.fn(offset)
            if rec is None:
                break
            records.append(rec)
            offset += 1
        return records, self.next_offset + len(records)

    def _replay_handle(self, start, end, records):
        return GeneratorReplay(self.fn, start, end)


class FileTailSource(Receiver):
    """tail -f over an append-only line file. Offsets are byte
    positions; only spans ending at a newline become records, so a line
    half written is never split across blocks."""

    kind = "file_tail"

    def __init__(self, stream_id: int, controller, conf, store, path: str):
        super().__init__(stream_id, controller, conf, store)
        self.path = path
        self._tail = b""  # bytes after the last newline
        # the raw length (newline included) of each buffered record: a
        # block's span must tile the bytes even where a lossy decode
        # changes a record's length
        self._buf_lens: List[int] = []

    def start(self, from_offset: Optional[int] = None) -> None:
        self._tail = b""
        self._buf_lens = []
        super().start(from_offset)

    def _poll(self):
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return [], self.next_offset
        read_from = self.next_offset + len(self._tail)
        if size <= read_from:
            return [], self.next_offset
        with open(self.path, "rb") as f:
            f.seek(read_from)
            data = self._tail + f.read(size - read_from)
        cut = data.rfind(b"\n")
        if cut < 0:
            self._tail = data
            return [], self.next_offset
        complete, self._tail = data[:cut + 1], data[cut + 1:]
        # every line, an empty one too, is a record: the records' raw
        # lengths must tile the span
        raw_lines = complete[:-1].split(b"\n")
        self._buf_lens.extend(len(line) + 1 for line in raw_lines)
        records = [line.decode("utf-8", "replace") for line in raw_lines]
        return records, self.next_offset + len(complete)

    def _advance(self, start, records):
        n = len(records)
        span = sum(self._buf_lens[:n])
        del self._buf_lens[:n]
        return start + span

    def _replay_handle(self, start, end, records):
        return FileTailReplay(self.path, start, end)


class SocketSource(Receiver):
    """Line-delimited TCP. Every read carries stream_socket_timeout_s (a
    timeout is "no data yet"); offsets count records. The wire cannot be
    read again, so a block's records ride in its handle: landed blocks
    are exactly-once, records lost before landing are the source's
    at-most-once caveat."""

    kind = "socket"

    def __init__(self, stream_id: int, controller, conf, store, host: str,
                 port: int):
        super().__init__(stream_id, controller, conf, store)
        self.host, self.port = host, port
        self.timeout_s = conf.stream_socket_timeout_s
        self._sock: Optional[socket.socket] = None
        self._file = None

    def _open(self) -> None:
        self._sock = socket.create_connection(
            (self.host, self.port), timeout=self.timeout_s)
        self._sock.settimeout(self.timeout_s)
        self._file = self._sock.makefile("rb")

    def _close(self) -> None:
        for closer in (self._file, self._sock):
            if closer is not None:
                try:
                    closer.close()
                except OSError:
                    pass
        self._file = None
        self._sock = None

    def _poll(self):
        if self._file is None:
            return [], self.next_offset
        try:
            line = self._file.readline()
        except socket.timeout:
            return [], self.next_offset
        if not line:  # the peer closed: keep what came
            time.sleep(0.01)
            return [], self.next_offset
        text = line.decode("utf-8", "replace").rstrip("\n")
        return [text], self.next_offset + 1
