"""StreamingContext, the micro-batch loop: the port's copy of
vega_tpu/streaming/context.py.

Every interval the loop (one daemon thread):
  1. restarts a crashed receiver from its landed frontier
     (ReceiverStarted, attempt + 1);
  2. forms a batch: seals each receiver's partial block and takes its
     queue (a failed batch in flight goes first, with the same batch_id
     and the same blocks, read from the store, never the wire);
  3. compiles every registered output's recipe over the batch's
     StreamBlockRDD and runs it with the thread's "pool" property set to
     the stream's pool, so its jobs are admitted as streaming work;
  4. folds each stateful stream (a named op on the Context's device
     through state_fold.fold_pairs_device where the pairs have a dense
     form; a function on the host) and commits (batch_id, offsets,
     state) through state.py, the exactly-once seam;
  5. on success drains the backpressure queue, retires blocks no window
     reaches and advances the batch id; on failure posts
     BatchCompleted(succeeded=False) and replays at the next tick, at
     most MAX_BATCH_REPLAYS times, after which the stream fails.

A fold on the card keeps fold_pairs_device's contract: only a refusal of
the data (a VegaError, None returned) folds on the host, with the same
result. A KernelError, a CollectiveError or a CUDA error fails the batch,
which replays; a batch never folds on the host in its place.

The loop runs device jobs on its own thread while the caller's thread
may run its own: the Context serializes its dense tier (one re-entrant
lock across a node's materialization and across settlement). Across
processes a timer thread cannot run collectives in one order on every
rank, so Context.streaming refuses a multi-process Context.
"""

from __future__ import annotations

import logging
import operator
import os
import tempfile
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

from vega_tpu_torch.lint.sync_witness import note_thread_role
from vega_tpu_torch.scheduler import events
from vega_tpu_torch import state_fold
from vega_tpu_torch.streaming.controller import RateController
from vega_tpu_torch.streaming.dstream import DStream, StreamBlockRDD
from vega_tpu_torch.streaming.source import (FileTailSource, GeneratorSource,
                                             SocketSource)
from vega_tpu_torch.streaming.state import StateStore

log = logging.getLogger(__name__)

# How many times one batch may replay before the stream fails (a
# deterministic fault would otherwise replay forever).
MAX_BATCH_REPLAYS = 5

_HOST_FOLDS = {
    "add": operator.add,
    "min": min,
    "max": max,
    "prod": operator.mul,
}

# this process's directory of default checkpoint directories: under the
# temp root, outliving every Context of the process (as the reference's
# per-process session work directory), so a later Context recovers
_SESSION_DIR = os.path.join(tempfile.gettempdir(), "vega-tpu",
                            f"session-{uuid.uuid4().hex[:12]}")


class InputStream(DStream):
    """The root DStream: one receiver's blocks."""

    def __init__(self, sctx, receiver):
        super().__init__(sctx, source=self)
        self.receiver = receiver
        self.stream_id = receiver.stream_id


class StatefulStream:
    """What update_state_by_key returns: the per-batch fold and commit,
    and the committed state."""

    def __init__(self, sctx, dstream: DStream, store: StateStore,
                 func: Optional[Callable], op: Optional[str]):
        self.sctx = sctx
        self.dstream = dstream
        self.store = store
        self.func = func
        self.op = op

    def snapshot(self) -> Dict[Any, Any]:
        """Committed state as of the last successful batch."""
        return self.store.snapshot()

    def get(self, key, default=None):
        return self.store.get(key, default)

    def process(self, batch_id: int, rdd, offsets: Dict[int, int]) -> None:
        pairs = self.sctx._collect(rdd)
        updates = self._fold(pairs)
        self.store.apply_batch(batch_id, offsets, updates)

    def _fold(self, pairs: List[Tuple[Any, Any]]) -> Dict[Any, Any]:
        if self.op is not None:
            combine = _HOST_FOLDS[self.op]
            folded = None
            if pairs:
                folded = state_fold.fold_pairs_device(self.sctx.ctx, pairs,
                                                      self.op)
            if folded is None:  # the host fold: the same result
                folded = {}
                for k, v in pairs:
                    folded[k] = v if k not in folded else combine(
                        folded[k], v)
            get = self.store.get
            return {k: v if get(k) is None else combine(get(k), v)
                    for k, v in folded.items()}
        grouped: Dict[Any, List[Any]] = {}
        for k, v in pairs:  # offset order within each key
            grouped.setdefault(k, []).append(v)
        return {k: self.func(values, self.store.get(k))
                for k, values in grouped.items()}


class StreamingContext:
    """The Context's streaming plane (Context.streaming). conf is the
    Context's stream_* settings. checkpoint_dir: the argument, else the
    Context's stream_checkpoint_dir, else <temp root>/vega-tpu/session-
    <this process's id>/streaming, which Context.stop() leaves, so a
    later Context of the process recovers from it."""

    def __init__(self, ctx, batch_interval_s: Optional[float] = None,
                 checkpoint_dir: Optional[str] = None):
        conf = ctx
        self.ctx = ctx
        self.interval_s = (batch_interval_s if batch_interval_s is not None
                           else conf.stream_batch_interval_s)
        self.pool = conf.stream_pool
        ctx.set_pool(self.pool, weight=conf.stream_pool_weight)
        self.controller = RateController(conf, ctx.metrics, self.pool,
                                         self.interval_s)
        # pending blocks count as queued demand for the elastic fleet
        if getattr(ctx, "elastic", None) is not None:
            ctx.elastic.add_load_signal(self.controller.load_signal)
        self.checkpoint_dir = (
            checkpoint_dir or conf.stream_checkpoint_dir
            or os.path.join(_SESSION_DIR, "streaming"))
        self._conf = conf
        self._inputs: List[InputStream] = []
        self._outputs: List[Tuple[DStream, Callable]] = []
        self._stateful: List[StatefulStream] = []
        # per stream: [(batch_id, [Block, ...]), ...], newest last, as
        # deep as the widest window (set at start())
        self._history: Dict[int, List[Tuple[int, List]]] = {}
        self._offsets: Dict[int, int] = {}  # end offset per stream so far
        self._inflight = None  # (batch_id, {sid: blocks}, offsets, attempt)
        self._window = 1
        self._batch_id = 0
        self._started = False
        self._stopped = False
        self.failed: Optional[str] = None
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # --- sources ------------------------------------------------------------
    def generator_stream(self, fn: Callable[[int], Any]) -> InputStream:
        """fn(offset) -> record | None (None: no data yet). fn must be
        deterministic: it is the replay path."""
        return self._add_input(
            lambda sid: GeneratorSource(sid, self.controller, self._conf,
                                        self.ctx._stream_blocks, fn))

    def file_tail_stream(self, path: str) -> InputStream:
        """tail -f over an append-only line file (byte offsets)."""
        return self._add_input(
            lambda sid: FileTailSource(sid, self.controller, self._conf,
                                       self.ctx._stream_blocks, path))

    def socket_stream(self, host: str, port: int) -> InputStream:
        """Line-delimited TCP; every read bounded by
        stream_socket_timeout_s."""
        return self._add_input(
            lambda sid: SocketSource(sid, self.controller, self._conf,
                                     self.ctx._stream_blocks, host, port))

    def _add_input(self, make) -> InputStream:
        self._check_mutable()
        stream = InputStream(self, make(len(self._inputs)))
        self._inputs.append(stream)
        return stream

    # --- registration -------------------------------------------------------
    def _register_output(self, dstream: DStream, fn: Callable) -> None:
        self._check_mutable()
        self._outputs.append((dstream, fn))

    def _register_stateful(self, dstream: DStream, func, op,
                           num_partitions: int) -> StatefulStream:
        self._check_mutable()
        if op is not None and op not in _HOST_FOLDS:
            raise ValueError(f"unknown named op {op!r}; expected one of "
                             f"{sorted(_HOST_FOLDS)}")
        store = StateStore(
            self.ctx,
            os.path.join(self.checkpoint_dir,
                         f"stateful-{len(self._stateful)}"),
            num_partitions=num_partitions)
        handle = StatefulStream(self, dstream, store, func=func, op=op)
        self._stateful.append(handle)
        return handle

    def _check_mutable(self) -> None:
        if self._started:
            raise RuntimeError(
                "streams and outputs must be declared before start()")

    # --- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        if self._started:
            raise RuntimeError("StreamingContext already started")
        if not self._outputs and not self._stateful:
            raise RuntimeError("no output registered: call foreach_rdd "
                               "or update_state_by_key before start()")
        self._started = True
        streams = ([d for d, _ in self._outputs]
                   + [h.dstream for h in self._stateful])
        self._window = max([d.window_intervals for d in streams] or [1])
        # Recovery resumes from the EARLIEST committed frontier across the
        # stateful stores: the batch a lagging store never committed
        # replays from the source offsets, and a store already past it
        # skips it as a duplicate, so every store stays exactly-once.
        recovered: List[Dict[int, int]] = []
        last_batches: List[int] = []
        for handle in self._stateful:
            offs = handle.store.recover()
            if offs is not None:
                recovered.append(offs)
                last_batches.append(handle.store.last_committed_batch)
        if recovered:
            self._batch_id = min(last_batches) + 1
            for sid in set().union(*recovered):
                self._offsets[sid] = min(o[sid] for o in recovered
                                         if sid in o)
        for stream in self._inputs:
            receiver = stream.receiver
            self._history[stream.stream_id] = []
            from_offset = self._offsets.get(stream.stream_id, 0)
            self._offsets[stream.stream_id] = from_offset
            receiver.start(from_offset=from_offset)
            self.ctx.bus.post(events.ReceiverStarted(
                stream_id=stream.stream_id, kind=receiver.kind,
                attempt=0, from_offset=from_offset))
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="stream-batches")
        self._thread.start()

    def stop(self) -> None:
        """Stop the receivers, join the loop and remove the streams'
        blocks; committed state stays in the checkpoint directory."""
        if not self._started or self._stopped:
            self._stopped = True
            return
        self._stopped = True
        self._stop_evt.set()
        for stream in self._inputs:
            stream.receiver.stop()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
        for stream in self._inputs:
            self.ctx._stream_blocks.remove_datum(stream.stream_id)

    def await_batches(self, n: int, timeout_s: float = 30.0) -> bool:
        """Wait until n batches have completed since start; False when the
        stream fails or the time runs out."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.failed is not None:
                return False
            if self._batch_id >= n and self._inflight is None:
                return True
            time.sleep(0.01)
        return False

    def status(self) -> Dict[str, Any]:
        return {
            "interval_s": self.interval_s,
            "pool": self.pool,
            "batches_committed": self._batch_id,
            "inflight": self._inflight is not None,
            "failed": self.failed,
            "controller": self.controller.status(),
            "receivers": [{
                "stream_id": s.stream_id,
                "kind": s.receiver.kind,
                "attempt": s.receiver.attempt,
                "crashed": s.receiver.crashed,
                "next_offset": s.receiver.next_offset,
                "blocks_landed": s.receiver.blocks_landed,
                "shed_blocks": s.receiver.shed_blocks,
                "shed_records": s.receiver.shed_records,
            } for s in self._inputs],
            "stateful": [{
                "last_committed_batch": h.store.last_committed_batch,
                "commits": h.store.commits,
                "duplicate_commits": h.store.duplicate_commits,
                "keys": len(h.store.snapshot()),
            } for h in self._stateful],
        }

    # --- internals ----------------------------------------------------------
    def _loop(self) -> None:
        note_thread_role("batch-driver")
        while not self._stop_evt.wait(self.interval_s):
            try:
                self._tick()
            except Exception:  # noqa: BLE001 — the loop survives a bad tick
                log.warning("streaming tick failed", exc_info=True)
            if self.failed is not None:
                return

    def _tick(self) -> None:
        self._restart_crashed_receivers()
        if self._inflight is None:
            formed = self._form_batch()
            if formed is None:
                return  # nothing new this interval
            self._inflight = formed
        batch_id, batch_blocks, offsets, attempt = self._inflight
        if attempt > MAX_BATCH_REPLAYS:
            self.failed = (f"batch {batch_id} failed after "
                           f"{MAX_BATCH_REPLAYS} replays")
            log.error("streaming stopped: %s", self.failed)
            return
        if self._execute(batch_id, batch_blocks, offsets, attempt):
            self._settle(batch_id, batch_blocks, offsets)
        else:
            self._inflight = (batch_id, batch_blocks, offsets, attempt + 1)

    def _restart_crashed_receivers(self) -> None:
        for stream in self._inputs:
            receiver = stream.receiver
            if receiver.crashed and not self._stop_evt.is_set():
                receiver.attempt += 1
                log.warning("restarting receiver %d (attempt %d) from "
                            "offset %d", stream.stream_id,
                            receiver.attempt, receiver.next_offset)
                receiver.start()  # resumes at its landed frontier
                self.ctx.bus.post(events.ReceiverStarted(
                    stream_id=stream.stream_id, kind=receiver.kind,
                    attempt=receiver.attempt,
                    from_offset=receiver.next_offset))

    def _form_batch(self):
        """Every receiver's queue as one batch; None when no stream has a
        new block (an empty interval runs no job and commits nothing)."""
        batch_blocks: Dict[int, List] = {}
        offsets = dict(self._offsets)
        total = 0
        for stream in self._inputs:
            stream.receiver.flush()
            blocks = stream.receiver.take_pending()
            batch_blocks[stream.stream_id] = blocks
            if blocks:
                offsets[stream.stream_id] = blocks[-1].end_offset
                total += len(blocks)
        if total == 0:
            return None
        return (self._batch_id, batch_blocks, offsets, 0)

    def _execute(self, batch_id: int, batch_blocks: Dict[int, List],
                 offsets: Dict[int, int], attempt: int) -> bool:
        records = sum(b.count for blocks in batch_blocks.values()
                      for b in blocks)
        nblocks = sum(len(blocks) for blocks in batch_blocks.values())
        self.ctx.bus.post(events.BatchSubmitted(
            batch_id=batch_id, records=records, blocks=nblocks,
            pool=self.pool, attempt=attempt))
        start = time.time()
        # every job this thread submits, a foreach_rdd callback's too,
        # lands in the stream's pool
        self.ctx.set_local_property("pool", self.pool)
        ok = True
        try:
            for dstream, fn in self._outputs:
                fn(dstream.compile(self._input_rdd(dstream, batch_blocks)),
                   batch_id)
            for handle in self._stateful:
                handle.process(
                    batch_id,
                    handle.dstream.compile(
                        self._input_rdd(handle.dstream, batch_blocks)),
                    offsets)
        except Exception:  # noqa: BLE001 — a failed batch replays
            ok = False
            log.warning("batch %d attempt %d failed; will replay from "
                        "stored blocks", batch_id, attempt, exc_info=True)
        self.ctx.bus.post(events.BatchCompleted(
            batch_id=batch_id, wall_s=round(time.time() - start, 6),
            records=records, succeeded=ok, pool=self.pool))
        return ok

    def _input_rdd(self, dstream: DStream, batch_blocks: Dict[int, List]):
        sid = dstream.source.stream_id
        window = dstream.window_intervals
        blocks: List = []
        if window > 1:
            for _, past in self._history[sid][-(window - 1):]:
                blocks.extend(past)
        blocks.extend(batch_blocks.get(sid, ()))
        return StreamBlockRDD(self.ctx, blocks)

    def _settle(self, batch_id: int, batch_blocks: Dict[int, List],
                offsets: Dict[int, int]) -> None:
        """Success: advance the offsets, drain the backpressure queue,
        keep the history, retire blocks no window reaches."""
        self._offsets.update(offsets)
        store = self.ctx._stream_blocks
        nblocks = 0
        for sid, blocks in batch_blocks.items():
            nblocks += len(blocks)
            history = self._history[sid]
            history.append((batch_id, blocks))
            while len(history) > self._window:
                _, retired = history.pop(0)
                for block in retired:
                    store.remove(sid, block.seq)
        self.controller.blocks_consumed(nblocks)
        self._inflight = None
        self._batch_id = batch_id + 1

    def _collect(self, rdd) -> list:
        """A batch's RDD through submit_job (the stream's pool, from the
        loop thread's property), in partition order, which is block and
        offset order."""
        future = self.ctx.submit_job(rdd, lambda tc, it: list(it))
        try:
            parts = future.result(max(30.0, self.interval_s * 120))
        except BaseException:
            # an abandoned attempt gives its admission slot back
            future.cancel("streaming batch attempt abandoned")
            raise
        return [rec for part in parts for rec in part]
