"""Streamed dense sources: datasets bigger than the device memory budget.

Counterpart of vega_tpu/tpu/stream.py. A StreamedDenseRDD holds a recipe
for its data as a sequence of chunk DenseRDDs, each small enough that its
planned exchange fits Context.dense_hbm_budget (planned_chunk_rows), and
runs the ordinary device pipelines chunk by chunk:

  narrow ops (map, filter, map_values, map_expand, flat_map_ragged) and a
  join against a resident table compose per chunk and stay streamed;

  reduce_by_key folds: each chunk reduces on the card, and its partial
  merges into an accumulator through a union and a second reduce, whose
  exchange is elided because both sides are hash-placed. The accumulator
  is bounded by the number of keys, not rows; the result is a resident
  source, so joins, sorts and collects downstream run as usual. This is
  BASELINE's 1B-row group_by+join on one card;

  count / sum / min / max fold per-chunk actions on the host, and
  take_ordered / top keep the running best n.

Everything else runs on the resident build (resident(), memoized), which
needs the whole dataset on the device. The reference falls back to its
host tier when a closure does not trace; the port has none, so the same
probe (a few-row block of the stream's schema) raises the VegaError of the
op's build-time checks before any chunk runs.

Chunks are sized as the reference sizes them (planned_chunk_rows): by the
exchange planner under Context(dense_exchange="auto"), so a chunk is the
largest whose planned exchange fits the budget; by the legacy rule (6x the
chunk's bytes within the budget) under a forced program.
"""

from __future__ import annotations

import logging
from typing import Callable, Iterator, Optional

import torch

from vega_tpu_torch import block as block_lib
from vega_tpu_torch import dense_rdd
from vega_tpu_torch import dict_encoding
from vega_tpu_torch import exchange_plan
from vega_tpu_torch.errors import VegaError

log = logging.getLogger(__name__)

# Without a plan (a forced exchange program, or a caller with no shards in
# hand): a one-shot exchange holds about this many transient copies of its
# operand block (operand, sorted copy, send slots, received block), so a
# chunk is sized such that chunk_bytes * footprint <= budget.
_EXCHANGE_FOOTPRINT = 6


def _legacy_chunk_rows(n_rows: int, bytes_per_row: int,
                       budget_bytes: int) -> Optional[int]:
    if n_rows * bytes_per_row * _EXCHANGE_FOOTPRINT <= budget_bytes:
        return None
    return max(int(budget_bytes // (bytes_per_row * _EXCHANGE_FOOTPRINT)), 1)


def planned_chunk_rows(n_rows: int, bytes_per_row: int, budget_bytes: int,
                       chunk_rows: Optional[int] = None,
                       n_shards: Optional[int] = None,
                       exchange: str = "auto") -> Optional[int]:
    """None when the whole source fits the budget (no streaming), else the
    chunk size in rows, rounded down to a shape-stable bucket (a multiple
    of 1M rows, or a power of two of at least 128 below 1M) so each
    chunk stays within the budget and chunk capacities repeat. An explicit
    chunk_rows wins; below 1 it raises.

    With n_shards given and exchange (the Context's dense_exchange)
    'auto', the exchange planner sizes the chunk: the largest whose
    planned exchange keeps its aggregate estimated peak within the budget
    (exchange_plan.planned_stream_rows). A forced program, or no n_shards,
    keeps the legacy 6x rule."""
    if chunk_rows is not None:
        if int(chunk_rows) < 1:
            raise VegaError(f"chunk_rows must be >= 1, got {chunk_rows}")
        return int(chunk_rows)
    if n_shards is not None and exchange == "auto":
        rows = exchange_plan.planned_stream_rows(n_rows, bytes_per_row,
                                                 budget_bytes, n_shards)
    else:
        rows = _legacy_chunk_rows(n_rows, bytes_per_row, budget_bytes)
    if rows is None:
        return None
    step = 1 << 20
    if rows >= step:
        return (rows // step) * step
    return max(128, 1 << (rows.bit_length() - 1))


class StreamedDenseRDD:
    """A chunked dense dataset: _make_chunks() yields fresh per-chunk
    DenseRDDs (one chunk's device memory is released before the next
    materializes), and resident() builds the equivalent whole DenseRDD
    for what cannot stream. Any attribute it does not define is the
    resident build's, so a streamed operand of a resident op behaves as
    its resident build."""

    def __init__(self, ctx, make_chunks: Callable[[], Iterator],
                 make_resident: Callable[[], object], n_chunks: int,
                 make_probe: Callable[[], object]):
        self.context = ctx
        self._make_chunks = make_chunks
        self._make_resident = make_resident
        self.n_chunks = n_chunks
        # a few-row block of the stream's schema (None when empty), for
        # the build-time checks only
        self._make_probe = make_probe
        self._resident_memo = None

    _INTERNALS = ("context", "n_chunks", "_make_chunks", "_make_resident",
                  "_make_probe", "_resident_memo")

    def resident(self):
        """The whole DenseRDD this stream is a recipe for, built once."""
        if self._resident_memo is None:
            log.info("streamed source: materializing resident build "
                     "(%d chunks coalesce into one block)", self.n_chunks)
            self._resident_memo = self._make_resident()
        return self._resident_memo

    def __getattr__(self, name):
        # only names not found normally; the _INTERNALS guard stops the
        # recursion when an attribute is probed before __init__ ran
        if name in StreamedDenseRDD._INTERNALS:
            raise AttributeError(name)
        if name in dense_rdd.REFERENCE_RDD_API and \
                not hasattr(dense_rdd.DenseRDD, name):
            # a host-tier name refuses before any chunk is built
            raise dense_rdd._host_name_refused("StreamedDenseRDD", name)
        return getattr(self.resident(), name)

    # --- narrow ops: compose per chunk -------------------------------------
    def _per_chunk(self, apply) -> "StreamedDenseRDD":
        make = self._make_chunks
        make_probe = self._make_probe
        # the op's build-time checks run on the probe: what has no device
        # form raises here, before any chunk runs (the reference's resident
        # fallback to its host tier)
        probe = make_probe()
        if probe is not None:
            apply(probe)

        def chunks():
            for chunk in make():
                yield apply(chunk)

        def child_probe():
            p = make_probe()
            return None if p is None else apply(p)

        # the child's resident build reuses the parent's memo
        return StreamedDenseRDD(self.context, chunks,
                                lambda: apply(self.resident()),
                                self.n_chunks, child_probe)

    def map(self, f: Callable):
        return self._per_chunk(lambda c: c.map(f))

    def filter(self, predicate: Callable):
        return self._per_chunk(lambda c: c.filter(predicate))

    def map_values(self, f: Callable):
        return self._per_chunk(lambda c: c.map_values(f))

    def map_expand(self, f: Callable, factor: int):
        return self._per_chunk(lambda c: c.map_expand(f, factor))

    def flat_map_ragged(self, f: Callable, max_out_per_row: int):
        return self._per_chunk(
            lambda c: c.flat_map_ragged(f, max_out_per_row))

    def join(self, other, *, exchange: Optional[str] = None):
        """Streamed join against a resident right side: a left row's
        matches depend only on the table, so each chunk joins on its own
        and the result streams. The table is hash-placed once up front
        (one group_by_key exchange), so every chunk's join elides its
        side; it must fit the budget itself. A streamed right side joins
        as its resident build. exchange= goes to each chunk's join."""
        other = dense_rdd._resident(other)
        if not isinstance(other, dense_rdd.DenseRDD):
            return self.resident().join(other, exchange=exchange)
        other._settle_placement()
        if not other.hash_placed:
            other = dense_rdd._GroupByKeyRDD(other)
        blk = other._block
        if blk is not None and blk.nbytes * 3 > self.context.dense_hbm_budget:
            log.warning(
                "streamed join: right side is %.1f MiB — chunk sizing "
                "does not account for it; lower chunk_rows if device "
                "memory overflows", blk.nbytes / 2**20)
        return self._per_chunk(lambda c: c.join(other, exchange=exchange))

    # --- streaming aggregations --------------------------------------------
    def reduce_by_key(self, func=None, *, op: Optional[str] = None,
                      exchange: Optional[str] = None):
        """The multi-pass fold: each chunk's reduce merges into the
        accumulator through a union and a reduce with its exchange elided;
        after each merge only the block is kept, as a hash-placed source,
        so the chunk's lineage frees before the next chunk builds. Returns
        a resident DenseRDD bounded by the number of keys. exchange= goes
        to every reduce."""
        probe = self._make_probe()
        if probe is not None:
            probe.reduce_by_key(func, op=op, exchange=exchange)  # checks
        acc = None
        for i, chunk in enumerate(self._make_chunks()):
            partial = chunk.reduce_by_key(func, op=op, exchange=exchange)
            merged = (partial if acc is None else
                      dense_rdd._DenseUnionRDD(acc, partial).reduce_by_key(
                          func, op=op, exchange=exchange))
            blk = merged.block()
            # placement from the materialized node, not assumed
            acc = dense_rdd.dense_from_block(self.context, blk,
                                             hash_placed=merged.hash_placed)
            log.info("streamed reduce_by_key: chunk %d/%d -> %d keys "
                     "(accumulator %.1f MiB device-resident)", i + 1,
                     self.n_chunks, blk.num_rows, blk.nbytes / 2**20)
        if acc is None:
            raise VegaError("streamed reduce_by_key on empty source")
        return acc

    def count(self) -> int:
        return sum(c.count() for c in self._make_chunks())

    def _fold_named(self, op: str):
        total = None
        for chunk in self._make_chunks():
            part = getattr(chunk, {"add": "sum", "min": "min",
                                   "max": "max"}[op])()
            if total is None:
                total = part
            elif op == "add":
                total = total + part
            elif op == "min":
                total = min(total, part)
            else:
                total = max(total, part)
        if total is None:
            raise VegaError("reduction over empty streamed source")
        return total

    def sum(self):
        return self._fold_named("add")

    def min(self):
        return self._fold_named("min")

    def max(self):
        return self._fold_named("max")

    def _stream_best(self, n: int, method: str, reverse: bool) -> list:
        best: list = []
        for chunk in self._make_chunks():
            best.extend(getattr(chunk, method)(n))
            best = sorted(best, reverse=reverse)[:n]
        return best

    def take_ordered(self, n: int, key=None) -> list:
        """The n smallest elements: each chunk's device take_ordered gives
        at most n candidates, and the host keeps the running best n. A
        key function runs on the resident build, which refuses it as
        DenseRDD.take_ordered does (no host tier)."""
        if key is not None:
            return self.resident().take_ordered(n, key)
        return self._stream_best(n, "take_ordered", reverse=False)

    def top(self, n: int, key=None) -> list:
        if key is not None:
            return self.resident().top(n, key)
        return self._stream_best(n, "top", reverse=True)


def streamed_range(ctx, n: int, chunk_rows: int,
                   dtype=torch.int32) -> StreamedDenseRDD:
    """Chunked ctx.dense_range: chunk i covers [i * chunk_rows, ...)."""
    mesh = ctx.mesh
    n_chunks = -(-n // chunk_rows)

    def chunks():
        for i in range(n_chunks):
            start = i * chunk_rows
            size = min(chunk_rows, n - start)
            yield dense_rdd.dense_from_block(
                ctx, block_lib.block_range(size, mesh, dtype, start=start))

    def resident():
        return dense_rdd.dense_from_block(
            ctx, block_lib.block_range(n, mesh, dtype))

    def probe():
        return dense_rdd.dense_from_block(
            ctx, block_lib.block_range(min(n, 8), mesh, dtype))

    return StreamedDenseRDD(ctx, chunks, resident, n_chunks, probe)


def streamed_npz(ctx, cols: dict, chunk_rows: int) -> StreamedDenseRDD:
    """Chunked dense_load_npz over host columns already loaded (the host
    holds the file once; the device one chunk). String columns are
    dictionary-encoded, and int64 keys and values encoded, once over the
    whole column, so every chunk has one schema and one dictionary per
    string column: the accumulator's union needs both (a dictionary per
    chunk would make every merge a unification)."""
    mesh = ctx.mesh
    cols, dicts = dict_encoding.encode_string_columns(
        dict(cols), enabled=ctx.dense_dict_enabled)
    cols = block_lib.encode_value_columns(block_lib.encode_key_columns(cols))
    n = len(next(iter(cols.values()))) if cols else 0
    n_chunks = max(1, -(-n // chunk_rows))

    def chunks():
        for i in range(n_chunks):
            lo = i * chunk_rows
            hi = min(lo + chunk_rows, n)
            yield dense_rdd.dense_from_block(ctx, block_lib.from_numpy(
                {name: col[lo:hi] for name, col in cols.items()}, mesh,
                dicts=dicts))

    def resident():
        return dense_rdd.dense_from_block(ctx, block_lib.from_numpy(
            cols, mesh, dicts=dicts))

    def probe():
        if n == 0:
            return None
        return dense_rdd.dense_from_block(ctx, block_lib.from_numpy(
            {name: col[:min(n, 8)] for name, col in cols.items()}, mesh,
            dicts=dicts))

    return StreamedDenseRDD(ctx, chunks, resident, n_chunks, probe)
