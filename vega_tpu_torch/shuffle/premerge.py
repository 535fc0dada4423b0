"""The push plan's server-side pre-merge tier: the port's copy of
vega_tpu/shuffle/premerge.py.

Under shuffle_plan="push" a map task pushes each finished VN01 bucket of
a named monoid to its reduce partition's owning shuffle server
(dependency._push_row); this tier, one per server, feeds the buckets
into a per-(shuffle, reduce) native.StreamingMerge as they arrive, so the
reducer later reads one mostly-merged frame instead of M buckets.
Anything else (a frame of the other value flag, a bucket past the
budget, a push after the freeze) is stored as it came in the server's
ShuffleStore and handed over unmerged.

- A bucket is known by its map id: a second push of one map id (a
  retry, a speculative copy) is dropped and counted as a duplicate,
  never fed twice (a map partition's compute is deterministic).
- freeze(), at the first read, finishes the merge once; the frozen VN01
  frame is stored under the reserved map id -1, so a retried reduce
  task reads the same answer.
- An int64 overflow of the merged values (finish() None, or a value past
  int64 on the exact path) voids the merged set: the reducer pulls
  those map outputs from their own servers and merges them exactly.
A failed push leaves its buckets to the pull plan; the map task never
fails for it."""

from __future__ import annotations

import logging
import struct
from typing import Dict, List, Optional, Tuple

from vega_tpu_torch import native
from vega_tpu_torch.lint.sync_witness import named_lock

log = logging.getLogger(__name__)

# Reserved map_id for the frozen pre-merged blob of a (shuffle, reduce):
# real map_ids are partition indices (>= 0), so -1 can never collide.
PREMERGED_MAP_ID = -1

# dependency.py's frame magics (a test holds them equal)
NATIVE_MAGIC = b"VN01"
NATIVE_GROUP_MAGIC = b"VG01"

_INT64_MIN = -(1 << 63)
_INT64_MAX = (1 << 63) - 1


def encode_native_pairs(pairs) -> Optional[Tuple[bytes, bool]]:
    """(k, v) pairs -> (16-byte-row payload, is_int), or None when the
    pairs cannot round-trip through the native row format exactly —
    an int that outgrew int64 (the Python-fallback merge is bignum-exact)
    or a mixed int/float value set (one flag per blob; forcing ints
    through doubles would silently round). None means: do not freeze a
    merged blob, let the reducer pull the raw buckets instead."""
    if all(type(v) is int for _, v in pairs):
        if any(v < _INT64_MIN or v > _INT64_MAX for _, v in pairs):
            return None
        return (b"".join(struct.pack("<qq", k, v) for k, v in pairs), True)
    if all(type(v) is float for _, v in pairs):
        return (b"".join(struct.pack("<qd", k, v) for k, v in pairs), False)
    return None


class _State:
    """Pre-merge accumulator for one (shuffle_id, reduce_id).

    Each state carries its OWN lock so independent reduce partitions
    merge in parallel (16 concurrent push_merged handler threads must not
    serialize on one tier-wide lock around the C++ feed); the tier lock
    guards only the states dict and the shared counters. Lock order is
    state -> tier (counters are taken nested inside a held state lock)
    and state -> store (freeze writes the frozen blob while holding the
    state lock); neither the tier nor the store ever acquires a state
    lock, so the order is acyclic."""

    __slots__ = ("lock", "merger", "is_int", "merged", "raw", "frozen",
                 "frozen_ids", "fed_bytes")

    def __init__(self):
        self.lock = named_lock("shuffle.premerge._State.lock")
        self.merger = None          # lazy native.StreamingMerge
        self.is_int = None          # flag of the first fed blob
        self.merged: set = set()    # map_ids fed into the merger
        self.raw: set = set()       # map_ids stored-and-forwarded
        self.frozen = False
        self.frozen_ids: List[int] = []  # merged ids the frozen blob covers
        self.fed_bytes = 0


class PreMergeTier:
    """One per shuffle server, sharing that server's ShuffleStore."""

    def __init__(self, store, budget_bytes: int = 1 << 30):
        self._store = store
        # Upper bound on resident merge-state bytes, approximated by the
        # sum of fed payload bytes (the accumulator dedups keys, so the
        # true footprint is <=). Feeds past it store-and-forward instead.
        self._budget = budget_bytes
        self._states: Dict[Tuple[int, int], _State] = {}
        self._lock = named_lock("shuffle.premerge.PreMergeTier._lock")
        self.counters = {
            "merged_buckets": 0, "raw_buckets": 0, "duplicates": 0,
            "frozen": 0, "overflow_freezes": 0, "fed_bytes": 0,
            "rejected": 0,
        }

    # ------------------------------------------------------------- feeding
    def feed_row(self, shuffle_id: int, map_id: int, attempt: int,
                 op_name: Optional[str], entries) -> Dict[str, int]:
        """One map task's pushed buckets for this server: `entries` is a
        list of (reduce_id, blob) where blob is the full stored bucket
        frame (magic + flag + payload for native encodings, else pickle
        bytes). Returns {"merged": n, "stored": n, "duplicate": n}.

        Mergeable (VN01 + recognized monoid + matching value flag + under
        budget + not frozen) -> fed into the (shuffle, reduce) MergeState.
        Everything else -> store.put under the pushing map's own key, so
        get_merged can still hand it to the reducer unmerged."""
        out = {"merged": 0, "stored": 0, "duplicate": 0}
        to_store = []
        mergeable_op = op_name in native.OP_BY_NAME
        for reduce_id, blob in entries:
            if (mergeable_op and blob[:4] == NATIVE_MAGIC
                    and (len(blob) - 5) % 16 != 0):
                # Structurally invalid VN01 frame (truncated/desynced
                # payload: rows are exactly 16 bytes). NEVER fed and NEVER
                # stored — forwarding provably-bad bytes would fail the
                # REDUCE task on every retry, where dropping just means
                # the reducer pulls the origin's good copy.
                log.warning(
                    "rejecting malformed pushed bucket: shuffle=%d map=%d "
                    "reduce=%d len=%d", shuffle_id, map_id, reduce_id,
                    len(blob))
                with self._lock:
                    self.counters["rejected"] += 1
                continue
            with self._lock:
                state = self._states.setdefault((shuffle_id, reduce_id),
                                                _State())
            with state.lock:
                if map_id in state.merged or map_id in state.raw:
                    # Map retry / replayed push (speculation makes these
                    # routine): deterministic compute means the bytes are
                    # identical — merging twice is the one thing this tier
                    # must never do. Surfaced via the `duplicates` counter
                    # and ShufflePushCompleted; info-level like the other
                    # expected degradations here.
                    out["duplicate"] += 1
                    with self._lock:
                        self.counters["duplicates"] += 1
                    log.info(
                        "duplicate shuffle push dropped: shuffle=%d map=%d "
                        "reduce=%d attempt=%d", shuffle_id, map_id,
                        reduce_id, attempt)
                    continue
                is_int = len(blob) > 4 and blob[4] == 1
                admitted = False
                if (mergeable_op and not state.frozen
                        and blob[:4] == NATIVE_MAGIC
                        and (state.is_int is None
                             or state.is_int == is_int)):
                    # Budget admission is atomic with the counter bump so
                    # concurrent feeds on OTHER states cannot jointly
                    # overshoot the cap.
                    with self._lock:
                        admitted = (self.counters["fed_bytes"] + len(blob)
                                    <= self._budget)
                        if admitted:
                            self.counters["fed_bytes"] += len(blob)
                            self.counters["merged_buckets"] += 1
                if admitted:
                    try:
                        if state.merger is None:
                            state.merger = native.StreamingMerge(op_name)
                            state.is_int = is_int
                        state.merger.feed(memoryview(blob)[5:], is_int)
                        state.merged.add(map_id)
                        state.fed_bytes += len(blob)
                        out["merged"] += 1
                        continue
                    except Exception:  # noqa: BLE001 — a corrupt frame must
                        # poison THIS state, not leak budget or fail the push
                        log.warning(
                            "pre-merge feed of shuffle %d map %d reduce %d "
                            "failed; voiding this partition's merge state "
                            "(reducer pulls instead)", shuffle_id, map_id,
                            reduce_id, exc_info=True)
                        # The accumulator may hold partial rows: void the
                        # WHOLE merged set (freeze will answer frozen_ids=[]
                        # and the reducer pulls those map_ids from their
                        # origins) and refund every charged byte — this
                        # blob's admission plus the prior feeds freeze()
                        # will now never reclaim. The offending bucket is
                        # DROPPED, not stored: its bytes just proved
                        # unusable, and serving them would fail the reduce
                        # task on every retry where a pull of the origin's
                        # good copy succeeds.
                        state.merger = None
                        state.frozen = True
                        state.frozen_ids = []
                        with self._lock:
                            self.counters["fed_bytes"] -= (len(blob)
                                                           + state.fed_bytes)
                            # Roll back this blob's admission AND the prior
                            # feeds the void just unwound — nothing from
                            # this state will ever be served merged, so
                            # leaving them counted would report phantom
                            # merges to status() readers.
                            self.counters["merged_buckets"] -= (
                                1 + len(state.merged))
                            self.counters["rejected"] += 1
                        state.fed_bytes = 0
                        continue
                if mergeable_op and blob[:4] == NATIVE_MAGIC:
                    # A mergeable bucket falling to store-and-forward is
                    # worth a line: frozen state (late push), value-flag
                    # mismatch, or budget pressure — all legal, all
                    # observable.
                    log.info(
                        "push of shuffle %d map %d reduce %d stored raw "
                        "(frozen=%s state_flag=%s blob_flag=%s)",
                        shuffle_id, map_id, reduce_id, state.frozen,
                        state.is_int, is_int)
                state.raw.add(map_id)
                with self._lock:
                    self.counters["raw_buckets"] += 1
                out["stored"] += 1
            # Store writes run OUTSIDE both locks (they take the store's
            # own lock and may hit disk); the map_id was already claimed
            # in `raw` above, so a racing duplicate push is still dropped
            # before it gets here.
            to_store.append((map_id, reduce_id, blob))
        for m, r, blob in to_store:
            self._store.put(shuffle_id, m, r, blob)
        return out

    # -------------------------------------------------------------- reading
    def freeze(self, shuffle_id: int, reduce_id: int
               ) -> Tuple[List[int], List[int]]:
        """Finalize the merge for one (shuffle, reduce) — idempotent, so
        reducer retries and speculative duplicates read a stable answer.
        Returns (merged_map_ids, raw_map_ids): the ids the frozen blob
        (stored under PREMERGED_MAP_ID) covers, and the ids held as raw
        store-and-forward buckets. On overflow the merged ids come back
        EMPTY — the reducer pulls them from their origins, keeping the
        int64-exactness contract (shuffled.py's redo path)."""
        with self._lock:
            state = self._states.get((shuffle_id, reduce_id))
        if state is None:
            return [], []
        with state.lock:
            if state.frozen:
                return list(state.frozen_ids), sorted(state.raw)
            # The whole finalize runs under the STATE lock — once per
            # (shuffle, reduce), pure CPU plus one store write — so a
            # CONCURRENT freeze (a speculative duplicate reduce attempt,
            # a reducer retry) parks here and observes the fully
            # published result, while feeds of OTHER partitions proceed.
            # Setting `frozen` before frozen_ids/the stored blob would
            # let the racer read an empty merged set and silently defeat
            # the pre-merge for this partition.
            merger, is_int = state.merger, state.is_int
            merged_ids = sorted(state.merged)
            state.merger = None  # the accumulator dies at freeze either way
            raw_ids = sorted(state.raw)
            blob = None
            if merger is not None and merged_ids:
                pairs = merger.finish()  # None iff the NATIVE state overflowed
                encoded = (encode_native_pairs(pairs)
                           if pairs is not None else None)
                if encoded is not None:
                    payload, enc_int = encoded
                    blob = (NATIVE_MAGIC + (b"\x01" if enc_int else b"\x00")
                            + payload)
                else:
                    with self._lock:
                        self.counters["overflow_freezes"] += 1
                        # these buckets will never be served merged: their
                        # counts roll back, as the feed failure's do
                        self.counters["merged_buckets"] -= len(merged_ids)
                    log.info(
                        "pre-merge of shuffle %d reduce %d overflowed int64 "
                        "(%s-flag state); voiding the merged set so the "
                        "reducer's exact pull path runs", shuffle_id,
                        reduce_id, "int" if is_int else "float")
                    merged_ids = []
            elif merged_ids:
                merged_ids = []
            if blob is not None:
                # Through the ordinary store: budget, spill and checksummed
                # disk reads all apply to the frozen blob like any bucket.
                # Lock order state -> store; the store never calls back
                # into the tier.
                self._store.put(shuffle_id, PREMERGED_MAP_ID, reduce_id,
                                blob)
            state.frozen_ids = list(merged_ids)
            state.frozen = True
            with self._lock:
                self.counters["frozen"] += 1
                self.counters["fed_bytes"] -= state.fed_bytes
        return list(merged_ids), raw_ids

    def merged_blob(self, shuffle_id: int, reduce_id: int) -> Optional[bytes]:
        """The frozen pre-merged frame, or None (never frozen, overflow,
        or the store lost it — a checksum miss reads as None and the
        caller degrades the merged set to a pull)."""
        return self._store.get(shuffle_id, PREMERGED_MAP_ID, reduce_id)

    # Bounds on the raw store-and-forward set one `read` returns: raws
    # are materialized on both the serving and the fetching side, so an
    # over-budget shuffle whose pushes mostly went raw must not turn one
    # get_merged round into an unbounded resident list (the pull path is
    # fetch_queue_buckets-bounded for exactly this reason). Unreturned
    # ids are simply not claimed — the reducer pulls them from their
    # origins under the normal bounded pipeline.
    RAW_READ_MAX_BUCKETS = 64
    RAW_READ_MAX_BYTES = 32 << 20

    def read(self, shuffle_id: int, reduce_id: int):
        """The reducer-facing read — freeze (idempotent), then
        (merged_map_ids, frozen_blob_or_None, [(map_id, raw_bucket)...]).
        This is the ONE home of the safety rule 'no blob => the merged
        set must be voided' (claiming ids without their bytes would lose
        data silently) and of the lost-raw-copy skip; both the get_merged
        server handler and the in-process self-owner fetch path call it."""
        merged_ids, raw_ids = self.freeze(shuffle_id, reduce_id)
        blob = self.merged_blob(shuffle_id, reduce_id) if merged_ids else None
        if blob is None:
            merged_ids = []
        raws = []
        raw_bytes = 0
        for m in raw_ids:
            if (len(raws) >= self.RAW_READ_MAX_BUCKETS
                    or raw_bytes >= self.RAW_READ_MAX_BYTES):
                break  # the rest pull from their origins, bounded
            data = self._store.get(shuffle_id, m, reduce_id)
            if data is not None:  # lost raw copy: the reducer pulls it
                raws.append((m, data))
                raw_bytes += len(data)
        return merged_ids, blob, raws

    # ------------------------------------------------------------ lifecycle
    def remove_shuffle(self, shuffle_id: int) -> None:
        """Drop all pre-merge state of a shuffle — the tier-side twin of
        ShuffleStore.remove_shuffle. Like the store (and the reference's
        process-pinned SHUFFLE_CACHE), state today lives for the worker
        process: both remove_shuffle hooks await the same future shuffle
        cleanup plane. Until then the cost of an abandoned unfrozen state
        is bounded by the budget gate in feed_row."""
        with self._lock:
            removed = [self._states.pop(k)
                       for k in [k for k in self._states
                                 if k[0] == shuffle_id]]
        for state in removed:
            # Settle under the STATE lock: a concurrent freeze() mid-
            # finalize would otherwise race this reclaim into a double
            # subtract (negative fed_bytes = an unbounded budget).
            with state.lock:
                if not state.frozen:
                    state.frozen = True
                    state.frozen_ids = []
                    state.merger = None
                    with self._lock:
                        self.counters["fed_bytes"] -= state.fed_bytes
                    state.fed_bytes = 0

    def status(self) -> Dict[str, int]:
        with self._lock:
            snap = dict(self.counters)
            snap["states"] = len(self._states)
        return snap
