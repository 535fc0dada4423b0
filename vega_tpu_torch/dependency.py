"""Lineage edges: the port's copy of the dependency objects of
vega_tpu/dependency.py.

A narrow dependency names the parent partitions one child partition reads
(OneToOne, Range for union, ManyToOne for coalesce and cartesian); a
ShuffleDependency is a stage boundary holding the parent, the aggregator
of the map-side combine and the output partitioner; its do_shuffle_task
is a map task's body (scheduler/task.py ShuffleMapTask): the parent
partition bucketed by the partitioner, combined per bucket, each bucket
written into the Context's shuffle store (shuffle/store.py) (an
executor's own store in mode="distributed").

A named monoid (add / min / max / prod) or the list-collecting group
under a HashPartitioner over (int, int | float) pairs takes the native
runtime (native.py): one C++ pass buckets and combines the rows into
VN01 frames (combined pairs) or VG01 frames (raw group rows). A stream
that turns mixed-type part-way, or an int64 combine that overflows, is
redone on the pickled Python path, which is exact.

In mode="distributed" a map task also publishes its row beyond its own
store, never failing for it:
- shuffle_plan="push": each VN01 bucket of a named monoid goes to its
  reduce partition's owner (push_owner_of over the sorted live peers),
  one push_merged round trip per owner, into that server's pre-merge
  tier (shuffle/premerge.py); a failed push leaves the bucket to the
  pull plan. The push counters (push_stats_snapshot) and
  ShufflePushCompleted record it.
- shuffle_coding (xor / rs(k,m)): the row, zlib-compressed, goes once
  to a peer's parity server (put_parity), which folds it into a parity
  group; the assignment is registered with the tracker
  (register_parity) so a reducer can decode the row if its server dies
  (shuffle/coding.py, shuffle/fetcher.py).
- shuffle_replication = k > 1: the row goes to k - 1 live peers (one
  put_many round trip each, peers rotated by map id) and the map task
  returns the ordered location list, the primary first."""

from __future__ import annotations

import itertools
import logging
import time
from typing import TYPE_CHECKING, List

from vega_tpu_torch import serialization
from vega_tpu_torch.aggregator import Aggregator
from vega_tpu_torch.lint.sync_witness import named_lock
from vega_tpu_torch.partitioner import HashPartitioner, Partitioner

if TYPE_CHECKING:
    from vega_tpu_torch.rdd.base import RDD

log = logging.getLogger(__name__)

# the frame tags of native buckets (16-byte rows after a value-int flag
# byte): VN01 combined (k, combiner) rows, VG01 raw (k, v) rows of a
# group; any other bucket is a pickled list of pairs
NATIVE_MAGIC = b"VN01"
NATIVE_GROUP_MAGIC = b"VG01"

# the live peers' shuffle servers, per process and tracker: a map stage
# asks the driver once per _PEER_CACHE_TTL_S, not once per task; a failed
# push drops it
_PEER_CACHE_TTL_S = 5.0
_peer_cache: dict = {"tracker": None, "peers": None, "expires": 0.0}

# this process's push-plan and redundancy counters (an executor's
# worker_stats)
_push_lock = named_lock("dependency._push_lock")
_PUSH_TOTALS = {
    "pushes": 0, "buckets": 0, "bytes": 0, "merged": 0, "stored": 0,
    "duplicates": 0, "failed": 0, "wall_s": 0.0,
}
_REDUNDANCY = {
    "replica_pushes": 0, "replica_push_bytes": 0, "parity_pushes": 0,
    "parity_push_bytes": 0, "parity_raw_bytes": 0, "parity_failed": 0,
}
# per shuffle, where this process's next parity push starts in the sorted
# peers: an origin's rows spread evenly over the parity servers, so each
# server can fill its groups from distinct origins
_PARITY_CURSOR: dict = {}


def push_stats_snapshot() -> dict:
    with _push_lock:
        return dict(_PUSH_TOTALS)


def redundancy_stats_snapshot() -> dict:
    with _push_lock:
        return dict(_REDUNDANCY)


def reset_push_stats() -> None:
    with _push_lock:
        for k in _PUSH_TOTALS:
            _PUSH_TOTALS[k] = 0 if isinstance(_PUSH_TOTALS[k], int) else 0.0
        for k in _REDUNDANCY:
            _REDUNDANCY[k] = 0


def _live_shuffle_peers(tracker) -> List[str]:
    now = time.monotonic()
    if _peer_cache["tracker"] is tracker and now < _peer_cache["expires"]:
        return _peer_cache["peers"]
    peers = [u for u in tracker.list_shuffle_peers().values() if u]
    _peer_cache.update(tracker=tracker, peers=peers,
                       expires=now + _PEER_CACHE_TTL_S)
    return peers


def _invalidate_peer_cache() -> None:
    _peer_cache["expires"] = 0.0


def is_push_plan(conf) -> bool:
    """The one test of shuffle_plan="push" (map side, reduce side and the
    DAG scheduler's placement agree on it)."""
    return str(getattr(conf, "shuffle_plan", "pull")).lower() == "push"


def resolve_push_peers(tracker):
    """The sorted live peers the push plan's owners rotate over, or None
    when the plan cannot apply (no peer listing, no peers, discovery
    failed): the shuffle then stays on the pull plan."""
    if getattr(tracker, "list_shuffle_peers", None) is None:
        return None
    from vega_tpu_torch.errors import NetworkError

    try:
        peers = sorted(_live_shuffle_peers(tracker))
    except NetworkError as e:
        log.warning("push-peer discovery failed (%s); staying on the "
                    "pull plan", e)
        return None
    return peers or None


def push_owner_of(peers, reduce_id: int) -> str:
    """The owner of a reduce partition: the one rule of mapper, reducer
    and scheduler."""
    return peers[reduce_id % len(peers)]


def push_owner_uri(tracker, reduce_id: int):
    peers = resolve_push_peers(tracker)
    return push_owner_of(peers, reduce_id) if peers else None


def push_owner_for_peers(peer_uris, reduce_id: int):
    """The owner over an explicit peer set (the backend's registry, for
    the DAG scheduler's placement)."""
    peers = sorted(u for u in peer_uris if u)
    return push_owner_of(peers, reduce_id) if peers else None


def is_mergeable(aggregator: Aggregator) -> bool:
    """A shuffle the push plan pushes and pre-merges: a named monoid."""
    from vega_tpu_torch import native

    return not aggregator.is_group and aggregator.op_name in native.OP_BY_NAME


_SENTINEL = object()


def _is_numeric_pair(item) -> bool:
    return (type(item) is tuple and len(item) == 2
            and type(item[0]) is int and type(item[1]) in (int, float))


class Dependency:
    __slots__ = ("rdd",)

    def __init__(self, rdd: "RDD"):
        self.rdd = rdd


class NarrowDependency(Dependency):
    """Each parent partition is read by at most one child partition."""

    def get_parents(self, partition_id: int) -> List[int]:
        raise NotImplementedError


class OneToOneDependency(NarrowDependency):
    def get_parents(self, partition_id: int) -> List[int]:
        return [partition_id]


class RangeDependency(NarrowDependency):
    """Child partitions [out_start, out_start + length) read parent
    partitions [in_start, in_start + length), one to one (union)."""

    __slots__ = ("in_start", "out_start", "length")

    def __init__(self, rdd: "RDD", in_start: int, out_start: int,
                 length: int):
        super().__init__(rdd)
        self.in_start = in_start
        self.out_start = out_start
        self.length = length

    def get_parents(self, partition_id: int) -> List[int]:
        if self.out_start <= partition_id < self.out_start + self.length:
            return [partition_id - self.out_start + self.in_start]
        return []


class ManyToOneDependency(NarrowDependency):
    """Child partition i reads the parent partitions groups[i] (coalesce,
    cartesian)."""

    __slots__ = ("groups",)

    def __init__(self, rdd: "RDD", groups: List[List[int]]):
        super().__init__(rdd)
        self.groups = groups

    def get_parents(self, partition_id: int) -> List[int]:
        return list(self.groups[partition_id])


class ShuffleDependency(Dependency):
    """A stage boundary: the parent, its map-side aggregator and the
    output partitioner, under a shuffle id the Context allocates."""

    __slots__ = ("shuffle_id", "aggregator", "partitioner", "is_cogroup")

    def __init__(self, shuffle_id: int, rdd: "RDD", aggregator: Aggregator,
                 partitioner: Partitioner, is_cogroup: bool = False):
        super().__init__(rdd)
        self.shuffle_id = shuffle_id
        self.aggregator = aggregator
        self.partitioner = partitioner
        self.is_cogroup = is_cogroup

    def do_shuffle_task(self, split, task_context=None) -> tuple:
        """Map-side combine of one parent partition into its buckets, each
        written into the shuffle store under (shuffle_id, map id, reduce
        id). Returns the map task's result: (location(s), per-reduce
        bucket bytes)."""
        env = self.rdd.context.env
        row, source = self._native_row(split, task_context)
        if row is None:
            if source is None:
                source = self.rdd.iterator(split, task_context)
            rows = list(source)
            buckets = [dict() for _ in range(self.partitioner.num_partitions)]
            _bucket(self, rows, buckets)
            row = [serialization.dumps_data(list(bucket.items()))
                   for bucket in buckets]
        store = env.shuffle_store
        for reduce_id, blob in enumerate(row):
            store.put(self.shuffle_id, split.index, reduce_id, blob)
        return self._publish(env, split.index, row, task_context)

    def _native_row(self, split, task_context):
        """(the partition's VN01 / VG01 bucket row through the native
        runtime, None), or (None, the rows left to the pickled path): an
        aggregator that is not a named monoid or the group, or another
        partitioner (None: the partition is not read yet), an empty
        partition or a first row that is not an (int, int | float) pair
        (its rows), or a call the library rejects, a mixed-type stream or
        an int64 overflow (None: the partition is computed again, its
        compute being deterministic)."""
        agg = self.aggregator
        if not (agg.op_name is not None or agg.is_group) \
                or type(self.partitioner) is not HashPartitioner:
            return None, None
        from vega_tpu_torch import native

        if not agg.is_group and agg.op_name not in native.OP_BY_NAME:
            return None, None
        it = self.rdd.iterator(split, task_context)
        first = next(it, _SENTINEL)
        if first is _SENTINEL:
            return None, iter(())
        stream = itertools.chain([first], it)
        if not _is_numeric_pair(first):
            return None, stream
        nat = native.get()
        n_out = self.partitioner.num_partitions
        if agg.is_group:
            result = nat.bucket_pairs(stream, n_out)
            magic = NATIVE_GROUP_MAGIC
        else:
            result = nat.bucket_reduce_pairs(stream, n_out,
                                             native.OP_BY_NAME[agg.op_name])
            magic = NATIVE_MAGIC
        if result is None:
            return None, None
        blobs, all_int = result
        flag = b"\x01" if all_int else b"\x00"
        return [magic + flag + blob for blob in blobs], None

    def _publish(self, env, map_id: int, row: list, task_context=None):
        """The stored bucket row as the map task's result: its
        location(s) and each bucket's bytes."""
        return (self._publish_locs(env, map_id, row, task_context),
                [len(b) for b in row])

    def _publish_locs(self, env, map_id: int, row: list, task_context=None):
        """This output's location: "local" in a driver's process, the
        executor's shuffle server in mode="distributed", and with
        shuffle_replication = k > 1 the list of it and up to k - 1 peers
        the row was pushed to. The push plan's and the coded shuffle's
        publications run first; neither changes the location."""
        server = env.shuffle_server
        if server is None:
            return "local"
        primary = server.uri
        if is_push_plan(env.conf):
            self._push_row(env, map_id, row, task_context)
        self._publish_parity(env, map_id, row, primary)
        k = int(env.conf.shuffle_replication)
        peers_fn = getattr(env.map_output_tracker, "list_shuffle_peers",
                           None)
        if k <= 1 or peers_fn is None:
            return primary
        from vega_tpu_torch.distributed.shuffle_server import (
            push_buckets_remote)
        from vega_tpu_torch.errors import NetworkError

        try:
            peers = sorted(u for u in
                           _live_shuffle_peers(env.map_output_tracker)
                           if u != primary)
        except NetworkError as e:
            log.warning("replica peer discovery failed (%s); the map "
                        "output keeps its primary only", e)
            return primary
        locs = [primary]
        row_bytes = sum(len(b) for b in row)
        for i in range(len(peers)):
            if len(locs) >= k:
                break
            uri = peers[(map_id + i) % len(peers)]
            try:
                push_buckets_remote(uri, self.shuffle_id, map_id, row)
            except NetworkError as e:
                log.warning("replica push of shuffle %d map %d to %s "
                            "failed (%s); %d cop%s kept", self.shuffle_id,
                            map_id, uri, e, len(locs),
                            "y" if len(locs) == 1 else "ies")
                _invalidate_peer_cache()
                continue
            with _push_lock:
                _REDUNDANCY["replica_pushes"] += 1
                _REDUNDANCY["replica_push_bytes"] += row_bytes
            locs.append(uri)
        return locs if len(locs) > 1 else primary

    def _publish_parity(self, env, map_id: int, row: list,
                        primary: str) -> None:
        """shuffle_coding: the row, compressed, to one peer's parity
        server (never this executor's own), starting at this process's
        cursor for the shuffle; the group and index it was given are
        registered with the tracker. Every failure leaves the row without
        parity, never fails the task."""
        from vega_tpu_torch.shuffle import coding

        spec = coding.spec_from_conf(env.conf)
        if spec is None or not row:
            return
        tracker = env.map_output_tracker
        if getattr(tracker, "list_shuffle_peers", None) is None:
            return
        scheme, k, m = spec
        from vega_tpu_torch.distributed.shuffle_server import (
            put_parity_remote)
        from vega_tpu_torch.errors import NetworkError

        try:
            candidates = sorted(u for u in _live_shuffle_peers(tracker)
                                if u != primary)
        except NetworkError as e:
            log.warning("parity peer discovery failed (%s); shuffle %d map "
                        "%d has no parity", e, self.shuffle_id, map_id)
            return
        if not candidates:
            return
        payloads = [coding.wire_pack(b) for b in row]
        with _push_lock:
            start = _PARITY_CURSOR.get(self.shuffle_id, 0)
            _PARITY_CURSOR[self.shuffle_id] = (start + 1) % len(candidates)
        for i in range(len(candidates)):
            uri = candidates[(start + i) % len(candidates)]
            try:
                gid, idx = put_parity_remote(
                    uri, self.shuffle_id, map_id, primary, scheme, k, m,
                    payloads)
            except NetworkError as e:
                log.warning("parity push of shuffle %d map %d to %s failed "
                            "(%s); trying the next peer", self.shuffle_id,
                            map_id, uri, e)
                _invalidate_peer_cache()
                continue
            try:
                tracker.register_parity(self.shuffle_id, uri, gid, map_id,
                                        idx, scheme, k, m)
            except Exception as e:  # noqa: BLE001 — coverage is advisory
                log.warning("parity registration of shuffle %d map %d "
                            "failed (%s)", self.shuffle_id, map_id, e)
            with _push_lock:
                _REDUNDANCY["parity_pushes"] += 1
                _REDUNDANCY["parity_push_bytes"] += sum(
                    len(p) for p in payloads)
                _REDUNDANCY["parity_raw_bytes"] += sum(len(b) for b in row)
            return
        log.warning("no live peer took parity for shuffle %d map %d",
                    self.shuffle_id, map_id)
        with _push_lock:
            _REDUNDANCY["parity_failed"] += 1

    def _push_row(self, env, map_id: int, row: list, task_context) -> None:
        """shuffle_plan="push": each bucket to its reduce partition's
        owner, one push_merged round trip per owner (the owner that is
        this executor is fed in process). Only a named monoid's VN01 row
        is pushed: the owner pre-merges it. After two failed owners the
        rest of the row is left to the pull plan at once."""
        if not is_mergeable(self.aggregator) \
                or not row or row[0][:4] != NATIVE_MAGIC:
            return
        peers = resolve_push_peers(env.map_output_tracker)
        if not peers:
            return
        by_owner: dict = {}
        for reduce_id, blob in enumerate(row):
            by_owner.setdefault(push_owner_of(peers, reduce_id),
                                []).append((reduce_id, blob))
        attempt = getattr(task_context, "attempt_id", 0) or 0
        op_name = self.aggregator.op_name
        slow_s = float(env.conf.fetch_slow_server_s or 0.0)
        totals = {"merged": 0, "stored": 0, "duplicate": 0}
        failed = 0
        failed_owners = 0
        t0 = time.monotonic()
        from vega_tpu_torch.distributed.shuffle_server import (
            push_merged_remote)
        from vega_tpu_torch.errors import NetworkError

        for uri, entries in by_owner.items():
            if failed_owners >= 2:
                failed += len(entries)
                continue
            try:
                if uri == env.shuffle_server.uri:
                    counts = env.shuffle_server.premerge.feed_row(
                        self.shuffle_id, map_id, attempt, op_name, entries)
                else:
                    counts = push_merged_remote(
                        uri, self.shuffle_id, map_id, attempt, op_name,
                        entries, deadline_s=slow_s or None)
                for key in totals:
                    totals[key] += int(counts.get(key, 0))
            except Exception as e:  # noqa: BLE001 — a push never fails the task
                failed += len(entries)
                failed_owners += 1
                log.warning("push of shuffle %d map %d to %s failed (%s); "
                            "those buckets are pulled instead",
                            self.shuffle_id, map_id, uri, e,
                            exc_info=not isinstance(e, NetworkError))
                _invalidate_peer_cache()
        wall = time.monotonic() - t0
        nbytes = sum(len(b) for b in row)
        with _push_lock:
            _PUSH_TOTALS["pushes"] += 1
            _PUSH_TOTALS["buckets"] += len(row)
            _PUSH_TOTALS["bytes"] += nbytes
            _PUSH_TOTALS["merged"] += totals["merged"]
            _PUSH_TOTALS["stored"] += totals["stored"]
            _PUSH_TOTALS["duplicates"] += totals["duplicate"]
            _PUSH_TOTALS["failed"] += failed
            _PUSH_TOTALS["wall_s"] += wall
        sink = env.fetch_event_sink
        if sink is not None:
            try:
                from vega_tpu_torch.scheduler.events import (
                    ShufflePushCompleted)

                sink(ShufflePushCompleted(
                    shuffle_id=self.shuffle_id, map_id=map_id,
                    buckets=len(row), nbytes=nbytes,
                    merged=totals["merged"], stored=totals["stored"],
                    duplicates=totals["duplicate"], failed=failed,
                    targets=len(by_owner), wall_s=wall))
            except Exception:  # noqa: BLE001 — observability never breaks the task
                log.debug("push event emit failed", exc_info=True)


def _bucket(dep: ShuffleDependency, rows: list, buckets: List[dict]) -> None:
    """One map partition's rows into its buckets, combined."""
    parts = dep.partitioner.get_partitions([kv[0] for kv in rows])
    if dep.aggregator.is_group:
        # the list-collecting aggregator's create / merge, inlined
        for (k, v), p in zip(rows, parts):
            bucket = buckets[p]
            got = bucket.get(k)
            if got is None:
                bucket[k] = [v]
            else:
                got.append(v)
        return
    create = dep.aggregator.create_combiner
    merge = dep.aggregator.merge_value
    for (k, v), p in zip(rows, parts):
        bucket = buckets[p]
        if k in bucket:
            bucket[k] = merge(bucket[k], v)
        else:
            bucket[k] = create(v)
