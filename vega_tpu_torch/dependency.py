"""Lineage edges: the port's copy of the dependency objects of
vega_tpu/dependency.py.

A narrow dependency names the parent partitions one child partition reads
(OneToOne, Range for union, ManyToOne for coalesce and cartesian); a
ShuffleDependency is a stage boundary holding the parent, the aggregator
of the map-side combine and the output partitioner; its do_shuffle_task
is a map task's body (scheduler/task.py ShuffleMapTask): the parent
partition bucketed by the partitioner, combined per bucket, each bucket
pickled into the Context's shuffle store (shuffle/store.py) (an
executor's own store in mode="distributed"). This is the reference's
pure-Python path, the one it takes without its native library. Under
shuffle_replication = k > 1 an executor's map task also pushes its bucket
row to k - 1 live peers (one put_many round trip each, peers rotated by
map id) and returns the ordered location list, the primary first; a
failed push leaves fewer replicas and never fails the task. The
reference's push and parity planes wait for ROADMAP queue 1 items 7-8."""

from __future__ import annotations

import logging
import threading
import time
from typing import TYPE_CHECKING, List

from vega_tpu_torch import serialization
from vega_tpu_torch.aggregator import Aggregator
from vega_tpu_torch.partitioner import Partitioner

if TYPE_CHECKING:
    from vega_tpu_torch.rdd.base import RDD

log = logging.getLogger(__name__)

# the live peers' shuffle servers, per process and tracker: a map stage
# asks the driver once per _PEER_CACHE_TTL_S, not once per task; a failed
# push drops it
_PEER_CACHE_TTL_S = 5.0
_peer_cache: dict = {"tracker": None, "peers": None, "expires": 0.0}

# replica bytes pushed by this process (an executor's worker_stats)
_push_lock = threading.Lock()
_REDUNDANCY = {"replica_pushes": 0, "replica_push_bytes": 0}


def redundancy_stats_snapshot() -> dict:
    with _push_lock:
        return dict(_REDUNDANCY)


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
        """Map-side combine of one parent partition: bucket its rows by
        the partitioner (hashed in one numpy pass for int keys,
        partitioner.get_partitions), combine each bucket (first-seen key
        order), pickle each bucket into the shuffle store under
        (shuffle_id, map id, reduce id). Returns the map task's result:
        ("local", per-reduce bucket bytes)."""
        env = self.rdd.context.env
        rows = list(self.rdd.iterator(split, task_context))
        buckets = [dict() for _ in range(self.partitioner.num_partitions)]
        _bucket(self, rows, buckets)
        row = [serialization.dumps_data(list(bucket.items()))
               for bucket in buckets]
        store = env.shuffle_store
        for reduce_id, blob in enumerate(row):
            store.put(self.shuffle_id, split.index, reduce_id, blob)
        return self._publish(env, split.index, row)

    def _publish(self, env, map_id: int, row: list) -> tuple:
        """The stored bucket row as the map task's result: its
        location(s) and each bucket's bytes."""
        return (self._publish_locs(env, map_id, row), [len(b) for b in row])

    def _publish_locs(self, env, map_id: int, row: list):
        """This output's location: "local" in a driver's process, the
        executor's shuffle server in mode="distributed", and with
        shuffle_replication = k > 1 the list of it and up to k - 1 peers
        the row was pushed to."""
        server = env.shuffle_server
        if server is None:
            return "local"
        primary = server.uri
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
