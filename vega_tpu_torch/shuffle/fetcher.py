"""Reduce-side shuffle fetch: the port's copy of vega_tpu/shuffle/fetcher.py
without its push-plan and coded-shuffle rungs.

fetch_stream(env, shuffle_id, reduce_id) looks up every map output's
ordered location list in the tracker (over the driver service on an
executor) and yields its bucket for reduce_id. A location that is this
process's store ("local", or the executor's own shuffle server) is read
in-process; the others are fetched from their executors' shuffle servers
(distributed/shuffle_server.py) by fetch threads, one batched get_many
round trip per server (one get per bucket under fetch_batch_enabled
False), into a queue of at most fetch_queue_buckets buckets that the
reduce task merges from while later buckets are still on the wire.

Recovery: a dropped connection is retried in place (fetch_retries); a
server that then fails, or under fetch_slow_server_s does not answer,
fails its undelivered buckets over to their next replica location
(shuffle_replication > 1; FetchFailedOver, no resubmission). With no
replica left the locations are resolved once more (a lost executor's
outputs may have been recomputed elsewhere) and only the undelivered
buckets fetched again; if that fails too, FetchFailedError reaches the
DAG scheduler, which unregisters the output and resubmits its map stage.
A bucket is delivered once whatever the retries. Every stream posts
ShuffleFetchCompleted (buckets, bytes, round trips, wall) and adds to
this process's totals (stats_snapshot, an executor's worker_stats)."""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Iterator, List

from vega_tpu_torch import serialization
from vega_tpu_torch.errors import FetchFailedError, ShuffleError, VegaError

log = logging.getLogger(__name__)


class _AbandonedStream(Exception):
    """The consumer closed the stream: the fetch threads unwind."""


# each fetch thread enqueues one when it ends, so the consumer's drain
# ends with the last of them
_PRODUCER_DONE = object()

_totals_lock = threading.Lock()
_TOTALS = {
    "streams": 0, "buckets": 0, "bytes": 0, "round_trips": 0,
    "net_s": 0.0, "wait_s": 0.0, "overlap_s": 0.0, "wall_s": 0.0,
    "peak_queued": 0, "duplicates": 0, "failovers": 0,
    "failover_buckets": 0,
}


def stats_snapshot() -> dict:
    """This process's fetch totals since the last reset."""
    with _totals_lock:
        return dict(_TOTALS)


def reset_stats() -> None:
    with _totals_lock:
        for k in _TOTALS:
            _TOTALS[k] = 0 if isinstance(_TOTALS[k], int) else 0.0


def _bank_totals(stats: dict) -> None:
    with _totals_lock:
        _TOTALS["streams"] += 1
        for k in ("buckets", "bytes", "round_trips", "net_s", "wait_s",
                  "overlap_s", "wall_s", "duplicates", "failovers",
                  "failover_buckets"):
            _TOTALS[k] += stats[k]
        if stats["peak_queued"] > _TOTALS["peak_queued"]:
            _TOTALS["peak_queued"] = stats["peak_queued"]


def _is_local(env, uri: str) -> bool:
    server = env.shuffle_server
    return uri == "local" or (server is not None and uri == server.uri)


def _post(env, event) -> None:
    sink = env.fetch_event_sink
    if sink is not None:
        try:
            sink(event)
        except Exception:  # noqa: BLE001 — observability never breaks IO
            log.debug("fetch event emit failed", exc_info=True)


class ShuffleFetcher:
    @staticmethod
    def fetch_stream(env, shuffle_id: int, reduce_id: int) -> Iterator[bytes]:
        """The raw buckets of reduce_id, as they arrive."""
        try:
            uri_lists = env.map_output_tracker.get_server_uri_lists(
                shuffle_id)
        except VegaError as e:
            # outputs lost and not yet recomputed: FetchFailedError makes
            # the scheduler resubmit the map stage
            raise FetchFailedError(
                None, shuffle_id, None, reduce_id,
                f"map output locations unavailable: {e}") from e
        uri_lists = [list(lst) for lst in uri_lists]
        if all(lst and _is_local(env, lst[0]) for lst in uri_lists):
            return ShuffleFetcher._local_stream(env, uri_lists, shuffle_id,
                                                reduce_id)
        return ShuffleFetcher._stream(env, uri_lists, shuffle_id, reduce_id)

    @staticmethod
    def _local_stream(env, uri_lists, shuffle_id: int,
                      reduce_id: int) -> Iterator[bytes]:
        """Every bucket in this process's store, in map-id order."""
        t0 = time.monotonic()
        store = env.shuffle_store
        nbytes = 0
        for map_id, locs in enumerate(uri_lists):
            data = store.get(shuffle_id, map_id, reduce_id)
            if data is None:
                raise FetchFailedError(locs[0], shuffle_id, map_id,
                                       reduce_id,
                                       "bucket missing from local store")
            nbytes += len(data)
            yield data
        from vega_tpu_torch.scheduler.events import ShuffleFetchCompleted

        _post(env, ShuffleFetchCompleted(
            shuffle_id=shuffle_id, reduce_id=reduce_id,
            buckets=len(uri_lists), nbytes=nbytes, round_trips=0,
            wall_s=time.monotonic() - t0))

    @staticmethod
    def _stream(env, uri_lists: List[List[str]], shuffle_id: int,
                reduce_id: int) -> Iterator[bytes]:
        from vega_tpu_torch.distributed.shuffle_server import (
            fetch_many_remote, fetch_remote)

        conf = env.conf
        tracker = env.map_output_tracker
        batched = bool(conf.fetch_batch_enabled)
        maxq = max(1, int(conf.fetch_queue_buckets))
        slow_s = float(conf.fetch_slow_server_s or 0.0)
        stats = {"buckets": 0, "bytes": 0, "round_trips": 0, "net_s": 0.0,
                 "wait_s": 0.0, "peak_queued": 0, "duplicates": 0,
                 "failovers": 0, "failover_buckets": 0}
        t_start = time.monotonic()
        delivered = set()
        total = len(uri_lists)
        # per map output, its place in its location list (failover moves
        # it to the next replica)
        cursor = [0] * total
        abandoned = {"flag": False}
        counter_lock = threading.Lock()
        resolved_once = False
        local_store = env.shuffle_store

        def current_uri(map_id: int):
            lst = uri_lists[map_id]
            return lst[cursor[map_id]] if cursor[map_id] < len(lst) else None

        def replicas_behind(map_id: int) -> bool:
            return cursor[map_id] + 1 < len(uri_lists[map_id])

        try:
            while True:
                local_ids: List[int] = []
                by_server: dict = {}
                for map_id in range(total):
                    if map_id in delivered:
                        continue
                    uri = current_uri(map_id)
                    if not uri:
                        raise FetchFailedError(
                            None, shuffle_id, map_id, reduce_id,
                            "missing map output location")
                    if _is_local(env, uri):
                        local_ids.append(map_id)
                    else:
                        by_server.setdefault(uri, []).append(map_id)
                # the slow-server deadline arms only for a server whose
                # every bucket has a replica to fail over to
                deadline_for = {
                    uri: (slow_s if slow_s and batched
                          and all(replicas_behind(m) for m in ids)
                          else None)
                    for uri, ids in by_server.items()}
                failures: List[FetchFailedError] = []
                threads: List[threading.Thread] = []
                q: "queue.Queue" = queue.Queue(maxsize=maxq)
                queued = {"n": 0}  # resident data buckets

                def _bounded_put(item, q=q):
                    # backpressure is the memory bound; an abandoned
                    # stream stops its fetch threads at the next bucket
                    while True:
                        if abandoned["flag"]:
                            raise _AbandonedStream()
                        try:
                            q.put(item, timeout=0.2)
                            return
                        except queue.Full:
                            pass

                def produce(assignments, failures=failures,
                            deadline_for=deadline_for, queued=queued):
                    t0 = time.monotonic()

                    def deliver(map_id, data):
                        with counter_lock:
                            queued["n"] += 1
                            if queued["n"] > stats["peak_queued"]:
                                stats["peak_queued"] = queued["n"]
                        try:
                            _bounded_put((map_id, data))
                        except _AbandonedStream:
                            with counter_lock:
                                queued["n"] -= 1
                            raise

                    try:
                        for uri, ids in assignments:
                            try:
                                if batched:
                                    rts = fetch_many_remote(
                                        uri, shuffle_id, ids, reduce_id,
                                        deliver,
                                        deadline_s=deadline_for.get(uri),
                                        conf=conf)
                                else:
                                    rts = 0
                                    for m in ids:
                                        data = fetch_remote(
                                            uri, shuffle_id, m, reduce_id,
                                            conf=conf)
                                        rts += 1
                                        deliver(m, data)
                                with counter_lock:
                                    stats["round_trips"] += rts
                            except FetchFailedError as e:
                                with counter_lock:
                                    failures.append(e)
                            except _AbandonedStream:
                                raise
                            except Exception:  # noqa: BLE001 — must reach the consumer
                                log.exception("unexpected shuffle-fetch "
                                              "failure from %s", uri)
                                with counter_lock:
                                    failures.append(FetchFailedError(
                                        uri, shuffle_id, ids[0], reduce_id,
                                        "unexpected fetch error (see log)"))
                    except _AbandonedStream:
                        return
                    finally:
                        with counter_lock:
                            stats["net_s"] += time.monotonic() - t0
                        try:
                            _bounded_put(_PRODUCER_DONE)
                        except _AbandonedStream:
                            pass

                # at most 16 fetch threads, each walking its servers in
                # turn
                n_workers = min(len(by_server), 16)
                lanes = [[] for _ in range(n_workers)]
                for i, item in enumerate(by_server.items()):
                    lanes[i % n_workers].append(item)
                for lane in lanes:
                    t = threading.Thread(target=produce, args=(lane,),
                                         name="shuffle-fetch", daemon=True)
                    threads.append(t)
                    t.start()

                # this process's buckets, one at a time, while the fetch
                # threads fill the queue
                for map_id in local_ids:
                    data = local_store.get(shuffle_id, map_id, reduce_id)
                    if data is None:
                        with counter_lock:
                            failures.append(FetchFailedError(
                                current_uri(map_id), shuffle_id, map_id,
                                reduce_id,
                                "bucket missing from local store"))
                        continue
                    delivered.add(map_id)
                    stats["buckets"] += 1
                    stats["bytes"] += len(data)
                    yield data

                ended = 0
                while ended < len(threads):
                    t_w = time.monotonic()
                    try:
                        item = q.get(timeout=0.2)
                    except queue.Empty:
                        stats["wait_s"] += time.monotonic() - t_w
                        continue
                    stats["wait_s"] += time.monotonic() - t_w
                    if item is _PRODUCER_DONE:
                        ended += 1
                        continue
                    map_id, data = item
                    with counter_lock:
                        queued["n"] -= 1
                    if map_id in delivered:
                        stats["duplicates"] += 1
                        log.warning("duplicate shuffle bucket suppressed: "
                                    "shuffle=%d map=%d reduce=%d",
                                    shuffle_id, map_id, reduce_id)
                        continue
                    delivered.add(map_id)
                    stats["buckets"] += 1
                    stats["bytes"] += len(data)
                    yield data
                for t in threads:
                    t.join(timeout=5.0)

                if not failures:
                    break
                # replica failover first: an undelivered bucket whose
                # server just failed moves to its next location
                failed_uris = {f.server_uri for f in failures
                               if f.server_uri}
                moved: dict = {}
                for map_id in range(total):
                    if map_id in delivered:
                        continue
                    uri = current_uri(map_id)
                    if uri in failed_uris and replicas_behind(map_id):
                        cursor[map_id] += 1
                        moved[uri] = moved.get(uri, 0) + 1
                if moved:
                    from vega_tpu_torch.scheduler.events import (
                        FetchFailedOver)

                    stats["failovers"] += len(moved)
                    stats["failover_buckets"] += sum(moved.values())
                    for from_uri, n in moved.items():
                        log.warning(
                            "shuffle %d reduce %d: failing %d undelivered "
                            "bucket(s) over from %s to replica locations",
                            shuffle_id, reduce_id, n, from_uri)
                        _post(env, FetchFailedOver(
                            shuffle_id=shuffle_id, reduce_id=reduce_id,
                            from_uri=from_uri, buckets=n))
                    continue
                failure = failures[0]
                if resolved_once:
                    raise failure
                resolved_once = True
                log.info("fetch of shuffle %d failed mid-stream (%s); "
                         "resolving the locations once more for the %d "
                         "undelivered buckets", shuffle_id, failure,
                         total - len(delivered))
                try:
                    uri_lists = [list(lst) for lst in
                                 tracker.get_server_uri_lists(shuffle_id,
                                                              timeout=5.0)]
                    cursor = [0] * total
                except VegaError:
                    # no new homes yet: only the scheduler's resubmission
                    # makes them, and it needs this FetchFailedError
                    raise failure from None

            if len(delivered) != total:
                raise ShuffleError(
                    f"shuffle {shuffle_id} reduce {reduce_id}: "
                    f"{total - len(delivered)} buckets never delivered")
        finally:
            abandoned["flag"] = True

        wall = time.monotonic() - t_start
        stats["wall_s"] = wall
        # fetch time hidden behind the consumer's merge (net_s sums over
        # concurrent threads, so it is clamped to the wall)
        stats["overlap_s"] = min(max(0.0, stats["net_s"] - stats["wait_s"]),
                                 wall)
        _bank_totals(stats)
        from vega_tpu_torch.scheduler.events import ShuffleFetchCompleted

        _post(env, ShuffleFetchCompleted(
            shuffle_id=shuffle_id, reduce_id=reduce_id,
            buckets=stats["buckets"], nbytes=stats["bytes"],
            round_trips=stats["round_trips"], wall_s=wall))

    @staticmethod
    def fetch_blobs(env, shuffle_id: int, reduce_id: int) -> List[bytes]:
        """Every bucket of reduce_id, materialized."""
        return list(ShuffleFetcher.fetch_stream(env, shuffle_id, reduce_id))

    @staticmethod
    def fetch(env, shuffle_id: int, reduce_id: int) -> Iterator[tuple]:
        """Every (K, C) row for reduce_id, each bucket unpickled as it is
        read."""
        for blob in ShuffleFetcher.fetch_stream(env, shuffle_id, reduce_id):
            yield from serialization.loads(blob)

    @staticmethod
    def fetch_into(env, shuffle_id: int, reduce_id: int, merge) -> dict:
        """Every row of reduce_id folded into a combiner dict."""
        out: dict = {}
        for kv in ShuffleFetcher.fetch(env, shuffle_id, reduce_id):
            merge(out, kv)
        return out
