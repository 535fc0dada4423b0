"""Reduce-side shuffle fetch: the port's copy of
vega_tpu/shuffle/fetcher.py.

fetch_stream(env, shuffle_id, reduce_id) looks up every map output's
ordered location list in the tracker (over the driver service on an
executor) and yields its bucket for reduce_id. A location that is this
process's store ("local", or the executor's own shuffle server) is read
in-process; the others are fetched from their executors' shuffle servers
(distributed/shuffle_server.py) by fetch threads, one batched get_many
round trip per server (one get per bucket under fetch_batch_enabled
False), into a queue of at most fetch_queue_buckets buckets that the
reduce task merges from while later buckets are still on the wire.

Under shuffle_plan="push" a mergeable shuffle's stream first reads the
reduce partition's owner's pre-merge tier (shuffle/premerge.py): in
process when this executor owns it (local_blob_reads), else one
get_merged round trip (merged_rtts). Its frozen VN01 blob covers the map
outputs that arrived pushed, and the pull rounds fetch only the rest; a
failed read leaves every bucket to the pull plan.

Recovery: a dropped connection is retried in place (fetch_retries); a
server that then fails, or under fetch_slow_server_s does not answer,
fails its undelivered buckets over to their next replica location
(shuffle_replication > 1; FetchFailedOver, no resubmission). Under
shuffle_coding a bucket with no location left, or on a "coded:"
pseudo-location the tracker put there when its server was lost, is
decoded from its parity group's surviving members and parity frames
(_reconstruct, coding.decode_group; coded_failovers, parity_decodes).
With neither, the locations are resolved once more (a lost executor's
outputs may have been recomputed elsewhere) and only the undelivered
buckets fetched again; if that fails too, FetchFailedError reaches the
DAG scheduler, which unregisters the output and resubmits its map stage.
A bucket is delivered once whatever the retries. Every stream posts
ShuffleFetchCompleted and adds to this process's totals (stats_snapshot,
an executor's worker_stats)."""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Iterator, List

from vega_tpu_torch import serialization
from vega_tpu_torch.dependency import is_push_plan
from vega_tpu_torch.errors import FetchFailedError, ShuffleError, VegaError
from vega_tpu_torch.lint.sync_witness import named_lock, note_thread_role

log = logging.getLogger(__name__)


class _AbandonedStream(Exception):
    """The consumer closed the stream: the fetch threads unwind."""


# each fetch thread enqueues one when it ends, so the consumer's drain
# ends with the last of them
_PRODUCER_DONE = object()

_totals_lock = named_lock("shuffle.fetcher._totals_lock")
_TOTALS = {
    "streams": 0, "buckets": 0, "bytes": 0, "round_trips": 0,
    "net_s": 0.0, "wait_s": 0.0, "overlap_s": 0.0, "wall_s": 0.0,
    "peak_queued": 0, "duplicates": 0, "failovers": 0,
    "failover_buckets": 0, "premerged": 0, "local_blob_reads": 0,
    "merged_rtts": 0, "coded_failovers": 0, "parity_decodes": 0,
    "decode_bytes": 0,
}

_SUMMED = ("buckets", "bytes", "round_trips", "net_s", "wait_s",
           "overlap_s", "wall_s", "duplicates", "failovers",
           "failover_buckets", "premerged", "local_blob_reads",
           "merged_rtts", "coded_failovers", "parity_decodes",
           "decode_bytes")


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
        for k in _SUMMED:
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
    def fetch_stream(env, shuffle_id: int, reduce_id: int,
                     mergeable: bool = False) -> Iterator[bytes]:
        """The raw buckets of reduce_id, as they arrive. mergeable (a
        named monoid's shuffle) lets the push plan's pre-merged read run
        first."""
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
        if not (mergeable and is_push_plan(env.conf)) and \
                all(lst and _is_local(env, lst[0]) for lst in uri_lists):
            return ShuffleFetcher._local_stream(env, uri_lists, shuffle_id,
                                                reduce_id)
        return ShuffleFetcher._stream(env, uri_lists, shuffle_id, reduce_id,
                                      mergeable)

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
                reduce_id: int, mergeable: bool = False) -> Iterator[bytes]:
        from vega_tpu_torch.distributed.shuffle_server import (
            fetch_many_remote, fetch_remote)

        conf = env.conf
        tracker = env.map_output_tracker
        batched = bool(conf.fetch_batch_enabled)
        maxq = max(1, int(conf.fetch_queue_buckets))
        slow_s = float(conf.fetch_slow_server_s or 0.0)
        stats = {"buckets": 0, "bytes": 0, "round_trips": 0, "net_s": 0.0,
                 "wait_s": 0.0, "peak_queued": 0, "duplicates": 0,
                 "failovers": 0, "failover_buckets": 0, "premerged": 0,
                 "local_blob_reads": 0, "merged_rtts": 0,
                 "coded_failovers": 0, "parity_decodes": 0,
                 "decode_bytes": 0}
        t_start = time.monotonic()
        delivered = set()
        total = len(uri_lists)
        # per map output, its place in its location list (failover moves
        # it to the next replica)
        cursor = [0] * total
        abandoned = {"flag": False}
        counter_lock = named_lock("shuffle.fetcher.stream_counters")
        resolved_once = False
        # buckets whose decode failed since the last resolve: not tried
        # again until the locations are resolved anew
        coded_failed: set = set()
        local_store = env.shuffle_store

        def current_uri(map_id: int):
            lst = uri_lists[map_id]
            return lst[cursor[map_id]] if cursor[map_id] < len(lst) else None

        def replicas_behind(map_id: int) -> bool:
            return cursor[map_id] + 1 < len(uri_lists[map_id])

        try:
            if mergeable and is_push_plan(conf):
                merged_ids, blob, raws = _read_premerged(
                    env, tracker, shuffle_id, reduce_id, slow_s, stats)
                # the blob counts only when every id it claims is a map
                # output not yet delivered: its rows are merged together
                if blob is not None and merged_ids and all(
                        0 <= m < total and m not in delivered
                        for m in merged_ids):
                    delivered.update(merged_ids)
                    stats["buckets"] += len(merged_ids)
                    stats["premerged"] += len(merged_ids)
                    stats["bytes"] += len(blob)
                    yield blob
                for m, data in raws:
                    if 0 <= m < total and m not in delivered:
                        delivered.add(m)
                        stats["buckets"] += 1
                        stats["bytes"] += len(data)
                        yield data
            while True:
                local_ids: List[int] = []
                by_server: dict = {}
                coded_pending: List[int] = []
                for map_id in range(total):
                    if map_id in delivered:
                        continue
                    uri = current_uri(map_id)
                    if not uri:
                        raise FetchFailedError(
                            None, shuffle_id, map_id, reduce_id,
                            "missing map output location")
                    if uri.startswith("coded:"):
                        # a claim on parity: decoded after the rounds
                        coded_pending.append(map_id)
                    elif _is_local(env, uri):
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
                    note_thread_role("fetch-producer")
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

                if not failures and not coded_pending:
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
                # then the coded rung: buckets on a coded: location, and
                # those whose last location just failed, are decoded
                # from their parity groups
                recover = [m for m in coded_pending
                           if m not in coded_failed and m not in delivered]
                for map_id in range(total):
                    if (map_id in delivered or map_id in recover
                            or map_id in coded_failed):
                        continue
                    uri = current_uri(map_id)
                    if (uri and not uri.startswith("coded:")
                            and uri in failed_uris
                            and not replicas_behind(map_id)):
                        recover.append(map_id)
                recovered_n = 0
                if recover:
                    t_rec = time.monotonic()
                    recovered, failed_now = _reconstruct(
                        env, tracker, uri_lists, shuffle_id, reduce_id,
                        recover, failed_uris, stats)
                    dt = time.monotonic() - t_rec
                    stats["net_s"] += dt
                    stats["wait_s"] += dt
                    coded_failed.update(failed_now)
                    if recovered:
                        stats["coded_failovers"] += 1
                    for map_id, data in sorted(recovered.items()):
                        if map_id in delivered:
                            stats["duplicates"] += 1
                            continue
                        delivered.add(map_id)
                        stats["buckets"] += 1
                        stats["bytes"] += len(data)
                        recovered_n += 1
                        yield data
                if moved or recovered_n:
                    continue
                if not failures:
                    bad = next(m for m in coded_pending
                               if m not in delivered)
                    raise FetchFailedError(
                        None, shuffle_id, bad, reduce_id,
                        "coded reconstruction failed and no location "
                        "serves the bucket")
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
                    coded_failed.clear()
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
            round_trips=stats["round_trips"], wall_s=wall,
            net_s=stats["net_s"], overlap_s=stats["overlap_s"],
            batched=batched, premerged_buckets=stats["premerged"],
            local_blob_reads=stats["local_blob_reads"],
            merged_rtts=stats["merged_rtts"],
            coded_failovers=stats["coded_failovers"],
            parity_decodes=stats["parity_decodes"],
            decode_bytes=stats["decode_bytes"]))

    @staticmethod
    def fetch_blobs(env, shuffle_id: int, reduce_id: int,
                    mergeable: bool = False) -> List[bytes]:
        """Every bucket of reduce_id, materialized."""
        return list(ShuffleFetcher.fetch_stream(env, shuffle_id, reduce_id,
                                                mergeable=mergeable))

    @staticmethod
    def fetch(env, shuffle_id: int, reduce_id: int,
              mergeable: bool = False) -> Iterator[tuple]:
        """Every (K, C) row for reduce_id, each bucket decoded as it is
        read: a VN01 frame's pairs, a VG01 frame's rows as singleton
        lists (the group's combiners), a pickled bucket's pairs."""
        from vega_tpu_torch.dependency import (NATIVE_GROUP_MAGIC,
                                               NATIVE_MAGIC)

        for blob in ShuffleFetcher.fetch_stream(env, shuffle_id, reduce_id,
                                                mergeable=mergeable):
            magic = blob[:4]
            if magic in (NATIVE_MAGIC, NATIVE_GROUP_MAGIC):
                from vega_tpu_torch import native

                rows = native.decode(blob[5:], blob[4] == 1)
                if magic == NATIVE_GROUP_MAGIC:
                    for k, v in rows:
                        yield (k, [v])
                else:
                    yield from rows
            else:
                yield from serialization.loads(blob)

    @staticmethod
    def fetch_into(env, shuffle_id: int, reduce_id: int, merge) -> dict:
        """Every row of reduce_id folded into a combiner dict."""
        out: dict = {}
        for kv in ShuffleFetcher.fetch(env, shuffle_id, reduce_id):
            merge(out, kv)
        return out


def _read_premerged(env, tracker, shuffle_id: int, reduce_id: int,
                    slow_s: float, stats: dict):
    """The push plan's read of the reduce partition's owner: (merged map
    ids, frozen blob or None, [(map id, raw pushed bucket)]), in process
    when this executor owns the partition, else over one get_merged round
    trip under fetch_slow_server_s (or the push deadline). Any failure
    reads as nothing pushed: the pull plan serves every bucket."""
    from vega_tpu_torch.dependency import push_owner_uri
    from vega_tpu_torch.distributed.shuffle_server import fetch_merged_remote

    owner = push_owner_uri(tracker, reduce_id)
    if owner is None:
        return [], None, []
    t_net = time.monotonic()
    try:
        if env.shuffle_server is not None \
                and owner == env.shuffle_server.uri:
            got = env.shuffle_server.premerge.read(shuffle_id, reduce_id)
            stats["local_blob_reads"] += 1
        else:
            got = fetch_merged_remote(owner, shuffle_id, reduce_id,
                                      deadline_s=slow_s or None)
            stats["round_trips"] += 1
            stats["merged_rtts"] += 1
    except Exception as e:  # noqa: BLE001 — the read is an optimization
        log.warning("pre-merged read of shuffle %d reduce %d from %s failed "
                    "(%s); every bucket is pulled", shuffle_id, reduce_id,
                    owner, e)
        got = [], None, []
    dt = time.monotonic() - t_net
    # the consumer waited for all of it
    stats["net_s"] += dt
    stats["wait_s"] += dt
    return got


def _fetch_survivor(env, uri_lists, shuffle_id: int, map_id: int,
                    reduce_id: int, failed_uris):
    """A surviving member's bucket for a decode: its real locations in
    order (coded: and failed ones skipped), this process's store in
    process, the others over get. None when no copy answers."""
    from vega_tpu_torch.distributed.shuffle_server import fetch_remote

    for uri in uri_lists[map_id]:
        if not uri or uri.startswith("coded:") or uri in failed_uris:
            continue
        if _is_local(env, uri):
            data = env.shuffle_store.get(shuffle_id, map_id, reduce_id)
            if data is not None:
                return data
            continue
        try:
            return fetch_remote(uri, shuffle_id, map_id, reduce_id,
                                conf=env.conf)
        except VegaError as e:
            log.warning("survivor fetch of shuffle %d map %d from %s failed "
                        "during a decode (%s)", shuffle_id, map_id, uri, e)
    return None


def _decode_device(env):
    """The device a decode's GF(256) accumulation runs on: an executor's
    CPU, a driver's Context device."""
    return "cpu" if env.shuffle_server is not None else env.decode_device


def _reconstruct(env, tracker, uri_lists, shuffle_id: int, reduce_id: int,
                 wanted, failed_uris, stats):
    """The wanted buckets of reduce_id decoded from their parity groups:
    every parity frame of the group from its parity server, every
    surviving member's bucket from its locations, then
    coding.decode_group. The frames' headers decide the membership and
    the lengths; the tracker only names (parity server, group). Returns
    ({map id: bucket} with the survivors read on the way, the map ids
    that could not be decoded); never raises."""
    from vega_tpu_torch.distributed.shuffle_server import fetch_parity_remote
    from vega_tpu_torch.errors import NetworkError
    from vega_tpu_torch.shuffle import coding

    wanted = set(wanted)
    get_map = getattr(tracker, "get_parity_map", None)
    if get_map is None:
        return {}, set(wanted)
    try:
        pmap = get_map(shuffle_id)
    except Exception as e:  # noqa: BLE001 — a decode degrades, never raises
        log.warning("parity map lookup for shuffle %d failed (%s)",
                    shuffle_id, e)
        return {}, set(wanted)
    member_of = {}
    for key, g in pmap.items():
        for mid in g["members"]:
            member_of[mid] = key
    by_group: dict = {}
    failed: set = set()
    for mid in wanted:
        key = member_of.get(mid)
        if key is None:
            # the pseudo-location names its parity server and group
            for u in uri_lists[mid]:
                if u and u.startswith("coded:"):
                    puri, _, gid_s = u[len("coded:"):].rpartition("/")
                    try:
                        cand = (puri, int(gid_s))
                    except ValueError:
                        continue
                    if cand in pmap:
                        key = cand
                        break
        if key is None:
            failed.add(mid)
        else:
            by_group.setdefault(key, set()).add(mid)
    device = _decode_device(env)
    recovered: dict = {}
    for (puri, gid), missing in by_group.items():
        g = pmap[(puri, gid)]
        if puri in failed_uris:
            failed |= missing  # the parity died with its server
            continue
        frames = []
        try:
            for unit in range(int(g.get("m", 1))):
                fr = fetch_parity_remote(puri, shuffle_id, gid, unit,
                                         reduce_id)
                stats["round_trips"] += 1
                if fr is not None:
                    frames.append(fr)
        except NetworkError as e:
            log.warning("parity fetch of shuffle %d group %d from %s "
                        "failed (%s)", shuffle_id, gid, puri, e)
            failed |= missing
            continue
        if not frames:
            failed |= missing
            continue
        # equations combine only over one membership: the largest set of
        # frames that agree on it
        by_members: dict = {}
        for fr in frames:
            key = tuple(sorted(fr[1]["members"].items()))
            by_members.setdefault(key, []).append(fr)
        frames = max(by_members.values(), key=len)
        fmembers = dict(frames[0][1]["members"])  # {map_id: (idx, length)}
        scheme = frames[0][1].get("scheme", g.get("scheme", "xor"))
        k = int(frames[0][1].get("k", g.get("k", 2)))
        unknown = {m for m in missing if m not in fmembers}
        failed |= unknown
        need = missing - unknown
        if not need:
            continue
        survivors: dict = {}
        for mid in fmembers:
            if mid in need:
                continue
            data = _fetch_survivor(env, uri_lists, shuffle_id, mid,
                                   reduce_id, failed_uris)
            stats["round_trips"] += 1
            if data is None:
                need.add(mid)  # a lost survivor is one more unknown
            else:
                survivors[mid] = data
        if len(need) > len(frames):
            failed |= (need & missing)
            continue
        try:
            decoded = coding.decode_group(scheme, k, frames, fmembers,
                                          survivors, sorted(need),
                                          device=device)
        except Exception as e:  # noqa: BLE001 — an unsolvable group degrades
            log.warning("decode of shuffle %d group %d failed (%s)",
                        shuffle_id, gid, e)
            failed |= (need & missing)
            continue
        stats["parity_decodes"] += len(decoded)
        stats["decode_bytes"] += sum(len(d) for d in decoded.values())
        log.info("coded reconstruction: shuffle %d reduce %d group %d "
                 "decoded %d bucket(s) from %d survivor(s) and %d parity "
                 "unit(s)", shuffle_id, reduce_id, gid, len(decoded),
                 len(survivors), len(frames))
        recovered.update(decoded)
        recovered.update(survivors)
    return recovered, failed
