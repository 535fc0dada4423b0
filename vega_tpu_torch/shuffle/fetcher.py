"""Reduce-side shuffle fetch: the port's copy of the "local" path of
vega_tpu/shuffle/fetcher.py.

fetch_stream(env, shuffle_id, reduce_id) looks up every map output's
locations in the tracker and reads its bucket for reduce_id from this
process's shuffle store, in map-id order (the reference's local tier
reads them so). A bucket the store does not hold (dropped, or corrupt on
disk) raises FetchFailedError naming it, which the DAG scheduler turns
into unregistering that output and resubmitting its map stage. Each
finished stream posts ShuffleFetchCompleted (buckets, bytes, wall;
round_trips 0: nothing crosses a network). The reference's remote
locations, batched round trips, replica failover and parity decoding
belong to its distributed backend."""

from __future__ import annotations

import time
from typing import Iterator

from vega_tpu_torch import serialization
from vega_tpu_torch.errors import (FetchFailedError, MapOutputError,
                                   ShuffleError)


class ShuffleFetcher:
    @staticmethod
    def fetch_stream(env, shuffle_id: int, reduce_id: int) -> Iterator[bytes]:
        """The raw buckets of reduce_id, one map output at a time."""
        try:
            uri_lists = env.map_output_tracker.get_server_uri_lists(
                shuffle_id)
        except MapOutputError as e:
            raise FetchFailedError(
                None, shuffle_id, None, reduce_id,
                f"map output locations unavailable: {e}") from e
        return ShuffleFetcher._stream(env, uri_lists, shuffle_id, reduce_id)

    @staticmethod
    def _stream(env, uri_lists, shuffle_id: int,
                reduce_id: int) -> Iterator[bytes]:
        t0 = time.monotonic()
        store = env.shuffle_store
        nbytes = 0
        for map_id, locs in enumerate(uri_lists):
            uri = locs[0] if locs else None
            if uri != "local":
                raise ShuffleError(
                    f"shuffle {shuffle_id} map {map_id}: location {uri!r} "
                    "is not this process's store")
            data = store.get(shuffle_id, map_id, reduce_id)
            if data is None:
                raise FetchFailedError(uri, shuffle_id, map_id, reduce_id,
                                       "bucket missing from local store")
            nbytes += len(data)
            yield data
        sink = env.fetch_event_sink
        if sink is not None:
            from vega_tpu_torch.scheduler.events import ShuffleFetchCompleted

            sink(ShuffleFetchCompleted(
                shuffle_id=shuffle_id, reduce_id=reduce_id,
                buckets=len(uri_lists), nbytes=nbytes, round_trips=0,
                wall_s=time.monotonic() - t0))

    @staticmethod
    def fetch(env, shuffle_id: int, reduce_id: int) -> Iterator[tuple]:
        """Every (K, C) row for reduce_id, each bucket unpickled as it is
        read."""
        for blob in ShuffleFetcher.fetch_stream(env, shuffle_id, reduce_id):
            yield from serialization.loads(blob)
