"""Cached-partition locations and get_or_compute: the port's copy of
vega_tpu/cache_tracker.py.

RDD.iterator calls get_or_compute for a persisted node: the partition is
read from the Context's tiered cache (store/tiered.py) or computed once,
under a per-partition lock so two tasks never compute the same cached
partition twice, put into the cache at the node's StorageLevel and its
location (the executor's id, "local" in the driver's process)
registered with the CacheTracker (from an executor over the driver
service, distributed/driver_service.py)."""

from __future__ import annotations

import threading
from typing import Dict, List

from vega_tpu_torch.cache import KeySpace
from vega_tpu_torch.lint.sync_witness import named_lock


class CacheTracker:
    def __init__(self):
        # rdd_id -> partition -> [locations]
        self._locs: Dict[int, Dict[int, List[str]]] = {}
        # also the guard of the per-partition locks (vega_tpu's
        # cache_tracker._loading_guard)
        self._lock = named_lock("cache_tracker.CacheTracker._lock")
        # per-partition materialization locks (get_or_compute): plain, as
        # vega_tpu's are — one name for all of them would read a nested
        # get_or_compute of another partition as a self-deadlock
        self._loading: Dict[tuple, threading.Lock] = {}

    def register_rdd(self, rdd_id: int, num_partitions: int) -> None:
        with self._lock:
            self._locs.setdefault(rdd_id, {})

    def unregister_rdd(self, rdd_id: int) -> None:
        with self._lock:
            self._locs.pop(rdd_id, None)

    def add_host(self, rdd_id: int, partition: int, host: str) -> None:
        with self._lock:
            hosts = self._locs.setdefault(rdd_id, {}).setdefault(partition,
                                                                 [])
            if host not in hosts:
                hosts.insert(0, host)

    def drop_executor(self, executor_id: str) -> int:
        """A lost executor dropped from every cached partition's
        locations; returns the entries removed."""
        removed = 0
        with self._lock:
            for parts in self._locs.values():
                for p, hosts in parts.items():
                    if executor_id in hosts:
                        parts[p] = [h for h in hosts if h != executor_id]
                        removed += 1
        return removed

    def get_location_snapshot(self) -> Dict[int, Dict[int, List[str]]]:
        with self._lock:
            return {rdd: {p: list(hosts) for p, hosts in parts.items()}
                    for rdd, parts in self._locs.items()}

    def get_cache_locs(self, rdd_id: int, partition: int) -> List[str]:
        with self._lock:
            return list(self._locs.get(rdd_id, {}).get(partition, []))

    def loading_lock(self, key: tuple) -> threading.Lock:
        with self._lock:
            return self._loading.setdefault(key, threading.Lock())


def get_or_compute(rdd, split, task_context=None):
    """The persisted partition's rows: from the cache, else computed,
    cached at rdd.storage_level and registered."""
    env = rdd.context.env
    key = (KeySpace.RDD, rdd.rdd_id, split.index)
    cached = env.cache.get(*key)
    if cached is not None:
        return iter(cached)
    tracker = env.cache_tracker
    with tracker.loading_lock(key):
        cached = env.cache.get(*key)
        if cached is not None:
            return iter(cached)
        data = list(rdd.compute(split, task_context))
        env.cache.put(KeySpace.RDD, rdd.rdd_id, split.index, data,
                      level=rdd.storage_level)
        tracker.add_host(rdd.rdd_id, split.index, env.executor_id or "local")
        return iter(data)
