"""The local runtime's settings and services: the port's copy of
vega_tpu/env.py.

Configuration holds the reference's fields for the local runtime, with
its defaults; Context(**settings) takes each as a keyword and checks it
(check_runtime_settings; spill_dir is the Context's own keyword). Env
bundles what the reference's process singleton bundles for local mode:
the configuration, the shuffle store
(shuffle/store.py), the tiered partition cache (store/tiered.py), the
map-output tracker and the cache tracker, and the sink of the fetcher's
events. The port keeps one Env per Context (ctx.env), not one per
process: several port Contexts may live at once, each with its own
shuffles and cache, where the reference refuses a second Context.

A shuffle's buckets and its tracker entry go once the node that reads
them is collected (track_shuffle); the reference keeps them until its
Env stops. The collection only queues the shuffle id: the DAG scheduler
drops the queued shuffles at the start of its next job
(drain_released_shuffles), on a driver thread, never inside a collector
pass that may run under the store's lock.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import os
import weakref
from typing import List, Optional

from vega_tpu_torch.errors import VegaError


class DeploymentMode(enum.Enum):
    LOCAL = "local"
    DISTRIBUTED = "distributed"


@dataclasses.dataclass
class Configuration:
    """The reference's Configuration fields that the local runtime reads,
    with its defaults."""

    deployment_mode: DeploymentMode = DeploymentMode.LOCAL
    # task threads of the local backend
    num_workers: int = dataclasses.field(
        default_factory=lambda: os.cpu_count() or 4)
    # round-trip every stage's (rdd, func | dep) and every task header
    # through serialization.py, as a distributed run would
    serialize_tasks_locally: bool = False
    # the memory tier of persisted host partitions (cache.py)
    cache_capacity_bytes: int = 2_000 * 1024 * 1024
    # root of the session's spill directories (None: the system's
    # temporary directory / vega-tpu / spill)
    spill_dir: Optional[str] = None
    # in-RAM shuffle bucket bytes before the oldest spill to disk
    shuffle_memory_budget: int = 1 << 30
    # a bucket larger than this goes straight to disk
    shuffle_spill_threshold: int = 64 * 1024 * 1024
    # a stage failed by a fetch failure is resubmitted this long after
    resubmit_timeout_s: float = 2.0
    # a job's event loop wakes this often with no completion
    poll_timeout_s: float = 0.05
    # attempts of one task before the job aborts with TaskError
    max_failures: int = 4
    # "fifo" or "fair" task arbitration between concurrent jobs
    scheduler_mode: str = "fifo"
    # the bound of deserialized stage binaries the local backend keeps
    # (its serialize_tasks_locally round trip rides them)
    task_binary_cache_entries: int = 32
    # straggler duplicates: once speculation_quorum of a stage's tasks
    # finished, a task running past max(speculation_min_s,
    # speculation_multiplier * median) gets one duplicate attempt
    speculation_enabled: bool = False
    speculation_multiplier: float = 3.0
    speculation_min_s: float = 1.0
    speculation_quorum: float = 0.75


def _positive_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool) and v >= 1


def _seconds(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool) \
        and v >= 0


# setting -> (its check, what it takes)
_CHECKS = {
    "num_workers": (_positive_int, "an int >= 1"),
    "serialize_tasks_locally": (lambda v: isinstance(v, bool), "a bool"),
    "cache_capacity_bytes": (_positive_int, "bytes >= 1"),
    "shuffle_memory_budget": (_positive_int, "bytes >= 1"),
    "shuffle_spill_threshold": (_positive_int, "bytes >= 1"),
    "resubmit_timeout_s": (_seconds, "seconds >= 0"),
    "poll_timeout_s": (lambda v: _seconds(v) and v > 0, "seconds > 0"),
    "max_failures": (_positive_int, "an int >= 1"),
    "scheduler_mode": (lambda v: v in ("fifo", "fair"),
                       "'fifo' or 'fair'"),
    "task_binary_cache_entries": (_positive_int, "an int >= 1"),
    "speculation_enabled": (lambda v: isinstance(v, bool), "a bool"),
    "speculation_multiplier": (lambda v: _seconds(v) and v > 0,
                               "a number > 0"),
    "speculation_min_s": (_seconds, "seconds >= 0"),
    "speculation_quorum": (lambda v: _seconds(v) and v <= 1,
                           "a fraction in [0, 1]"),
}

RUNTIME_SETTINGS = tuple(_CHECKS)


def check_runtime_settings(settings: dict) -> Configuration:
    """A Configuration of the given runtime settings (the rest at their
    defaults); an unknown name or a bad value raises VegaError naming
    what it takes."""
    conf = Configuration()
    for name, value in settings.items():
        if name not in _CHECKS:
            raise VegaError(f"unknown runtime setting {name!r}")
        ok, takes = _CHECKS[name]
        if not ok(value):
            raise VegaError(f"{name}={value!r}: expected {takes}")
        setattr(conf, name, value)
    return conf


class Env:
    """One Context's runtime services. session_root is the Context's
    session directory: the shuffle store spills under <root>/shuffle; the
    partition cache's disk tier is the Context's disk store (cache_disk,
    <root>/cache), which the dense tier demotes to as well."""

    def __init__(self, conf: Configuration, session_root: str, cache_disk):
        from vega_tpu_torch.cache import BoundedMemoryCache
        from vega_tpu_torch.cache_tracker import CacheTracker
        from vega_tpu_torch.map_output_tracker import MapOutputTracker
        from vega_tpu_torch.shuffle.store import ShuffleStore
        from vega_tpu_torch.store.tiered import TieredCache

        self.conf = conf
        self.session_root = session_root
        self.shuffle_store = ShuffleStore(
            spill_dir=os.path.join(session_root, "shuffle"),
            spill_threshold=conf.shuffle_spill_threshold,
            memory_budget=conf.shuffle_memory_budget)
        self.cache = TieredCache(
            BoundedMemoryCache(conf.cache_capacity_bytes), cache_disk)
        self.map_output_tracker = MapOutputTracker()
        self.cache_tracker = CacheTracker()
        # set by the Context to its bus's post: the fetcher posts
        # ShuffleFetchCompleted per reduce stream
        self.fetch_event_sink = None
        self.executor_id: Optional[str] = None
        # shuffle ids whose reading node was collected, not yet dropped
        self._released_shuffles: collections.deque = collections.deque()

    def track_shuffle(self, owner, shuffle_id: int) -> None:
        """Queue shuffle_id's release once owner, the node that reads
        it, is collected."""
        weakref.finalize(owner, self._released_shuffles.append,
                         shuffle_id).atexit = False

    def drain_released_shuffles(self) -> List[int]:
        """Drop the buckets and the tracker entry of every queued
        shuffle; returns their ids."""
        done = []
        while self._released_shuffles:
            sid = self._released_shuffles.popleft()
            self.shuffle_store.remove_shuffle(sid)
            self.map_output_tracker.unregister_shuffle(sid)
            done.append(sid)
        return done

    def close(self) -> None:
        self.shuffle_store.close()
        self.cache.close()
