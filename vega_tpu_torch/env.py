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
import logging
import os
import tempfile
import weakref
from typing import List, Optional

from vega_tpu_torch.errors import VegaError
from vega_tpu_torch.lint.sync_witness import assert_role


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
    # --- the distributed backend (distributed/) ---
    # executor processes of mode="distributed" (None: 2)
    num_executors: Optional[int] = None
    # > 0: reduce tasks prefer the servers holding most of their input and
    # placement scores PROCESS_LOCAL > HOST_LOCAL > ANY; a task whose
    # preferred host has its executor respawning waits up to this long
    locality_wait_s: float = 0.3
    # worker -> driver heartbeat period
    heartbeat_interval_s: float = 2.0
    # an executor silent this long is declared lost
    executor_liveness_timeout_s: float = 30.0
    # the liveness reaper's sweep period
    executor_reap_interval_s: float = 5.0
    # respawns of a dead executor slot, attempt k after backoff * 2**k
    executor_max_restarts: int = 3
    executor_restart_backoff_s: float = 1.0
    # consecutive dispatch failures before an executor is passed over
    executor_blacklist_threshold: int = 5
    # a dropped fetch connection retried in place this many times, with
    # linear backoff, before FetchFailedError
    fetch_retries: int = 3
    fetch_retry_interval_s: float = 0.2
    # one batched get_many round trip per (reducer, server); False: one
    # get per bucket
    fetch_batch_enabled: bool = True
    # fetched-but-unmerged buckets a reduce task holds at most
    fetch_queue_buckets: int = 32
    # task_v2: a stage's binary shipped once per executor and a small
    # header per task; False: the whole task per task
    task_binary_dedup: bool = True
    # executors holding each map output (1: the primary only)
    shuffle_replication: int = 1
    # > 0: a server whose every requested bucket has a replica is given
    # up after this long and its buckets read from the replicas
    fetch_slow_server_s: float = 0.0
    # "pull", or "push": map tasks push a named monoid's buckets to their
    # reduce partition's owner, which pre-merges them (shuffle/premerge.py)
    shuffle_plan: str = "pull"
    # "none", "xor" or "rs" / "rs(k,m)": each map output's row folded into
    # a peer's parity group of up to coding_group_k members with
    # coding_parity_m units (xor: 1), so a lost server's buckets decode
    # (shuffle/coding.py)
    shuffle_coding: str = "none"
    coding_group_k: int = 4
    coding_parity_m: int = 1
    # the executors' hosts (hosts.py; None: VEGA_TPU_HOSTS_FILE, else
    # num_executors on this host); a remote host is started over ssh
    hosts_file: Optional[str] = None
    # the elastic fleet (scheduler/elastic.py): the fleet grows when
    # demand per slot holds above scale_up_threshold for a decision
    # interval and shrinks (graceful decommission) below
    # scale_down_threshold with an empty queue, within [min, max]
    elastic_enabled: bool = False
    elastic_min_executors: int = 1
    elastic_max_executors: int = 8
    elastic_scale_up_threshold: float = 2.0
    elastic_scale_down_threshold: float = 0.25
    elastic_decision_interval_s: float = 1.0
    # a decommissioned executor's drain bound before it is declared lost
    decommission_timeout_s: float = 10.0
    # a dispatch-failure count older than this is forgiven (0: never)
    blacklist_decay_s: float = 60.0
    # the session log files of mode="distributed": <local_dir>/session-*/
    # driver.log and executor-<id>.log, at log_level, removed at stop
    # unless log_cleanup is False
    local_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                             "vega-tpu"))
    log_level: str = "WARNING"
    log_cleanup: bool = True

    @staticmethod
    def from_environ(environ=None) -> "Configuration":
        """A Configuration from the VEGA_TPU_* variables an executor is
        started with (backend._worker_knobs), the rest at their
        defaults."""
        env = os.environ if environ is None else environ
        cfg = Configuration()
        pref = "VEGA_TPU_"
        if env.get(pref + "DEPLOYMENT_MODE"):
            cfg.deployment_mode = DeploymentMode(env[pref + "DEPLOYMENT_MODE"])
        for name in _ENV_STR:
            if env.get(pref + name):
                setattr(cfg, name.lower(), env[pref + name])
        for name in _ENV_INT:
            if env.get(pref + name):
                setattr(cfg, name.lower(), int(env[pref + name]))
        for name in _ENV_BOOL:
            if env.get(pref + name):
                setattr(cfg, name.lower(),
                        env[pref + name].lower() in ("1", "true"))
        for name in _ENV_FLOAT:
            if env.get(pref + name):
                setattr(cfg, name.lower(), float(env[pref + name]))
        return cfg


_ENV_STR = ("LOCAL_DIR", "LOG_LEVEL", "SPILL_DIR", "SCHEDULER_MODE",
            "SHUFFLE_PLAN", "SHUFFLE_CODING", "HOSTS_FILE")
_ENV_INT = ("NUM_WORKERS", "NUM_EXECUTORS", "CACHE_CAPACITY_BYTES",
            "MAX_FAILURES", "SHUFFLE_MEMORY_BUDGET",
            "SHUFFLE_SPILL_THRESHOLD", "EXECUTOR_MAX_RESTARTS",
            "EXECUTOR_BLACKLIST_THRESHOLD", "FETCH_RETRIES",
            "FETCH_QUEUE_BUCKETS", "TASK_BINARY_CACHE_ENTRIES",
            "SHUFFLE_REPLICATION", "CODING_GROUP_K", "CODING_PARITY_M",
            "ELASTIC_MIN_EXECUTORS", "ELASTIC_MAX_EXECUTORS")
_ENV_BOOL = ("LOG_CLEANUP", "SERIALIZE_TASKS_LOCALLY",
             "SPECULATION_ENABLED", "FETCH_BATCH_ENABLED",
             "TASK_BINARY_DEDUP", "ELASTIC_ENABLED")
_ENV_FLOAT = ("RESUBMIT_TIMEOUT_S", "POLL_TIMEOUT_S",
              "SPECULATION_MULTIPLIER", "SPECULATION_MIN_S",
              "SPECULATION_QUORUM", "HEARTBEAT_INTERVAL_S",
              "EXECUTOR_LIVENESS_TIMEOUT_S", "EXECUTOR_REAP_INTERVAL_S",
              "EXECUTOR_RESTART_BACKOFF_S", "FETCH_RETRY_INTERVAL_S",
              "FETCH_SLOW_SERVER_S", "LOCALITY_WAIT_S",
              "DECOMMISSION_TIMEOUT_S", "BLACKLIST_DECAY_S",
              "ELASTIC_SCALE_UP_THRESHOLD", "ELASTIC_SCALE_DOWN_THRESHOLD",
              "ELASTIC_DECISION_INTERVAL_S")


def _coding_spec(v) -> bool:
    """A shuffle_coding value coding.spec_from_conf reads: none / off /
    xor / rs / rs(k,m)."""
    if not isinstance(v, str):
        return False
    raw = v.strip().lower()
    if raw in ("", "none", "off", "0", "xor", "rs"):
        return True
    if raw.startswith("rs(") and raw.endswith(")"):
        parts = raw[3:-1].split(",")
        return len(parts) == 2 and all(p.strip().isdigit() for p in parts)
    return False


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
    "num_executors": (lambda v: v is None or _positive_int(v),
                      "an int >= 1 or None"),
    "locality_wait_s": (_seconds, "seconds >= 0"),
    "heartbeat_interval_s": (lambda v: _seconds(v) and v > 0,
                             "seconds > 0"),
    "executor_liveness_timeout_s": (lambda v: _seconds(v) and v > 0,
                                    "seconds > 0"),
    "executor_reap_interval_s": (lambda v: _seconds(v) and v > 0,
                                 "seconds > 0"),
    "executor_max_restarts": (lambda v: isinstance(v, int)
                              and not isinstance(v, bool) and v >= 0,
                              "an int >= 0"),
    "executor_restart_backoff_s": (_seconds, "seconds >= 0"),
    "executor_blacklist_threshold": (_positive_int, "an int >= 1"),
    "fetch_retries": (_positive_int, "an int >= 1"),
    "fetch_retry_interval_s": (_seconds, "seconds >= 0"),
    "fetch_batch_enabled": (lambda v: isinstance(v, bool), "a bool"),
    "fetch_queue_buckets": (_positive_int, "an int >= 1"),
    "task_binary_dedup": (lambda v: isinstance(v, bool), "a bool"),
    "shuffle_replication": (_positive_int, "an int >= 1"),
    "fetch_slow_server_s": (_seconds, "seconds >= 0"),
    "decommission_timeout_s": (_seconds, "seconds >= 0"),
    "blacklist_decay_s": (_seconds, "seconds >= 0"),
    "shuffle_plan": (lambda v: isinstance(v, str)
                     and v.lower() in ("pull", "push"), "'pull' or 'push'"),
    "shuffle_coding": (_coding_spec, "'none', 'xor', 'rs' or 'rs(k,m)'"),
    "coding_group_k": (lambda v: _positive_int(v) and v >= 2,
                       "an int >= 2"),
    "coding_parity_m": (_positive_int, "an int >= 1"),
    "hosts_file": (lambda v: v is None or (isinstance(v, str) and bool(v)),
                   "a path or None"),
    "elastic_enabled": (lambda v: isinstance(v, bool), "a bool"),
    "elastic_min_executors": (lambda v: isinstance(v, int)
                              and not isinstance(v, bool) and v >= 0,
                              "an int >= 0"),
    "elastic_max_executors": (_positive_int, "an int >= 1"),
    "elastic_scale_up_threshold": (lambda v: _seconds(v) and v > 0,
                                   "a number > 0"),
    "elastic_scale_down_threshold": (_seconds, "a number >= 0"),
    "elastic_decision_interval_s": (lambda v: _seconds(v) and v > 0,
                                    "seconds > 0"),
    "local_dir": (lambda v: isinstance(v, str) and bool(v), "a path"),
    "log_level": (lambda v: isinstance(v, (str, int))
                  and not isinstance(v, bool), "a logging level"),
    "log_cleanup": (lambda v: isinstance(v, bool), "a bool"),
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
        # an executor's own shuffle server (distributed/worker.py); None
        # on a driver, which serves no shuffle data
        self.shuffle_server = None
        # where a driver's coded-shuffle decode runs (its Context's
        # device; an executor's decode runs on the CPU)
        self.decode_device = None
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
        # the teardown of this Env's store and cache under every task
        # that reads them: the driver's or an executor's main thread
        assert_role()
        self.shuffle_store.close()
        self.cache.close()


def normalize_log_level(level) -> int:
    """'info', 'INFO' or 20 -> 20; an unknown name -> WARNING."""
    if isinstance(level, int):
        return level
    resolved = logging.getLevelName(str(level).upper())
    return resolved if isinstance(resolved, int) else logging.WARNING


def attach_session_logger(session_dir: str, role: str, level):
    """A log file <session_dir>/<role>.log on the package's logger at
    level; the handler, or None when the directory is not writable."""
    try:
        os.makedirs(session_dir, exist_ok=True)
        handler = logging.FileHandler(os.path.join(session_dir,
                                                   f"{role}.log"))
    except OSError:
        return None
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s %(message)s"))
    level = normalize_log_level(level)
    handler.setLevel(level)
    pkg_log = logging.getLogger("vega_tpu_torch")
    pkg_log.addHandler(handler)
    if level < pkg_log.getEffectiveLevel():
        pkg_log.setLevel(level)
    return handler


def detach_session_logger(handler) -> None:
    if handler is not None:
        logging.getLogger("vega_tpu_torch").removeHandler(handler)
        handler.close()
