"""Context: the entry point of vega_tpu_torch (counterpart of the dense
sources of vega_tpu/context.py).

    with Context() as ctx:                       # the first CUDA card
        kv = ctx.dense_range(n).map(lambda x: (x % k, x * 0.5))
        kv.reduce_by_key(op="add").join(table).count()

A Context runs on CUDA unless the caller passes device="cpu"; with no card
and no device it raises. Its n_shards virtual shards (default 8, the
reference test mesh) are the leading dimension of every column tensor.

Four plan settings, the reference's Configuration knobs, choose how dense
programs sort, reduce and exchange; each takes 'auto'. The first three
resolve by the Context's device as the reference resolves them by backend;
dense_exchange resolves per exchange launch on every device:

    setting           values                         auto: cpu / cuda
    dense_sort_impl   xla | packed | radix | radix4  packed / xla
    dense_rbk_plan    fused_sort | sort_partition    sort_partition /
                                                     fused_sort
    dense_table_plan  on | off                       on / off
    dense_exchange    all_to_all | staged | ring     planned per launch

create_frame(columns) and read_parquet(path) give a DataFrame
(frame/), whose verbs lower onto the nodes above.

dense_exchange picks each exchange's program: 'auto' plans every launch
with the cost model of exchange_plan.py (the one-shot all_to_all when its
estimated peak fits dense_hbm_budget, else the staged exchange with the
largest group that fits, else ring); the others force a program, as an
op's exchange= keyword does for its own exchange. exchange_plans() counts
the launches per program and those over the budget; each exchange node
keeps its last plan in _exchange_plan.

A misspelt value of any of these raises VegaError naming the allowed
values.

dense_hbm_budget (bytes, default 4 GiB, the reference's Configuration
field) bounds device memory three times, as in the reference: a source
whose planned exchange would need more streams in chunks (stream.py; under
a forced program, the legacy rule of 6x its bytes), each exchange launch
plans against it, and materialized intermediates beyond it are evicted in
LRU order and recomputed from their lineage when read again
(dense_hbm_in_use).

String columns of a host source are dictionary-encoded (dict_encoding.py)
into int32 rank codes with a sorted host dictionary per column, decoded
only when rows come back to the host. dense_dict_enabled=False makes a
string column raise instead; dense_dict_capacity (default 65536) is the
first size of the remap tables that put two sides' codes onto one merged
dictionary (doubled and retried on overflow).

spill_dir is where persisted nodes demote their blocks (the reference's
Configuration.spill_dir): the Context's disk store lives in
<spill_dir or tempfile.gettempdir()/vega-tpu/spill>/session-<id>/cache, the
reference's layout with a session id of its own per Context, made at the
first demotion and removed by stop(). spill_status() gives its counters.

multihost=dict(coordinator="host:port", num_processes=P, process_id=r,
heartbeat_timeout_s=100, backend=None) runs one program on P
processes, the reference's Context(multihost=...): each process joins a
torch.distributed group (mesh.ensure_multihost; nccl on a card, gloo on
the CPU, backend= overrides) before any block is built, runs on
cuda:{r % device_count} unless device= says otherwise, and holds n_shards
/ P of the n_shards global shards (n_shards must divide by P). Exchanges
cross processes through the group and every host read gathers all
shards, so every process gets the same results. Missing keys default
from JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID. stop()
leaves the group up for a later Context with the same settings. The
frame layer, string columns, npz files and the streaming fold run across
processes as on one: every process passes the same host data (the same
columns, the same parquet file, the same pairs) and reads the same
results; a save_npz path that every process passes is written by
process 0 alone. A persisted node recomputes instead of demoting to the
disk store.

parallelize(data, num_slices) (alias make_rdd), range(start, stop, step,
num_slices), union(rdds) and empty_rdd() give host RDDs (rdd/), lazy
lineages of Python rows run in this process by the reference's local
runtime (env.py: one Env per Context, ctx.env): run_job submits a job
to the job server (scheduler/jobserver.py), whose driver thread runs the
DAG scheduler's event loop (scheduler/dag.py): stages cut at shuffles,
tasks on the thread pool of the local backend (num_workers threads),
retried up to max_failures attempts before the job raises TaskError; a
map task pickles its buckets into the shuffle store (shuffle/store.py,
spilling past shuffle_memory_budget) and a reduce task reads them
through the fetcher, whose missing bucket (FetchFailedError) resubmits
the map stage; persisted partitions live in the tiered cache
(store/tiered.py, cache_capacity_bytes in memory). A host RDD's dense()
lifts its rows onto this Context's device; a DenseRDD's to_rdd(),
glom(), map_partitions(), coalesce() and the rest hand its shards' rows
to this layer. default_parallelism is the shard count. The runtime's
settings are the reference's Configuration fields with its defaults
(env.py): num_workers, serialize_tasks_locally, cache_capacity_bytes,
shuffle_memory_budget, shuffle_spill_threshold, resubmit_timeout_s,
poll_timeout_s, max_failures, scheduler_mode,
task_binary_cache_entries, speculation_enabled / _multiplier / _min_s /
_quorum.

mode="distributed" runs every host job's tasks on num_executors
executor processes over TCP instead (distributed/backend.py; the
reference's Context("distributed")): each an executor of its own with
its shuffle store served by its shuffle server, the driver's trackers
served to them (distributed/driver_service.py), the dense tier on this
Context's device; executors run on the CPU and a DenseRDD a task reads
reaches them as its rows (dense_rdd._HostDenseView). Its settings are
the reference's with its defaults: num_executors (2), locality_wait_s,
heartbeat_interval_s, executor_liveness_timeout_s,
executor_reap_interval_s, executor_max_restarts,
executor_restart_backoff_s, executor_blacklist_threshold, fetch_retries,
fetch_retry_interval_s, fetch_batch_enabled, fetch_queue_buckets,
task_binary_dedup, shuffle_replication, fetch_slow_server_s,
decommission_timeout_s, blacklist_decay_s, the session logs'
local_dir, log_level, log_cleanup, and shuffle_plan ("pull" / "push":
shuffle/premerge.py), shuffle_coding ("none" / "xor" / "rs(k,m)",
coding_group_k, coding_parity_m: shuffle/coding.py), hosts_file
(hosts.py: executors over ssh), elastic_enabled with
elastic_min_executors / _max_executors / _scale_up_threshold /
_scale_down_threshold / _decision_interval_s (scheduler/elastic.py;
self.elastic, fleet_status()). With multihost= every process joins the
group first and then spawns a fleet of its own, the reference's
Context("distributed", multihost=...): each rank's fleet runs the whole
host job over every shard's rows (read on the job's driver thread, one
host_get in one order on every rank), and a host RDD's dense() lifts the
rows that process 0 collected on every rank (mesh.agree_objects), since
two fleets may merge buckets in different orders. An executor never
joins the group: its environment carries neither the JAX_* multihost
variables nor torch.distributed's.

The job server's names: submit_job(rdd, func, partitions, pool,
transform) runs a job asynchronously in a pool (set_pool: weight,
max_concurrent_tasks, max_queued; the thread's "pool" property,
set_local_property, by default), admitted by the reference's check
(admission_mode "reject" or "block", pool_max_queued or a pool's
max_queued; 0 is no bound); run_approximate_job (an evaluator's estimate
at the deadline, its final value later), broadcast(value),
metrics_summary() (the event bus's MetricsListener: jobs, stages, tasks,
failures, resubmissions, spills, speculation, fetch, the streaming
counters, pool_latency; plus exchange_plans) and storage_status() (the
partition cache's and the shuffle store's counters). Across processes a
host job runs on the submitting thread, one at a time, and its tasks one
at a time in submission order (num_workers 1 in local mode, no
speculation), so every rank issues the collectives its tasks reach in one
order.
Context.active()
is the newest Context of the process not yet stopped (the port allows
several at once; the reference refuses a second).

read_source(config, decoder), text_file(path, num_partitions),
whole_text_files(path) and parquet_file(path, columns, num_partitions)
give host RDDs over whole files (io/readers.py), one partition per group
of files, default_parallelism groups by default.

streaming(batch_interval_s, checkpoint_dir) is the Context's one
StreamingContext (streaming/), and stream_from_generator /
stream_from_file_tail / stream_from_socket its sources; a stateful
stream's update_state_by_key(op=...) folds each micro-batch on this
Context's device. The stream_* settings are the reference's
Configuration fields with its defaults: stream_batch_interval_s 0.5,
stream_block_max_records 10,000, stream_queue_max_blocks 64,
stream_backpressure_mode "block" | "shed", stream_pool "streaming" of
weight stream_pool_weight 4, stream_storage_level "memory_and_disk" (a
StorageLevel value), stream_socket_timeout_s 5.0, stream_checkpoint_dir
"" (the default directory: streaming/context.py). A stream's loop runs
device jobs on its own thread, so the dense tier runs under one
re-entrant lock per Context (_dense_lock): a node's materialization and
every settlement. Streaming refuses a multi-process Context. stop()
stops the streaming plane first.

profiler(log_dir) traces a block of work with torch.profiler (the
reference's Context.profiler traces with jax.profiler): CPU activity
always, the card's kernels when the Context runs on CUDA, written on exit
as a Chrome trace under log_dir that TensorBoard's profiler plugin also
reads.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import shutil
import tempfile
import threading
import uuid
from typing import Any, Callable, List, Optional, Sequence

import torch

from vega_tpu_torch import dense_rdd
from vega_tpu_torch import exchange_plan
from vega_tpu_torch import kernels
from vega_tpu_torch.env import (Configuration,
                                DeploymentMode, Env, attach_session_logger,
                                check_runtime_settings,
                                detach_session_logger)
from vega_tpu_torch.errors import VegaError
from vega_tpu_torch.frame.api import DataFrame
from vega_tpu_torch import mesh as mesh_lib
from vega_tpu_torch.lint.sync_witness import assert_role, named_lock
from vega_tpu_torch.mesh import make_mesh
from vega_tpu_torch.scheduler import events
from vega_tpu_torch.scheduler import jobserver
from vega_tpu_torch.scheduler.dag import DAGScheduler
from vega_tpu_torch.scheduler.local_backend import LocalBackend, in_task
from vega_tpu_torch.store import DiskStore, StorageLevel

log = logging.getLogger(__name__)

# the live Contexts of the process, oldest first (Context.active)
_live_contexts: list = []
_live_lock = named_lock("context._active_context_lock")
_ctx_ids = itertools.count()


def _check_setting(name: str, value, ok: bool, allowed: str):
    if not ok:
        raise VegaError(f"{name} must be {allowed}, got {value!r}")
    return value


class Context:
    def __init__(self, device: Optional[str] = None, n_shards: int = 8,
                 dense_sort_impl: str = "auto", dense_rbk_plan: str = "auto",
                 dense_table_plan: str = "auto",
                 dense_hbm_budget: int = 4 << 30,
                 dense_exchange: str = "auto",
                 dense_dict_enabled: bool = True,
                 dense_dict_capacity: int = 65536,
                 spill_dir: Optional[str] = None,
                 multihost: Optional[dict] = None,
                 admission_mode: str = "reject", pool_max_queued: int = 0,
                 stream_batch_interval_s: float = 0.5,
                 stream_block_max_records: int = 10_000,
                 stream_queue_max_blocks: int = 64,
                 stream_backpressure_mode: str = "block",
                 stream_pool: str = "streaming",
                 stream_pool_weight: int = 4,
                 stream_storage_level: str = "memory_and_disk",
                 stream_socket_timeout_s: float = 5.0,
                 stream_checkpoint_dir: str = "",
                 num_workers: Optional[int] = None,
                 serialize_tasks_locally: bool = False,
                 cache_capacity_bytes: int = 2_000 * 1024 * 1024,
                 shuffle_memory_budget: int = 1 << 30,
                 shuffle_spill_threshold: int = 64 * 1024 * 1024,
                 resubmit_timeout_s: float = 2.0,
                 poll_timeout_s: float = 0.05,
                 max_failures: int = 4,
                 scheduler_mode: str = "fifo",
                 task_binary_cache_entries: int = 32,
                 speculation_enabled: bool = False,
                 speculation_multiplier: float = 3.0,
                 speculation_min_s: float = 1.0,
                 speculation_quorum: float = 0.75,
                 mode: str = "local",
                 num_executors: Optional[int] = None,
                 locality_wait_s: float = 0.3,
                 heartbeat_interval_s: float = 2.0,
                 executor_liveness_timeout_s: float = 30.0,
                 executor_reap_interval_s: float = 5.0,
                 executor_max_restarts: int = 3,
                 executor_restart_backoff_s: float = 1.0,
                 executor_blacklist_threshold: int = 5,
                 fetch_retries: int = 3,
                 fetch_retry_interval_s: float = 0.2,
                 fetch_batch_enabled: bool = True,
                 fetch_queue_buckets: int = 32,
                 task_binary_dedup: bool = True,
                 shuffle_replication: int = 1,
                 fetch_slow_server_s: float = 0.0,
                 decommission_timeout_s: float = 10.0,
                 blacklist_decay_s: float = 60.0,
                 local_dir: Optional[str] = None,
                 log_level: str = "WARNING",
                 log_cleanup: bool = True,
                 shuffle_plan: str = "pull",
                 shuffle_coding: str = "none",
                 coding_group_k: int = 4,
                 coding_parity_m: int = 1,
                 hosts_file: Optional[str] = None,
                 elastic_enabled: bool = False,
                 elastic_min_executors: int = 1,
                 elastic_max_executors: int = 8,
                 elastic_scale_up_threshold: float = 2.0,
                 elastic_scale_down_threshold: float = 0.25,
                 elastic_decision_interval_s: float = 1.0):
        mode = _check_setting("mode", mode, mode in ("local", "distributed"),
                              "'local' or 'distributed'")
        runtime = dict(
            serialize_tasks_locally=serialize_tasks_locally,
            cache_capacity_bytes=cache_capacity_bytes,
            shuffle_memory_budget=shuffle_memory_budget,
            shuffle_spill_threshold=shuffle_spill_threshold,
            resubmit_timeout_s=resubmit_timeout_s,
            poll_timeout_s=poll_timeout_s, max_failures=max_failures,
            scheduler_mode=scheduler_mode,
            task_binary_cache_entries=task_binary_cache_entries,
            speculation_enabled=speculation_enabled,
            speculation_multiplier=speculation_multiplier,
            speculation_min_s=speculation_min_s,
            speculation_quorum=speculation_quorum)
        if num_workers is not None:
            runtime["num_workers"] = num_workers
        runtime.update(
            num_executors=num_executors, locality_wait_s=locality_wait_s,
            heartbeat_interval_s=heartbeat_interval_s,
            executor_liveness_timeout_s=executor_liveness_timeout_s,
            executor_reap_interval_s=executor_reap_interval_s,
            executor_max_restarts=executor_max_restarts,
            executor_restart_backoff_s=executor_restart_backoff_s,
            executor_blacklist_threshold=executor_blacklist_threshold,
            fetch_retries=fetch_retries,
            fetch_retry_interval_s=fetch_retry_interval_s,
            fetch_batch_enabled=fetch_batch_enabled,
            fetch_queue_buckets=fetch_queue_buckets,
            task_binary_dedup=task_binary_dedup,
            shuffle_replication=shuffle_replication,
            fetch_slow_server_s=fetch_slow_server_s,
            decommission_timeout_s=decommission_timeout_s,
            blacklist_decay_s=blacklist_decay_s, log_level=log_level,
            log_cleanup=log_cleanup, shuffle_plan=shuffle_plan,
            shuffle_coding=shuffle_coding, coding_group_k=coding_group_k,
            coding_parity_m=coding_parity_m, hosts_file=hosts_file,
            elastic_enabled=elastic_enabled,
            elastic_min_executors=elastic_min_executors,
            elastic_max_executors=elastic_max_executors,
            elastic_scale_up_threshold=elastic_scale_up_threshold,
            elastic_scale_down_threshold=elastic_scale_down_threshold,
            elastic_decision_interval_s=elastic_decision_interval_s)
        if local_dir is not None:
            runtime["local_dir"] = local_dir
        # the runtime's Configuration (env.py), each setting checked
        self.conf: Configuration = check_runtime_settings(runtime)
        self.conf.spill_dir = spill_dir
        self.conf.deployment_mode = DeploymentMode(mode)
        self._check_job_settings(
            admission_mode, pool_max_queued, stream_batch_interval_s,
            stream_block_max_records, stream_queue_max_blocks,
            stream_backpressure_mode, stream_pool, stream_pool_weight,
            stream_storage_level, stream_socket_timeout_s,
            stream_checkpoint_dir)
        if dense_hbm_budget < 0:
            raise VegaError(f"dense_hbm_budget must be >= 0 bytes, got "
                            f"{dense_hbm_budget}")
        self.dense_hbm_budget = int(dense_hbm_budget)
        self.dense_exchange = exchange_plan.check_mode(dense_exchange)
        self.dense_dict_enabled = bool(dense_dict_enabled)
        if int(dense_dict_capacity) < 1:
            raise VegaError(f"dense_dict_capacity must be >= 1, got "
                            f"{dense_dict_capacity}")
        self.dense_dict_capacity = int(dense_dict_capacity)
        # the planned exchange launches of this Context
        # (exchange_plan.add_to_summary)
        self._exchange_plans = exchange_plan.new_plan_summary()
        if multihost is not None:
            device = self._join(dict(multihost), device)
        self.mesh = make_mesh(n_shards, device,
                              multihost=multihost is not None)
        dev = self.mesh.device
        self.dense_sort_impl = kernels.resolve_backend_mode(
            "dense_sort_impl", dense_sort_impl, kernels.SORT_IMPLS,
            "packed", "xla", dev)
        self.dense_rbk_plan = kernels.resolve_backend_mode(
            "dense_rbk_plan", dense_rbk_plan, kernels.RBK_PLANS,
            "sort_partition", "fused_sort", dev)
        self.dense_table_plan = kernels.resolve_backend_mode(
            "dense_table_plan", dense_table_plan, kernels.TABLE_PLANS,
            "on", "off", dev)
        # capacity hints: (lineage, input sizes) -> (slot, out) capacities
        self._capacity_hints: dict = {}
        # observed key ranges: (lineage, input sizes) -> (kmin, kmax), for
        # the table plan
        self._key_range_hints: dict = {}
        # deferred exchanges awaiting settlement, in launch order
        self._pending: list = []
        # set while a settlement repairs: every exchange runs blocking
        self._no_defer = False
        # materialized intermediates, least recently used first (in
        # registration order across processes): rdd_id -> (weakref to the
        # node, bytes at registration) (dense_rdd's block lifetime)
        self._dense_block_lru: dict = {}
        self._rdd_ids = itertools.count()
        self._shuffle_ids = itertools.count()
        # the session directory (paths only: each store makes its own
        # directory at its first write); the disk tier of persisted nodes,
        # dense and host, is its cache/ store
        base = spill_dir or os.path.join(tempfile.gettempdir(), "vega-tpu",
                                         "spill")
        session = os.path.join(base, f"session-{uuid.uuid4().hex[:12]}")
        self._spill = DiskStore(os.path.join(session, "cache"))
        # the dense tier's lock: a node's materialization and every
        # settlement, so a stream's loop thread, a job's driver thread and
        # a task thread never interleave device jobs. It stands where
        # vega_tpu's device-read locks stand (tpu.block._host_cache_lock,
        # tpu.mesh._lock and tpu.mesh._device_door): the port's blocks
        # read to the host inside it
        self._dense_lock = named_lock("context.Context._dense_lock",
                                      reentrant=True)
        # the event bus and its metrics (scheduler/events.py)
        self.bus = events.LiveListenerBus()
        self.metrics = events.MetricsListener()
        self.bus.add_listener(self.metrics)
        self.bus.start()
        # the local runtime (env.py): the shuffle store, the tiered
        # partition cache over the disk store, the trackers
        self.env = Env(self.conf, session, self._spill)
        self.env.cache.event_sink = self.bus.post
        self.env.shuffle_store.event_sink = self.bus.post
        self.env.fetch_event_sink = self.bus.post
        # a decode on this driver (the coded shuffle) runs on its device
        self.env.decode_device = dev
        if self.mesh.collective:
            # every rank runs a job's tasks one at a time, in submission
            # order (one task thread here, no duplicate attempts), so each
            # collective a task reaches is issued in one order everywhere;
            # an executor's tasks reach none (it holds rows, not a mesh),
            # so a fleet keeps the num_workers the caller gave
            if mode == "local":
                self.conf.num_workers = 1
            self.conf.speculation_enabled = False
        # the DAG scheduler over the thread-pool backend or the executor
        # fleet, behind the job server (scheduler/)
        self._log_handler = None
        self._log_dir = None
        if mode == "distributed":
            from vega_tpu_torch.distributed.backend import DistributedBackend

            self._log_dir = os.path.join(
                self.conf.local_dir, f"session-{uuid.uuid4().hex[:12]}")
            self._log_handler = attach_session_logger(
                self._log_dir, "driver", self.conf.log_level)
            try:
                self._backend = DistributedBackend(self.conf, self.env)
            except BaseException:
                self._close_session_log()
                self.bus.stop()
                self.env.close()
                raise
            self._backend.event_sink = self.bus.post
        else:
            self._backend = LocalBackend(self.conf)
        self.scheduler = DAGScheduler(self._backend, self.env, self.bus)
        if mode == "distributed":
            self._backend.add_executor_lost_listener(
                self.scheduler._on_executor_lost)
        self.scheduler.prepare = _materialize_dense
        self.job_server = jobserver.JobServer(
            self.scheduler, self.conf, admission_mode=self.admission_mode,
            pool_max_queued=self.pool_max_queued)
        # the elastic fleet's controller (scheduler/elastic.py), over an
        # executor fleet: decommission and fleet_status work with its
        # loop off; the loop runs under elastic_enabled
        self.elastic = None
        if mode == "distributed":
            from vega_tpu_torch.scheduler.elastic import ElasticController

            self.elastic = ElasticController(
                self._backend, self.job_server.arbiter, self.scheduler,
                self.conf, self.bus, self.env)
            if self.conf.elastic_enabled:
                self.elastic.start()
        # thread-local job properties ("pool")
        self._local_props = threading.local()
        # the streaming plane's landed blocks and the plane itself,
        # made at the first streaming() call
        from vega_tpu_torch.streaming.source import BlockStore

        self._stream_blocks = BlockStore(self._spill)
        self._streaming = None
        self._stopped = False
        self._ctx_id = next(_ctx_ids)
        with _live_lock:
            _live_contexts.append(self)

    def _check_job_settings(self, admission_mode, pool_max_queued,
                            interval_s, block_max_records, queue_max_blocks,
                            backpressure_mode, pool, pool_weight,
                            storage_level, socket_timeout_s,
                            checkpoint_dir) -> None:
        """The job server's and the streaming plane's settings, each
        checked; a bad one raises VegaError naming what it takes."""
        self.admission_mode = jobserver.check_admission_mode(admission_mode)
        self.pool_max_queued = _check_setting(
            "pool_max_queued", pool_max_queued,
            isinstance(pool_max_queued, int) and pool_max_queued >= 0,
            "an int >= 0 (0: no bound)")
        self.stream_batch_interval_s = float(_check_setting(
            "stream_batch_interval_s", interval_s,
            isinstance(interval_s, (int, float)) and interval_s > 0,
            "seconds > 0"))
        self.stream_block_max_records = _check_setting(
            "stream_block_max_records", block_max_records,
            isinstance(block_max_records, int) and block_max_records >= 1,
            "an int >= 1")
        self.stream_queue_max_blocks = _check_setting(
            "stream_queue_max_blocks", queue_max_blocks,
            isinstance(queue_max_blocks, int) and queue_max_blocks >= 1,
            "an int >= 1")
        self.stream_backpressure_mode = _check_setting(
            "stream_backpressure_mode", backpressure_mode,
            backpressure_mode in ("block", "shed"), "'block' or 'shed'")
        self.stream_pool = _check_setting(
            "stream_pool", pool, isinstance(pool, str) and bool(pool),
            "a pool name")
        self.stream_pool_weight = _check_setting(
            "stream_pool_weight", pool_weight,
            isinstance(pool_weight, int) and pool_weight >= 1,
            "an int >= 1")
        levels = [lv.value for lv in StorageLevel]
        self.stream_storage_level = _check_setting(
            "stream_storage_level", storage_level,
            isinstance(storage_level, str)
            and storage_level.lower() in levels,
            f"one of {levels}")
        self.stream_socket_timeout_s = float(_check_setting(
            "stream_socket_timeout_s", socket_timeout_s,
            isinstance(socket_timeout_s, (int, float))
            and socket_timeout_s > 0, "seconds > 0"))
        self.stream_checkpoint_dir = _check_setting(
            "stream_checkpoint_dir", checkpoint_dir,
            isinstance(checkpoint_dir, str), "a path or ''")

    @staticmethod
    def active() -> Optional["Context"]:
        """The live Context of this process: the newest not stopped."""
        with _live_lock:
            return _live_contexts[-1] if _live_contexts else None

    @staticmethod
    def _join(multihost: dict, device):
        """Join the process group before any block is built
        (mesh.ensure_multihost) and return the device: the one given,
        else cuda:{process_id % device_count}; with no card and no device
        given this raises, as a one-process Context does."""
        unknown = set(multihost) - {"coordinator", "num_processes",
                                    "process_id", "heartbeat_timeout_s",
                                    "backend"}
        if unknown:
            raise VegaError(f"unknown multihost keys {sorted(unknown)}")
        if device is None:
            _, _, pid = mesh_lib._normalize_multihost(
                multihost.get("coordinator"),
                multihost.get("num_processes"), multihost.get("process_id"))
            if not torch.cuda.is_available():
                raise VegaError("no CUDA device available; pass "
                                "device='cpu' to run on the CPU")
            device = f"cuda:{(pid or 0) % torch.cuda.device_count()}"
        mesh_lib.ensure_multihost(device=device, **multihost)
        return device

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    # --- the host RDD layer (rdd/) ------------------------------------------
    def new_rdd_id(self) -> int:
        return next(self._rdd_ids)

    def new_shuffle_id(self) -> int:
        return next(self._shuffle_ids)

    @property
    def default_parallelism(self) -> int:
        return self.mesh.n_shards

    def parallelize(self, data: Sequence, num_slices: Optional[int] = None):
        """A host RDD over an in-memory sequence in num_slices contiguous
        slices (default: the shard count)."""
        from vega_tpu_torch.rdd.narrow import ParallelCollectionRDD

        self._check_running()
        return ParallelCollectionRDD(self, data,
                                     num_slices or self.default_parallelism)

    make_rdd = parallelize

    def range(self, start: int, stop: Optional[int] = None, step: int = 1,
              num_slices: Optional[int] = None):
        """parallelize(range(start, stop, step)), its slices ranges (no
        rows are held until computed); range(n) is range(0, n)."""
        if stop is None:
            start, stop = 0, start
        return self.parallelize(range(start, stop, step), num_slices)

    def union(self, rdds: List):
        from vega_tpu_torch.rdd.union import UnionRDD

        self._check_running()
        return UnionRDD(self, rdds)

    def empty_rdd(self):
        return self.parallelize([], 1)

    def run_job(self, rdd, func: Callable,
                partitions: Optional[List[int]] = None) -> list:
        """func(task_context, rows) of each partition asked for (default:
        all) as one job of the thread's pool: submit_job, then its result
        (a caller unwinding cancels the job). A job started inside
        another (on a job's driver thread or a task thread) is part of
        it: its event loop runs on the calling thread, not admitted."""
        self._check_running()
        if partitions is not None and not partitions:
            return []
        if in_task() or jobserver.in_job():
            return self.scheduler.run_job(rdd, func, partitions)
        future = self.submit_job(rdd, func, partitions)
        try:
            return future.result()
        except BaseException:
            future.cancel("blocking caller interrupted")
            raise

    # --- the job server's names ---------------------------------------------
    def set_local_property(self, key: str, value) -> None:
        """A thread-local job property; "pool" picks the pool of the jobs
        this thread submits. None clears the key."""
        props = getattr(self._local_props, "props", None)
        if props is None:
            props = self._local_props.props = {}
        if value is None:
            props.pop(key, None)
        else:
            props[key] = value

    def get_local_property(self, key: str, default=None):
        props = getattr(self._local_props, "props", None)
        return default if props is None else props.get(key, default)

    def set_pool(self, name: str, weight: int = 1,
                 max_concurrent_tasks: Optional[int] = None,
                 max_queued: Optional[int] = None):
        """Declare or configure a pool (scheduler/jobserver.py
        PoolConfig): weight skews the fair share of task slots under
        scheduler_mode "fair", max_concurrent_tasks caps its running
        tasks, max_queued bounds its jobs in flight (admission_mode
        decides what a full pool does)."""
        return self.job_server.set_pool(name, weight, max_concurrent_tasks,
                                        max_queued)

    def submit_job(self, rdd, func: Callable,
                   partitions: Optional[List[int]] = None,
                   pool: Optional[str] = None,
                   transform: Optional[Callable[[list], Any]] = None):
        """func(task_context, rows) of each partition asked for (default:
        all) as an asynchronous job: a JobFuture settled with the list of
        partition results, or with transform(that list). The pool
        defaults to the thread's "pool" property. The job's event loop
        runs on a driver thread of its own, concurrently with other jobs;
        across processes it runs here, before this returns, so every
        process runs its host jobs one at a time in one order."""
        self._check_running()
        if pool is None:
            pool = self.get_local_property("pool")
        return self.job_server.submit(rdd, func, partitions, pool=pool,
                                      transform=transform,
                                      inline=self.mesh.collective)

    def _submit_call(self, finish: Callable[[], Any]):
        """finish() as a job of the thread's pool on a thread of its own
        (the dense tier's asynchronous actions: their device work ran
        before)."""
        self._check_running()
        return self.job_server.submit_call(
            finish, pool=self.get_local_property("pool"))

    def run_approximate_job(self, rdd, func: Callable, evaluator,
                            timeout_s: float):
        """func over every partition, each result merged into evaluator
        (merge(index, result)) as its task finishes. The job's end
        within timeout_s gives a final PartialResult of
        evaluator.current_result(); else the current estimate, not final,
        whose final value comes when the job ends. A failed job gives a
        failed result."""
        from vega_tpu_torch.partial import PartialResult

        self._check_running()
        future = self.job_server.submit(
            rdd, func, list(range(rdd.num_partitions)),
            pool=self.get_local_property("pool"),
            on_task_success=evaluator.merge, inline=self.mesh.collective)
        try:
            future.result(timeout_s)
        except TimeoutError:
            result = PartialResult(evaluator.current_result(),
                                   is_final=False)

            def finisher(fut):
                exc = fut.exception()
                if exc is not None:
                    result.set_failure(exc)
                else:
                    result.set_final_value(evaluator.current_result())

            future.add_done_callback(finisher)
            return result
        except Exception as exc:  # noqa: BLE001 — folded into the result
            return PartialResult(None, failure=exc)
        return PartialResult(evaluator.current_result())

    def broadcast(self, value: Any):
        """A broadcast variable (broadcast.py): in one process a holder
        shared by reference."""
        from vega_tpu_torch.broadcast import Broadcast

        return Broadcast(self, value)

    def metrics_summary(self) -> dict:
        """The event bus's metrics (scheduler/events.py
        MetricsListener.summary: jobs, stages, tasks, failures,
        resubmissions, executors lost and restarted, spills, speculation,
        fetch, locality, dispatch, streaming, pool_latency) and
        exchange_plans (exchange_plans())."""
        self.bus.flush()
        return {**self.metrics.summary(),
                "exchange_plans": self.exchange_plans()}

    def fleet_status(self) -> dict:
        """The serving plane in one view: the fleet (a row per executor
        slot: alive, draining, in flight, restarts; empty in local mode),
        the arbiter's running and queued tasks, each pool's admission,
        the elastic controller's state, the pools' latency and the
        streaming plane's status."""
        backend = self._backend
        return {
            "fleet": backend.fleet_snapshot()
            if hasattr(backend, "fleet_snapshot") else [],
            "scheduler": self.job_server.arbiter.stats(),
            "admission": self.job_server.admission_status(),
            "elastic": self.elastic.status() if self.elastic is not None
            else {"enabled": False},
            "pool_latency": self.metrics.pool_latency(),
            "streaming": self._streaming.status()
            if self._streaming is not None else {"active": False},
        }

    def storage_status(self) -> dict:
        """The block stores' counters under the reference's keys: the
        partition cache's ("cache": its memory tier, then the disk
        store's, which the dense tier's demotions count in too) and the
        shuffle store's ("shuffle")."""
        return {"cache": self.env.cache.status(),
                "shuffle": self.env.shuffle_store.status()}

    # --- file sources (io/readers.py) ---------------------------------------
    def read_source(self, config, decoder: Optional[Callable] = None):
        """config.make_reader(self), mapped through decoder if given."""
        self._check_running()
        rdd = config.make_reader(self)
        if decoder is not None:
            rdd = rdd.map(decoder)
        return rdd

    def text_file(self, path: str, num_partitions: Optional[int] = None):
        """One str per line of the files under path (a directory, a glob
        or a file), in num_partitions groups of whole files."""
        from vega_tpu_torch.io.readers import TextFileReaderConfig

        return self.read_source(TextFileReaderConfig(
            path, num_partitions or self.default_parallelism))

    def whole_text_files(self, path: str):
        """(path, bytes) per file."""
        from vega_tpu_torch.io.readers import WholeFileReaderConfig

        return self.read_source(WholeFileReaderConfig(path))

    def parquet_file(self, path: str, columns: Optional[List[str]] = None,
                     num_partitions: Optional[int] = None):
        """The {name: numpy column} blocks of the parquet files under path
        (pyarrow), columns pruned in the reader."""
        from vega_tpu_torch.io.readers import ParquetColumnReader

        return self.read_source(ParquetColumnReader(
            path, columns, num_partitions or self.default_parallelism))

    # --- streaming (streaming/) ---------------------------------------------
    def streaming(self, batch_interval_s: Optional[float] = None,
                  checkpoint_dir: Optional[str] = None):
        """The Context's StreamingContext, made at the first call (whose
        interval and checkpoint directory it keeps). Refused across
        processes: a timer thread cannot run collectives in one order
        on every rank."""
        self._check_running()
        if self.mesh.collective:
            raise VegaError(
                "streaming() across processes is not supported: the batch "
                "loop's timer thread cannot run collectives in one order "
                "on every process")
        if self._streaming is None:
            from vega_tpu_torch.streaming.context import StreamingContext

            self._streaming = StreamingContext(
                self, batch_interval_s=batch_interval_s,
                checkpoint_dir=checkpoint_dir)
        return self._streaming

    def stream_from_generator(self, fn, **kwargs):
        """A DStream over fn(offset) -> record | None (deterministic: the
        replay path)."""
        return self.streaming(**kwargs).generator_stream(fn)

    def stream_from_file_tail(self, path: str, **kwargs):
        """A DStream tailing an append-only line file (byte offsets)."""
        return self.streaming(**kwargs).file_tail_stream(path)

    def stream_from_socket(self, host: str, port: int, **kwargs):
        """A DStream over line-delimited TCP."""
        return self.streaming(**kwargs).socket_stream(host, port)

    def _work_dir(self) -> str:
        """This Context's session directory (the spill store's parent),
        home of default checkpoint directories; stop() removes it."""
        return os.path.dirname(self._spill.root)

    def _check_running(self) -> None:
        if self._stopped:
            raise VegaError("Context is stopped")

    def dense_range(self, n: int, num_partitions: Optional[int] = None,
                    dtype=None, chunk_rows: Optional[int] = None):
        """Device iota source of n rows (int32 unless dtype says). It
        streams in chunks (a StreamedDenseRDD) when its planned exchange
        would pass dense_hbm_budget (stream.planned_chunk_rows), or when
        chunk_rows is given and below n. num_partitions is accepted and
        ignored, as the reference's device tier does: one partition per
        shard (so in dense_from_numpy, create_frame and read_parquet)."""
        self._check_running()
        return dense_rdd.dense_range(self, n, dtype or torch.int32,
                                     chunk_rows=chunk_rows)

    def dense_from_numpy(self, *columns,
                         num_partitions: Optional[int] = None):
        """Dense source from host arrays: (values) or (keys, values);
        arrays no block holds are parallelized into num_partitions
        slices (dense_rdd.dense_from_numpy)."""
        self._check_running()
        return dense_rdd.dense_from_numpy(self, columns, num_partitions)

    def dense_from_columns(self, columns: Optional[dict] = None,
                           key: Optional[str] = None, **kwcolumns):
        """Dense source from named host columns; key= names the shuffle
        key column."""
        self._check_running()
        return dense_rdd.dense_from_columns(self, columns, key=key,
                                            **kwcolumns)

    def dense_load_npz(self, path: str, chunk_rows: Optional[int] = None):
        """Reload a DenseRDD written by save_npz (either package's),
        re-sharded onto this Context's shards; streams as dense_range
        does."""
        self._check_running()
        return dense_rdd.dense_load_npz(self, path, chunk_rows=chunk_rows)

    def create_frame(self, columns: Optional[dict] = None,
                     num_partitions: Optional[int] = None, **kwcolumns):
        """In-memory columns (a dict and / or keywords) -> DataFrame
        (frame/api.py), the frame-layer sibling of dense_from_columns.
        Nothing is coerced or copied to the device until an action.
        num_partitions: the host tier's partitions (default the shard
        count); the device tier holds the shards."""
        self._check_running()
        data = dict(columns or {})
        for name, c in kwcolumns.items():
            if name in data:
                raise VegaError(f"duplicate column {name!r}")
            data[name] = c
        return DataFrame.from_columns(self, data, num_partitions)

    def read_parquet(self, path: str, columns: Optional[list] = None,
                     num_partitions: Optional[int] = None):
        """Parquet -> DataFrame: the planner pushes column pruning and
        supported predicates into the reader (frame/parquet.py, which
        needs pyarrow) and applies each narrow verb chain as one stage.
        columns= pre-prunes at the entry point; num_partitions: the host
        tier's groups of files (default the shard count)."""
        self._check_running()
        return DataFrame.from_parquet(self, path, columns, num_partitions)

    def exchange_plans(self) -> dict:
        """The exchange launches this Context planned: per program
        (all_to_all, staged, ring), the staged rounds summed, the largest
        estimated per-shard peak and how many launches were over the
        budget even as ring (the reference's
        metrics_summary()["exchange_plans"])."""
        return dict(self._exchange_plans)

    def dense_hbm_in_use(self) -> int:
        """Tracked device bytes of materialized dense intermediates
        (sources excluded), the quantity eviction holds to
        dense_hbm_budget; not the allocator's count."""
        return dense_rdd.dense_hbm_in_use(self)

    def spill_status(self) -> dict:
        """The disk tier's counters, under the reference's status() keys:
        disk_bytes, disk_entries, spill_count, spilled_bytes,
        promote_count, promoted_bytes, disk_read_errors."""
        return self._spill.status()

    @contextlib.contextmanager
    def profiler(self, log_dir: str):
        """A torch.profiler trace over a block of work, the counterpart of
        the reference's jax.profiler one:

            with ctx.profiler("/tmp/trace") as prof:
                rdd.reduce_by_key(op="add").collect()

        Records CPU activity, and CUDA activity when the Context's device
        is a card (a synchronize first, so the block's kernels are in).
        On exit, an exception from the block included, the trace stops and
        is written under log_dir as <host>_<pid>.<time>.pt.trace.json
        (torch.profiler.tensorboard_trace_handler's name): open it in
        chrome://tracing or Perfetto, or point TensorBoard's profiler
        plugin at log_dir. Yields the torch.profiler.profile object
        (key_averages() and the rest). Changes no result."""
        from torch.profiler import ProfilerActivity, profile, \
            tensorboard_trace_handler

        cuda = self.device.type == "cuda"
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=activities,
                       on_trace_ready=tensorboard_trace_handler(log_dir))
        prof.start()
        try:
            yield prof
        finally:
            try:
                if cuda:
                    torch.cuda.synchronize(self.device)
            finally:
                prof.stop()  # writes the trace (on_trace_ready)

    def stop(self) -> None:
        """Stop the streaming plane (its receivers, its loop, its blocks;
        committed state stays), stop the job server (every job in flight
        cancelled, its future settled, later jobs refused), settle the
        deferred exchanges, so blocks a caller holds stay readable and the
        Context holds no block after it stops; stop the scheduler's
        backend and bus, close the shuffle store and the cache and remove
        the session directory; then stop. If settlement raises, its
        leftover blocks raise on read."""
        assert_role()  # driver teardown — never from a confined thread
        try:
            if self._streaming is not None:
                try:
                    self._streaming.stop()
                except Exception:  # noqa: BLE001 — the rest still stops
                    log.warning("streaming stop failed", exc_info=True)
            # the autoscaler first: no decision against a stopping fleet
            if getattr(self, "elastic", None) is not None:
                self.elastic.stop(teardown=True)
            self.job_server.stop()
            dense_rdd._settle_pending(self)
        finally:
            with _live_lock:
                if self in _live_contexts:
                    _live_contexts.remove(self)
            for entry in self._pending:
                entry["block"].settle = dense_rdd._unrepaired_raise
            self._pending.clear()
            self._capacity_hints.clear()
            self._key_range_hints.clear()
            self.scheduler.stop()
            self.env.close()
            shutil.rmtree(self._work_dir(), ignore_errors=True)
            self._close_session_log()
            self._stopped = True

    def _close_session_log(self) -> None:
        detach_session_logger(self._log_handler)
        self._log_handler = None
        if self._log_dir is not None and self.conf.log_cleanup:
            shutil.rmtree(self._log_dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def __reduce__(self):
        """A serialized lineage (serialize_tasks_locally) carries its
        Context as a handle to this live one, never its state."""
        return (_live_context, (self._ctx_id,))


def _live_context(ctx_id: int) -> "Context":
    """The Context a lineage names: the live one of that id, else, in an
    executor process, its _StubContext."""
    with _live_lock:
        for ctx in _live_contexts:
            if ctx._ctx_id == ctx_id:
                return ctx
    if _stub_context is not None:
        return _stub_context
    raise VegaError(f"Context {ctx_id} is not live in this process")


class _StubContext:
    """What a lineage's Context is inside an executor process (the
    reference's _StubContext): id counters from 1 << 40, so ids made here
    never meet the driver's, and the executor's Env; a job cannot start
    here."""

    def __init__(self, env):
        self.env = env
        self._rdd_ids = itertools.count(1 << 40)
        self._shuffle_ids = itertools.count(1 << 40)

    def new_rdd_id(self) -> int:
        return next(self._rdd_ids)

    def new_shuffle_id(self) -> int:
        return next(self._shuffle_ids)

    def run_job(self, *_a, **_k):
        raise RuntimeError("run_job is driver-only; executors compute "
                           "partitions")

    def __reduce__(self):
        return (_live_context, (-1,))


_stub_context: Optional[_StubContext] = None


def _install_executor_env(env) -> None:
    """Make this process an executor's: lineages it unpickles get a
    _StubContext over env (distributed/worker.py)."""
    global _stub_context
    _stub_context = _StubContext(env)


def _materialize_dense(rdd) -> None:
    """The device work of a host job, on its driver thread before its
    stages are cut (DAGScheduler.prepare): every DenseRDD the lineage
    reads materialized (each one's own lineage with it), in one
    depth-first order; across processes each one's rows are read to the
    host here too, so task threads dispatch no collective."""
    ctx = rdd.context
    ships = ctx.scheduler.backend.preserialize_stage_binaries or \
        ctx.conf.deployment_mode is DeploymentMode.DISTRIBUTED
    stack, seen = [rdd], set()
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        if isinstance(node, dense_rdd.DenseRDD):
            if node.mesh.collective:
                node._host_stage()
            else:
                node.block()
            if ships:
                # the node's rows as they will be pickled, taken here
                # under the dense lock (never on a dispatch thread)
                node._pickle_memo()
            continue
        stack.extend(reversed([dep.rdd for dep in node.get_dependencies()]))
