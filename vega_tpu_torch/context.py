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
lineages of Python rows run in this process: run_job computes the
partitions an action asks for in order on the calling thread, and a
shuffle's map side runs once, in process (rdd/shuffled.py). A host RDD's
dense() lifts its rows onto this Context's device; a DenseRDD's to_rdd(),
glom(), map_partitions(), coalesce() and the rest hand its shards' rows
to this layer. default_parallelism is the shard count.

profiler(log_dir) traces a block of work with torch.profiler (the
reference's Context.profiler traces with jax.profiler): CPU activity
always, the card's kernels when the Context runs on CUDA, written on exit
as a Chrome trace under log_dir that TensorBoard's profiler plugin also
reads.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import os
import pickle
import shutil
import tempfile
import uuid
from typing import Callable, List, Optional, Sequence

import torch

from vega_tpu_torch import dense_rdd
from vega_tpu_torch import exchange_plan
from vega_tpu_torch import jobs
from vega_tpu_torch import kernels
from vega_tpu_torch.errors import VegaError
from vega_tpu_torch.frame.api import DataFrame
from vega_tpu_torch import mesh as mesh_lib
from vega_tpu_torch.mesh import make_mesh
from vega_tpu_torch.store import DiskStore


class Context:
    def __init__(self, device: Optional[str] = None, n_shards: int = 8,
                 dense_sort_impl: str = "auto", dense_rbk_plan: str = "auto",
                 dense_table_plan: str = "auto",
                 dense_hbm_budget: int = 4 << 30,
                 dense_exchange: str = "auto",
                 dense_dict_enabled: bool = True,
                 dense_dict_capacity: int = 65536,
                 spill_dir: Optional[str] = None,
                 multihost: Optional[dict] = None):
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
        # the host layer's in-process shuffles: shuffle id -> [reduce
        # partition][map partition] -> combined rows (rdd/shuffled.py)
        self._shuffle_outputs: dict = {}
        # persisted host partitions kept in memory: (rdd_id, index) -> rows
        self._host_cache: dict = {}
        # the disk tier of persisted nodes (paths only: the store makes its
        # directory at the first demotion)
        base = spill_dir or os.path.join(tempfile.gettempdir(), "vega-tpu",
                                         "spill")
        self._spill = DiskStore(os.path.join(
            base, f"session-{uuid.uuid4().hex[:12]}", "cache"))
        # the FIFO worker of the asynchronous actions (jobs.py)
        self._jobs = jobs.JobRunner()
        self._stopped = False

    @staticmethod
    def _join(multihost: dict, device):
        """Join the process group before any block is built
        (mesh.ensure_multihost) and return the device: the one given,
        else cuda:{process_id % device_count} when a card exists, else
        the CPU (the gloo default)."""
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
        all), computed in order on the calling thread. The lineage's
        checkpoint-marked nodes are written first. The cyclic garbage
        collector pauses while partitions compute (paused_gc), user
        functions included."""
        self._check_running()
        if partitions is not None and not partitions:
            return []
        rdd._do_checkpoint()
        splits = rdd.cached_splits()
        ids = range(len(splits)) if partitions is None else partitions
        out = []
        with paused_gc():
            for i in ids:
                tc = TaskContext(i)
                out.append(func(tc, rdd.iterator(splits[i], tc)))
        return out

    def _submit_host_job(self, rdd, func: Callable, transform: Callable):
        """An asynchronous host action: a JobFuture (jobs.py) settled with
        transform(run_job(rdd, func)). The lineage's device work (its
        checkpoints and every DenseRDD's block) runs here, on the calling
        thread, and the rows are read on the job worker; across processes
        the whole job runs here, so every process dispatches its
        collectives in one order."""
        self._check_running()
        rdd._do_checkpoint()
        if self.mesh.collective:
            try:
                value = transform(self.run_job(rdd, func))
            except Exception as e:  # noqa: BLE001 — surfaces via result()
                err = e

                def fail():
                    raise err
                return self._jobs.submit(fail)
            return self._jobs.submit(lambda: value)
        _materialize_dense(rdd)
        return self._jobs.submit(lambda: transform(self.run_job(rdd, func)))

    def _host_cached(self, rdd, split, task_context):
        """A persisted host node's partition: computed once, then kept in
        memory (MEMORY_ONLY, MEMORY_AND_DISK) or in the disk store as a
        pickled row list (DISK_ONLY)."""
        from vega_tpu_torch.store import StorageLevel

        if rdd.storage_level is StorageLevel.DISK_ONLY:
            key = _host_disk_key(rdd.rdd_id, split.index)
            data = self._spill.get(key)
            if data is not None:
                return iter(pickle.loads(data))
            rows = list(rdd.compute(split, task_context))
            self._spill.put(key, pickle.dumps(
                rows, protocol=pickle.HIGHEST_PROTOCOL))
            return iter(rows)
        key = (rdd.rdd_id, split.index)
        rows = self._host_cache.get(key)
        if rows is None:
            rows = list(rdd.compute(split, task_context))
            self._host_cache[key] = rows
        return iter(rows)

    def _host_uncache(self, rdd) -> None:
        for i in range(rdd.num_partitions):
            self._host_cache.pop((rdd.rdd_id, i), None)
            self._spill.remove(_host_disk_key(rdd.rdd_id, i))

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
        """Settle the deferred exchanges, so blocks a caller holds stay
        readable and the Context holds no block after it stops; remove
        the spill directory; then stop. The asynchronous actions'
        worker drains first. If settlement raises, its leftover blocks
        raise on read."""
        try:
            self._jobs.drain()
            dense_rdd._settle_pending(self)
        finally:
            for entry in self._pending:
                entry["block"].settle = dense_rdd._unrepaired_raise
            self._pending.clear()
            self._capacity_hints.clear()
            self._key_range_hints.clear()
            self._shuffle_outputs.clear()
            self._host_cache.clear()
            self._spill.close()
            shutil.rmtree(self._work_dir(), ignore_errors=True)
            self._stopped = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


class TaskContext:
    """What run_job passes each partition's function: the partition's
    index (and the reference's attempt id, always 0 here)."""

    __slots__ = ("split_index", "attempt_id")

    def __init__(self, split_index: int):
        self.split_index = split_index
        self.attempt_id = 0


@contextlib.contextmanager
def paused_gc():
    """The cyclic garbage collector off for one host job: the host
    layer's rows, buckets and groups hold no cycles, and at millions of
    rows the collector's passes over them cost more than the job
    (PERF.md, PR 19: phase 19 with and without the pause)."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def _host_disk_key(rdd_id: int, index: int) -> str:
    return f"host-rdd-{rdd_id}-{index}"


def _materialize_dense(rdd) -> None:
    """Materialize every DenseRDD a host lineage reads (each one's own
    lineage with it)."""
    stack, seen = [rdd], set()
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        if isinstance(node, dense_rdd.DenseRDD):
            node.block()
            continue
        stack.extend(dep.rdd for dep in node.get_dependencies())
