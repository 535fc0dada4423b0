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

profiler(log_dir) traces a block of work with torch.profiler (the
reference's Context.profiler traces with jax.profiler): CPU activity
always, the card's kernels when the Context runs on CUDA, written on exit
as a Chrome trace under log_dir that TensorBoard's profiler plugin also
reads.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import tempfile
import uuid
from typing import Optional

import torch

from vega_tpu_torch import dense_rdd
from vega_tpu_torch import exchange_plan
from vega_tpu_torch import kernels
from vega_tpu_torch.errors import VegaError
from vega_tpu_torch.frame.api import DataFrame
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
                 spill_dir: Optional[str] = None):
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
        self.mesh = make_mesh(n_shards, device)
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
        # materialized intermediates, least recently used first:
        # rdd_id -> weakref to the node (dense_rdd's lifetime LRU)
        self._dense_block_lru: dict = {}
        self._rdd_ids = itertools.count()
        # the disk tier of persisted nodes (paths only: the store makes its
        # directory at the first demotion)
        base = spill_dir or os.path.join(tempfile.gettempdir(), "vega-tpu",
                                         "spill")
        self._spill = DiskStore(os.path.join(
            base, f"session-{uuid.uuid4().hex[:12]}", "cache"))
        self._stopped = False

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def _check_running(self) -> None:
        if self._stopped:
            raise VegaError("Context is stopped")

    def dense_range(self, n: int, dtype=torch.int32,
                    chunk_rows: Optional[int] = None):
        """Device iota source of n rows (int32 unless dtype says). It
        streams in chunks (a StreamedDenseRDD) when its planned exchange
        would pass dense_hbm_budget (stream.planned_chunk_rows), or when
        chunk_rows is given and below n."""
        self._check_running()
        return dense_rdd.dense_range(self, n, dtype, chunk_rows=chunk_rows)

    def dense_from_numpy(self, *columns):
        """Dense source from host arrays: (values) or (keys, values)."""
        self._check_running()
        return dense_rdd.dense_from_numpy(self, columns)

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

    def create_frame(self, columns: Optional[dict] = None, **kwcolumns):
        """In-memory columns (a dict and / or keywords) -> DataFrame
        (frame/api.py), the frame-layer sibling of dense_from_columns.
        Nothing is coerced or copied to the device until an action."""
        self._check_running()
        data = dict(columns or {})
        for name, c in kwcolumns.items():
            if name in data:
                raise VegaError(f"duplicate column {name!r}")
            data[name] = c
        return DataFrame.from_columns(self, data)

    def read_parquet(self, path: str, columns: Optional[list] = None):
        """Parquet -> DataFrame: the planner pushes column pruning and
        supported predicates into the reader (frame/parquet.py, which
        needs pyarrow) and applies each narrow verb chain as one stage.
        columns= pre-prunes at the entry point."""
        self._check_running()
        return DataFrame.from_parquet(self, path, columns)

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
        the spill directory; then stop. If settlement raises, its
        leftover blocks raise on read."""
        try:
            dense_rdd._settle_pending(self)
        finally:
            for entry in self._pending:
                entry["block"].settle = dense_rdd._unrepaired_raise
            self._pending.clear()
            self._capacity_hints.clear()
            self._key_range_hints.clear()
            self._spill.close()
            self._stopped = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
