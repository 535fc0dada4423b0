"""Context: the entry point of vega_tpu_torch (counterpart of the dense
sources of vega_tpu/context.py).

    with Context() as ctx:                       # the first CUDA card
        kv = ctx.dense_range(n).map(lambda x: (x % k, x * 0.5))
        kv.reduce_by_key(op="add").join(table).count()

A Context runs on CUDA unless the caller passes device="cpu"; with no card
and no device it raises. Its n_shards virtual shards (default 8, the
reference test mesh) are the leading dimension of every column tensor.

Three plan settings, the reference's Configuration knobs, choose how dense
programs sort and reduce; each takes 'auto', resolved by the Context's
device as the reference resolves it by backend:

    setting           values                         auto: cpu / cuda
    dense_sort_impl   xla | packed | radix | radix4  packed / xla
    dense_rbk_plan    fused_sort | sort_partition    sort_partition /
                                                     fused_sort
    dense_table_plan  on | off                       on / off

A misspelt value raises VegaError naming the allowed values.

dense_hbm_budget (bytes, default 4 GiB, the reference's Configuration
field) bounds device memory twice, as in the reference: a source whose
one-shot exchange would need more (6x its bytes) streams in chunks
(stream.py), and materialized intermediates beyond it are evicted in LRU
order and recomputed from their lineage when read again
(dense_hbm_in_use).
"""

from __future__ import annotations

import itertools
from typing import Optional

import torch

from vega_tpu_torch import dense_rdd
from vega_tpu_torch import kernels
from vega_tpu_torch.errors import VegaError
from vega_tpu_torch.mesh import make_mesh


class Context:
    def __init__(self, device: Optional[str] = None, n_shards: int = 8,
                 dense_sort_impl: str = "auto", dense_rbk_plan: str = "auto",
                 dense_table_plan: str = "auto",
                 dense_hbm_budget: int = 4 << 30):
        if dense_hbm_budget < 0:
            raise VegaError(f"dense_hbm_budget must be >= 0 bytes, got "
                            f"{dense_hbm_budget}")
        self.dense_hbm_budget = int(dense_hbm_budget)
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
        streams in chunks (a StreamedDenseRDD) when 6x its bytes exceed
        dense_hbm_budget, or when chunk_rows is given and below n."""
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

    def dense_hbm_in_use(self) -> int:
        """Tracked device bytes of materialized dense intermediates
        (sources excluded), the quantity eviction holds to
        dense_hbm_budget; not the allocator's count."""
        return dense_rdd.dense_hbm_in_use(self)

    def stop(self) -> None:
        """Settle the deferred exchanges, so blocks a caller holds stay
        readable and the Context holds no block after it stops; then
        stop. If settlement raises, its leftover blocks raise on read."""
        try:
            dense_rdd._settle_pending(self)
        finally:
            for entry in self._pending:
                entry["block"].settle = dense_rdd._unrepaired_raise
            self._pending.clear()
            self._capacity_hints.clear()
            self._key_range_hints.clear()
            self._stopped = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
