"""Context: the entry point of vega_tpu_torch (counterpart of the dense
sources of vega_tpu/context.py).

    with Context() as ctx:                       # the first CUDA card
        kv = ctx.dense_range(n).map(lambda x: (x % k, x * 0.5))
        kv.reduce_by_key(op="add").join(table).count()

A Context runs on CUDA unless the caller passes device="cpu"; with no card
and no device it raises. Its n_shards virtual shards (default 8, the
reference test mesh) are the leading dimension of every column tensor.
"""

from __future__ import annotations

from typing import Optional

import torch

from vega_tpu_torch import dense_rdd
from vega_tpu_torch.errors import VegaError
from vega_tpu_torch.mesh import make_mesh


class Context:
    # The reference resolves these per backend; these are its choices on an
    # accelerator and the only plans ported.
    dense_rbk_plan = "fused_sort"
    dense_table_plan = "off"
    dense_sort_impl = "xla"

    def __init__(self, device: Optional[str] = None, n_shards: int = 8):
        self.mesh = make_mesh(n_shards, device)
        # capacity hints: (lineage, input sizes) -> (slot, out) capacities
        self._capacity_hints: dict = {}
        self._stopped = False

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def _check_running(self) -> None:
        if self._stopped:
            raise VegaError("Context is stopped")

    def dense_range(self, n: int, dtype=torch.int32):
        """Device iota source of n rows (int32 unless dtype says)."""
        self._check_running()
        return dense_rdd.dense_range(self, n, dtype)

    def dense_from_numpy(self, *columns):
        """Dense source from host arrays: (values) or (keys, values)."""
        self._check_running()
        return dense_rdd.dense_from_numpy(self, columns)

    def stop(self) -> None:
        self._capacity_hints.clear()
        self._stopped = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
