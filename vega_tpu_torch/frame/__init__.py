"""vega_tpu_torch.frame: the columnar DataFrame layer on the device tier
(the port of vega_tpu/frame's device lowering).

Expression IR (expr.py), logical plan and its pure rewrites (logical.py),
the logical -> device compiler with whole-stage fusion and parquet
pushdown (planner.py), the lazy sources (physical.py), the parquet
helpers (parquet.py) and the action surface (api.py, the only module
here that materializes).

Entry points: ``ctx.create_frame(cols)`` and ``ctx.read_parquet(path)``
(context.py)."""

from vega_tpu_torch.frame.api import DataFrame, GroupedFrame
from vega_tpu_torch.frame.expr import F, col, lit, udf

__all__ = ["DataFrame", "GroupedFrame", "F", "col", "lit", "udf"]
