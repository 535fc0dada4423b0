"""The DataFrame API of vega_tpu_torch (the port's copy of
vega_tpu/frame/api.py): the user-facing face of the frame layer.

A DataFrame is an immutable (logical plan, options) pair; every verb
returns a new frame, and nothing is read, computed, or placed on the
device until an ACTION runs (collect / collect_columns / count / take).
This module is the one place in vega_tpu_torch/frame/ that materializes.

    df = ctx.create_frame(user=users, ms=ms)          # or read_parquet
    out = (df.select("user", "ms")
             .filter(col("ms") > 10)
             .with_column("s", col("ms") / 1000)
             .group_by("user").agg(F.sum("s"), F.count())
             .sort("user")
             .collect())

Fusion, pushdown and per-exchange policy live in planner.py; `hint()`
exposes the knobs (fuse / pushdown / tier / exchange / shuffle_plan).
tier="host" compiles the plan on the host tier (the reference's host
lowering over the port's host RDD layer), tier="device" raises as the
reference's does on a plan it compiles on its host tier, and
shuffle_plan sets the host tier's shuffle plan for the frame's actions
(ignored, with a warning, where the executors were spawned with
another plan, as the reference's).
to_rdd() hands the frame's rows to the RDD API."""

from __future__ import annotations

import contextlib
import logging
from typing import List, Optional

import numpy as np

from vega_tpu_torch.env import DeploymentMode
from vega_tpu_torch.errors import VegaError
from vega_tpu_torch.frame import logical as L
from vega_tpu_torch.frame import parquet as parquet_lib
from vega_tpu_torch.frame import physical as P
from vega_tpu_torch.frame import planner as planner_lib
from vega_tpu_torch.frame.expr import F, Agg, Col, Expr, _as_expr


class DataFrame:
    def __init__(self, ctx, plan: L.LogicalPlan,
                 options: Optional[dict] = None):
        self._ctx = ctx
        self._plan = plan
        self._options = {**planner_lib.DEFAULT_OPTIONS, **(options or {})}

    # ------------------------------------------------------- constructors
    @staticmethod
    def from_parquet(ctx, path: str, columns: Optional[List[str]] = None,
                     num_partitions: Optional[int] = None) -> "DataFrame":
        all_cols = list(parquet_lib.parquet_schema(path))
        plan: L.LogicalPlan = L.ParquetScan(path, all_cols,
                                            num_partitions=num_partitions)
        if columns is not None:
            missing = [c for c in columns if c not in all_cols]
            if missing:
                raise VegaError(
                    f"unknown column(s) {missing} — parquet file "
                    f"{path!r} has {all_cols}")
            plan = L.Project(plan, [(c, Col(c)) for c in columns])
        return DataFrame(ctx, plan)

    @staticmethod
    def from_columns(ctx, data: dict,
                     num_partitions: Optional[int] = None) -> "DataFrame":
        if not data:
            raise VegaError("create_frame needs at least one column")
        arrays = {nm: np.asarray(c) for nm, c in data.items()}
        lens = {nm: len(c) for nm, c in arrays.items()}
        if len(set(lens.values())) > 1:
            raise VegaError(f"columns have unequal lengths: {lens}")
        return DataFrame(ctx, L.ColumnsScan(arrays, num_partitions))

    # --------------------------------------------------------------- verbs
    def _derive(self, plan: L.LogicalPlan) -> "DataFrame":
        if isinstance(self._plan, L.Limit):
            raise VegaError(
                "limit() is terminal — apply transformations before it")
        return DataFrame(self._ctx, plan, self._options)

    @property
    def columns(self) -> List[str]:
        return self._plan.columns()

    def select(self, *cols, **named) -> "DataFrame":
        """Positional args: column names or Exprs (Col exprs keep their
        name; other exprs need the keyword form). Keywords name computed
        columns: select(total=col("a") + col("b"))."""
        outputs = []
        for c in cols:
            if isinstance(c, str):
                outputs.append((c, Col(c)))
            elif isinstance(c, Col):
                outputs.append((c.name, c))
            else:
                raise VegaError(
                    "select() positional arguments must be column names; "
                    "use select(name=expr) for computed columns")
        outputs.extend((nm, _as_expr(e)) for nm, e in named.items())
        known = set(self.columns)
        for _nm, e in outputs:
            refs: set = set()
            e.references(refs)
            missing = refs - known
            if missing:
                raise VegaError(
                    f"unknown column(s) {sorted(missing)} — frame has "
                    f"{self.columns}")
        return self._derive(L.Project(self._plan, outputs))

    def _check_refs(self, expr: Expr, what: str) -> Expr:
        refs: set = set()
        expr.references(refs)
        missing = refs - set(self.columns)
        if missing:
            raise VegaError(
                f"{what} references unknown column(s) {sorted(missing)} — "
                f"frame has {self.columns}")
        return expr

    def with_column(self, name: str, expr) -> "DataFrame":
        expr = self._check_refs(_as_expr(expr), f"with_column({name!r})")
        outputs = [(c, Col(c)) for c in self.columns if c != name]
        outputs.append((name, expr))
        return self._derive(L.Project(self._plan, outputs))

    def rename(self, mapping: dict) -> "DataFrame":
        missing = set(mapping) - set(self.columns)
        if missing:
            raise VegaError(
                f"rename() references unknown column(s) {sorted(missing)}"
                f" — frame has {self.columns}")
        outputs = [(mapping.get(c, c), Col(c)) for c in self.columns]
        return self._derive(L.Project(self._plan, outputs))

    def filter(self, predicate) -> "DataFrame":
        predicate = self._check_refs(_as_expr(predicate), "filter()")
        return self._derive(L.Filter(self._plan, predicate))

    where = filter

    def group_by(self, key: str) -> "GroupedFrame":
        if key not in self.columns:
            raise VegaError(
                f"unknown group key {key!r} — frame has {self.columns}")
        return GroupedFrame(self, key)

    groupBy = group_by

    def join(self, other: "DataFrame", on: str, how: str = "inner",
             fill_value=0) -> "DataFrame":
        if not isinstance(other, DataFrame):
            raise VegaError("join() joins DataFrames")
        if isinstance(other._plan, L.Limit):
            # Same build-time crispness _derive gives the left side.
            raise VegaError(
                "limit() is terminal — apply transformations (and joins) "
                "before it")
        for side, frame in (("left", self), ("right", other)):
            if on not in frame.columns:
                raise VegaError(
                    f"join column {on!r} missing on the {side} side "
                    f"({frame.columns})")
        return self._derive(L.Join(self._plan, other._plan, on, how,
                                   fill_value))

    def sort(self, by: str, ascending: bool = True) -> "DataFrame":
        if by not in self.columns:
            raise VegaError(
                f"unknown sort column {by!r} — frame has {self.columns}")
        return self._derive(L.Sort(self._plan, by, ascending))

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self._ctx, L.Limit(self._plan, n), self._options)

    _HINT_VALUES = {
        "tier": ("auto", "device", "host"),
        "exchange": ("auto", "all_to_all", "ring", "staged"),
        "shuffle_plan": ("pull", "push"),
    }

    def hint(self, **hints) -> "DataFrame":
        """Planner knobs: fuse=, pushdown=, tier=('auto'|'device': the
        reference's error where it would compile its host tier; 'host':
        the host tier for every plan),
        exchange=('auto'|'all_to_all'|'ring'|'staged') — 'auto' routes
        through the exchange planner — and shuffle_plan=('pull'|'push'),
        the host tier's shuffle plan for this frame's actions (in one
        process; across processes the executors keep the plan they were
        spawned with and the hint is ignored with a warning, as the
        reference's)."""
        unknown = set(hints) - set(planner_lib.DEFAULT_OPTIONS)
        if unknown:
            raise VegaError(
                f"unknown hint(s) {sorted(unknown)}; have "
                f"{sorted(planner_lib.DEFAULT_OPTIONS)}")
        # values are validated here: a typo must not reach the planner
        for key, allowed in self._HINT_VALUES.items():
            if key in hints and hints[key] is not None \
                    and hints[key] not in allowed:
                raise VegaError(
                    f"hint {key}={hints[key]!r} — valid values: {allowed}")
        for key in ("fuse", "pushdown"):
            if key in hints and not isinstance(hints[key], bool):
                raise VegaError(f"hint {key}= takes a bool, got "
                                f"{hints[key]!r}")
        return DataFrame(self._ctx, self._plan,
                         {**self._options, **hints})

    # ------------------------------------------------------------- actions
    def _compiled(self) -> planner_lib.Compiled:
        return planner_lib.compile_plan(self._ctx, self._plan,
                                        self._options)

    def explain(self) -> str:
        return self._compiled().explain()

    def collect(self) -> list:
        """Rows as tuples in frame column order (single-column frames
        still yield 1-tuples — the shape never depends on the plan)."""
        cols = self.collect_columns()
        names = self.columns
        arrays = [np.asarray(cols[nm]) for nm in names]
        n = len(arrays[0]) if arrays else 0
        return [tuple(_pyval(a[i]) for a in arrays) for i in range(n)]

    def _shuffle_plan_override(self):
        """hint(shuffle_plan=) around an action: the Context's plan
        swapped for the hint's while it runs; a no-op (warned) when the
        Context's executors were spawned with another plan."""
        plan = self._options.get("shuffle_plan")
        if plan is None:
            return contextlib.nullcontext()
        conf = self._ctx.conf
        if conf.deployment_mode is not DeploymentMode.LOCAL \
                and str(conf.shuffle_plan).lower() != str(plan).lower():
            logging.getLogger(__name__).warning(
                "hint(shuffle_plan=%r) ignored: the executors were spawned "
                "with shuffle_plan=%r and read it at spawn; set it on the "
                "Context instead", plan, conf.shuffle_plan)
            return contextlib.nullcontext()

        @contextlib.contextmanager
        def override():
            saved = conf.shuffle_plan
            conf.shuffle_plan = plan
            try:
                yield
            finally:
                conf.shuffle_plan = saved

        return override()

    def collect_columns(self) -> dict:
        """Columnar collect: {name: numpy array}. A device plan gives its
        block's columns (DenseRDD.collect_arrays; strings decoded), a
        host plan its numpy blocks concatenated or its rows pivoted."""
        with self._shuffle_plan_override():
            return self._collect_columns()

    def _collect_columns(self) -> dict:
        compiled = self._compiled()
        if compiled.kind == "device":
            blk_cols = compiled.rdd.collect_arrays()
            out = {fn: np.asarray(blk_cols[bn]) for fn, bn in compiled.out}
            for fn in compiled.float64:  # decoded as int64: float64 bits
                out[fn] = out[fn].view(np.float64)
            for fn in compiled.bools:  # 0 / 1 int32 words
                out[fn] = out[fn] != 0
        elif compiled.layout == "blocks":
            blocks = compiled.rdd.collect()
            out = {}
            for nm in compiled.cols:
                parts = [np.asarray(b[nm]) for b in blocks]
                out[nm] = (np.concatenate(parts) if parts
                           else np.empty((0,)))
        else:
            # a limit over rows pulls partitions one by one through
            # take() (a sorted layout is ordered across partitions, so
            # the prefix is the answer)
            rows = (compiled.rdd.take(compiled.limit)
                    if compiled.limit is not None
                    else compiled.rdd.collect())
            out = {nm: np.asarray([r[i] for r in rows])
                   for i, nm in enumerate(compiled.cols)}
        if compiled.limit is not None:
            out = {nm: c[:compiled.limit] for nm, c in out.items()}
        return out

    def count(self) -> int:
        compiled = self._compiled()
        with self._shuffle_plan_override():
            if compiled.kind == "host" and compiled.layout == "blocks":
                # the blocks' lengths, not the blocks
                n = sum(compiled.rdd.map(P.host_block_len).collect())
            else:
                n = compiled.rdd.count()
        if compiled.limit is not None:
            n = min(n, compiled.limit)
        return n

    def take(self, n: int) -> list:
        return self.limit(n).collect()

    def to_rdd(self):
        """The compiled lineage as an RDD of frame-ordered row tuples of
        Python values, the escape hatch to the RDD API. A device plan
        gives its DenseRDD's host rows (DenseRDD.to_rdd()) reordered to
        frame order, a float64 column's bits and a bool key's words read
        back as their values; a host plan its row lineage. A limited
        frame collects its (small, by intent) rows and parallelizes
        them, so the limit is never dropped."""
        compiled = self._compiled()
        if compiled.limit is not None:
            return self._ctx.parallelize(self.collect())
        if compiled.kind == "device":
            names = compiled.rdd.row_names()
            idx = [names.index(bn) for _fn, bn in compiled.out]
            kinds = [("float64" if fn in compiled.float64 else
                      "bool" if fn in compiled.bools else None)
                     for fn, _bn in compiled.out]
            return compiled.rdd.to_rdd().map(_frame_row(idx, kinds))
        if compiled.layout == "blocks":
            return compiled.rdd.flat_map(P.host_block_rows(compiled.cols))
        return compiled.rdd


def _pyval(x):
    """numpy scalar -> Python native; object-column values pass through."""
    return x.item() if hasattr(x, "item") else x


def _frame_row(idx: List[int], kinds: List[Optional[str]]):
    """A device plan's host row -> the frame's row: its columns at idx,
    as Python values (a float64 column's int64 bits as the float64, a
    bool key's 0 / 1 word as a bool)."""

    def run(row):
        if not isinstance(row, tuple):
            row = (row,)
        out = []
        for i, kind in zip(idx, kinds):
            x = row[i]
            if kind == "float64":
                x = np.int64(x).view(np.float64)
            elif kind == "bool":
                x = bool(x)
            out.append(_pyval(x))
        return tuple(out)

    return run


class GroupedFrame:
    """group_by(key) cursor; agg(...) closes it back into a DataFrame."""

    def __init__(self, frame: DataFrame, key: str):
        self._frame = frame
        self._key = key

    def agg(self, *aggs: Agg) -> DataFrame:
        for a in aggs:
            if not isinstance(a, Agg):
                raise VegaError(
                    "agg() takes aggregate descriptors (F.sum/F.min/"
                    "F.max/F.count/F.mean)")
        return self._frame._derive(
            L.GroupAgg(self._frame._plan, self._key, list(aggs)))

    def count(self) -> DataFrame:
        return self.agg(F.count())
