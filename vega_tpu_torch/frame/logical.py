"""Frame logical plan (the port's copy of vega_tpu/frame/logical.py): a
small verb tree (scan / project / filter / group-agg / join / sort /
limit) plus the pure rewrites the planner runs before lowering: column
pruning (only referenced columns survive down to the scan, so the parquet
reader materializes nothing else) and predicate pushdown (supported
`col op literal` conjuncts sitting on a parquet scan move INTO the scan,
where row-group statistics skip whole groups).

Everything here is pure plan algebra: no data reads, no device work, no
node construction (tests/test_torch_frame.py holds explain() to that);
the one external touch is a CACHED parquet-footer read gating float
predicate pushdown (see _exact_under_narrowing)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from vega_tpu_torch.errors import VegaError
from vega_tpu_torch.frame.expr import Agg, BinOp, Col, Expr, Lit, _render


class LogicalPlan:
    """Base node. `columns()` is the output column list (schema order)."""

    def columns(self) -> List[str]:
        raise NotImplementedError

    def children(self) -> Tuple["LogicalPlan", ...]:
        return ()

    def describe(self) -> str:
        raise NotImplementedError


class ParquetScan(LogicalPlan):
    def __init__(self, path: str, all_columns: Sequence[str],
                 columns: Optional[Sequence[str]] = None,
                 predicate: Sequence[tuple] = (),
                 num_partitions: Optional[int] = None):
        self.path = path
        self.all_columns = list(all_columns)
        self.columns_kept = list(columns) if columns is not None else None
        self.predicate = list(predicate)
        # the host tier's partitions (the device tier's are the shards)
        self.num_partitions = num_partitions

    def columns(self) -> List[str]:
        return list(self.columns_kept if self.columns_kept is not None
                    else self.all_columns)

    def describe(self) -> str:
        cols = ("*" if self.columns_kept is None
                else ",".join(self.columns_kept))
        pred = "".join(f" and {nm}{op}{v!r}"
                       for nm, op, v in self.predicate)
        return f"ParquetScan({self.path}, cols=[{cols}]{pred})"


class ColumnsScan(LogicalPlan):
    """In-memory columnar source (ctx.create_frame)."""

    def __init__(self, data: dict, num_partitions: Optional[int] = None):
        self.data = {nm: c for nm, c in data.items()}
        self.num_partitions = num_partitions

    def columns(self) -> List[str]:
        return list(self.data)

    def describe(self) -> str:
        return f"ColumnsScan([{','.join(self.data)}])"


class Project(LogicalPlan):
    """Named expression projection — select() and with_column() both
    normalize to this (with_column = every existing column + the new)."""

    def __init__(self, child: LogicalPlan, outputs: Sequence[Tuple[str, Expr]]):
        names = [nm for nm, _ in outputs]
        if len(set(names)) != len(names):
            raise VegaError(f"duplicate output columns: {names}")
        self.child = child
        self.outputs = list(outputs)

    def columns(self) -> List[str]:
        return [nm for nm, _ in self.outputs]

    def children(self):
        return (self.child,)

    def describe(self) -> str:
        parts = ", ".join(
            nm if isinstance(e, Col) and e.name == nm
            else f"{_render(e)} as {nm}" for nm, e in self.outputs)
        return f"Project[{parts}]"


class Filter(LogicalPlan):
    def __init__(self, child: LogicalPlan, predicate: Expr):
        self.child = child
        self.predicate = predicate

    def columns(self) -> List[str]:
        return self.child.columns()

    def children(self):
        return (self.child,)

    def describe(self) -> str:
        return f"Filter[{_render(self.predicate)}]"


class GroupAgg(LogicalPlan):
    def __init__(self, child: LogicalPlan, key: str, aggs: Sequence[Agg]):
        if not aggs:
            raise VegaError("groupBy(...).agg() needs at least one aggregate")
        names = [key] + [a.alias for a in aggs]
        if len(set(names)) != len(names):
            raise VegaError(f"duplicate agg output columns: {names}")
        self.child = child
        self.key = key
        self.aggs = list(aggs)

    def columns(self) -> List[str]:
        return [self.key] + [a.alias for a in self.aggs]

    def children(self):
        return (self.child,)

    def describe(self) -> str:
        return (f"GroupAgg[key={self.key}; "
                + ", ".join(repr(a) for a in self.aggs) + "]")


class Join(LogicalPlan):
    def __init__(self, left: LogicalPlan, right: LogicalPlan, on: str,
                 how: str = "inner", fill_value=0):
        if how not in ("inner", "left"):
            raise VegaError(f"unsupported join type {how!r} (inner|left)")
        overlap = (set(left.columns()) & set(right.columns())) - {on}
        if overlap:
            raise VegaError(
                f"join would collide columns {sorted(overlap)}; rename via "
                "select(..., alias) first")
        self.left = left
        self.right = right
        self.on = on
        self.how = how
        self.fill_value = fill_value

    def columns(self) -> List[str]:
        return ([self.on]
                + [c for c in self.left.columns() if c != self.on]
                + [c for c in self.right.columns() if c != self.on])

    def children(self):
        return (self.left, self.right)

    def describe(self) -> str:
        return f"Join[{self.how} on {self.on}]"


class Sort(LogicalPlan):
    def __init__(self, child: LogicalPlan, by: str, ascending: bool = True):
        self.child = child
        self.by = by
        self.ascending = ascending

    def columns(self) -> List[str]:
        return self.child.columns()

    def children(self):
        return (self.child,)

    def describe(self) -> str:
        return f"Sort[{self.by} {'asc' if self.ascending else 'desc'}]"


class Limit(LogicalPlan):
    def __init__(self, child: LogicalPlan, n: int):
        if n < 0:
            raise VegaError("limit(n) needs n >= 0")
        self.child = child
        self.n = n

    def columns(self) -> List[str]:
        return self.child.columns()

    def children(self):
        return (self.child,)

    def describe(self) -> str:
        return f"Limit[{self.n}]"


# ---------------------------------------------------------------------------
# optimizer: column pruning + predicate pushdown (pure rewrites)
# ---------------------------------------------------------------------------


def _expr_refs(e: Expr) -> set:
    out: set = set()
    e.references(out)
    return out


def prune_columns(plan: LogicalPlan,
                  required: Optional[set] = None) -> LogicalPlan:
    """Top-down pruning: each node keeps only the columns its consumers
    reference; scans end up reading exactly what the query touches."""
    if isinstance(plan, Project):
        outputs = (plan.outputs if required is None
                   else [(nm, e) for nm, e in plan.outputs
                         if nm in required])
        if not outputs:  # a consumer needing nothing still needs rows
            outputs = plan.outputs[:1]
        need: set = set()
        for _nm, e in outputs:
            need |= _expr_refs(e)
        if not need:
            # Literal-only projection: no column is referenced, but the
            # ROW COUNT still is — keep one child column so the scan
            # cannot prune to zero columns (which would read zero rows).
            child_cols = plan.child.columns()
            if child_cols:
                need = {child_cols[0]}
        return Project(prune_columns(plan.child, need), outputs)
    if isinstance(plan, Filter):
        child_req = (None if required is None
                     else set(required) | _expr_refs(plan.predicate))
        return Filter(prune_columns(plan.child, child_req), plan.predicate)
    if isinstance(plan, GroupAgg):
        need = {plan.key}
        for a in plan.aggs:
            if a.expr is not None:
                need |= _expr_refs(a.expr)
        return GroupAgg(prune_columns(plan.child, need), plan.key, plan.aggs)
    if isinstance(plan, Join):
        lcols = set(plan.left.columns())
        rcols = set(plan.right.columns())
        if required is None:
            lreq, rreq = lcols, rcols
        else:
            lreq = (required & lcols) | {plan.on}
            rreq = (required & rcols) | {plan.on}
        return Join(prune_columns(plan.left, lreq),
                    prune_columns(plan.right, rreq),
                    plan.on, plan.how, plan.fill_value)
    if isinstance(plan, Sort):
        child_req = (None if required is None
                     else set(required) | {plan.by})
        return Sort(prune_columns(plan.child, child_req), plan.by,
                    plan.ascending)
    if isinstance(plan, Limit):
        return Limit(prune_columns(plan.child, required), plan.n)
    if isinstance(plan, ParquetScan):
        if required is None:
            return plan
        # Keep file schema order — stable output ordering regardless of
        # the consumer's reference order.
        kept = [c for c in plan.all_columns if c in required]
        if not kept and plan.all_columns:
            kept = plan.all_columns[:1]  # row count survives pruning
        missing = required - set(plan.all_columns)
        if missing:
            raise VegaError(
                f"unknown column(s) {sorted(missing)} — parquet file "
                f"{plan.path!r} has {plan.all_columns}")
        return ParquetScan(plan.path, plan.all_columns, kept,
                           plan.predicate, plan.num_partitions)
    if isinstance(plan, ColumnsScan):
        if required is None:
            return plan
        missing = required - set(plan.data)
        if missing:
            raise VegaError(
                f"unknown column(s) {sorted(missing)} — frame has "
                f"{list(plan.data)}")
        if not required and plan.data:
            required = {next(iter(plan.data))}  # row count survives
        return ColumnsScan({nm: c for nm, c in plan.data.items()
                            if nm in required}, plan.num_partitions)
    raise VegaError(f"unknown plan node {type(plan).__name__}")


_PUSHABLE_OPS = ("==", "!=", "<", "<=", ">", ">=")


def _conjuncts(e: Expr) -> List[Expr]:
    if isinstance(e, BinOp) and e.op == "&":
        return _conjuncts(e.left) + _conjuncts(e.right)
    return [e]


def _as_pushdown(e: Expr) -> Optional[tuple]:
    """(column, op, literal) when the conjunct is a supported scan-level
    comparison, else None (it stays a residual in-plan filter)."""
    if not (isinstance(e, BinOp) and e.op in _PUSHABLE_OPS):
        return None
    flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
            "==": "==", "!=": "!="}
    left, right, op = e.left, e.right, e.op
    if isinstance(left, Lit) and isinstance(right, Col):
        left, right, op = right, left, flip[op]
    if isinstance(left, Col) and isinstance(right, Lit) \
            and isinstance(right.value, (int, float, str, bytes, bool)):
        return (left.name, op, right.value)
    return None


def _pushable_path(plan: LogicalPlan):
    """(scan, name_map, rebuild) when `plan` reaches a ParquetScan through
    nothing but pure column projections and filters — the nodes a
    per-row predicate commutes with. `name_map` translates THIS level's
    column names to scan column names (computed projections drop out:
    predicates over them stay residual); `rebuild(new_scan)` re-wraps the
    path around a replacement scan."""
    if isinstance(plan, ParquetScan):
        return plan, {c: c for c in plan.all_columns}, lambda s: s
    if isinstance(plan, Project):
        scan, inner, rebuild = _pushable_path(plan.child)
        if scan is None:
            return None, None, None
        mapping = {nm: inner[e.name] for nm, e in plan.outputs
                   if isinstance(e, Col) and e.name in inner}
        outputs = plan.outputs
        return scan, mapping, lambda s: Project(rebuild(s), outputs)
    if isinstance(plan, Filter):
        scan, inner, rebuild = _pushable_path(plan.child)
        if scan is None:
            return None, None, None
        pred = plan.predicate
        return scan, inner, lambda s: Filter(rebuild(s), pred)
    return None, None, None


def _exact_under_narrowing(scan: ParquetScan, column: str) -> bool:
    """True when comparisons on this scan column give the same answer in
    the reader (raw file values) and in a device stage (after the
    documented dtype narrowing). Floats narrow f64->f32 on device, so a
    reader-side f64 compare can keep a row a device-side f32 compare
    would drop — pushing such a conjunct would make pushdown observable.
    Ints/bools/objects are exact (out-of-range ints never reach the
    device: the source raises first). Metadata-only (cached parquet
    footer); unknown dtypes stay conservative."""
    try:
        import numpy as np

        from vega_tpu_torch.frame.parquet import parquet_schema

        dt = np.dtype(parquet_schema(scan.path)[column])
    except Exception:  # noqa: BLE001 — no metadata: don't push
        return False
    return dt.kind in ("i", "u", "b", "O")


def push_predicates(plan: LogicalPlan) -> LogicalPlan:
    """Move supported `col op literal` conjuncts of filters into the
    ParquetScan they (transitively) read from — through pure column
    projections, with renames translated; unsupported conjuncts (and
    conjuncts a dtype narrowing could make tier-observable) remain as a
    residual in-plan Filter."""
    if isinstance(plan, Filter):
        child = push_predicates(plan.child)
        scan, mapping, rebuild = _pushable_path(child)
        if scan is not None:
            pushed: List[tuple] = []
            residual: List[Expr] = []
            for c in _conjuncts(plan.predicate):
                p = _as_pushdown(c)
                if p is not None and p[0] in mapping \
                        and _exact_under_narrowing(scan, mapping[p[0]]):
                    pushed.append((mapping[p[0]], p[1], p[2]))
                else:
                    residual.append(c)
            if pushed:
                new_scan = ParquetScan(scan.path, scan.all_columns,
                                       scan.columns_kept,
                                       list(scan.predicate) + pushed,
                                       scan.num_partitions)
                child = rebuild(new_scan)
            if not residual:
                return child
            pred = residual[0]
            for c in residual[1:]:
                pred = BinOp("&", pred, c)
            return Filter(child, pred)
        return Filter(child, plan.predicate)
    kids = plan.children()
    if not kids:
        return plan
    new_kids = tuple(push_predicates(k) for k in kids)
    if all(a is b for a, b in zip(kids, new_kids)):
        return plan
    clone = object.__new__(type(plan))
    clone.__dict__.update(plan.__dict__)
    if isinstance(plan, Join):
        clone.left, clone.right = new_kids
    else:
        clone.child = new_kids[0]
    return clone


def optimize(plan: LogicalPlan, pushdown: bool = True) -> LogicalPlan:
    plan = prune_columns(plan, None)
    if pushdown:
        plan = push_predicates(plan)
        # pushdown may have emptied a filter; prune once more so scans
        # reflect the final shape.
        plan = prune_columns(plan, None)
    return plan


def explain_tree(plan: LogicalPlan, indent: int = 0) -> str:
    lines = ["  " * indent + plan.describe()]
    for k in plan.children():
        lines.append(explain_tree(k, indent + 1))
    return "\n".join(lines)
