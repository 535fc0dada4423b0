"""Frame expression IR (the port's copy of vega_tpu/frame/expr.py):
column refs, literals, arithmetic / comparison / boolean operators, opaque
columnwise UDFs, and named aggregate descriptors.

An Expr is a small tree evaluated COLUMNWISE: `evaluate(expr, env)` maps a
{name: column} environment of torch tensors ([n_shards, capacity]) to a
column with plain Python operators. The planner decides traceability by
running the whole stage once on empty probe columns (planner._flush),
never by value probing. `Udf` wraps a Python callable applied to whole
columns: a torch-vectorized callable fuses into the stage like any
operator; anything else fails the probe and the plan compiles on the
host tier, as the reference's does. There `evaluate(expr, env,
host=True)` runs the same tree over numpy columns (a block) or Python
values (a row), and a Udf is called on numpy arrays, then element by
element where it does not take arrays.

Aggregates (`F.sum/min/max/count/mean`) are descriptors, not expressions:
the planner lowers them onto the named-op reduce or a traced tuple
combiner (monoid selection by NAME, never by value probing)."""

from __future__ import annotations

import operator
from typing import Callable, Optional

from vega_tpu_torch.errors import VegaError

_BIN_OPS = {
    "+": operator.add, "-": operator.sub, "*": operator.mul,
    "/": operator.truediv, "//": operator.floordiv, "%": operator.mod,
    "==": operator.eq, "!=": operator.ne,
    "<": operator.lt, "<=": operator.le,
    ">": operator.gt, ">=": operator.ge,
    "&": operator.and_, "|": operator.or_, "^": operator.xor,
}
_UNARY_OPS = {"-": operator.neg, "~": operator.invert}


class Expr:
    """Base expression node. Subclasses implement `_eval(env)`,
    `references(out)` and `token()` (a stable, picklable structural
    identity used for program-cache keys and explain output)."""

    # --- operator sugar ----------------------------------------------------
    def _bin(self, op: str, other, reflected: bool = False) -> "Expr":
        other = _as_expr(other)
        return BinOp(op, other, self) if reflected else BinOp(op, self, other)

    def __add__(self, o):
        return self._bin("+", o)

    def __radd__(self, o):
        return self._bin("+", o, True)

    def __sub__(self, o):
        return self._bin("-", o)

    def __rsub__(self, o):
        return self._bin("-", o, True)

    def __mul__(self, o):
        return self._bin("*", o)

    def __rmul__(self, o):
        return self._bin("*", o, True)

    def __truediv__(self, o):
        return self._bin("/", o)

    def __rtruediv__(self, o):
        return self._bin("/", o, True)

    def __floordiv__(self, o):
        return self._bin("//", o)

    def __mod__(self, o):
        return self._bin("%", o)

    def __eq__(self, o):  # noqa: D105 — builds an expression, not identity
        return self._bin("==", o)

    def __ne__(self, o):
        return self._bin("!=", o)

    def __lt__(self, o):
        return self._bin("<", o)

    def __le__(self, o):
        return self._bin("<=", o)

    def __gt__(self, o):
        return self._bin(">", o)

    def __ge__(self, o):
        return self._bin(">=", o)

    def __and__(self, o):
        return self._bin("&", o)

    def __or__(self, o):
        return self._bin("|", o)

    def __xor__(self, o):
        return self._bin("^", o)

    def __neg__(self):
        return UnaryOp("-", self)

    def __invert__(self):
        return UnaryOp("~", self)

    __hash__ = None  # == builds an Expr; these are not dict keys

    # --- protocol ----------------------------------------------------------
    def _eval(self, env: dict):
        raise NotImplementedError

    def references(self, out: set) -> None:
        raise NotImplementedError

    def token(self) -> tuple:
        raise NotImplementedError

    def __repr__(self) -> str:
        return _render(self)


class Col(Expr):
    def __init__(self, name: str):
        self.name = name

    def _eval(self, env: dict):
        try:
            return env[self.name]
        except KeyError:
            raise VegaError(
                f"no such column: {self.name!r} (have {sorted(env)})"
            ) from None

    def references(self, out: set) -> None:
        out.add(self.name)

    def token(self) -> tuple:
        return ("col", self.name)


class Lit(Expr):
    def __init__(self, value):
        self.value = value

    def _eval(self, env: dict):
        return self.value

    def references(self, out: set) -> None:
        pass

    def token(self) -> tuple:
        # repr keeps NaN/float identity stable across processes.
        return ("lit", repr(self.value), type(self.value).__name__)


class BinOp(Expr):
    def __init__(self, op: str, left: Expr, right: Expr):
        if op not in _BIN_OPS:
            raise VegaError(f"unknown operator {op!r}")
        self.op = op
        self.left = left
        self.right = right

    def _eval(self, env: dict):
        return _BIN_OPS[self.op](self.left._eval(env), self.right._eval(env))

    def references(self, out: set) -> None:
        self.left.references(out)
        self.right.references(out)

    def token(self) -> tuple:
        return ("bin", self.op, self.left.token(), self.right.token())


class UnaryOp(Expr):
    def __init__(self, op: str, operand: Expr):
        self.op = op
        self.operand = operand

    def _eval(self, env: dict):
        return _UNARY_OPS[self.op](self.operand._eval(env))

    def references(self, out: set) -> None:
        self.operand.references(out)

    def token(self) -> tuple:
        return ("unary", self.op, self.operand.token())


class Udf(Expr):
    """Opaque columnwise callable: fn receives the evaluated argument
    COLUMN(s) and must return a same-length column or a Python constant.
    On the device tier (torch tensors) the stage probe decides:
    torch-vectorized callables fuse like any operator; anything else
    sends the plan to the host tier, where fn runs over numpy columns,
    with a per-element fallback for scalar-only callables
    (_eval_host)."""

    def __init__(self, fn: Callable, *args: Expr, name: Optional[str] = None):
        self.fn = fn
        self.args = tuple(_as_expr(a) for a in args)
        self.name = name or getattr(fn, "__name__", "udf")

    def _eval(self, env: dict):
        return self.fn(*[a._eval(env) for a in self.args])

    def _eval_host(self, env: dict):
        """Host evaluation with the scalar-callable fallback: the
        columnwise contract first; a callable that fails on arrays (dict
        lookups, object methods) or does not give one value per row is
        applied per element instead."""
        import numpy as np

        cols = [a._eval(env) for a in self.args]
        try:
            out = self.fn(*cols)
            first = next((c for c in cols if hasattr(c, "__len__")), None)
            if first is not None and (not hasattr(out, "__len__")
                                      or len(out) != len(first)):
                raise TypeError("not columnwise")
            return out
        except Exception:  # noqa: BLE001 — scalar fallback, same contract
            arrays = [np.asarray(c) for c in cols]
            # the loop's length is the first ARRAY argument's, wherever
            # it sits: a literal first argument must not shrink the column
            ref = next((a for a in arrays if a.ndim), None)
            if ref is None:  # all-scalar call
                return self.fn(*[a.item() for a in arrays])
            return np.asarray([
                self.fn(*[a[i].item() if a.ndim else a.item()
                          for a in arrays])
                for i in range(len(ref))
            ])

    def references(self, out: set) -> None:
        for a in self.args:
            a.references(out)

    def token(self) -> tuple:
        # the code, constants and captured values of fn (dense_rdd._fp)
        from vega_tpu_torch.dense_rdd import _fp

        return ("udf", self.name, _fp(self.fn)) + tuple(
            a.token() for a in self.args)


def _as_expr(v) -> Expr:
    if isinstance(v, Expr):
        return v
    if isinstance(v, str):
        return Col(v)
    return Lit(v)


def _render(e: Expr) -> str:
    if isinstance(e, Col):
        return e.name
    if isinstance(e, Lit):
        return repr(e.value)
    if isinstance(e, BinOp):
        return f"({_render(e.left)} {e.op} {_render(e.right)})"
    if isinstance(e, UnaryOp):
        return f"({e.op}{_render(e.operand)})"
    if isinstance(e, Udf):
        return f"{e.name}({', '.join(_render(a) for a in e.args)})"
    return object.__repr__(e)


def evaluate(expr: Expr, env: dict, host: bool = False):
    """Columnwise evaluation against {name: column}. host=True routes Udf
    nodes through the host tier's scalar fallback (Udf._eval_host)."""
    if host:
        return _eval_host(expr, env)
    return expr._eval(env)


def _eval_host(expr: Expr, env: dict):
    if isinstance(expr, Udf):
        # sub-arguments on the host path too (nested udfs)
        hosted = Udf(expr.fn, *[Lit(_eval_host(a, env)) for a in expr.args],
                     name=expr.name)
        return hosted._eval_host(env)
    if isinstance(expr, BinOp):
        return _BIN_OPS[expr.op](_eval_host(expr.left, env),
                                 _eval_host(expr.right, env))
    if isinstance(expr, UnaryOp):
        return _UNARY_OPS[expr.op](_eval_host(expr.operand, env))
    return expr._eval(env)


# ---------------------------------------------------------------------------
# public constructors
# ---------------------------------------------------------------------------


def col(name: str) -> Col:
    return Col(name)


def lit(value) -> Lit:
    return Lit(value)


def udf(fn: Callable, *args, name: Optional[str] = None) -> Udf:
    return Udf(fn, *args, name=name)


# ---------------------------------------------------------------------------
# aggregate descriptors
# ---------------------------------------------------------------------------

_AGG_OPS = ("sum", "min", "max", "count", "mean")
# Monoid each aggregate lowers onto (count/mean ride synthesized add
# columns). Selection is by NAME — sound by construction.
_AGG_MONOID = {"sum": "add", "min": "min", "max": "max",
               "count": "add", "mean": "add"}


class Agg:
    """One aggregate: op over an expression, output column `alias`."""

    def __init__(self, op: str, expr: Optional[Expr], alias: str):
        if op not in _AGG_OPS:
            raise VegaError(f"unknown aggregate {op!r}; have {_AGG_OPS}")
        self.op = op
        self.expr = expr
        self.alias = alias

    def alias_as(self, name: str) -> "Agg":
        return Agg(self.op, self.expr, name)

    def token(self) -> tuple:
        return ("agg", self.op,
                None if self.expr is None else self.expr.token(), self.alias)

    def __repr__(self) -> str:
        inner = "" if self.expr is None else _render(self.expr)
        return f"{self.op}({inner}) as {self.alias}"


class _F:
    """Aggregate namespace: F.sum("x"), F.count(), F.mean(col("x") * 2)."""

    @staticmethod
    def _make(op: str, e=None, alias: Optional[str] = None) -> Agg:
        expr = None if e is None else _as_expr(e)
        if alias is None:
            base = e if isinstance(e, str) else (
                expr.name if isinstance(expr, Col) else op)
            alias = f"{op}_{base}" if e is not None else op
        return Agg(op, expr, alias)

    @staticmethod
    def sum(e, alias: Optional[str] = None) -> Agg:
        return _F._make("sum", e, alias)

    @staticmethod
    def min(e, alias: Optional[str] = None) -> Agg:
        return _F._make("min", e, alias)

    @staticmethod
    def max(e, alias: Optional[str] = None) -> Agg:
        return _F._make("max", e, alias)

    @staticmethod
    def count(alias: Optional[str] = None) -> Agg:
        return _F._make("count", None, alias)

    @staticmethod
    def mean(e, alias: Optional[str] = None) -> Agg:
        return _F._make("mean", e, alias)


F = _F()
