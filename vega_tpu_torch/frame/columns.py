"""Column forms inside a frame stage that plain torch operators do not
give: exact int64 arithmetic over wide columns, comparisons of string
columns, whose device form is rank codes into a sorted dictionary, and
the forms by which the planner applies the reference's host-tier rules:
its numpy arithmetic (host_binop, host_unary, over NpInt columns of
numpy's own width), the float64 cast of a sum (Cast) and the float64
key's decode (KeyFloat64).

A wide int64 column (block.encode_i64's hi / biased-lo word pair) enters
a stage as a `WideInt` over its int64 values. Python operators on it give
another WideInt (+ - * // % and negation, exact), a bool column
(comparisons) or a float64 column (true division, a float operand).
Where an operation leaves int64, or divides by zero, the row is recorded
in the stage's sink; the stage raises VegaError when a valid row is
recorded (the reference's host tier computes on Python ints, which never
overflow, so the port refuses rather than wrap).

A comparison of a string column with a string literal, or of two string
columns, becomes a `DictCmp`. Its codes are resolved when the stage runs,
from the dictionaries of the block it runs on (`resolve`): a literal
becomes a code or a rank boundary, two dictionaries a pair of remap
tables onto their merge. Nothing derived from one dictionary is kept in
the stage or its token, so one stage over two sources with different
dictionaries gives each its own rows."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from vega_tpu_torch import dict_encoding
from vega_tpu_torch.errors import VegaError
from vega_tpu_torch.wideint import I32_MAX, I32_MIN, I64_MAX, I64_MIN, WideInt
from vega_tpu_torch.frame.expr import (_BIN_OPS, _UNARY_OPS, BinOp, Col,
                                       Expr, Lit, UnaryOp, Udf)

# the environment key under which a stage passes its resolved dictionary
# inputs to DictCmp (no frame column is named so)
RESOLVED = "\x00resolved"
# the environment key under which a stage passes its overflow sink to
# HostArith's int64 arithmetic
SINK = "\x00sink"
_CMP_OPS = ("==", "!=", "<", "<=", ">", ">=")
_FLIP = {"==": "==", "!=": "!=", "<": ">", "<=": ">=", ">": "<",
         ">=": "<="}


class Cast(Expr):
    """e as float64, where the reference's host tier divides a sum it
    holds as a Python int (a mean of an integer column)."""

    def __init__(self, e: Expr):
        self.e = e

    def _eval(self, env: dict):
        x = self.e._eval(env)
        return (x.v if isinstance(x, (WideInt, NpInt))
                else torch.as_tensor(x)).to(torch.float64)

    def references(self, out: set) -> None:
        self.e.references(out)

    def token(self) -> tuple:
        return ("cast", "float64", self.e.token())

    def __repr__(self) -> str:
        return f"float64({self.e!r})"


_ARITH_OPS = ("+", "-", "*", "/", "//", "%")


class NumpyOverflow(VegaError):
    """A Python int that numpy 2 (NEP 50) refuses beside a column of a
    narrower integer dtype: the reference's host tier raises
    OverflowError there, so the port raises this when the plan
    compiles."""

    def __init__(self, value: int, dt: np.dtype):
        super().__init__(
            "the reference's host tier computes this stage in numpy, which "
            f"raises OverflowError: Python integer {value} out of bounds "
            f"for {dt}")


class NpInt:
    """The values of a numpy integer column of 32 bits or fewer inside a
    host-tier stage before its first exchange (the reference's blocks
    layout, where numpy holds each source column in its own dtype): v the
    exact values as int64, dt the numpy dtype. host_binop computes on it
    as numpy 2 does: in dt, wrapping, beside another such column or a
    Python int that fits dt (one that does not raises NumpyOverflow);
    in int64 (a WideInt) beside an int64 column. stored() is its block
    form: int32 words, or the wide pair for a uint32 column, whose
    values may pass int32."""

    __slots__ = ("v", "dt")

    def __init__(self, v: torch.Tensor, dt):
        self.v = v.to(torch.int64)
        self.dt = np.dtype(dt)

    def __bool__(self):
        raise TypeError("an integer column has no truth value (a branch "
                        "on a value)")

    def stored(self):
        if self.dt == np.uint32:
            return WideInt(self.v, [])
        return self.v.to(torch.int32)

    def tensor(self) -> torch.Tensor:
        """The values in the torch dtype closest to dt (a Udf's input)."""
        return self.v.to(_TORCH_OF_NP.get(self.dt, torch.int32))


# numpy dtype -> the torch dtype that holds it (the rest: int32)
_TORCH_OF_NP = {np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
                np.dtype(np.uint8): torch.uint8,
                np.dtype(np.uint32): torch.int64}


def _wrapped(r: torch.Tensor, dt: np.dtype) -> NpInt:
    """int64 values r taken mod 2^width into dt's range, as numpy wraps."""
    bits = dt.itemsize * 8
    mask = (1 << bits) - 1
    if dt.kind == "u":
        return NpInt(r & mask, dt)
    half = 1 << (bits - 1)
    return NpInt(((r + half) & mask) - half, dt)


def _np_kind(x):
    """numpy's view of one operand of a host-tier stage: its dtype, a weak
    Python scalar (False, 0, 0.0: NEP 50 gives it the other operand's
    kind), or None for anything else (a string). A plain int32 column is
    int64 to numpy: an int64 source held as int32 because it fits, or a
    Python int after an exchange."""
    if isinstance(x, NpInt):
        return x.dt
    if isinstance(x, WideInt):
        return np.dtype(np.int64)
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bool:
            return np.dtype(np.bool_)
        if x.dtype.is_floating_point:
            return np.dtype(str(x.dtype).replace("torch.", ""))
        return np.dtype(np.int64)
    if isinstance(x, np.generic):
        return x.dtype
    if isinstance(x, (bool, int, float)):
        return type(x)(0)
    return None


def _scalar(x):
    return x.item() if isinstance(x, np.generic) else x


def _i64(x):
    """An integer or bool operand as exact int64 values (a Python scalar
    stays one)."""
    if isinstance(x, (NpInt, WideInt)):
        return x.v
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    return int(_scalar(x))


def _fits_int32(x) -> bool:
    """Whether an operand's values provably lie in int32: a plain int32 or
    bool column, a numpy column narrower than uint32, a Python int in
    range."""
    if isinstance(x, NpInt):
        return x.dt != np.uint32
    if isinstance(x, torch.Tensor):
        return x.dtype in (torch.int32, torch.bool)
    x = _scalar(x)
    return isinstance(x, int) and I32_MIN <= x <= I32_MAX


def _i32(x):
    if isinstance(x, NpInt):
        return x.v.to(torch.int32)
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32)
    return int(_scalar(x))


def _divmod_guarded(op, x, y):
    """x // y or x % y over integers, one of them a tensor, with a zero
    divisor giving 0 (numpy's answer, with its warning)."""
    if not isinstance(y, torch.Tensor):
        return torch.zeros_like(x) if y == 0 else op(x, y)
    zero = y == 0
    return torch.where(zero, 0, op(x, torch.where(zero, 1, y)))


def _int32_form(op, a, b, sink):
    """a op b where int32 holds the result (the range proof keeps an int32
    key, which the hash_bucket kernel hashes): // by a literal not in
    {0, -1}, % by an int32 operand, & | ^ of two; else None. A zero
    divisor in % is recorded in sink, as WideInt records it."""
    if not (_fits_int32(a) and _fits_int32(b)):
        return None
    bs = _scalar(b)
    if op == "//" and isinstance(bs, int) and bs not in (0, -1) and \
            isinstance(a, (torch.Tensor, NpInt)):
        return _i32(a) // bs
    if op in ("&", "|", "^"):
        return _BIN_OPS[op](_i32(a), _i32(b))
    if op != "%" or not isinstance(a, (torch.Tensor, NpInt)):
        return None
    x = _i32(a)
    if not isinstance(b, (torch.Tensor, NpInt)):
        if bs == 0:
            return None
        return torch.zeros_like(x) if bs == -1 else x % bs
    y = _i32(b)
    # -2^31 % -1 is 0, which C's remainder may trap on: both guarded
    odd = (y == 0) | (y == -1)
    sink.append(y == 0)
    return torch.where(odd, 0, x % torch.where(odd, 1, y))


def host_binop(op: str, a, b, sink: list):
    """a op b as the reference's host tier computes it (numpy 2 before the
    first exchange, Python numbers after it), on the port's forms of its
    values: the result dtype is numpy's (np.result_type, a Python scalar
    weak); / of integers is float64. A float result computes in that
    float dtype; a bool one with torch's bool ops. An integer comparison
    is exact (numpy 2 compares a Python int out of range exactly). An
    integer result of 32 bits or fewer wraps in its dtype (NpInt); a
    Python int outside that dtype raises NumpyOverflow. An int64 result
    keeps the int32 form where the range proof holds (_int32_form), else
    is a WideInt, exact, whose int64 overflow flags its row."""
    ka, kb = _np_kind(a), _np_kind(b)
    tensors = [x for x in (a, b)
               if isinstance(x, (torch.Tensor, NpInt, WideInt))]
    if ka is None or kb is None or not tensors:
        return _BIN_OPS[op](a, b)
    rt = np.result_type(ka, kb)
    if op == "/" and rt.kind in "biu":
        rt = np.dtype(np.float64)
    if rt.kind == "f":
        t = getattr(torch, rt.name)
        a, b = ((x.v if isinstance(x, (NpInt, WideInt)) else x).to(t)
                if isinstance(x, (torch.Tensor, NpInt, WideInt))
                else _scalar(x) for x in (a, b))
        # a constant as a column of the operation's dtype: torch divides
        # a scalar by a tensor through its reciprocal, which rounds twice
        like = a if isinstance(a, torch.Tensor) else b
        a, b = (x if isinstance(x, torch.Tensor)
                else torch.full_like(like, x) for x in (a, b))
        r = _BIN_OPS[op](a, b)
        if op == "%":
            # numpy's (and Python's) zero remainder takes the divisor's
            # sign; torch's the dividend's
            r = torch.where(r == 0, torch.copysign(torch.zeros_like(r), b),
                            r)
        return r
    if rt.kind == "b":
        return _BIN_OPS[op](a, b)
    if op in _CMP_OPS:
        return _BIN_OPS[op](_i64(a), _i64(b))
    if rt.itemsize < 8:
        for x in (a, b):
            x = _scalar(x)
            if isinstance(x, int) and not isinstance(x, bool) and \
                    not np.iinfo(rt).min <= x <= np.iinfo(rt).max:
                raise NumpyOverflow(x, rt)
        x, y = _i64(a), _i64(b)
        if op in ("//", "%"):
            r = _divmod_guarded(_BIN_OPS[op], x, y)
        else:
            r = _BIN_OPS[op](x, y)
        return _wrapped(r, rt)
    r = _int32_form(op, a, b, sink)
    if r is not None:
        return r
    a, b = (WideInt(_i64(x), sink)
            if isinstance(x, (torch.Tensor, NpInt)) else _scalar(x)
            for x in (a, b))
    return _BIN_OPS[op](a, b)


def host_unary(op: str, x, sink: list):
    """-x or ~x on the host tier: a numpy column of 32 bits or fewer wraps
    in its dtype; the negation of an int64 column held as int32 is a
    WideInt (-(-2^31) leaves int32); the rest as torch and WideInt
    compute it."""
    if isinstance(x, NpInt):
        return _wrapped(-x.v if op == "-" else ~x.v, x.dt)
    if op == "-" and isinstance(x, torch.Tensor) and not (
            x.dtype.is_floating_point or x.dtype == torch.bool):
        return -WideInt(x.to(torch.int64), sink)
    return _UNARY_OPS[op](x)


class HostArith(Expr):
    """A BinOp as the reference's host tier computes it (host_binop): its
    numpy arithmetic, comparisons and bitwise operators."""

    def __init__(self, e: BinOp):
        self.e = e

    def _eval(self, env: dict):
        return host_binop(self.e.op, self.e.left._eval(env),
                          self.e.right._eval(env), env[SINK])

    def references(self, out: set) -> None:
        self.e.references(out)

    def token(self) -> tuple:
        return ("host", self.e.token())

    def __repr__(self) -> str:
        return repr(self.e)


class HostUnary(Expr):
    """A UnaryOp as the reference's host tier computes it (host_unary)."""

    def __init__(self, e: UnaryOp):
        self.e = e

    def _eval(self, env: dict):
        return host_unary(self.e.op, self.e.operand._eval(env), env[SINK])

    def references(self, out: set) -> None:
        self.e.references(out)

    def token(self) -> tuple:
        return ("host", self.e.token())

    def __repr__(self) -> str:
        return repr(self.e)


class HostUdf(Expr):
    """A Udf on the host tier: a numpy-width column reaches it as a tensor
    of its closest torch dtype (NpInt.tensor)."""

    def __init__(self, e: Udf):
        self.e = e

    def _eval(self, env: dict):
        args = [a._eval(env) for a in self.e.args]
        return self.e.fn(*[a.tensor() if isinstance(a, NpInt) else a
                           for a in args])

    def references(self, out: set) -> None:
        self.e.references(out)

    def token(self) -> tuple:
        return ("host", self.e.token())

    def __repr__(self) -> str:
        return repr(self.e)


def host_arith(e: Expr) -> Expr:
    """e with each BinOp a HostArith, each UnaryOp a HostUnary and each
    Udf a HostUdf (the reference's host tier's numpy rules), through the
    whole tree."""
    if isinstance(e, BinOp):
        return HostArith(BinOp(e.op, host_arith(e.left),
                               host_arith(e.right)))
    if isinstance(e, UnaryOp):
        return HostUnary(UnaryOp(e.op, host_arith(e.operand)))
    if isinstance(e, Udf):
        return HostUdf(Udf(e.fn, *[host_arith(a) for a in e.args],
                           name=e.name))
    if isinstance(e, Cast):
        return Cast(host_arith(e.e))
    return e


class KeyFloat64(Expr):
    """The float64 values of a float64 exchange key (kernels.f64_key's
    words, a wide column) and the sign of a zero key: the low bit of
    sign, the wide column a group-by keeps of the key's first row."""

    def __init__(self, key: Col, sign: Col):
        self.key = key
        self.sign = sign

    def _eval(self, env: dict):
        from vega_tpu_torch import kernels

        sign = self.sign._eval(env).v
        return kernels.f64_from_key(self.key._eval(env).v, (sign & 1) == 1)

    def references(self, out: set) -> None:
        self.key.references(out)
        self.sign.references(out)

    def token(self) -> tuple:
        return ("keyfloat64", self.key.token(), self.sign.token())

    def __repr__(self) -> str:
        return f"float64({self.key.name})"


# ---------------------------------------------------------------------------
# string comparisons
# ---------------------------------------------------------------------------


class DictCmp(Expr):
    """`left op right` over string columns: left a string column, right a
    string literal (lit) or another string column. src_left / src_right
    name the stage-input block columns whose dictionaries apply; slot is
    this comparison's index into the stage's resolved inputs."""

    def __init__(self, op: str, left: Col, src_left: str,
                 right: Optional[Col] = None, src_right: Optional[str] = None,
                 lit: Optional[str] = None):
        self.op = op
        self.left = left
        self.src_left = src_left
        self.right = right
        self.src_right = src_right
        self.lit = lit
        self.slot = 0  # set by rewrite_string_cmps

    def _eval(self, env: dict):
        r = env[RESOLVED][self.slot]
        codes = self.left._eval(env)
        if self.lit is not None:
            # r: the literal's code (-1 when absent) for == / !=, else the
            # rank boundary resolve() chose for the order
            if self.op in ("==", "!="):
                return _BIN_OPS[self.op](codes, r)
            return codes < r if self.op in ("<", "<=") else codes >= r
        other = self.right._eval(env)
        if r is not None:  # two dictionaries: compare on their merge
            ta, tb = r
            codes = ta[codes.clamp(0, ta.numel() - 1).to(torch.int64)]
            other = tb[other.clamp(0, tb.numel() - 1).to(torch.int64)]
        return _BIN_OPS[self.op](codes, other)

    def references(self, out: set) -> None:
        self.left.references(out)
        if self.right is not None:
            self.right.references(out)

    def token(self) -> tuple:
        # the literal's text, never its code: the code depends on the data
        other = (("lit", self.lit) if self.lit is not None
                 else self.right.token())
        return ("dictcmp", self.op, self.left.token(), other)

    def __repr__(self) -> str:
        other = repr(self.lit) if self.lit is not None else self.right.name
        return f"({self.left.name} {self.op} {other})"


def rewrite_string_cmps(e: Expr, live: set, origin: Dict[str, str],
                        cmps: List[DictCmp]) -> Expr:
    """e with every comparison of a string column (one of `live`, which
    passes the stage-input block column origin[name] through) against a
    string literal or another string column replaced by a DictCmp,
    appended to cmps; the rest of the tree is kept."""
    if isinstance(e, BinOp):
        lft, rgt = e.left, e.right
        if e.op in _CMP_OPS:
            ls = isinstance(lft, Col) and lft.name in live
            rs = isinstance(rgt, Col) and rgt.name in live
            node = None
            if ls and rs:
                node = DictCmp(e.op, lft, origin[lft.name], rgt,
                               origin[rgt.name])
            elif ls and isinstance(rgt, Lit) and isinstance(rgt.value, str):
                node = DictCmp(e.op, lft, origin[lft.name], lit=rgt.value)
            elif rs and isinstance(lft, Lit) and isinstance(lft.value, str):
                node = DictCmp(_FLIP[e.op], rgt, origin[rgt.name],
                               lit=lft.value)
            if node is not None:
                node.slot = len(cmps)
                cmps.append(node)
                return node
        return BinOp(e.op, rewrite_string_cmps(lft, live, origin, cmps),
                     rewrite_string_cmps(rgt, live, origin, cmps))
    if isinstance(e, UnaryOp):
        return UnaryOp(e.op, rewrite_string_cmps(e.operand, live, origin,
                                                 cmps))
    if isinstance(e, Cast):
        return Cast(rewrite_string_cmps(e.e, live, origin, cmps))
    return e


def computing_refs(e: Expr) -> set:
    """The columns an expression computes on: every reference but those a
    DictCmp resolves through a dictionary."""
    if isinstance(e, DictCmp):
        return set()
    if isinstance(e, Col):
        return {e.name}
    if isinstance(e, BinOp):
        return computing_refs(e.left) | computing_refs(e.right)
    if isinstance(e, UnaryOp):
        return computing_refs(e.operand)
    if isinstance(e, Cast):
        return computing_refs(e.e)
    if isinstance(e, Udf):
        out: set = set()
        for a in e.args:
            out |= computing_refs(a)
        return out
    return set()


def resolve(cmps: List[DictCmp], dicts: Dict[str, np.ndarray],
            device: torch.device, memo: dict) -> list:
    """Each comparison's input from the dictionaries of the block the
    stage runs on ({block column: sorted dictionary}; {} at the probe):
    a literal's code under == / != (-1, which no code takes, when the
    literal is absent), its left rank boundary under < and >=, its right
    one under <= and >; for two columns, None when they share one
    dictionary, else their remap tables onto the merged dictionary
    (memoized per pair of dictionaries)."""
    out = []
    for c in cmps:
        d = dicts.get(c.src_left)
        if c.lit is not None:
            if d is None:
                out.append(0)
                continue
            side = "right" if c.op in ("<=", ">") else "left"
            i = int(np.searchsorted(d, c.lit, side=side))
            if c.op in ("==", "!="):
                i = i if i < len(d) and d[i] == c.lit else -1
            out.append(i)
            continue
        e = dicts.get(c.src_right)
        if d is None or e is None or d is e:
            out.append(None)
            continue
        key = (id(d), id(e))
        hit = memo.get(key)
        if hit is None or hit[0] is not d or hit[1] is not e:
            _merged, lmap, rmap = dict_encoding.merge_dicts(d, e)
            tables = tuple(torch.from_numpy(np.append(m, 0).astype(
                np.int32)).to(device) for m in (lmap, rmap))
            hit = memo[key] = (d, e, tables)
        out.append(hit[2])
    return out
