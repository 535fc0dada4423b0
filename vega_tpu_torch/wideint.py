"""Exact int64 values with per-row overflow flags, shared by the frame
layer's host-tier stages (frame/columns.py) and the RDD API's host-row
form (host_rows.py).

A WideInt wraps an int64 tensor. Python operators on it give another
WideInt (+ - * // % and negation, exact), a bool tensor (comparisons) or a
float64 tensor (true division, a float operand). Where an operation leaves
int64, or divides by zero, the row's flag is appended to the sink list the
WideInt shares with its operands; the caller raises VegaError when a valid
row is flagged (the reference's host tier computes on Python ints, which
never overflow, so the port refuses rather than wrap).

fits32 marks a value known to lie in int32 (an int32 input column as it
came in, or its remainder modulo an int32 constant): the host-row form
stores such an output as an int32 column."""

from __future__ import annotations

import operator

import torch

from vega_tpu_torch.errors import VegaError

I64_MIN, I64_MAX = -2**63, 2**63 - 1
I32_MIN, I32_MAX = -2**31, 2**31 - 1


class WideInt:
    """Exact int64 values of a wide column inside a stage: v is the int64
    tensor, sink the stage's list of per-row overflow flags, to which
    every operation that can leave int64 appends its own; fits32 whether
    every value is known to lie in int32."""

    __slots__ = ("v", "sink", "fits32")

    def __init__(self, v: torch.Tensor, sink: list, fits32: bool = False):
        self.v = v
        self.sink = sink
        self.fits32 = fits32

    def __bool__(self):
        raise TypeError("a wide int64 column has no truth value (a branch "
                        "on a value)")

    def _other(self, o):
        """o as an int64 tensor or Python int; None for a float operand
        (the result is then a float64 column)."""
        if isinstance(o, WideInt):
            return o.v
        if isinstance(o, bool):
            return int(o)
        if isinstance(o, int):
            if not I64_MIN <= o <= I64_MAX:
                raise VegaError(f"constant {o} is outside int64")
            return o
        if isinstance(o, torch.Tensor) and not o.dtype.is_floating_point:
            return o.to(torch.int64)
        return None

    def _wrap(self, r, bad=None):
        if bad is not None:
            self.sink.append(bad)
        return WideInt(r, self.sink)

    def _float(self, op, o, reflected=False):
        a = self.v.to(torch.float64)
        return op(o, a) if reflected else op(a, o)

    def __add__(self, o):
        b = self._other(o)
        if b is None:
            return self._float(operator.add, o)
        r = self.v + b
        return self._wrap(r, ((self.v ^ r) & (r ^ b)) < 0)

    __radd__ = __add__

    def __sub__(self, o):
        b = self._other(o)
        if b is None:
            return self._float(operator.sub, o)
        r = self.v - b
        return self._wrap(r, ((self.v ^ r) & (self.v ^ b)) < 0)

    def __rsub__(self, o):
        b = self._other(o)
        if b is None:
            return self._float(operator.sub, o, True)
        r = b - self.v
        return self._wrap(r, ((r ^ b) & (self.v ^ b)) < 0)

    def __mul__(self, o):
        b = self._other(o)
        if b is None:
            return self._float(operator.mul, o)
        a = self.v
        r = a * b
        if isinstance(b, int):
            if b == 0:
                return self._wrap(r)
            # the a whose product fits, clamped to int64 (b == -1 gives
            # hi = 2^63: only MIN * -1 leaves it, as under negation)
            lo, hi = ((-((-I64_MIN) // b), I64_MAX // b) if b > 0
                      else (-((-I64_MAX) // b), I64_MIN // b))
            return self._wrap(r, (a < max(lo, I64_MIN))
                              | (a > min(hi, I64_MAX)))
        # r // a recovers b exactly iff a * b did not wrap; a == -1 is
        # checked apart (MIN // -1 itself overflows)
        safe = torch.where((a == 0) | (a == -1), 1, a)
        bad = torch.where(a == -1, b == I64_MIN, (a != 0) & (r // safe != b))
        return self._wrap(r, bad)

    __rmul__ = __mul__

    def _divmod(self, a, b, op):
        """a // b or a % b over int64 with the two traps guarded: b == 0
        (recorded) and MIN // -1 (recorded for //; MIN % -1 is 0)."""
        if isinstance(a, int):
            a = torch.full_like(self.v, a)
        zero = b == 0
        trap = (a == I64_MIN) & (b == -1)
        safe = torch.where(zero | trap, 1, b)
        r = op(a, safe)
        if op is operator.mod:
            return self._wrap(torch.where(trap, 0, r), zero)
        return self._wrap(r, zero | trap)

    def __floordiv__(self, o):
        b = self._other(o)
        if b is None:
            return self._float(operator.floordiv, o)
        return self._divmod(self.v, b, operator.floordiv)

    def __rfloordiv__(self, o):
        b = self._other(o)
        if b is None:
            return self._float(operator.floordiv, o, True)
        return self._divmod(b, self.v, operator.floordiv)

    def __mod__(self, o):
        b = self._other(o)
        if b is None:
            return self._float(operator.mod, o)
        r = self._divmod(self.v, b, operator.mod)
        # a remainder lies strictly between 0 and its divisor
        r.fits32 = isinstance(b, int) and b != 0 and abs(b) <= 2**31
        return r

    def __rmod__(self, o):
        b = self._other(o)
        if b is None:
            return self._float(operator.mod, o, True)
        return self._divmod(b, self.v, operator.mod)

    def __truediv__(self, o):
        b = self._other(o)
        return self.v.to(torch.float64) / (o if b is None else b)

    def __rtruediv__(self, o):
        b = self._other(o)
        return (o if b is None else b) / self.v.to(torch.float64)

    def __neg__(self):
        return self._wrap(-self.v, self.v == I64_MIN)

    def __invert__(self):
        return self._wrap(~self.v)

    def _bits(op):  # noqa: N805 — builds the bitwise operators
        def run(self, o):
            b = self._other(o)
            if b is None:
                return NotImplemented
            return self._wrap(op(self.v, b))
        return run

    def __and__(self, o):
        r = WideInt._bits_and(self, o)
        if isinstance(r, WideInt):
            # two int32 operands, or a mask by a non-negative int32
            # constant: within int32
            r.fits32 = (self.fits32 and isinstance(o, WideInt) and o.fits32
                        or isinstance(o, int) and not isinstance(o, bool)
                        and 0 <= o <= I32_MAX)
        return r

    _bits_and = _bits(operator.and_)
    __rand__ = __and__
    __or__ = __ror__ = _bits(operator.or_)
    __xor__ = __rxor__ = _bits(operator.xor)

    def _cmp(op):  # noqa: N805 — builds the comparisons
        def run(self, o):
            b = self._other(o)
            if b is None:
                return op(self.v.to(torch.float64), o)
            return op(self.v, b)
        return run

    __eq__ = _cmp(operator.eq)
    __ne__ = _cmp(operator.ne)
    __lt__ = _cmp(operator.lt)
    __le__ = _cmp(operator.le)
    __gt__ = _cmp(operator.gt)
    __ge__ = _cmp(operator.ge)
    __hash__ = None
    del _bits, _cmp
