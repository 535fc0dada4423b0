"""The reference's literal rule while user code is traced.

The reference traces row functions, binops and frame stages with jax, 64-bit
types off. Its trace refuses any Python int outside int32, whatever the
dtype of the array it meets (int32, bool, float32 or a narrow logical
dtype): it raises "An overflow was encountered while parsing an argument",
and the reference hands the closure or the plan to its host tier, which
computes exact Python ints. Torch refuses nothing: an int32 tensor plus
2**40 stays int32 and wraps, and a bool tensor times 3e9 becomes an int64
that the port would narrow.

int32_literals() is a TorchFunctionMode that the port holds only while it
traces user code (dense_rdd._traced, the frame planner's copy of the
reference's tier decision). Inside it any torch function or tensor method
called with a Python int outside [-2**31, 2**31 - 1] raises OverflowError,
as jax's trace does. A bool is no such int, nor is a numpy integer (jax
converts those without a word). Positional and keyword arguments are
looked through, and one level into tuples and lists. The mode is off
while a torch function it let through runs, so the port's own operators
inside it (a uint32 row value's 0xFFFFFFFF mask) do not trip it."""

from __future__ import annotations

from torch.overrides import TorchFunctionMode

INT32_MIN, INT32_MAX = -2**31, 2**31 - 1


def past_int32(x) -> bool:
    """Whether x is a Python int (not a bool) outside int32."""
    return (isinstance(x, int) and not isinstance(x, bool)
            and not INT32_MIN <= x <= INT32_MAX)


def _arguments(args, kwargs):
    for a in (*args, *kwargs.values()):
        if isinstance(a, (tuple, list)):
            yield from a
        else:
            yield a


class LiteralOverflow(OverflowError):
    """The rule's refusal: a torch call was given a Python int past
    int32. The RDD API then traces the closure again in the reference
    host tier's row form (host_rows.py)."""


class Int32Literals(TorchFunctionMode):
    """Raises LiteralOverflow on a torch call with a Python int past
    int32."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for a in _arguments(args, kwargs):
            if past_int32(a):
                raise LiteralOverflow(
                    f"Python int {a} is outside int32: the reference's "
                    "trace (64-bit types off) refuses it")
        return func(*args, **kwargs)


def int32_literals() -> Int32Literals:
    """The mode, entered with `with`."""
    return Int32Literals()
