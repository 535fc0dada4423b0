"""What the reference's trace refuses, while user code is traced.

The reference traces row functions, binops and frame stages with jax, 64-bit
types off. Its trace refuses any Python int outside int32, whatever the
dtype of the array it meets (int32, bool, float32 or a narrow logical
dtype): it raises "An overflow was encountered while parsing an argument",
and the reference hands the closure or the plan to its host tier, which
computes exact Python ints. Torch refuses nothing: an int32 tensor plus
2**40 stays int32 and wraps, and a bool tensor times 3e9 becomes an int64
that the port would narrow.

int32_literals() is a TorchFunctionMode that the port holds only while it
traces user code (the frame planner's copy of the reference's tier
decision; reference_trace below, for the RDD API's closures, applies the
same rule). Inside it any torch function or tensor method
called with a Python int outside [-2**31, 2**31 - 1] raises OverflowError,
as jax's trace does. A bool is no such int, nor is a numpy integer (jax
converts those without a word). Positional and keyword arguments are
looked through, and one level into tuples and lists. The mode is off
while a torch function it let through runs, so the port's own operators
inside it (a uint32 row value's 0xFFFFFFFF mask) do not trip it.

jax's trace refuses more than that: a tracer has no value, so numpy
(np.sqrt(x), np.where(x > 1, x, 0): its __array__), Python's conversions
(float(x), int(x), math.sqrt(x), an `if` on x: __float__, __int__,
__bool__, __index__), .item() / .tolist(), len() of a row and hashing it
(a dict key) all raise there, and the reference runs the closure on its
host tier. A probe tensor of the port holds no values either, but torch
lets numpy read a CPU tensor, where a CUDA tensor refuses: the port's
choice of tier must not depend on the device. reference_trace() is the
mode the RDD API traces its closures under: it
refuses each of those conversions with TraceRefusal, on every device,
and (with literals) applies the literal rule too. Tensor.__hash__ does
not dispatch to a mode, so while one is active on a thread, the hash of
any tensor raises there as well (guarded_hash)."""

from __future__ import annotations

import threading

import torch
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
        self._check(func, args, kwargs)
        return func(*args, **kwargs)

    def _check(self, func, args, kwargs) -> None:
        for a in _arguments(args, kwargs):
            if past_int32(a):
                raise LiteralOverflow(
                    f"Python int {a} is outside int32: the reference's "
                    "trace (64-bit types off) refuses it")


def int32_literals() -> Int32Literals:
    """The mode, entered with `with`."""
    return Int32Literals()


class TraceRefusal(TypeError):
    """A traced closure asked for a probe's value (numpy, a Python
    scalar, a hash), which jax's trace refuses: the RDD API hands the op
    to its host tier."""


# the tensor methods that give a value to numpy or to Python
_CONVERSIONS = frozenset((
    "__array__", "__array_wrap__", "__bool__", "__float__", "__int__",
    "__index__", "__complex__", "__len__", "item", "tolist", "numpy"))
_active = threading.local()
_torch_hash = torch.Tensor.__hash__


def guarded_hash(self) -> int:
    """Tensor.__hash__ as torch has it (the object's id), except while a
    reference_trace() is active on this thread."""
    if getattr(_active, "depth", 0):
        raise TraceRefusal("a traced row is not hashable (jax's tracers "
                           "are not)")
    return _torch_hash(self)


class ReferenceTrace(Int32Literals):
    """Raises TraceRefusal where jax's trace would ask a tracer for its
    value, and the literal rule's LiteralOverflow when literals is set.
    Off (depth 0) while a call it let through runs, so the port's own
    code inside may convert and hash."""

    def __init__(self, literals: bool = True):
        super().__init__()
        self.literals = literals

    def __enter__(self):
        if torch.Tensor.__hash__ is not guarded_hash:
            torch.Tensor.__hash__ = guarded_hash
        _active.depth = getattr(_active, "depth", 0) + 1
        return super().__enter__()

    def __exit__(self, *exc):
        _active.depth -= 1
        return super().__exit__(*exc)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self._check(func, args, kwargs)
        depth, _active.depth = _active.depth, 0
        try:
            return func(*args, **kwargs)
        finally:
            _active.depth = depth

    def _check(self, func, args, kwargs) -> None:
        name = getattr(func, "__name__", "")
        if name in _CONVERSIONS:
            raise TraceRefusal(
                f"{name} of a traced row: jax's trace has no value to give "
                "(the reference runs the closure on its host tier)")
        if self.literals:
            super()._check(func, args, kwargs)


def reference_trace(literals: bool = True) -> ReferenceTrace:
    """The mode the RDD API traces user closures under, entered with
    `with`."""
    return ReferenceTrace(literals)
