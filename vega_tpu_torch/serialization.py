"""Task and wire encoding: the port's copy of vega_tpu/serialization.py.

dumps / loads carry a task's lineage and its functions over the standard
library's pickle (protocol 5). The reference pickles with cloudpickle,
which carries lambdas and local closures by value; the port does the same
with a pickle.Pickler whose reducer_override sends a function by value
when its module is __main__ or its __qualname__ holds <lambda> or
<locals>: its code object (marshal), its closure cells (a recursive
closure too: the function is memoized before its cells are filled), the
globals its code and its nested code objects name, its defaults,
kwdefaults, __dict__, __qualname__ and module. Every other function, and
every class, goes by reference, as pickle sends them; a module goes as
its name. marshal's format is the interpreter's own, which is safe here:
every executor is started from the driver's own sys.executable.

A class defined in a function or in __main__ is not sent by value (a
recorded difference from cloudpickle): a local one refuses at dumps, a
__main__ one at the executor's loads.

dumps_oob / loads_oob send large buffers (numpy arrays) out of band, and
the framing helpers put an 8-byte little-endian length before each frame,
the reference's wire format (distributed/protocol.py)."""

from __future__ import annotations

import builtins
import dis
import importlib
import io
import marshal
import pickle
import struct
import types

from vega_tpu_torch.errors import VegaError

_PROTO = 5


def _by_value(func: types.FunctionType) -> bool:
    qualname = getattr(func, "__qualname__", "")
    return func.__module__ == "__main__" or "<lambda>" in qualname \
        or "<locals>" in qualname


_GLOBAL_OPS = frozenset(("LOAD_GLOBAL", "STORE_GLOBAL", "DELETE_GLOBAL"))


def _global_names(code: types.CodeType, out: set) -> set:
    """The global names code and its nested code objects reach."""
    for ins in dis.get_instructions(code):
        if ins.opname in _GLOBAL_OPS:
            out.add(ins.argval)
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            _global_names(const, out)
    return out


class _EmptyCell:
    """Marks a closure cell not yet assigned (a class pickles by
    reference, so the marker keeps its identity across processes)."""


def _cell_value(cell):
    try:
        return cell.cell_contents
    except ValueError:
        return _EmptyCell


def _make_function(code_bytes: bytes, name: str, n_cells: int):
    """The function's skeleton: its code, fresh globals and empty cells
    (filled by _fill_function once the pickle memoized it)."""
    code = marshal.loads(code_bytes)
    closure = tuple(types.CellType() for _ in range(n_cells)) or None
    return types.FunctionType(code, {"__builtins__": builtins}, name, None,
                              closure)


def _fill_function(func, state) -> None:
    func.__globals__.update(state["globals"])
    for cell, value in zip(func.__closure__ or (), state["cells"]):
        if value is not _EmptyCell:
            cell.cell_contents = value
    func.__defaults__ = state["defaults"]
    func.__kwdefaults__ = state["kwdefaults"]
    func.__dict__.update(state["dict"])
    func.__qualname__ = state["qualname"]
    func.__module__ = state["module"]
    func.__doc__ = state["doc"]


def _function_reduce(func: types.FunctionType):
    code = func.__code__
    names = _global_names(code, set())
    glob = func.__globals__
    state = {
        "globals": {n: glob[n] for n in sorted(names) if n in glob},
        "cells": [_cell_value(c) for c in func.__closure__ or ()],
        "defaults": func.__defaults__,
        "kwdefaults": func.__kwdefaults__,
        "dict": dict(func.__dict__),
        "qualname": func.__qualname__,
        "module": func.__module__,
        "doc": func.__doc__,
    }
    return (_make_function,
            (marshal.dumps(code), func.__name__,
             len(func.__closure__ or ())),
            state, None, None, _fill_function)


class _Pickler(pickle.Pickler):
    def reducer_override(self, obj):
        if type(obj) is types.FunctionType and _by_value(obj):
            return _function_reduce(obj)
        if type(obj) is types.ModuleType:
            return importlib.import_module, (obj.__name__,)
        return NotImplemented


def _describe(obj) -> str:
    return getattr(obj, "__qualname__", type(obj).__name__)


def dumps(obj, buffer_callback=None) -> bytes:
    """obj pickled, functions by value where the module above says so;
    what cannot pickle raises VegaError naming it."""
    buf = io.BytesIO()
    try:
        _Pickler(buf, protocol=_PROTO,
                 buffer_callback=buffer_callback).dump(obj)
    except (pickle.PicklingError, AttributeError, TypeError,
            ValueError) as e:
        raise VegaError(
            f"cannot serialize {_describe(obj)} with the standard "
            f"library's pickle ({e})") from e
    return buf.getvalue()


def loads(data):
    return pickle.loads(data)


def dumps_data(obj) -> bytes:
    """Rows (a shuffle bucket): the standard pickler, whose C fast path
    skips reducer_override; a row holding a function falls back to
    dumps."""
    try:
        return pickle.dumps(obj, protocol=_PROTO)
    except (pickle.PicklingError, AttributeError, TypeError):
        return dumps(obj)


def dumps_oob(obj):
    """(header, [buffers]): large buffers out of band, as raw memoryviews
    (a numpy array crosses without the in-band copy)."""
    buffers = []
    header = dumps(obj, buffer_callback=buffers.append)
    return header, [b.raw() for b in buffers]


def loads_oob(header, buffers):
    return pickle.loads(header, buffers=buffers)


# --- length framing (the reference's one-field envelope) ---------------------

_FRAME = struct.Struct("<Q")


def write_frame(stream, payload) -> None:
    stream.write(_FRAME.pack(len(payload)))
    stream.write(payload)


def frame_bytes(payload: bytes) -> bytes:
    """One frame as bytes, for a caller that joins several frames into one
    write."""
    return _FRAME.pack(len(payload)) + payload


def frame_prefix(n: int) -> bytes:
    """The length prefix alone, for a payload sent in its own write."""
    return _FRAME.pack(n)


def read_frame_len(stream) -> int:
    (n,) = _FRAME.unpack(_read_exact(stream, _FRAME.size))
    return n


def read_frame(stream) -> bytes:
    return _read_exact(stream, read_frame_len(stream))


def _read_exact(stream, n: int) -> bytes:
    chunks = []
    remaining = n
    while remaining:
        chunk = stream.read(remaining)
        if not chunk:
            raise EOFError(f"stream closed with {remaining} bytes outstanding")
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)
