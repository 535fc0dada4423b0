"""Logical column dtypes: narrow and uint32 columns on 32-bit storage.

The reference keeps int8, int16, uint8, uint16, uint32 and float16 columns
in their own dtypes. The port stores each in the block dtype contract's 32
bits and keeps the reference's dtype as the column's logical dtype, in the
node schema and in Block.logical. So every device op (the hash_bucket
kernel, the sorts, the segment reduces, the exchanges, the merge join)
runs on the int32 / float32 tensors it was written for, and torch's
missing uint16 / uint32 ops (index_add_, scatter_reduce_, sort, add,
compare) are never asked for:

    logical   stored (physical)                     row functions see
    int8      int32, sign-extended                  int8
    int16     int32, sign-extended                  int16
    uint8     int32, zero-extended                  uint8
    uint16    int32, zero-extended                  RowTensor (int64)
    uint32    int32: the bits with bit 31 flipped   RowTensor (int64)
    float16   float32, exact                        float16

A uint32 column is stored in the wide encoding's low-word form (block.
encode_i64): signed int32 order of the stored word is the unsigned order
of the value, so sorts, min / max, top-k, merge joins and range bounds
compare unsigned with no change. hash_input flips the bit back before the
hash, so the hash_bucket kernel hashes the value's bits, as the
reference's hash32 hashes astype(uint32), and placement is the
reference's. Narrow signed and unsigned columns hash their sign- or
zero-extended int32, which is the reference's astype(uint32) too, and a
float16 key its value converted as astype(uint32) converts it.

Arithmetic wraps as the reference's does. A named reduce adds and
multiplies in int32 (mod 2^32; uint32 on its unbiased bits, see
reduce_form) and wraps the result mod 2^width at the end (wrap): two's
complement add and prod commute with truncation, so the result is bit
for bit the reference's. A float16 reduce runs in float32 and rounds once
at the end. Row functions and traced binops see the logical values
(to_row): torch's own int8 / int16 / uint8 / float16, and for uint16 /
uint32, which torch cannot compute in, a RowTensor: int64 values that
carry their logical dtype and follow jnp's promotion op by op (wrapping
an unsigned result at once, and a mixed one to int32, as jax with 64-bit
types off does). An output's logical dtype (logical_dtype) is what that
promotion gave it, and to_physical stores it back.

A row closure sees every column through a RowView (row_view): the
column as stored, or its RowTensor, with its leading [n_shards, capacity]
dims hidden, so the closure sees one row as the reference's jax.vmap
shows it (ndim 0, shape (), jnp's astype, copy, reductions, round() and
divmod()); a binop sees 1-D operands. The view wraps the column without
a copy, and to_physical takes the stored tensor back out of it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch.utils import _pytree

from vega_tpu_torch.errors import VegaError

# logical dtype -> stored dtype
PHYSICAL = {torch.int8: torch.int32, torch.int16: torch.int32,
            torch.uint8: torch.int32, torch.uint16: torch.int32,
            torch.uint32: torch.int32, torch.float16: torch.float32}
_NUMPY = {torch.int8: np.int8, torch.int16: np.int16, torch.uint8: np.uint8,
          torch.uint16: np.uint16, torch.uint32: np.uint32,
          torch.float16: np.float16}
_OF_NUMPY = {np.dtype(v): k for k, v in _NUMPY.items()}
_SIGN = -2**31  # bit 31 as an int32
_U32_BIAS = np.uint32(0x80000000)


def is_logical(dt) -> bool:
    return dt in PHYSICAL


def physical(dt: torch.dtype) -> torch.dtype:
    """The stored dtype of a column of logical dtype dt."""
    return PHYSICAL.get(dt, dt)


def logical_of(schema) -> Dict[str, torch.dtype]:
    """{name: logical dtype} of a schema's logical columns."""
    return {nm: dt for nm, dt in schema if dt in PHYSICAL}


def to_row(col: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """A stored column as its row form (exact); a uint16 / uint32 column
    as a RowTensor."""
    if dt not in PHYSICAL:
        return col
    if dt == torch.uint32:
        return _tagged((col ^ _SIGN).to(torch.int64) & 0xFFFFFFFF, dt)
    if dt == torch.uint16:
        return _tagged(col.to(torch.int64), dt)
    return col.to(dt)


def to_physical(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """A tensor (a row function's output) as the stored column of logical
    dtype dt, wrapping mod 2^width as a cast to dt would; a plain
    tensor, never a RowTensor."""
    x = plain(x)
    if dt == torch.uint32:
        return (x.to(torch.int64) ^ 0x80000000).to(torch.int32)
    if dt == torch.uint16:
        return (x.to(torch.int64) & 0xFFFF).to(torch.int32)
    if dt in PHYSICAL:
        return x.to(dt).to(PHYSICAL[dt])
    return x if x.dtype == dt else x.to(dt)


def logical_dtype(x: torch.Tensor) -> torch.dtype:
    """The logical dtype of a traced output: a RowTensor's (or its row
    view's) own; a 64-bit dtype narrows to 32 bits, as jax's with 64-bit
    types off; anything else is its own."""
    ldt = getattr(x, "_ldt", None)
    if ldt is not None:
        return ldt
    dt = plain(x).dtype
    return {torch.int64: torch.int32, torch.float64: torch.float32
            }.get(dt, dt)


# ---------------------------------------------------------------------------
# RowTensor: uint16 / uint32 row values under jnp's promotion
# ---------------------------------------------------------------------------
# Ops whose integer result dtype is jnp's promotion of their tensor
# operands (Python scalars are weak and take the tensor's dtype).
_PROMOTING = frozenset((
    "add", "radd", "iadd", "sub", "rsub", "isub", "mul", "rmul", "imul",
    "floordiv", "rfloordiv", "floor_divide", "mod", "rmod", "remainder",
    "fmod", "pow", "rpow", "and", "rand", "or", "ror", "xor", "rxor",
    "bitwise_and", "bitwise_or", "bitwise_xor", "lshift", "rlshift",
    "rshift", "rrshift", "bitwise_left_shift", "bitwise_right_shift",
    "eq", "ne", "lt", "le", "gt", "ge", "maximum", "minimum", "max", "min",
    "where", "clamp", "clip", "neg", "negative", "abs", "invert",
    "bitwise_not", "truediv", "rtruediv", "div", "true_divide", "stack",
    "cat", "concat", "sum", "cumsum", "prod", "cumprod"))
# Sums and products accumulate in jnp's default width: uint32 for
# unsigned operands, int32 for signed ones.
_ACCUMULATING = frozenset(("sum", "cumsum", "prod", "cumprod"))
# Ops whose int64 result is an index, not a value.
_INDEXING = frozenset((
    "argmax", "argmin", "argsort", "nonzero", "searchsorted", "bucketize",
    "count_nonzero"))
_MASK = {torch.uint16: 0xFFFF, torch.uint32: 0xFFFFFFFF}
_CANONICAL = {np.dtype(np.int64): torch.int32,
              np.dtype(np.uint64): torch.uint32}


class RowTensor(torch.Tensor):
    """The row form of a uint16 / uint32 column: int64 values in the
    dtype's range, with the logical dtype in `_ldt`. Each op it takes
    part in computes as jnp would on the logical dtypes: the result of
    an arithmetic op over an emulated dtype wraps mod 2^width at once
    and stays a RowTensor; a result that jnp promotes to int32 (uint16 +
    int32, uint32 + int8) is a plain int32 tensor, a uint32 operand
    wrapped to int32 first; comparisons, floats and casts give plain
    tensors. Shape ops and indexing keep the dtype."""

    _ldt = torch.uint32

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        with torch._C.DisableTorchFunctionSubclass():
            name = getattr(func, "__name__", "")
            if name == "__get__":
                return func(*args, **kwargs)
            return _row_op(func, name.strip("_"), args, kwargs)


def _tagged(x: torch.Tensor, dt: torch.dtype) -> "RowTensor":
    r = x.as_subclass(RowTensor)
    r._ldt = dt
    return r


def _ldt_of(t: torch.Tensor) -> torch.dtype:
    return t._ldt if isinstance(t, RowTensor) else t.dtype


def _join(ldts) -> Optional[torch.dtype]:
    """jnp's promotion of integer / bool logical dtypes, 64-bit results
    narrowed to 32 (a plain int64 tensor counts as int32); None when a
    float takes part."""
    nps = []
    for dt in ldts:
        if dt.is_floating_point or dt.is_complex:
            return None
        nps.append(np.int32 if dt == torch.int64 else numpy_dtype(dt))
    res = np.result_type(*nps)
    return _CANONICAL.get(res) or torch.from_numpy(np.zeros(0, res)).dtype


def _finish(r, ldt):
    """One int64 result of an op whose jnp dtype is ldt."""
    if not isinstance(r, torch.Tensor) or r.dtype != torch.int64 or \
            ldt is None:
        return r
    if ldt in _MASK:
        return _tagged(r & _MASK[ldt], ldt)
    return r.to(torch.int32)


def _row_op(func, op, args, kwargs):
    leaves = _pytree.tree_leaves((args, kwargs))
    tensors = [a for a in leaves if isinstance(a, torch.Tensor)]
    rows = [t for t in tensors if isinstance(t, RowTensor)]
    cast = ("dtype" in kwargs or op in ("long", "int", "short", "char",
                                        "byte", "half", "float", "double",
                                        "bool", "type")
            or any(isinstance(a, torch.dtype) for a in leaves))
    if cast or not rows or op in _INDEXING:
        # plain results, even where the op returns its operand (a .to()
        # of the same dtype)
        return _pytree.tree_map(
            lambda r: r.as_subclass(torch.Tensor)
            if isinstance(r, RowTensor) else r, func(*args, **kwargs))
    if op not in _PROMOTING:
        # shape ops and indexing: a result of the operand's int64 keeps
        # its logical dtype; an index (a sort's indices) does not
        out = func(*args, **kwargs)
        ldt = rows[0]._ldt
        if isinstance(out, tuple) and hasattr(out, "indices"):
            return type(out)((_finish(out.values, ldt), out.indices))
        return _pytree.tree_map(
            lambda r: _tagged(r, ldt) if isinstance(r, torch.Tensor)
            and r.dtype == torch.int64 else r, out)
    ldt = _join(_ldt_of(t) for t in tensors)
    if ldt == torch.int32 and any(t._ldt == torch.uint32 for t in rows):
        # jnp converts the uint32 operand to int32 (wrapping) first
        args, kwargs = _pytree.tree_map(
            lambda a: a.to(torch.int32) if isinstance(a, RowTensor)
            and a._ldt == torch.uint32 else a, (args, kwargs))
    out = func(*args, **kwargs)
    if ldt is not None and op in _ACCUMULATING:
        ldt = torch.uint32 if not ldt.is_signed and ldt != torch.bool \
            else torch.int32
    if isinstance(out, tuple) and hasattr(out, "indices"):
        return type(out)((_finish(out.values, ldt), out.indices))
    return _pytree.tree_map(lambda r: _finish(r, ldt), out)


# ---------------------------------------------------------------------------
# RowView: one row, as the reference's vmap shows it to a row closure
# ---------------------------------------------------------------------------
# the reductions a row view takes whole (_reduce_row)
_REDUCTIONS = frozenset(("sum", "prod", "mean", "max", "min", "amax",
                         "amin", "any", "all"))
# where a dim argument sits (positional index; keywords by name) in the
# ops a row view translates: a dim counts from the row's first dim
_DIM_AT = dict.fromkeys((
    "sum", "prod", "mean", "max", "min", "amax", "amin", "any", "all",
    "cumsum", "cumprod", "argmax", "argmin", "sort", "argsort", "softmax",
    "log_softmax", "unsqueeze", "squeeze", "stack", "cat", "concat",
    "concatenate", "flip", "unbind", "select", "narrow", "index_select",
    "gather", "std", "var", "logsumexp", "nansum", "count_nonzero"), (1,))
_DIM_AT.update(dict.fromkeys(("transpose", "swapaxes", "movedim",
                              "moveaxis"), (1, 2)))
_DIM_AT.update(dict.fromkeys(("roll", "take_along_dim", "diff", "split",
                              "chunk"), (2,)))
_DIM_AT["topk"] = (2,)
_DIM_KWARGS = ("dim", "dims", "dim0", "dim1", "source", "destination",
               "axis")
# ops whose omitted dim is 0: the row's first dim under a view
_DIM_ZERO = frozenset(("stack", "cat", "concat", "concatenate", "unbind",
                       "split", "chunk"))
_IN_PLACE = {"__iadd__": "__add__", "__isub__": "__sub__",
             "__imul__": "__mul__", "__itruediv__": "__truediv__",
             "__ifloordiv__": "__floordiv__", "__imod__": "__mod__",
             "__ipow__": "__pow__", "__iand__": "__and__",
             "__ior__": "__or__", "__ixor__": "__xor__",
             "__ilshift__": "__lshift__", "__irshift__": "__rshift__",
             "__imatmul__": "__matmul__"}


class RowView(torch.Tensor):
    """A column as a row closure sees it. The reference runs every row
    closure under jax.vmap, so the closure sees one row: a scalar for a
    map / filter / key_by / map_values / expansion closure, a 1-D array
    for a binop. The view is the stored column itself ([n_shards,
    capacity], no copy: as_subclass) with its leading `_nb` dims hidden,
    and gives what jax's row gives:

    - ndim, shape, size (an int), dim(), numel() and T are the row's;
    - sum / prod / mean / max / min / any / all with no dim reduce the
      row's own dims (a scalar row is its own reduction) in jnp's result
      dtype (an integer sum int32 or uint32, a mean float32);
    - astype(dtype) and copy() as jnp's (64-bit dtypes narrow to 32);
    - round(x), round(x, n) and divmod(x, y) with jnp's dtypes;
    - a dim argument, a reshape, a stack and an index count from the
      row's first dim; in-place operators compute a new row, as jax's
      immutable arrays do, and the trailing-underscore methods raise.

    Every op over a view gives a view. A uint16 / uint32 column's view
    carries its RowTensor's logical dtype (`_ldt`), and its ops follow
    RowTensor's promotion. Traced under tracing.reference_trace, a view
    is refused what jax's tracer is refused."""

    _nb = 2
    _ldt: Optional[torch.dtype] = None

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name == "__get__":
            with torch._C.DisableTorchFunctionSubclass():
                return func(*args, **kwargs)
        view = next((a for a in _pytree.tree_leaves((args, kwargs))
                     if isinstance(a, RowView)), None)
        if view is None:
            return func(*args, **kwargs)
        nb = view._nb
        if name in _IN_PLACE:
            name = _IN_PLACE[name]
            func = getattr(torch.Tensor, name)
        elif name == "__setitem__" or (name.endswith("_")
                                       and not name.startswith("__")):
            raise TypeError(f"{name}: a row is immutable, as jax's arrays "
                            "are")
        op = name.strip("_")
        if op in _REDUCTIONS and len(args) == 1 and not kwargs:
            return _reduce_row(op, args[0])
        if op == "len":
            if args[0].ndim == 0:
                raise TypeError("len() of a 0-d row (jax's scalar row has "
                                "no length)")
            return args[0].shape[0]
        batch = tuple(plain(view).shape[:nb])
        if op == "flatten" and nb:
            x = args[0]
            start = args[1] if len(args) > 1 else kwargs.get("start_dim", 0)
            end = args[2] if len(args) > 2 else kwargs.get("end_dim", -1)
            out = (_inner(x).reshape(batch + (1,)) if x.ndim == 0 else
                   _inner(x).flatten(_shift(start, nb), _shift(end, nb)))
            return _rewrap(out, nb, batch)
        args, kwargs = _row_args(op, name, args, kwargs, view, batch)
        out = func(*_pytree.tree_map(_inner, args),
                   **_pytree.tree_map(_inner, kwargs))
        return _rewrap(out, nb, batch)

    @property
    def ndim(self) -> int:
        return plain(self).dim() - self._nb

    @property
    def shape(self) -> torch.Size:
        return plain(self).shape[self._nb:]

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def dim(self) -> int:
        return self.ndim

    def numel(self) -> int:
        return self.size

    @property
    def T(self) -> "RowView":
        return self.permute(*range(self.ndim - 1, -1, -1)) \
            if self.ndim > 1 else self

    def astype(self, dtype) -> "RowView":
        dt = jnp_dtype(dtype)
        if dt in _MASK:
            with torch._C.DisableTorchFunction():
                v = plain(self).to(torch.int64) & _MASK[dt]
            return _view(v, self._nb, dt)
        return self.to(dt)

    def copy(self) -> "RowView":
        return self.clone()

    def __round__(self, ndigits=None):
        ldt = logical_dtype(self)
        if ldt == torch.bool:
            raise ValueError("round() of a bool row: jnp.round refuses a "
                             "bool (not inexact)")
        if ndigits is None:
            # jax's __round__: jnp.round, then an int32
            return (torch.round(self) if ldt.is_floating_point
                    else self).to(torch.int32)
        if not ldt.is_floating_point:
            if ndigits < 0:
                raise NotImplementedError("integer np.round not "
                                          "implemented for decimals < 0")
            return self
        if ndigits == 0:
            return torch.round(self)
        # jnp.round's rescaling in float32; the reference's compiler
        # divides by the factor as a multiply by its float32 reciprocal
        x = self.to(torch.float32) if ldt == torch.float16 else self
        factor = np.float32(10.0 ** ndigits)
        out = torch.round(x * float(factor)) * float(np.float32(1) / factor)
        return out.to(torch.float16) if ldt == torch.float16 else out

    def __divmod__(self, other):
        x = self.to(torch.int32) if logical_dtype(self) == torch.bool \
            else self
        return torch.floor_divide(x, other), torch.remainder(x, other)

    def __rdivmod__(self, other):
        x = self.to(torch.int32) if logical_dtype(self) == torch.bool \
            else self
        return x.__rfloordiv__(other), x.__rmod__(other)


def plain(x: torch.Tensor) -> torch.Tensor:
    """The stored tensor of a RowView or RowTensor (no copy)."""
    return x.as_subclass(torch.Tensor) if type(x) is not torch.Tensor else x


def _view(x: torch.Tensor, nb: int, ldt=None) -> RowView:
    r = x.as_subclass(RowView)
    if nb != RowView._nb:
        r._nb = nb
    if ldt is not None:
        r._ldt = ldt
    return r


def row_view(x: torch.Tensor, nb: int = 2) -> RowView:
    """A row-form column (to_row) as its row view, hiding its leading nb
    dims: 2 for a row closure's [n_shards, capacity] column, 1 for a
    binop's [n_shards, m] operand, 0 for one value."""
    return _view(x, nb, x._ldt if isinstance(x, RowTensor) else None)


def _inner(a):
    """A view's column as the op computes on it: a RowTensor for an
    emulated dtype, else the plain tensor."""
    if not isinstance(a, RowView):
        return a
    return _tagged(plain(a), a._ldt) if a._ldt is not None else plain(a)


def _rewrap(out, nb: int, batch: tuple):
    """Each tensor result that keeps the rows' leading dims, as a view."""
    if type(out) is torch.Tensor:
        if out.dim() >= nb and tuple(out.shape[:nb]) == batch:
            return _view(out, nb)
        return out

    def wrap(r):
        if not isinstance(r, torch.Tensor):
            return r
        p = plain(r)
        if p.dim() >= nb and tuple(p.shape[:nb]) == batch:
            return _view(p, nb, r._ldt if isinstance(r, RowTensor) else None)
        return r
    if isinstance(out, tuple) and hasattr(out, "indices"):
        return type(out)((wrap(out.values), wrap(out.indices)))
    return _pytree.tree_map(wrap, out)


def _shift(d, nb: int):
    """A row dim (an int, or a tuple / list of them) as the column's."""
    if isinstance(d, (tuple, list)):
        return type(d)(_shift(x, nb) for x in d)
    if isinstance(d, int) and not isinstance(d, bool) and d >= 0:
        return d + nb
    return d


def _row_args(op: str, name: str, args, kwargs, view, batch: tuple):
    """args / kwargs of an op over views with the row's dims, shapes and
    indices as the column's."""
    nb = view._nb
    if nb == 0:
        return args, kwargs
    if name == "__getitem__":
        idx = args[1] if isinstance(args[1], tuple) else (args[1],)
        return (args[0], (slice(None),) * nb + idx), kwargs
    if op in ("reshape", "view") and args[0] is view and not any(
            isinstance(a, torch.dtype) for a in args[1:]):
        shape = args[1] if len(args) == 2 and isinstance(
            args[1], (tuple, list)) else args[1:]
        shape = kwargs.pop("shape", shape)
        return (args[0], batch + tuple(shape)), kwargs
    if op == "permute":
        dims = args[1] if len(args) == 2 and isinstance(
            args[1], (tuple, list)) else args[1:]
        dims = kwargs.pop("dims", dims)
        return (args[0], tuple(range(nb)) + _shift(tuple(dims), nb)), kwargs
    if op == "squeeze" and len(args) == 1 and not kwargs:
        dims = tuple(d for d, s in enumerate(args[0].shape) if s == 1)
        return (args[0], _shift(dims, nb)), kwargs
    at = _DIM_AT.get(op)
    if at is None:
        return args, kwargs
    args = list(args)
    if op in _DIM_ZERO and len(args) <= at[0] and \
            not any(k in kwargs for k in _DIM_KWARGS):
        args += [None] * (at[0] - len(args)) + [0]
    for i in at:
        if i < len(args):
            args[i] = _shift(args[i], nb)
    for k in _DIM_KWARGS:
        if k in kwargs:
            kwargs[k] = _shift(kwargs[k], nb)
    return tuple(args), kwargs


def _reduce_row(op: str, v: RowView) -> RowView:
    """A whole-row reduction of a view in jnp's result dtype: a scalar
    row is its own (no copy where the dtype stays)."""
    nb, ldt = v._nb, logical_dtype(v)
    s = plain(v)
    if s.dim() > nb:
        flat = s.reshape(s.shape[:nb] + (-1,))
        if op == "mean":
            s = flat.to(_reduced_dtype(op, ldt)).mean(-1)
        else:
            s = getattr(flat, {"max": "amax", "min": "amin"}.get(op, op))(-1)
    dt = _reduced_dtype(op, ldt)
    if dt in _MASK:
        with torch._C.DisableTorchFunction():
            return _view(s.to(torch.int64) & _MASK[dt], nb, dt)
    return _view(s if s.dtype == dt else s.to(dt), nb)


def _reduced_dtype(op: str, ldt: torch.dtype) -> torch.dtype:
    if op in ("any", "all"):
        return torch.bool
    if op == "mean":
        return ldt if ldt.is_floating_point else torch.float32
    if op in ("sum", "prod") and not ldt.is_floating_point:
        unsigned = ldt in (torch.uint8, torch.uint16, torch.uint32)
        return torch.uint32 if unsigned else torch.int32
    return ldt


def jnp_dtype(dtype) -> torch.dtype:
    """The torch dtype of an astype() argument (a numpy dtype or type, a
    Python type, a string, a torch dtype) as jax with 64-bit types off
    gives it: int64 -> int32, uint64 -> uint32, float64 -> float32."""
    if isinstance(dtype, torch.dtype):
        return logical_dtype(torch.empty(0, dtype=dtype))
    nd = np.dtype(dtype)
    nd = {np.dtype(np.int64): np.dtype(np.int32),
          np.dtype(np.uint64): np.dtype(np.uint32),
          np.dtype(np.float64): np.dtype(np.float32)}.get(nd, nd)
    return _OF_NUMPY.get(nd) or torch.from_numpy(np.zeros(0, nd)).dtype


def reduce_form(col: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """A uint32 column's unbiased bits (int32), on which add and prod wrap
    mod 2^32; the same call maps them back. Other columns as they are."""
    return col ^ _SIGN if dt == torch.uint32 else col


def wrap(col: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """A stored column after int32 / float32 arithmetic back into its
    logical range: mod 2^width for the narrow integers, one rounding for
    float16. uint32 wraps by itself (reduce_form)."""
    if dt == torch.uint16:
        return col & 0xFFFF
    if dt in PHYSICAL and dt != torch.uint32:
        return col.to(dt).to(PHYSICAL[dt])
    return col


def hash_input(key: torch.Tensor, dt: Optional[torch.dtype]) -> torch.Tensor:
    """The word the hash_bucket kernel hashes for a key column of logical
    dtype dt, the reference's astype(uint32) of the key: a uint32's bits,
    a float16's value converted as XLA converts it (truncated toward zero,
    negatives and NaN to 0, +inf to 2^32 - 1; equal keys still share a
    bucket); anything else its stored word."""
    if dt == torch.uint32:
        return key ^ _SIGN
    if dt == torch.float16:
        t = torch.where(torch.isnan(key), 0.0, key).clamp(min=0.0)
        return torch.where(torch.isinf(t), -1, t.to(torch.int32))
    return key


def to_float32(col: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Values as float32 (stats, histogram)."""
    return (to_row(col, dt) if dt == torch.uint32 else col).to(torch.float32)


def from_numpy(src: np.ndarray):
    """(stored numpy array, logical torch dtype or None) of a host column."""
    dt = _OF_NUMPY.get(src.dtype)
    if dt is None:
        return src, None
    if dt == torch.uint32:
        return (src ^ _U32_BIAS).view(np.int32), dt
    if dt == torch.float16:
        return src.astype(np.float32), dt
    return src.astype(np.int32), dt


def to_numpy(col: np.ndarray, dt: Optional[torch.dtype]) -> np.ndarray:
    """A stored host column back in its logical numpy dtype."""
    if dt is None or dt not in PHYSICAL:
        return col
    if dt == torch.uint32:
        return np.asarray(col, dtype=np.int32).view(np.uint32) ^ _U32_BIAS
    return np.asarray(col).astype(_NUMPY[dt])


def decode_cols(cols: dict, logical: Optional[dict]) -> dict:
    """Every logical column of a host column dict back in its numpy dtype;
    the others pass through, order kept."""
    if not logical:
        return cols
    return {nm: to_numpy(c, logical.get(nm)) for nm, c in cols.items()}


def numpy_dtype(dt: torch.dtype):
    """The numpy dtype of a logical or plain torch dtype."""
    if dt in _NUMPY:
        return np.dtype(_NUMPY[dt])
    return torch.empty((), dtype=dt).numpy().dtype


def stored_scalar(value, dt: torch.dtype):
    """A Python scalar of logical dtype dt as its stored word (a join's
    fill, a lookup's key); a value dt cannot hold raises VegaError."""
    if dt not in PHYSICAL:
        return value
    if dt == torch.float16:
        return float(np.float16(value))
    try:
        v = int(value)
    except (TypeError, ValueError, OverflowError) as e:
        raise VegaError(f"{value!r} has no {dt} form") from e
    info = np.iinfo(_NUMPY[dt])
    if not info.min <= v <= info.max:
        raise VegaError(f"{value!r} is outside {dt}")
    if dt == torch.uint32:
        v ^= 0x80000000
        return v - (1 << 32) if v >= 1 << 31 else v
    return v
