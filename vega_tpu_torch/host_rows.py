"""The reference host tier's row form for the RDD API's closures.

The reference traces a row function, predicate or binop with jax, 64-bit
types off. A Python int past int32 fails that trace (tracing.py), and so
does any closure over a wide int64 column; the reference then hands the
node, and everything downstream of it, to its host tier, which calls the
closure on each row's Python values: exact ints, floats as float64.

The port traces such a closure again on columns in that form and runs it
on the device:

    column                       the closure sees
    int32, narrow, uint32 int    wideint.WideInt: exact int64 values whose
    or a wide int64 pair         overflow flags the row
    float32, float16, float64    a float64 tensor
    bool                         a bool tensor

Its outputs are stored as: a WideInt known to lie in int32 (an int32 input
as it came, or its remainder modulo an int32 constant) or a Python int in
int32 as an int32 column; any other integer as the wide (name, name.lo)
pair; a float as a float64 column; a bool as a bool column. A row that
leaves int64 (or divides by zero) raises VegaError when the node's
overflow flags are read, one host read per application, only for a
closure whose trace recorded such an operation: the reference keeps a
Python int there.

A node built so is a host-row node (DenseRDD.host_rows), and so is every
node downstream of one: their closures take this form directly, a named
add over their int32 or float32 values sums in int64 or float64, and
fold_by_key / aggregate_by_key fold their zero once per key per shard, as
the host tier folds it once per key per partition."""

from __future__ import annotations

import operator
from typing import List, Tuple

import numpy as np
import torch

from vega_tpu_torch import block as block_lib
from vega_tpu_torch import coltypes
from vega_tpu_torch import dense_rdd as dr
from vega_tpu_torch import kernels
from vega_tpu_torch import mesh as mesh_lib
from vega_tpu_torch import tracing
from vega_tpu_torch.block import KEY, KEY_LO, VALUE
from vega_tpu_torch.errors import VegaError
from vega_tpu_torch.wideint import I32_MAX, I32_MIN, I64_MAX, I64_MIN, WideInt

# the working column of a host binop's per-row overflow flags
BAD = "\x00bad"


# ---------------------------------------------------------------------------
# the row form
# ---------------------------------------------------------------------------


def logical_columns(schema) -> List[Tuple[str, torch.dtype, bool]]:
    """(name, dtype, wide) of each logical column, a wide pair once."""
    names = {nm for nm, _ in schema}
    return [(nm, dt, block_lib.lo_of(nm) in names) for nm, dt in schema
            if not block_lib.is_lo(nm)]


def _value(cols, nm: str, dt: torch.dtype, wide: bool, sink: list):
    """One stored column as the host tier's values."""
    col = cols[nm]
    if wide:
        return WideInt(kernels.wide_i64(col, cols[block_lib.lo_of(nm)]),
                       sink)
    if dt == torch.bool:
        return col
    if dt.is_floating_point:
        return col.to(torch.float64)
    row = coltypes.to_row(col, dt)
    if isinstance(row, coltypes.RowTensor):
        row = row.as_subclass(torch.Tensor)
    return WideInt(row.to(torch.int64), sink, fits32=dt != torch.uint32)


def row_view(cols, schema, sink: list):
    """The row a closure sees, as the reference forms it: (k, v) for the
    canonical pair, v for one value column, else a tuple of every logical
    column."""
    logical = logical_columns(schema)
    vals = {nm: _value(cols, nm, dt, wide, sink) for nm, dt, wide in logical}
    names = [nm for nm, _, _ in logical]
    if set(names) == {KEY, VALUE}:
        return (vals[KEY], vals[VALUE])
    if names == [VALUE]:
        return vals[VALUE]
    return tuple(vals[nm] for nm in names)


def _probe_cols(schema, n_shards: int):
    return {nm: torch.empty((n_shards, 0), dtype=coltypes.physical(dt))
            for nm, dt in schema}


def refuse_strings(node, op: str) -> None:
    d = node._dicts()
    if d:
        raise dr._NotTraceable(
            f"{op} over the string (dictionary-encoded) columns "
            f"{sorted(d)} (the host tier's closure sees the strings)")


def _traced(what: str, f, sink: list, *args):
    """f(*args) on probe columns in the row form, whose operations record
    their overflow flags in sink; (output, flagged): flagged when one
    was recorded. It traces under tracing.reference_trace (no literal
    rule: the row form holds exact int64), so what jax's trace refuses
    (numpy or a Python conversion of the row, a hash of it) fails here
    too, and the op is the host RDD layer's (dr._NotTraceable)."""
    try:
        with tracing.reference_trace(literals=False):
            out = f(*args)
    except VegaError:
        raise
    except Exception as e:  # noqa: BLE001 — any failure means "no form"
        raise dr._NotTraceable(
            f"{what} {f!r} does not run on the host tier's row form "
            f"({type(e).__name__}: {e})") from e
    return out, _flagged(sink)


def _flagged(sink: list) -> bool:
    return any(not (isinstance(x, bool) and not x) for x in sink)


def check_flags(mesh, sink: list, valid: torch.Tensor, what: str) -> None:
    """Raise VegaError when a valid row is flagged (one host read)."""
    flags = [x for x in sink if not (isinstance(x, bool) and not x)]
    if not flags:
        return
    bad = torch.zeros(valid.shape[0], dtype=torch.bool, device=valid.device)
    for x in flags:
        bad |= (valid & x).any(dim=1)
    if np.asarray(mesh_lib.host_get(mesh, bad)).any():
        raise VegaError(
            f"{what}: a row's integer left the int64 range (or divided by "
            "zero); the reference's host tier computes it on Python ints, "
            "which the device cannot hold")


# ---------------------------------------------------------------------------
# outputs
# ---------------------------------------------------------------------------


def out_kind(x, shape, what: str) -> str:
    """The stored form of one output: int32, wide, float64 or bool."""
    if isinstance(x, WideInt):
        x, kind = x.v, "int32" if x.fits32 else "wide"
    elif isinstance(x, torch.Tensor):
        kind = ("bool" if x.dtype == torch.bool else
                "float64" if x.dtype.is_floating_point else "wide")
    else:
        if isinstance(x, np.generic):
            x = x.item()
        if isinstance(x, bool):
            return "bool"
        if isinstance(x, int):
            if not I64_MIN <= x <= I64_MAX:
                raise VegaError(f"{what}: constant {x} is outside int64")
            return "int32" if I32_MIN <= x <= I32_MAX else "wide"
        if isinstance(x, float):
            return "float64"
        raise dr._NotTraceable(f"{what} of type {type(x).__name__} "
                               "(neither a column nor a constant)")
    if tuple(x.shape) != tuple(shape):
        raise dr._NotTraceable(f"{what} must be one scalar per row, got "
                               f"shape {tuple(x.shape)} for rows "
                               f"{tuple(shape)}")
    return kind


def out_schema(nm: str, kind: str):
    if kind == "wide":
        return ((nm, torch.int32), (block_lib.lo_of(nm), torch.int32))
    return ((nm, {"int32": torch.int32, "bool": torch.bool,
                  "float64": torch.float64}[kind]),)


def store(nm: str, x, kind: str, like: torch.Tensor) -> dict:
    """One output as its stored columns, of like's shape and device."""
    shape = tuple(like.shape[:2])
    if isinstance(x, WideInt):
        x = x.v
    if isinstance(x, np.generic):
        x = x.item()
    if kind == "wide":
        v = (x.to(torch.int64) if isinstance(x, torch.Tensor) else
             torch.full(shape, int(x), dtype=torch.int64,
                        device=like.device))
        hi, lo = kernels.wide_words(v)
        return {nm: hi.contiguous(), block_lib.lo_of(nm): lo.contiguous()}
    dt = {"int32": torch.int32, "bool": torch.bool,
          "float64": torch.float64}[kind]
    if isinstance(x, torch.Tensor):
        return {nm: x.to(dt).contiguous()}
    return {nm: torch.full(shape, x, dtype=dt, device=like.device)}


def _outputs(out):
    """(whether out is a (key, value) pair, its outputs)."""
    pair = isinstance(out, tuple) and len(out) == 2
    return pair, (out if pair else (out,))


# ---------------------------------------------------------------------------
# narrow nodes
# ---------------------------------------------------------------------------


class HostMapRDD(dr._NarrowRDD):
    """map(f) in the host tier's row form: f returns a value or a
    (key, value) pair."""

    _host_rows_self = True
    _debug_name = "MapperRDD"  # the reference's host node for this map

    def __init__(self, parent: dr.DenseRDD, f):
        refuse_strings(parent, "map")
        schema = parent._schema()
        n = parent.n_shards
        sink: list = []
        out, self._flagged = _traced(
            "row function", f, sink,
            row_view(_probe_cols(schema, n), schema, sink))
        self._pair, outs = _outputs(out)
        names = (KEY, VALUE) if self._pair else (VALUE,)
        self._kinds = [(nm, out_kind(x, (n, 0),
                                     f"row function output {nm!r}"))
                       for nm, x in zip(names, outs)]
        super().__init__(parent, sum((out_schema(nm, k)
                                      for nm, k in self._kinds), ()))
        self._f = f
        self._dict_renames = {}

    def _fp_extra(self):
        return ("host", dr._fp(self._f))

    def _shard_fn(self, cols, count):
        like = next(iter(cols.values()))
        inputs = dr._row_inputs(cols, count)
        if inputs is None:
            return dr._zero_cols(self._out_schema, like), count
        sink: list = []
        res = self._f(row_view(inputs, self.parent._schema(), sink))
        if self._flagged:
            check_flags(self.mesh, sink,
                        kernels.valid_mask(like.shape[1], count),
                        "row function")
        out = {}
        for (nm, kind), x in zip(self._kinds, _outputs(res)[1]):
            out.update(store(nm, x, kind, like))
        return out, count


class HostFilterRDD(dr._NarrowRDD):
    """filter(pred) in the host tier's row form: a row stays when its
    predicate's value is true (an int or float when non-zero)."""

    _host_rows_self = True
    _debug_name = "MapPartitionsRDD"  # the reference's host filter
    _keeps_counts = False
    _keeps_placement = True

    def __init__(self, parent: dr.DenseRDD, pred):
        refuse_strings(parent, "filter")
        schema = parent._schema()
        n = parent.n_shards
        sink: list = []
        out, self._flagged = _traced(
            "filter predicate", pred, sink,
            row_view(_probe_cols(schema, n), schema, sink))
        out_kind(out, (n, 0), "filter predicate")
        super().__init__(parent, schema)
        self._pred = pred

    def _fp_extra(self):
        return ("host", dr._fp(self._pred))

    def _shard_fn(self, cols, count):
        like = next(iter(cols.values()))
        valid = kernels.valid_mask(like.shape[1], count)
        inputs = dr._row_inputs(cols, count)
        keep = valid
        if inputs is not None:
            sink: list = []
            x = self._pred(row_view(inputs, self._out_schema, sink))
            if self._flagged:
                check_flags(self.mesh, sink, valid, "filter predicate")
            if isinstance(x, WideInt):
                x = x.v
            if isinstance(x, torch.Tensor):
                keep = keep & (x != 0)
            elif not x:
                keep = torch.zeros_like(valid)
        return kernels.compact(cols, keep, like.shape[1])


class HostMapValuesRDD(dr._NarrowRDD):
    """map_values(f) in the host tier's row form over the one logical
    value column; the key columns pass through."""

    _host_rows_self = True
    _debug_name = "MapPartitionsRDD"  # the reference's host map_values
    _keeps_placement = True

    def __init__(self, parent: dr.DenseRDD, f):
        logical = [c for c in logical_columns(parent._schema())
                   if c[0] not in (KEY, KEY_LO)]
        if len(logical) != 1:
            raise VegaError(
                "map_values needs exactly one value column (have "
                f"{[c[0] for c in logical]})")
        self._vcol = logical[0]
        if self._vcol[0] in parent._dicts():
            raise dr._NotTraceable("map_values over a string "
                                   "(dictionary-encoded) value column")
        vschema = [(nm, dt) for nm, dt in parent._schema()
                   if nm in (self._vcol[0], block_lib.lo_of(self._vcol[0]))]
        n = parent.n_shards
        sink: list = []
        probe = _value(_probe_cols(vschema, n), *self._vcol, sink)
        out, self._flagged = _traced("map_values function", f, sink, probe)
        self._kind = out_kind(out, (n, 0), "map_values output")
        pschema = dict(parent._schema())
        key_schema = tuple((nm, pschema[nm]) for nm in (KEY, KEY_LO)
                           if nm in pschema)
        super().__init__(parent, key_schema
                         + out_schema(self._vcol[0], self._kind))
        self._f = f
        self._dict_renames = {KEY: KEY}

    def _fp_extra(self):
        return ("host", dr._fp(self._f))

    def _shard_fn(self, cols, count):
        like = next(iter(cols.values()))
        out = {nm: cols[nm] for nm in (KEY, KEY_LO) if nm in cols}
        inputs = dr._row_inputs(cols, count)
        nm = self._vcol[0]
        if inputs is None:
            out.update(dr._zero_cols(out_schema(nm, self._kind), like))
            return out, count
        sink: list = []
        res = self._f(_value(inputs, *self._vcol, sink))
        if self._flagged:
            check_flags(self.mesh, sink,
                        kernels.valid_mask(like.shape[1], count),
                        "map_values function")
        out.update(store(nm, res, self._kind, like))
        return out, count


class WidenValuesRDD(dr._NarrowRDD):
    """The value columns of a host-row node in the forms a named add
    keeps exact on the host tier: integers and bools (True + True is 2
    there) as the wide pair (int64), float32 / float16 as float64. Keys
    and wide or float64 values pass through."""

    _host_rows_self = True
    _keeps_placement = True

    def __init__(self, parent: dr.DenseRDD):
        schema = []
        self._widen = {}
        dicts = parent._dicts()
        for nm, dt, wide in logical_columns(parent._schema()):
            kind = _widened(nm, dt, wide, dicts)
            if kind is None:
                schema.append((nm, dt))
                if wide:
                    schema.append((block_lib.lo_of(nm), torch.int32))
            else:
                self._widen[nm] = (dt, kind)
                schema.extend(out_schema(nm, kind))
        super().__init__(parent, schema)

    def _shard_fn(self, cols, count):
        out = {}
        for nm, _ in self._out_schema:
            if nm in self._widen:
                dt, kind = self._widen[nm]
                out.update(store(nm, _value(cols, nm, dt, False, []),
                                 kind, cols[nm]))
            elif not (block_lib.is_lo(nm) and nm[:-len(block_lib.LO_SUFFIX)]
                      in self._widen):
                out[nm] = cols[nm]
        return out, count


def _widened(nm: str, dt: torch.dtype, wide: bool, dicts) -> str:
    """The wider stored form in which a named add keeps a value column
    exact on the host tier, or None (a key, a wide or float64 value, a
    string)."""
    if nm in (KEY, KEY_LO) or wide or nm in dicts or dt == torch.float64:
        return None
    return "float64" if dt.is_floating_point else "wide"


def needs_widening(node) -> bool:
    """Whether a named add over node's values would sum a column the host
    tier keeps exact in a wider form (an int32, bool or float32 value)."""
    dicts = node._dicts()
    return any(_widened(nm, dt, wide, dicts) for nm, dt, wide
               in logical_columns(node._schema()))


# ---------------------------------------------------------------------------
# binops
# ---------------------------------------------------------------------------


class HostBinop:
    """A reduce binop in the host tier's row form over the value columns
    of a schema: over one value column f maps two values to one, over
    several two tuples to a tuple. The reduce runs on working columns:
    an integer column as int64, a float column as float64, a bool as it
    is, plus BAD, the rows' overflow flags, which the combine ORs along
    with its own; stored() gives the reduced columns back in their stored
    forms (an integer as the wide pair)."""

    def __init__(self, f, schema, what: str):
        self.f = f
        self.what = what
        self.columns = [c for c in logical_columns(schema)
                        if c[0] not in (KEY, KEY_LO)]
        if not self.columns:
            raise VegaError(f"{what} needs a value column")
        self.kinds = {}
        for nm, dt, wide in self.columns:
            self.kinds[nm] = ("int" if wide or not (
                dt.is_floating_point or dt == torch.bool)
                else "float" if dt.is_floating_point else "bool")
        sink: list = []
        probe = [self._wrap(nm, torch.empty((1, 0), dtype=self._dtype(nm)),
                            sink) for nm in self.names]
        arg = probe[0] if len(probe) == 1 else tuple(probe)
        out, _ = _traced(f"{what} binop", f, sink, arg, arg)
        outs = [out] if len(probe) == 1 else out
        if not isinstance(outs, (tuple, list)) or len(outs) != len(probe):
            raise dr._NotTraceable(f"{what} binop over {len(probe)} value "
                                   f"columns must return a {len(probe)}-"
                                   "tuple")
        for nm, o in zip(self.names, outs):
            self._unwrap(nm, o)

    @property
    def names(self) -> List[str]:
        return [nm for nm, _, _ in self.columns]

    def _dtype(self, nm: str) -> torch.dtype:
        return {"int": torch.int64, "float": torch.float64,
                "bool": torch.bool}[self.kinds[nm]]

    def _wrap(self, nm: str, col: torch.Tensor, sink: list):
        return WideInt(col, sink) if self.kinds[nm] == "int" else col

    def _unwrap(self, nm: str, o) -> torch.Tensor:
        """The binop's output for column nm as its working tensor; any
        other kind (an int column made a float) refuses."""
        if isinstance(o, WideInt):
            o = o.v
        kind = self.kinds[nm]
        if not isinstance(o, torch.Tensor) or o.dim() != 2 or (
                (o.dtype == torch.bool) != (kind == "bool")) or (
                o.dtype.is_floating_point != (kind == "float")):
            raise dr._NotTraceable(
                f"{self.what} binop must map the value column {nm!r} to "
                f"one {kind} per row (the kind a column holds stays)")
        return o.to(self._dtype(nm))

    def schema(self, key_schema) -> tuple:
        """The reduce's output schema: the keys, then each value column
        in its stored host form."""
        out = tuple(key_schema)
        for nm in self.names:
            out += out_schema(nm, {"int": "wide", "float": "float64",
                                   "bool": "bool"}[self.kinds[nm]])
        return out

    def working(self, cols) -> dict:
        out = {nm: cols[nm] for nm in (KEY, KEY_LO) if nm in cols}
        for nm, dt, wide in self.columns:
            v = _value(cols, nm, dt, wide, [])
            out[nm] = (v.v if isinstance(v, WideInt) else v).to(
                self._dtype(nm))
        like = cols[self.names[0]]
        out[BAD] = torch.zeros(like.shape[:2], dtype=torch.bool,
                               device=like.device)
        return out

    def combine(self, a: dict, b: dict) -> dict:
        sink: list = []
        args = [tuple(self._wrap(nm, side[nm], sink) for nm in self.names)
                for side in (a, b)]
        if len(self.names) == 1:
            res = (self.f(args[0][0], args[1][0]),)
        else:
            res = tuple(self.f(args[0], args[1]))
        out = {nm: self._unwrap(nm, o) for nm, o in zip(self.names, res)}
        bad = a[BAD] | b[BAD]
        for x in sink:
            if not (isinstance(x, bool) and not x):
                bad = bad | x
        out[BAD] = bad
        return out

    def stored(self, cols, count):
        """(stored columns, bad): bad[s] when a valid row of shard s
        left int64."""
        like = cols[self.names[0]]
        valid = kernels.valid_mask(like.shape[1], count)
        out = {nm: cols[nm] for nm in (KEY, KEY_LO) if nm in cols}
        for nm in self.names:
            kind = {"int": "wide", "float": "float64",
                    "bool": "bool"}[self.kinds[nm]]
            out.update(store(nm, cols[nm], kind, like))
        return out, (cols[BAD] & valid).any(dim=1)


# ---------------------------------------------------------------------------
# fold_by_key / aggregate_by_key: the zero once per key per shard
# ---------------------------------------------------------------------------


class ShardFoldRDD(dr._NarrowRDD):
    """Each shard's rows reduced by key within the shard, with no
    exchange: the host tier's fold of one partition. A named seq reduces
    through kernels.segment_reduce_named (a named add or prod of int32,
    bool or float32 values over their widened forms), any other through
    the segmented scan in the row form (HostBinop). Rows stay in their
    shard, so the parent's placement holds."""

    _host_rows_self = True
    _keeps_counts = False
    _keeps_placement = True

    def __init__(self, parent: dr.DenseRDD, seq):
        parent._check_sortable_key("fold_by_key")
        op = dr._infer_named_op(seq)
        if op in ("add", "prod") and needs_widening(parent):
            parent = WidenValuesRDD(parent)
        schema = parent._schema()
        names = [nm for nm, _ in schema]
        self._binop = None
        if op is None or (op == "prod"
                          and block_lib.wide_value_pairs(names)):
            op = None
            self._binop = HostBinop(seq, schema, "fold_by_key")
            schema = self._binop.schema(
                [(nm, dt) for nm, dt in schema if nm in (KEY, KEY_LO)])
        self._op, self._seq = op, seq
        super().__init__(parent, schema)

    def _fp_extra(self):
        return ("shard fold", self._op or dr._fp(self._seq))

    def _shard_fn(self, cols, count):
        lo = KEY_LO if KEY_LO in cols else None
        like = cols[KEY]
        impl = self.context.dense_sort_impl
        wide = {}
        if self._binop is not None:
            w = kernels.sort_by_column(self._binop.working(cols), count,
                                       KEY, impl=impl, lo_name=lo)
            inputs = dr._row_inputs(
                {nm: w[nm] for nm in self._binop.names + [BAD]}, count)
            if inputs is None:
                return dr._zero_cols(self._out_schema, like), count
            w, count = kernels.segment_reduce_sorted(
                dict(w, **inputs), count, KEY, self._binop.combine,
                presorted=True, lo_name=lo)
            out, bad = self._binop.stored(w, count)
        else:
            schema = self.parent._schema()
            wide = block_lib.wide_value_pairs([nm for nm, _ in schema])
            logical = {nm: dt for nm, dt in coltypes.logical_of(
                schema).items() if nm not in (KEY, KEY_LO)}
            w = dr._logical_form(dr._wide_working_form(
                cols, wide, self._op), logical, self._op)
            w, count = kernels.segment_reduce_named(
                w, count, KEY, self._op, sort_impl=impl, lo_name=lo)
            out, bad = dr._wide_stored_form(w, count, wide, self._op)
            out = dr._logical_form(out, logical, self._op, back=True)
        if (self._binop is not None or wide) and np.asarray(
                mesh_lib.host_get(self.mesh, bad)).any():
            raise VegaError(
                "fold_by_key: a key's fold left the int64 range (or divided "
                "by zero); the reference's host tier computes it on Python "
                "ints, which the device cannot hold")
        return {nm: out[nm] for nm, _ in self._out_schema}, count


def keyed_fold(node: dr.DenseRDD, zero, seq, comb) -> dr.DenseRDD:
    """fold_by_key (seq = comb) / aggregate_by_key in the host tier's row
    form. The host tier folds each key's values of a partition from zero
    with seq, then merges the partitions' results with comb: with seq
    associative (as a reduce binop is), the fold of a shard's values is
    seq(zero, seq-reduce of them). So each shard reduces its rows by key
    with seq (ShardFoldRDD), each result becomes seq(zero, c), and comb
    reduces them across shards."""
    folded = dr._dense_or_refuse(ShardFoldRDD(node, seq).map_values(
        _zero_first(seq, zero)))
    return dr._dense_or_refuse(folded.reduce_by_key(comb))


def _zero_first(seq, zero):
    """c -> seq(zero, c) in the row form. Builtin max and min branch on a
    value, so over an integer column with an int zero, or a float column
    with a float zero, they run as the choice they make: max(zero, c) is
    c where c > zero (min: c < zero), else zero."""
    beats = {max: operator.gt, min: operator.lt}.get(seq)

    def pick(c):
        if isinstance(c, WideInt) and type(zero) is int:
            return WideInt(torch.where(beats(c, zero), c.v, zero), c.sink)
        if isinstance(c, torch.Tensor) and c.dtype == torch.float64 \
                and type(zero) is float:
            return torch.where(beats(c, zero), c, zero)
        return seq(zero, c)

    return (lambda c: seq(zero, c)) if beats is None else pick


# ---------------------------------------------------------------------------
# reduce(f)
# ---------------------------------------------------------------------------


def _python(x: np.ndarray, kind: str):
    v = x.item()
    return bool(v) if kind == "bool" else v


def reduce_launch(node: dr.DenseRDD, f):
    """reduce(f) in the host tier's row form: each shard folds its rows
    through the segmented scan on working columns (exact int64, float64),
    then the host folds the shards' results with f on Python values, as
    the host tier merges its partitions' results. Returns the callable
    that fetches the partials and folds them."""
    binop = HostBinop(f, node._schema(), "reduce")
    if len(binop.names) != 1:
        raise VegaError("reduce(f) needs one value column")
    nm = binop.names[0]
    kind = binop.kinds[nm]
    blk = node.block()
    w = binop.working(dict(blk.cols))
    inputs = dr._row_inputs(w, blk.counts)
    if inputs is None:
        first = torch.zeros_like(w[nm][:, 0])
        bad = torch.zeros_like(w[BAD][:, 0])
        n_out = torch.zeros_like(blk.counts)
    else:
        keyed = dict(inputs)
        keyed["\x00k"] = torch.zeros_like(w[BAD], dtype=torch.int32)
        out, n_out = kernels.segment_reduce_sorted(
            keyed, blk.counts, "\x00k", binop.combine, presorted=True)
        first, bad = out[nm][:, 0], out[BAD][:, 0]

    def finish():
        parts, flags, nonempty = mesh_lib.host_get(
            blk.mesh, [first, bad, n_out > 0])
        if (flags & nonempty).any():
            raise VegaError("reduce: the binop left the int64 range (or "
                            "divided by zero) on a row; the reference's "
                            "host tier computes it on Python ints, which "
                            "the device cannot hold")
        picked = [_python(parts[s], kind) for s in range(len(nonempty))
                  if nonempty[s]]
        if not picked:
            raise VegaError("reduce() of empty RDD")
        acc = picked[0]
        for x in picked[1:]:
            acc = f(acc, x)
        return acc
    return finish
