"""Frame physical building blocks (the port's copy of
vega_tpu/frame/physical.py): the lazy device sources, and the host tier's
per-partition closures over numpy blocks and row tuples.

Plan compilation builds the source node and checks the dtypes; the first
block() reads the file or coerces the arrays and shards them onto the
Context's device (planning itself never touches data or the device).

Dtype contract at the device boundary. The scan's forms (columns_forms,
parquet_forms) classify each column once, with the reference's verdict
beside it: int64 / uint64 / uint32 columns whose values fit int32 narrow
to int32, and the others take the wide int64 pair (block.encode_i64:
<name> the high word, <name>.lo the biased low word), where the
reference compiles the plan on its host tier; strings become int32
dictionary codes plus a sorted host dictionary (dict_encoding.py). The
rest follows the tier the reference would pick for the plan
(planner.reference_tier), since its two tiers hold these values apart:
on its device tier float64 narrows to float32 and bool widens to int32;
on its host tier a float64 column stays float64 (the words of its bits,
a pair like the wide one), a bool column stays a bool (0 / 1 int32
words read back as bools), and an integer column of 32 bits or fewer
keeps its numpy dtype beside its int32 words (ScanForms.np_ints), which
numpy computes in before the first exchange. Anything else (object
columns of anything but strings, uint64 beyond int64) has no device
form: the plan compiles onto the host tier (NoDeviceLowering, caught by
planner.compile_plan), as the reference's does. What a stage computes
from these columns follows the same tier (planner._Stage).

The host tier's closures (host_block_stage to host_left_join_emit) are
the reference's: columnar blocks {name: numpy column} until the first
exchange, row tuples of Python values after it, evaluated with numpy
and Python operators (expr.evaluate(..., host=True))."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vega_tpu_torch import block as block_lib
from vega_tpu_torch import dense_rdd
from vega_tpu_torch import dict_encoding
from vega_tpu_torch.errors import VegaError
from vega_tpu_torch.frame import parquet as parquet_lib
from vega_tpu_torch.frame.expr import evaluate

_TORCH_DTYPES = {"int32": torch.int32, "float32": torch.float32}
# the stored words of a pair: the wide int64 and the float64 bits
_PAIRS = ("wide", "float64")


class NoDeviceLowering(VegaError):
    """A plan with no device form in the port (the reference's
    HostFallback): planner.compile_plan compiles it on the host tier, or
    raises it under hint(tier="device"). reason is the reference's."""

    def __init__(self, reason: str):
        super().__init__(f"the plan has no device lowering: {reason}")
        self.reason = reason


# ---------------------------------------------------------------------------
# dtype forms at the device boundary
# ---------------------------------------------------------------------------


class ScanForms:
    """A scan's columns as the plan compiles them: kinds {frame name:
    "int32" | "bool" | "wide" | "float32" | "float64" | "dict"}, the
    reference's reason for compiling the plan on its host tier at this
    scan (its first HostFallback here; None when its device tier takes
    the scan) and the port's own refusal (the VegaError of the first
    column with no device form, or None); a parquet scan's file dtypes.
    np_ints {frame name: numpy dtype} names the integer columns of 32
    bits or fewer (int8 to int32, uint8 to uint32): numpy computes in
    their own width on the reference's host tier, where an int64 column
    held as int32 because it fits computes in int64."""

    def __init__(self, kinds: Dict[str, str], reference: Optional[str],
                 error: Optional[VegaError], file_dtypes=None):
        self.kinds = kinds
        self.reference = reference
        self.error = error
        self.file_dtypes = file_dtypes
        self.np_ints: Dict[str, np.dtype] = {}

    def check(self) -> None:
        if self.error is not None:
            raise self.error


def _number_kind(dt: np.dtype) -> Optional[str]:
    """The kind of a bool / int / float dtype ("int64?" when a value range
    decides between int32 and the wide pair), None for any other."""
    if dt == np.bool_:
        return "bool"
    if dt.kind in ("i", "u"):
        return "int32" if dt.itemsize <= 4 and dt != np.uint32 else "int64?"
    if dt.kind == "f":
        return "float64" if dt.itemsize >= 8 else "float32"
    return None


def _column_form(name: str, col: np.ndarray, dict_enabled: bool):
    """(kind or None, the reference's host-tier reason or None, the port's
    refusal reason or None) of one in-memory column: the dtype kind, the
    int64 range check, the all-str object scan."""
    col = np.asarray(col)
    dt = col.dtype
    if dt.kind == "O":
        # object columns have a device form only when every element is a
        # str (the pandas pivot shape): a full scan, the same class of
        # compile-time value check as the int64 range proof below
        if not dict_encoding.is_string_array(col):
            why = f"column {name!r} (object dtype) has no device column form"
            return None, why, why
        if not dict_enabled:
            why = f"string column {name!r} with dense_dict_enabled off"
            return None, why, why
        return "dict", None, None
    if dt.kind in ("U", "S"):
        if not dict_enabled:
            why = f"string column (dtype {dt}) with dense_dict_enabled off"
            return None, why, why
        return "dict", None, None
    kind = _number_kind(dt)
    if kind is None:
        why = f"dtype {dt} has no device column form"
        return None, why, why
    if kind != "int64?":
        return kind, None, None
    info = np.iinfo(np.int32)
    if not len(col) or (col.min() >= info.min and col.max() <= info.max):
        return "int32", None, None
    why = f"column {name!r} holds int64 values beyond int32 range"
    if dt == np.uint64 and col.max() > np.uint64(2**63 - 1):
        return None, why, f"column {name!r} holds uint64 values beyond int64"
    return "wide", why, None


def _np_ints(dtypes) -> Dict[str, np.dtype]:
    """The integer columns of 32 bits or fewer of {frame name: dtype}."""
    return {fn: dt for fn, dt in dtypes
            if dt.kind in ("i", "u") and dt.itemsize <= 4}


def _forms(checked) -> ScanForms:
    """ScanForms of (frame name, (kind, reference reason, refusal)) in the
    scan's column order; the first reason of each side counts."""
    kinds, reference, error = {}, None, None
    for fn, (kind, why, refusal) in checked:
        kinds[fn] = kind
        reference = reference or why
        if error is None and refusal:
            error = NoDeviceLowering(refusal)
    return ScanForms(kinds, reference, error)


def columns_forms(data: Dict[str, np.ndarray],
                  dict_enabled: bool = True) -> ScanForms:
    """The forms of in-memory columns (create_frame), in their order."""
    forms = _forms((fn, _column_form(fn, data[fn], dict_enabled))
                   for fn in data)
    forms.np_ints = _np_ints((fn, np.asarray(data[fn]).dtype)
                             for fn in data)
    return forms


def parquet_forms(path: str, columns: List[str], predicate,
                  dtypes: Dict[str, np.dtype],
                  dict_enabled: bool = True) -> ScanForms:
    """The forms of a parquet scan's columns from its footers only (schema,
    min / max and null statistics). The reference's verdicts: a string
    conjunct pushed into the reader, a string column with nulls (or no
    null statistics), an int64 column with no statistics proving it fits
    int32. The port filters a pushed-down string conjunct in the reader
    (it refuses one over a column with nulls) and reads an unproven int64
    column as the wide pair."""
    string_cols = parquet_lib.parquet_string_columns(path)

    def nulls_of(nm):
        nulls = parquet_lib.parquet_column_nulls(path, nm)
        return nulls is None or nulls > 0

    head = []
    strings = [nm for nm, _op, _lit in predicate if nm in string_cols]
    if strings:
        # a pushed-down conjunct compares the reader's values, where a null
        # has no order
        bad = [nm for nm in sorted(set(strings)) if nulls_of(nm)]
        head.append((None, (None, (
            f"pushed-down predicate on string column {strings[0]!r} — host "
            "tier filters it"), bad and (
                f"parquet string column {bad[0]!r} has nulls (or no "
                "null-count statistics) under a pushed-down predicate"))))
    checked = []
    for fn in columns:
        if fn in string_cols:
            if not dict_enabled:
                why = (f"parquet string column {fn!r} with "
                       "dense_dict_enabled off")
                checked.append((fn, (None, why, why)))
            elif nulls_of(fn):
                why = (f"parquet string column {fn!r} has nulls (or no "
                       "null-count statistics); codes have no null slot")
                checked.append((fn, (None, why, why)))
            else:
                checked.append((fn, ("dict", None, None)))
            continue
        dt = np.dtype(dtypes[fn])
        kind = _number_kind(dt)
        if dt.kind in ("U", "S"):
            why = (f"parquet column {fn!r}: string dtype without an arrow "
                   "string type — host tier serves it")
            checked.append((fn, (None, why, why)))
        elif kind is None:
            why = f"dtype {dt} has no device column form"
            checked.append((fn, (None, why, why)))
        elif kind == "int64?":
            # int32 where the statistics prove it fits; otherwise (missing
            # statistics or out of range) the wide pair, which holds any
            # int64 (a uint64 beyond int64 raises when it is read)
            mm = parquet_lib.parquet_column_minmax(path, fn)
            info = np.iinfo(np.int32)
            if mm is None or mm[0] < info.min or mm[1] > info.max:
                checked.append((fn, ("wide", (
                    f"parquet column {fn!r} is int64 with no proof it fits "
                    "int32 (missing stats or out of range)"), None)))
            else:
                checked.append((fn, ("int32", None, None)))
        else:
            checked.append((fn, (kind, None, None)))
    forms = _forms(head + checked)
    forms.kinds.pop(None, None)
    forms.file_dtypes = dtypes
    forms.np_ints = _np_ints((fn, np.dtype(dtypes[fn])) for fn in columns)
    return forms


def stored_kind(kind: str, host: bool) -> str:
    """The stored form of a column kind under the reference's tier (host:
    True for its host tier): "int32", "float32", "wide" or "float64" (a
    pair of words) or "dict" (int32 codes). A float64 column narrows to
    float32 unless the host tier holds it, a bool column is 0 / 1 int32
    words."""
    if kind == "bool":
        return "int32"
    if kind == "float64" and not host:
        return "float32"
    return kind


def _host_column(src: np.ndarray, dtype: str, bn: str, out: dict) -> None:
    """One non-string host column in its stored form under block name bn:
    the astype, or the (bn, bn.lo) words of its int64 values ("wide") or
    of its float64 bits ("float64")."""
    if dtype == "float64":
        words = src.astype(np.float64).view(np.int64)
    elif dtype == "wide":
        if src.dtype == np.uint64 and len(src) and \
                src.max() > np.uint64(2**63 - 1):
            raise VegaError(f"column {bn!r} holds uint64 values beyond "
                            "int64, which no device column holds")
        words = src.astype(np.int64)
    else:
        out[bn] = src.astype(dtype, copy=False)
        return
    out[bn], out[block_lib.lo_of(bn)] = block_lib.encode_i64(words)


# ---------------------------------------------------------------------------
# lazy device sources
# ---------------------------------------------------------------------------


class _FrameSource(dense_rdd.DenseRDD):
    """A lazy source: names are (frame name, block name) pairs, kinds each
    frame column's kind and np_ints the numpy integer dtypes of 32 bits
    or fewer (ScanForms), host whether the reference compiles the plan on
    its host tier (stored_kind). It materializes once at its first
    block() and, as every source, never enters the lifetime LRU (its host
    copy is the data)."""

    def __init__(self, ctx, names: List[Tuple[str, str]],
                 kinds: Dict[str, str], host: bool,
                 np_ints: Dict[str, np.dtype]):
        super().__init__(ctx, ctx.mesh)
        self._names = list(names)
        stored = {fn: stored_kind(kinds[fn], host) for fn, _bn in names}
        self._dict_bns = {bn for fn, bn in names if stored[fn] == "dict"}
        self._dtypes = {bn: "int32" if bn in self._dict_bns else stored[fn]
                        for fn, bn in names}
        # frame columns that are dictionary codes (the planner's gates),
        # float64 bits and bools on 0 / 1 words
        self._frame_dict_cols = frozenset(
            fn for fn, bn in names if bn in self._dict_bns)
        self._frame_f64_cols = frozenset(
            fn for fn, _bn in names if stored[fn] == "float64")
        self._frame_bool_cols = frozenset(
            fn for fn, _bn in names if host and kinds[fn] == "bool")
        # frame columns numpy computes on in their own width (host tier)
        self._frame_np_ints = {fn: np_ints[fn] for fn, _bn in names
                               if host and fn in np_ints}

    def _schema(self):
        out = []
        for _fn, bn in self._names:
            if self._dtypes[bn] in _PAIRS:
                out += [(bn, torch.int32), (block_lib.lo_of(bn), torch.int32)]
            else:
                out.append((bn, _TORCH_DTYPES[self._dtypes[bn]]))
        return tuple(out)

    def block_spec(self):
        if self._block is None:
            self._block = self._materialize()
        return self._block

    def unpersist(self):
        return self  # the host copy is the data: nothing cheaper to drop

    def _build(self, cols, dicts):
        return block_lib.from_numpy(
            cols, self.mesh, dicts=dicts or None,
            dict_enabled=self.context.dense_dict_enabled)


class _ColumnsSource(_FrameSource):
    """In-memory columns (create_frame)."""

    def __init__(self, ctx, data: Dict[str, np.ndarray], names, kinds,
                 host, np_ints):
        super().__init__(ctx, names, kinds, host, np_ints)
        self._data = data
        self._encoded: Dict[str, tuple] = {}  # bn -> (codes, dictionary)

    def _encode(self, fn: str, bn: str):
        # one encode, shared by _dicts() (graph-build gates and the join's
        # dictionary unification need it) and _materialize
        if bn not in self._encoded:
            self._encoded[bn] = dict_encoding.encode_array(
                np.asarray(self._data[fn]))
        return self._encoded[bn]

    def _fp_extra(self):
        return tuple((bn, self._dtypes[bn], bn in self._dict_bns,
                      len(self._data[fn])) for fn, bn in self._names)

    def _dicts(self):
        return {bn: self._encode(fn, bn)[1] for fn, bn in self._names
                if bn in self._dict_bns}

    def _materialize(self):
        cols, dicts = {}, {}
        for fn, bn in self._names:
            if bn in self._dict_bns:
                cols[bn], dicts[bn] = self._encode(fn, bn)
            else:
                _host_column(np.asarray(self._data[fn]), self._dtypes[bn],
                             bn, cols)
        return self._build(cols, dicts)


def make_columns_source(ctx, data: Dict[str, np.ndarray],
                        names: List[Tuple[str, str]], forms: ScanForms,
                        host: bool) -> _ColumnsSource:
    """Lazy source over in-memory columns; names maps (frame name, block
    name), forms are the columns' (columns_forms: checked when the plan
    compiles) and host whether the reference compiles the plan on its
    host tier. The data is coerced and sharded onto the device at the
    first materialization."""
    forms.check()
    return _ColumnsSource(ctx, data, names, forms.kinds, host,
                          forms.np_ints)


class _ParquetSource(_FrameSource):
    """A parquet path read with column pruning and the pushed-down
    predicate applied inside the reader."""

    def __init__(self, ctx, files, columns, predicate, names, kinds, host,
                 file_dtypes, np_ints):
        super().__init__(ctx, names, kinds, host, np_ints)
        self._files = files
        self._columns = list(columns)
        self._predicate = [tuple(p) for p in predicate]
        self._file_dtypes = file_dtypes
        self._dict_memo: Dict[str, np.ndarray] = {}  # bn -> dictionary

    def _fp_extra(self):
        return (tuple(self._files), tuple(self._columns),
                tuple(self._predicate),
                tuple(sorted(self._dtypes.items())),
                tuple(sorted(self._dict_bns)))

    def _dicts(self):
        if self._dict_bns and not self._dict_memo:
            # graph-build consumers (the join's dictionary unification)
            # need the dictionaries before an action: one column-pruned
            # read of just the string columns, memoized so _materialize
            # reuses the identical sorted dictionary
            sub = [fn for fn, bn in self._names if bn in self._dict_bns]
            pieces: Dict[str, list] = {fn: [] for fn in sub}
            for batch in parquet_lib.iter_parquet_batches(
                    self._files, sub, self._predicate,
                    arrow_columns=set(sub)):
                for fn in sub:
                    pieces[fn].append(_string_part(batch[fn])[1])
            for fn, bn in self._names:
                if bn in self._dict_bns:
                    self._dict_memo[bn] = _merged(pieces[fn])
        return {bn: self._dict_memo[bn] for bn in self._dict_bns}

    def _materialize(self):
        """One pass over the files; string columns arrive as per-batch
        (codes, values) pairs off the arrow dictionary pages and are
        remapped onto one sorted dictionary per column."""
        dict_fns = {fn for fn, bn in self._names if bn in self._dict_bns}
        parts: Dict[str, list] = {fn: [] for fn, _bn in self._names}
        for batch in parquet_lib.iter_parquet_batches(
                self._files, self._columns, self._predicate,
                arrow_columns=dict_fns):
            for fn, _bn in self._names:
                parts[fn].append(batch[fn])
        cols, dicts = {}, {}
        for fn, bn in self._names:
            if bn in self._dict_bns:
                pairs = [_string_part(p) for p in parts[fn]]
                merged = self._dict_memo.setdefault(
                    bn, _merged([v for _c, v in pairs]))
                cols[bn] = (np.concatenate([
                    np.searchsorted(merged, v).astype(
                        dict_encoding.CODE_DTYPE)[c]
                    for c, v in pairs]) if pairs
                    else np.zeros(0, dict_encoding.CODE_DTYPE))
                dicts[bn] = merged
            else:
                stacked = (np.concatenate(parts[fn]) if parts[fn]
                           else np.empty((0,), self._file_dtypes[fn]))
                _host_column(stacked, self._dtypes[bn], bn, cols)
        return self._build(cols, dicts)


def _string_part(part):
    """One batch of a string column as (codes, values): the reader gives a
    column a pushed-down conjunct reads as its flat values, any other as
    the arrow dictionary's pair."""
    if isinstance(part, tuple):
        return part
    return dict_encoding.encode_array(np.asarray(part))


def _merged(values: list) -> np.ndarray:
    """One sorted dictionary over per-batch dictionaries."""
    return (np.unique(np.concatenate(values)) if values
            else np.zeros(0, "<U1"))


def make_parquet_source(ctx, path: str, columns: List[str], predicate,
                        names: List[Tuple[str, str]],
                        dtypes: Dict[str, np.dtype], forms: ScanForms,
                        host: bool) -> _ParquetSource:
    """Lazy source over a parquet path with pruning and predicate pushdown
    applied inside the reader; forms are parquet_forms' (footers only),
    host as make_columns_source's. The files are read at the first
    materialization."""
    forms.check()
    return _ParquetSource(ctx, parquet_lib.discover_parquet_files(path),
                          columns, predicate, names, forms.kinds, host,
                          dtypes, forms.np_ints)


# ---------------------------------------------------------------------------
# host-tier per-partition closures
# ---------------------------------------------------------------------------


def host_block_stage(colmap: List[Tuple[str, str]], steps,
                     emit: List[Tuple[str, object]]):
    """Columnar host stage over one {name: np column} block: the same
    project / filter step list the device stage fuses, evaluated with
    numpy. Returns a new {out_name: column} block."""

    def run(block: dict) -> dict:
        env = {fn: block[bn] for fn, bn in colmap}
        n = len(next(iter(env.values()))) if env else 0
        for kind, payload in steps:
            if kind == "project":
                env = {nm: _host_broadcast(evaluate(e, env, host=True), n)
                       for nm, e in payload}
            else:  # filter
                keep = np.asarray(_host_broadcast(
                    evaluate(payload, env, host=True), n), dtype=bool)
                env = {nm: c[keep] for nm, c in env.items()}
                n = len(next(iter(env.values()))) if env else 0
        return {bn: _host_broadcast(evaluate(e, env, host=True), n)
                for bn, e in emit}

    return run


def _host_broadcast(v, n: int):
    arr = np.asarray(v)
    if arr.ndim == 0:
        return np.full(n, arr[()])
    return arr


def host_block_to_pairs(key_name: str, specs: List[Tuple[str, object]],
                        scalar: bool = False):
    """A columnar block pivoted into (key, value) rows for the host
    group-agg: specs are (alias, Expr) in output order; scalar=True
    (single-aggregate plans) emits the bare value instead of a 1-tuple.
    Keys become Python natives, so hashing and equality match the device
    collect's tolist view."""

    def run(block: dict):
        env = dict(block)
        n = len(next(iter(env.values()))) if env else 0
        keys = np.asarray(env[key_name])
        vals = [_host_broadcast(evaluate(e, env, host=True), n)
                for _alias, e in specs]
        if scalar:
            v0 = np.asarray(vals[0])
            for i in range(n):
                yield (_item(keys[i]), _item(v0[i]))
            return
        arrays = [np.asarray(v) for v in vals]
        for i in range(n):
            yield (_item(keys[i]), tuple(_item(a[i]) for a in arrays))

    return run


def _item(x):
    """Element -> Python native; object-column elements (str, ...) pass
    through."""
    return x.item() if hasattr(x, "item") else x


_HOST_OPS = {
    "add": lambda a, b: a + b,
    "min": min,
    "max": max,
}


def host_tuple_combiner(ops: List[str]):
    """Elementwise tuple monoid combine for the host reduce."""

    def combine(a, b):
        return tuple(_HOST_OPS[op](x, y) for op, x, y in zip(ops, a, b))

    return combine


def host_rows_stage(cols: List[str], steps,
                    emit: List[Tuple[str, object]]):
    """Rowwise host stage over (c0, c1, ...) tuples (the post-exchange
    layout): evaluates the same expression trees per row."""

    def run(row: tuple):
        env = dict(zip(cols, row))
        for kind, payload in steps:
            if kind == "project":
                env = {nm: evaluate(e, env, host=True)
                       for nm, e in payload}
            else:
                raise AssertionError("row-layout filters lower via filter()")
        return tuple(_native(evaluate(e, env, host=True))
                     for _nm, e in emit)

    return run


def host_rows_filter(cols: List[str], predicate):
    def run(row: tuple) -> bool:
        env = dict(zip(cols, row))
        return bool(evaluate(predicate, env, host=True))

    return run


def _native(v):
    arr = np.asarray(v)
    if arr.ndim == 0:
        return arr[()].item() if hasattr(arr[()], "item") else arr[()]
    return v


def host_rows_to_pairs(cols: List[str], key_name: str,
                       specs: List[Tuple[str, object]],
                       scalar: bool = False):
    """Rowwise pivot to (key, value[-tuple]) for a group-agg over the
    post-exchange row layout (scalar: see host_block_to_pairs)."""

    def run(row: tuple):
        env = dict(zip(cols, row))
        k = _native(env[key_name])
        if scalar:
            return (k, _native(evaluate(specs[0][1], env, host=True)))
        return (k, tuple(_native(evaluate(e, env, host=True))
                         for _alias, e in specs))

    return run


def host_pair_to_row():
    """(k, v) -> (k, v) row tuple (scalar single-aggregate finalize)."""

    def run(pair):
        return (pair[0], pair[1])

    return run


def host_finalize_slots(slots: List[tuple]):
    """(key, value-tuple) -> row. slots: ('v', i) picks vals[i];
    ('mean', i, j) emits vals[i] / vals[j]."""

    def run(pair):
        k, vals = pair
        out = [k]
        for slot in slots:
            if slot[0] == "v":
                out.append(vals[slot[1]])
            else:
                out.append(vals[slot[1]] / vals[slot[2]])
        return tuple(out)

    return run


def host_block_rows(cols: List[str]):
    """Columnar block -> row tuples (cols order), Python natives."""

    def run(block: dict):
        arrays = [np.asarray(block[c]) for c in cols]
        n = len(arrays[0]) if arrays else 0
        for i in range(n):
            yield tuple(_item(a[i]) for a in arrays)

    return run


def host_block_len(block: dict) -> int:
    """Row count of one columnar block: count() sums these instead of
    collecting the blocks."""
    return len(next(iter(block.values()))) if block else 0


def host_row_to_pair(idx: int):
    """Row tuple -> (key, rest-tuple) keyed on column index idx."""

    def run(row: tuple):
        return (row[idx], row[:idx] + row[idx + 1:])

    return run


def host_join_rows():
    """(k, (lrest, rrest)) -> (k, *lrest, *rrest)."""

    def run(pair):
        k, (lrest, rrest) = pair
        return (k,) + tuple(lrest) + tuple(rrest)

    return run


def host_left_join_emit(r_arity: int, fill_value):
    """Cogroup groups -> left-outer rows with an explicit fill (the device
    join's fill_value semantics, so results do not depend on the tier)."""

    def run(pair):
        k, (lvs, rvs) = pair
        if not rvs:
            fill = (fill_value,) * r_arity
            return [(k,) + tuple(lv) + fill for lv in lvs]
        return [(k,) + tuple(lv) + tuple(rv) for lv in lvs for rv in rvs]

    return run


def host_parquet_source(ctx, path: str, columns: Optional[List[str]],
                        predicate, num_partitions: int):
    """The host tier's parquet scan over the reference's file splits
    (io/readers.py's ParquetColumnReader: one partition per group of
    files), with the columns pruned and the predicate's conjuncts applied
    in the reader (parquet.iter_parquet_batches)."""
    from vega_tpu_torch.io.readers import ParquetColumnReader

    return ParquetColumnReader(path, columns, num_partitions,
                               predicate=predicate).make_reader(ctx)
