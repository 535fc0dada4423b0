"""Frame physical building blocks: the lazy device sources (the port's
copy of the device half of vega_tpu/frame/physical.py).

Plan compilation builds the source node and checks the dtypes; the first
block() reads the file or coerces the arrays and shards them onto the
Context's device (planning itself never touches data or the device).

Dtype contract at the device boundary (the reference's, the same degrade
block.from_numpy applies): int64 / uint64 / uint32 columns whose values
fit int32 narrow to int32; float64 narrows to float32; bool widens to
int32; strings become int32 dictionary codes plus a sorted host
dictionary (dict_encoding.py). Anything else (object columns of anything
but strings, out-of-range int64) raises VegaError when the plan compiles:
the reference compiles such a plan on its host tier, which the port does
not have."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from vega_tpu_torch import block as block_lib
from vega_tpu_torch import dense_rdd
from vega_tpu_torch import dict_encoding
from vega_tpu_torch.errors import VegaError
from vega_tpu_torch.frame import parquet as parquet_lib

_TORCH_DTYPES = {"int32": torch.int32, "float32": torch.float32}


def no_device_lowering(reason: str) -> VegaError:
    """The error for a plan the reference compiles on its host tier (its
    HostFallback), carrying the reference's reason."""
    return VegaError(f"the plan has no device lowering: {reason} (the "
                     "reference compiles it on its host tier, which "
                     "vega_tpu_torch does not have)")


# ---------------------------------------------------------------------------
# dtype coercion at the device boundary
# ---------------------------------------------------------------------------


def coerce_dtype(np_dtype, dict_enabled: bool = True) -> str:
    """numpy dtype -> device dtype name ("int32", "float32", "dict32" for
    a string column, or "int64?" when a value-range check must decide),
    or raise. Object dtypes are decided by coerced_dtype, which may scan
    the values."""
    dt = np.dtype(np_dtype)
    if dt == np.bool_:
        return "int32"
    if dt.kind in ("i", "u"):
        if dt.itemsize <= 4 and dt != np.uint32:
            return "int32"
        return "int64?"  # needs a value-range check (fits-int32 proof)
    if dt.kind == "f":
        return "float32"
    if dt.kind in ("U", "S"):
        if dict_enabled:
            return "dict32"
        raise no_device_lowering(
            f"string column (dtype {dt}) with dense_dict_enabled off")
    raise no_device_lowering(f"dtype {dt} has no device column form")


def coerced_dtype(name: str, col: np.ndarray,
                  dict_enabled: bool = True) -> Tuple[str, bool]:
    """(device dtype name one host column coerces to, is_dictionary): the
    CHECK only (dtype kind, the int64 range proof, the all-str object
    scan), no copy; the astype / encode runs at materialization."""
    col = np.asarray(col)
    if col.dtype.kind == "O":
        # object columns have a device form only when every element is a
        # str (the pandas pivot shape): a full scan, the same class of
        # compile-time value check as the int64 range proof below
        if dict_encoding.is_string_array(col):
            if dict_enabled:
                return "int32", True
            raise no_device_lowering(
                f"string column {name!r} with dense_dict_enabled off")
        raise no_device_lowering(
            f"column {name!r} (object dtype) has no device column form")
    kind = coerce_dtype(col.dtype, dict_enabled)
    if kind == "dict32":
        return "int32", True
    if kind == "int64?":
        info = np.iinfo(np.int32)
        if len(col) and (col.min() < info.min or col.max() > info.max):
            raise no_device_lowering(
                f"column {name!r} holds int64 values beyond int32 range")
        kind = "int32"
    return kind, False


# ---------------------------------------------------------------------------
# lazy device sources
# ---------------------------------------------------------------------------


class _FrameSource(dense_rdd.DenseRDD):
    """A lazy source: names are (frame name, block name) pairs, dtypes the
    device dtype name of each block column, dict_bns the block columns
    that are dictionary codes. It materializes once at its first block()
    and, as every source, never enters the lifetime LRU (its host copy is
    the data)."""

    def __init__(self, ctx, names: List[Tuple[str, str]],
                 dtypes: Dict[str, str], dict_bns: set):
        super().__init__(ctx, ctx.mesh)
        self._names = list(names)
        self._dtypes = dict(dtypes)
        self._dict_bns = set(dict_bns)
        # frame columns that are dictionary codes (the planner's gates)
        self._frame_dict_cols = frozenset(
            fn for fn, bn in names if bn in self._dict_bns)

    def _schema(self):
        return tuple((bn, _TORCH_DTYPES[self._dtypes[bn]])
                     for _fn, bn in self._names)

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

    def __init__(self, ctx, data: Dict[str, np.ndarray], names, dtypes,
                 dict_bns):
        super().__init__(ctx, names, dtypes, dict_bns)
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
                cols[bn] = np.asarray(self._data[fn]).astype(
                    self._dtypes[bn], copy=False)
        return self._build(cols, dicts)


def make_columns_source(ctx, data: Dict[str, np.ndarray],
                        names: List[Tuple[str, str]]) -> _ColumnsSource:
    """Lazy source over in-memory columns; names maps (frame name, block
    name). The dtypes are checked now (pure numpy); the data is coerced
    and sharded onto the device at the first materialization."""
    dtypes, dict_bns = {}, set()
    for fn, bn in names:
        dtypes[bn], is_dict = coerced_dtype(fn, data[fn],
                                            ctx.dense_dict_enabled)
        if is_dict:
            dict_bns.add(bn)
    return _ColumnsSource(ctx, data, names, dtypes, dict_bns)


class _ParquetSource(_FrameSource):
    """A parquet path read with column pruning and the pushed-down
    predicate applied inside the reader."""

    def __init__(self, ctx, files, columns, predicate, names, dtypes,
                 dict_bns, file_dtypes):
        super().__init__(ctx, names, dtypes, dict_bns)
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
                    pieces[fn].append(batch[fn][1])
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
                merged = self._dict_memo.setdefault(
                    bn, _merged([v for _c, v in parts[fn]]))
                cols[bn] = (np.concatenate([
                    np.searchsorted(merged, v).astype(
                        dict_encoding.CODE_DTYPE)[c]
                    for c, v in parts[fn]]) if parts[fn]
                    else np.zeros(0, dict_encoding.CODE_DTYPE))
                dicts[bn] = merged
            else:
                stacked = (np.concatenate(parts[fn]) if parts[fn]
                           else np.empty((0,), self._file_dtypes[fn]))
                cols[bn] = stacked.astype(self._dtypes[bn], copy=False)
        return self._build(cols, dicts)


def _merged(values: list) -> np.ndarray:
    """One sorted dictionary over per-batch dictionaries."""
    return (np.unique(np.concatenate(values)) if values
            else np.zeros(0, "<U1"))


def make_parquet_source(ctx, path: str, columns: List[str], predicate,
                        names: List[Tuple[str, str]],
                        dtypes: Dict[str, np.dtype]) -> _ParquetSource:
    """Lazy source over a parquet path with pruning and predicate pushdown
    applied inside the reader. Compile time reads footers only (schema,
    min / max and null statistics); the files are read at the first
    materialization."""
    string_cols = parquet_lib.parquet_string_columns(path)
    for nm, _op, _lit in predicate:
        if nm in string_cols:
            # a pushed-down conjunct evaluates as a numpy mask inside the
            # reader; there is no device-side literal encode
            raise no_device_lowering(
                f"pushed-down predicate on string column {nm!r} — "
                "host tier filters it")
    out_dtypes, dict_bns = {}, set()
    for fn, bn in names:
        if fn in string_cols:
            if not ctx.dense_dict_enabled:
                raise no_device_lowering(
                    f"parquet string column {fn!r} with "
                    "dense_dict_enabled off")
            # dictionary codes have no null slot: the device path needs a
            # statistics PROOF the column is null-free (metadata only)
            nulls = parquet_lib.parquet_column_nulls(path, fn)
            if nulls is None or nulls > 0:
                raise no_device_lowering(
                    f"parquet string column {fn!r} has nulls (or no "
                    "null-count statistics); codes have no null slot")
            out_dtypes[bn] = "int32"
            dict_bns.add(bn)
            continue
        kind = coerce_dtype(dtypes[fn], ctx.dense_dict_enabled)
        if kind == "dict32":
            raise no_device_lowering(
                f"parquet column {fn!r}: string dtype without an arrow "
                "string type — host tier serves it")
        if kind == "int64?":
            mm = parquet_lib.parquet_column_minmax(path, fn)
            info = np.iinfo(np.int32)
            if mm is None or mm[0] < info.min or mm[1] > info.max:
                raise no_device_lowering(
                    f"parquet column {fn!r} is int64 with no proof it "
                    "fits int32 (missing stats or out of range)")
            kind = "int32"
        out_dtypes[bn] = kind
    files = parquet_lib.discover_parquet_files(path)
    return _ParquetSource(ctx, files, columns, predicate, names, out_dtypes,
                          dict_bns, dtypes)
